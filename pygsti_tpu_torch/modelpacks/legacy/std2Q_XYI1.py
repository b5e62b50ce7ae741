"""Legacy model pack: Idle, X(pi/2), and Y(pi/2) gates on the first of two qubits
(counterpart of pygsti_tpu/modelpacks/legacy/std2Q_XYI1.py)."""

import sys as _sys

from pygsti_tpu_torch.modelpacks.legacy import _legacy
from pygsti_tpu_torch.modelpacks.smq2Q_XYI1 import _Pack as _smq_pack

_legacy.populate(
    vars(_sys.modules[__name__]), _smq_pack,
    description='Idle, X(pi/2), and Y(pi/2) gates on the first of two qubits',
    gates=['Gii', 'Gxi', 'Gyi'],
    state_space=[('Q0',)],
    op_labels=['Gii', 'Gxi', 'Gyi'],
    op_expressions=['I(Q0)', 'X(pi/2,Q0)', 'Y(pi/2,Q0)'],
    effect_labels=['0', '1'], effect_expressions=['0', '1'])
