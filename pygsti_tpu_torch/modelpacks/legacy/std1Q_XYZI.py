"""Legacy model pack: Idle, X(pi/2), Y(pi/2), and Z(pi/2) gates
(counterpart of pygsti_tpu/modelpacks/legacy/std1Q_XYZI.py)."""

import sys as _sys

from pygsti_tpu_torch.modelpacks.legacy import _legacy
from pygsti_tpu_torch.modelpacks.smq1Q_XYZI import _Pack as _smq_pack

_legacy.populate(
    vars(_sys.modules[__name__]), _smq_pack,
    description='Idle, X(pi/2), Y(pi/2), and Z(pi/2) gates',
    gates=['Gi', 'Gx', 'Gy', 'Gz'],
    state_space=[('Q0',)],
    op_labels=['Gi', 'Gx', 'Gy', 'Gz'],
    op_expressions=['I(Q0)', 'X(pi/2,Q0)', 'Y(pi/2,Q0)', 'Z(pi/2,Q0)'])
