"""Legacy model pack: I*I, I*X(pi/2), I*Y(pi/2), X(pi/2)*I, and Y(pi/2)*I gates
(counterpart of pygsti_tpu/modelpacks/legacy/std2Q_XYI.py)."""

import sys as _sys

from pygsti_tpu_torch.modelpacks.legacy import _legacy
from pygsti_tpu_torch.modelpacks.smq2Q_XYI import _Pack as _smq_pack

_legacy.populate(
    vars(_sys.modules[__name__]), _smq_pack,
    description='I*I, I*X(pi/2), I*Y(pi/2), X(pi/2)*I, and Y(pi/2)*I gates',
    gates=['Gii', 'Gix', 'Giy', 'Gxi', 'Gyi'],
    state_space=[('Q0', 'Q1')],
    op_labels=['Gii', 'Gix', 'Giy', 'Gxi', 'Gyi'],
    op_expressions=['I(Q0):I(Q1)', 'I(Q0):X(pi/2,Q1)', 'I(Q0):Y(pi/2,Q1)', 'X(pi/2,Q0):I(Q1)', 'Y(pi/2,Q0):I(Q1)'])
