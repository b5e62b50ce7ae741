"""Legacy model pack: Z(pi/2) and rot(X=pi/2, Y=sqrt(3)/2) gates
(counterpart of pygsti_tpu/modelpacks/legacy/std1Q_ZN.py)."""

import sys as _sys

from pygsti_tpu_torch.modelpacks.legacy import _legacy
from pygsti_tpu_torch.modelpacks.smq1Q_ZN import _Pack as _smq_pack

_legacy.populate(
    vars(_sys.modules[__name__]), _smq_pack,
    description='Z(pi/2) and rot(X=pi/2, Y=sqrt(3)/2) gates',
    gates=['Gz', 'Gn'],
    state_space=[('Q0',)],
    op_labels=['Gz', 'Gn'],
    op_expressions=['Z(pi/2,Q0)', 'N(pi/2, sqrt(3)/2, 0, -0.5, Q0)'])
