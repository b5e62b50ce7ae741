"""Legacy model pack: X(pi/2) and Z(pi/2) gates
(counterpart of pygsti_tpu/modelpacks/legacy/std1Q_XZ.py)."""

import sys as _sys

from pygsti_tpu_torch.modelpacks.legacy import _legacy
from pygsti_tpu_torch.modelpacks.smq1Q_XZ import _Pack as _smq_pack

_legacy.populate(
    vars(_sys.modules[__name__]), _smq_pack,
    description='X(pi/2) and Z(pi/2) gates',
    gates=['Gx', 'Gz'],
    state_space=[('Q0',)],
    op_labels=['Gx', 'Gz'],
    op_expressions=['X(pi/2,Q0)', 'Z(pi/2,Q0)'])
