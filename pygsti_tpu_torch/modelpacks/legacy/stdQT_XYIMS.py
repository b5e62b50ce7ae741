"""Legacy qutrit model pack: idle, symmetric X(pi/2), symmetric Y(pi/2) and
Molmer-Sorensen gates on the symmetric (triplet) subspace of two qubits
(counterpart of pygsti_tpu/modelpacks/legacy/stdQT_XYIMS.py).  It has no
smq twin, so its circuits are listed here: gate names without state-space
labels on line '*', which the layout resolves to the target's operations
('Gx' names 'Gx:T0').
"""

from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.models import qutrit as _qutrit

description = "Idle, symmetric X(pi/2), symmetric Y(pi/2), and Molmer-Sorenson gates"

gates = ['Gi', 'Gx', 'Gy', 'Gm']


def _circuits(tuples):
    return [Circuit(t, line_labels=('*',)) for t in tuples]


prepStrs = _circuits([
    (),
    ('Gx',),
    ('Gy',),
    ('Gm',),
    ('Gx', 'Gx'),
    ('Gm', 'Gx'),
    ('Gm', 'Gy'),
    ('Gy', 'Gy', 'Gy'),
    ('Gx', 'Gx', 'Gx'),
])

effectStrs = _circuits([
    (),
    ('Gx',),
    ('Gy',),
    ('Gm',),
    ('Gx', 'Gx'),
    ('Gy', 'Gm'),
    ('Gx', 'Gm'),
])

germs = _circuits([
    ('Gi',),
    ('Gy',),
    ('Gx',),
    ('Gm',),
    ('Gi', 'Gy'),
    ('Gi', 'Gx'),
    ('Gi', 'Gm'),
    ('Gy', 'Gm'),
    ('Gx', 'Gm'),
    ('Gx', 'Gy'),
    ('Gi', 'Gi', 'Gy'),
    ('Gi', 'Gi', 'Gx'),
    ('Gx', 'Gx', 'Gy'),
    ('Gi', 'Gi', 'Gm'),
    ('Gi', 'Gy', 'Gy'),
    ('Gi', 'Gy', 'Gx'),
    ('Gi', 'Gy', 'Gm'),
    ('Gi', 'Gx', 'Gy'),
    ('Gi', 'Gx', 'Gx'),
    ('Gi', 'Gx', 'Gm'),
    ('Gi', 'Gm', 'Gy'),
    ('Gi', 'Gm', 'Gx'),
    ('Gi', 'Gm', 'Gm'),
    ('Gy', 'Gy', 'Gx'),
    ('Gy', 'Gy', 'Gm'),
    ('Gy', 'Gx', 'Gx'),
    ('Gy', 'Gx', 'Gm'),
    ('Gy', 'Gm', 'Gx'),
    ('Gy', 'Gm', 'Gm'),
    ('Gx', 'Gx', 'Gm'),
    ('Gx', 'Gm', 'Gm'),
    ('Gx', 'Gy', 'Gy'),
    ('Gx', 'Gy', 'Gi'),
    ('Gx', 'Gi', 'Gy'),
    ('Gx', 'Gi', 'Gi'),
    ('Gy', 'Gi', 'Gi'),
    ('Gx', 'Gm', 'Gy'),
    ('Gx', 'Gy', 'Gy', 'Gi'),
    ('Gm', 'Gm', 'Gx', 'Gm'),
    ('Gx', 'Gx', 'Gy', 'Gx'),
    ('Gm', 'Gy', 'Gm', 'Gx'),
    ('Gx', 'Gi', 'Gy', 'Gy'),
    ('Gy', 'Gy', 'Gm', 'Gm'),
    ('Gi', 'Gx', 'Gy', 'Gm'),
    ('Gx', 'Gi', 'Gi', 'Gm'),
    ('Gx', 'Gx', 'Gy', 'Gy'),
    ('Gx', 'Gm', 'Gy', 'Gx'),
    ('Gm', 'Gy', 'Gm', 'Gi'),
    ('Gx', 'Gi', 'Gm', 'Gi', 'Gy'),
    ('Gy', 'Gm', 'Gx', 'Gy', 'Gy'),
    ('Gx', 'Gy', 'Gm', 'Gy', 'Gy'),
    ('Gm', 'Gx', 'Gi', 'Gx', 'Gx'),
    ('Gx', 'Gi', 'Gy', 'Gi', 'Gy'),
    ('Gx', 'Gx', 'Gy', 'Gm', 'Gy'),
    ('Gm', 'Gy', 'Gm', 'Gm', 'Gy'),
    ('Gy', 'Gi', 'Gi', 'Gy', 'Gx'),
    ('Gy', 'Gy', 'Gx', 'Gx', 'Gy'),
    ('Gx', 'Gy', 'Gm', 'Gx', 'Gi'),
    ('Gm', 'Gi', 'Gm', 'Gy', 'Gi'),
    ('Gy', 'Gm', 'Gx', 'Gx', 'Gx'),
    ('Gy', 'Gi', 'Gm', 'Gx', 'Gi'),
    ('Gy', 'Gy', 'Gx', 'Gm', 'Gx'),
    ('Gx', 'Gx', 'Gy', 'Gx', 'Gy', 'Gy'),
    ('Gi', 'Gy', 'Gx', 'Gx', 'Gy', 'Gy'),
    ('Gy', 'Gx', 'Gx', 'Gy', 'Gx', 'Gm'),
    ('Gx', 'Gi', 'Gi', 'Gy', 'Gy', 'Gy'),
    ('Gm', 'Gy', 'Gi', 'Gx', 'Gy', 'Gi'),
    ('Gx', 'Gx', 'Gy', 'Gx', 'Gi', 'Gx'),
    ('Gm', 'Gy', 'Gx', 'Gm', 'Gm', 'Gy'),
])

germs_lite = _circuits([
    ('Gi',),
    ('Gy',),
    ('Gx',),
    ('Gm',),
    ('Gi', 'Gy'),
    ('Gi', 'Gx'),
    ('Gi', 'Gm'),
    ('Gx', 'Gy'),
    ('Gy', 'Gm'),
    ('Gx', 'Gm'),
    ('Gi', 'Gi', 'Gy'),
    ('Gi', 'Gi', 'Gx'),
    ('Gx', 'Gx', 'Gy'),
    ('Gi', 'Gi', 'Gm'),
    ('Gi', 'Gy', 'Gy'),
    ('Gi', 'Gy', 'Gx'),
    ('Gi', 'Gy', 'Gm'),
    ('Gi', 'Gx', 'Gy'),
    ('Gi', 'Gx', 'Gx'),
    ('Gi', 'Gx', 'Gm'),
    ('Gi', 'Gm', 'Gy'),
    ('Gi', 'Gm', 'Gx'),
    ('Gi', 'Gm', 'Gm'),
    ('Gy', 'Gy', 'Gx'),
    ('Gy', 'Gy', 'Gm'),
    ('Gy', 'Gx', 'Gx'),
    ('Gy', 'Gx', 'Gm'),
    ('Gy', 'Gm', 'Gx'),
    ('Gy', 'Gm', 'Gm'),
    ('Gx', 'Gx', 'Gm'),
    ('Gx', 'Gm', 'Gm'),
])

fiducials = prepStrs
prep_fiducials = prepStrs
meas_fiducials = effectStrs


def target_model(parameterization_type="full", sim_type="auto"):
    """The ideal qutrit model, its gates keyed ('Gi', 'T0'), ..., of type
    `parameterization_type`."""
    mdl = _qutrit.create_qutrit_model(error_scale=0, basis='qt')
    if parameterization_type not in ("full", "full arbitrary"):
        mdl.set_all_parameterizations(parameterization_type)
    return mdl
