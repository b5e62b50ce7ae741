"""Model pack: 2 qubits, X/Y(pi/2) on each + CNOT (no idle)
(counterpart of pygsti_tpu/modelpacks/smq2Q_XYCNOT.py)."""

from pygsti_tpu_torch.modelpacks._modelpack import GSTModelPack
from pygsti_tpu_torch.modelpacks.smq2Q_XYICNOT import _Pack as _XYICNOTPack


class _Pack(GSTModelPack):
    _nqubits = 2
    _gates = ['Gxpi2', 'Gypi2', 'Gcnot']
    _include_idle = False

    _germs = [g for g in _XYICNOTPack._germs if g != '[]@(0,1)']
    _germs_lite = _germs
    _prep_fids = _XYICNOTPack._prep_fids
    _meas_fids = _XYICNOTPack._meas_fids

    _op_order = [('Gxpi2', (1,)), ('Gypi2', (1,)),
                 ('Gxpi2', (0,)), ('Gypi2', (0,)), ('Gcnot', (0, 1))]


target_model = _Pack.target_model
germs = _Pack.germs
prep_fiducials = _Pack.prep_fiducials
meas_fiducials = _Pack.meas_fiducials
create_gst_experiment_design = _Pack.create_gst_experiment_design
