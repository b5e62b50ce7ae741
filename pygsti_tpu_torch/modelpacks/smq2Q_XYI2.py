"""Model pack: idle + X/Y(pi/2) on qubit 1 only (2-qubit space)
(counterpart of pygsti_tpu/modelpacks/smq2Q_XYI2.py)."""

from pygsti_tpu_torch.modelpacks._modelpack import GSTModelPack


class _Pack(GSTModelPack):
    _nqubits = 2
    _gates = ['Gxpi2', 'Gypi2']
    _include_idle = True
    _availability = {'Gxpi2': [(1,)], 'Gypi2': [(1,)]}

    _germs = ['[]@(0,1)', 'Gxpi2:1@(0,1)', 'Gypi2:1@(0,1)',
              'Gxpi2:1Gypi2:1@(0,1)', 'Gxpi2:1Gxpi2:1Gypi2:1@(0,1)']

    _germs_lite = ['[]@(0,1)', 'Gxpi2:1@(0,1)', 'Gypi2:1@(0,1)',
              'Gxpi2:1Gypi2:1@(0,1)', 'Gxpi2:1Gxpi2:1Gypi2:1@(0,1)']

    _prep_fids = ['{}@(0,1)', 'Gxpi2:1@(0,1)', 'Gypi2:1@(0,1)',
              'Gxpi2:1Gxpi2:1@(0,1)']

    _meas_fids = ['{}@(0,1)', 'Gxpi2:1@(0,1)', 'Gypi2:1@(0,1)',
              'Gxpi2:1Gxpi2:1@(0,1)']


target_model = _Pack.target_model
germs = _Pack.germs
prep_fiducials = _Pack.prep_fiducials
meas_fiducials = _Pack.meas_fiducials
create_gst_experiment_design = _Pack.create_gst_experiment_design
