"""Model pack: 1 qubit, X(pi/4) and Z(pi/2) gates
(counterpart of pygsti_tpu/modelpacks/smq1Q_pi4_pi2_XZ.py)."""

from pygsti_tpu_torch.modelpacks._modelpack import GSTModelPack


class _Pack(GSTModelPack):
    _nqubits = 1
    _gates = ['Gxpi4', 'Gzpi2']
    _include_idle = False
    _germs = ['Gxpi4:0@(0)', 'Gzpi2:0@(0)', 'Gzpi2:0Gxpi4:0@(0)',
              'Gzpi2:0Gzpi2:0Gxpi4:0@(0)']
    _germs_lite = _germs
    _prep_fids = ['{}@(0)', 'Gxpi4:0Gxpi4:0@(0)', 'Gxpi4:0Gxpi4:0Gzpi2:0@(0)',
                  'Gxpi4:0Gxpi4:0Gxpi4:0Gxpi4:0@(0)',
                  'Gxpi4:0Gxpi4:0Gxpi4:0Gxpi4:0Gxpi4:0Gxpi4:0@(0)',
                  'Gxpi4:0Gxpi4:0Gzpi2:0Gzpi2:0Gzpi2:0@(0)']
    _meas_fids = ['{}@(0)', 'Gxpi4:0Gxpi4:0@(0)', 'Gzpi2:0Gxpi4:0Gxpi4:0@(0)',
                  'Gxpi4:0Gxpi4:0Gxpi4:0Gxpi4:0@(0)',
                  'Gxpi4:0Gxpi4:0Gxpi4:0Gxpi4:0Gxpi4:0Gxpi4:0@(0)',
                  'Gzpi2:0Gzpi2:0Gzpi2:0Gxpi4:0Gxpi4:0@(0)']


target_model = _Pack.target_model
germs = _Pack.germs
prep_fiducials = _Pack.prep_fiducials
meas_fiducials = _Pack.meas_fiducials
create_gst_experiment_design = _Pack.create_gst_experiment_design
