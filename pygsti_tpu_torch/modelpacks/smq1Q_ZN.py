"""Model pack: 1 qubit, Z(pi/2) and N (pi/2 about a tilted axis) gates
(counterpart of pygsti_tpu/modelpacks/smq1Q_ZN.py)."""

from pygsti_tpu_torch.modelpacks._modelpack import GSTModelPack


class _Pack(GSTModelPack):
    _nqubits = 1
    _gates = ['Gzpi2', 'Gn']
    _include_idle = False
    _germs = ['Gzpi2:0@(0)', 'Gn:0@(0)', 'Gzpi2:0Gn:0@(0)', 'Gzpi2:0Gzpi2:0Gn:0@(0)',
              'Gzpi2:0Gn:0Gn:0@(0)', 'Gzpi2:0Gzpi2:0Gn:0Gzpi2:0Gn:0Gn:0@(0)']
    _germs_lite = _germs
    _prep_fids = ['{}@(0)', 'Gn:0@(0)', 'Gn:0Gn:0@(0)', 'Gn:0Gzpi2:0Gn:0@(0)',
                  'Gn:0Gn:0Gn:0@(0)', 'Gn:0Gzpi2:0Gn:0Gn:0Gn:0@(0)']
    _meas_fids = ['{}@(0)', 'Gn:0@(0)', 'Gn:0Gn:0@(0)', 'Gn:0Gzpi2:0Gn:0@(0)',
                  'Gn:0Gn:0Gn:0@(0)', 'Gn:0Gn:0Gn:0Gzpi2:0Gn:0@(0)']


target_model = _Pack.target_model
germs = _Pack.germs
prep_fiducials = _Pack.prep_fiducials
meas_fiducials = _Pack.meas_fiducials
create_gst_experiment_design = _Pack.create_gst_experiment_design
