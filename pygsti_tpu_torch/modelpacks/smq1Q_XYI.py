"""Model pack: 1 qubit, X(pi/2), Y(pi/2) and idle gates
(counterpart of pygsti_tpu/modelpacks/smq1Q_XYI.py)."""

from pygsti_tpu_torch.modelpacks._modelpack import GSTModelPack


class _Pack(GSTModelPack):
    _nqubits = 1
    _gates = ['Gxpi2', 'Gypi2']

    _germs = ['[]@(0)', 'Gxpi2:0@(0)', 'Gypi2:0@(0)', 'Gxpi2:0Gypi2:0@(0)',
              'Gxpi2:0Gxpi2:0Gypi2:0@(0)']

    _prep_fids = ['{}@(0)', 'Gxpi2:0@(0)', 'Gypi2:0@(0)', 'Gxpi2:0Gxpi2:0@(0)',
                  'Gxpi2:0Gxpi2:0Gxpi2:0@(0)', 'Gypi2:0Gypi2:0Gypi2:0@(0)']
    _meas_fids = ['{}@(0)', 'Gxpi2:0@(0)', 'Gypi2:0@(0)', 'Gxpi2:0Gxpi2:0@(0)',
                  'Gxpi2:0Gxpi2:0Gxpi2:0@(0)', 'Gypi2:0Gypi2:0Gypi2:0@(0)']


target_model = _Pack.target_model
germs = _Pack.germs
prep_fiducials = _Pack.prep_fiducials
meas_fiducials = _Pack.meas_fiducials
