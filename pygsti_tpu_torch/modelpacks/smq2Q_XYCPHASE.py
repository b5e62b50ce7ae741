"""Model pack: 2 qubits, X/Y(pi/2) on each + CPHASE (no idle)
(counterpart of pygsti_tpu/modelpacks/smq2Q_XYCPHASE.py)."""

from pygsti_tpu_torch.modelpacks._modelpack import GSTModelPack


class _Pack(GSTModelPack):
    _nqubits = 2
    _gates = ['Gxpi2', 'Gypi2', 'Gcphase']
    _include_idle = False

    _germs = [
        'Gxpi2:0@(0,1)', 'Gypi2:0@(0,1)', 'Gxpi2:1@(0,1)', 'Gypi2:1@(0,1)',
        'Gcphase:0:1@(0,1)', 'Gxpi2:0Gypi2:0@(0,1)', 'Gxpi2:1Gypi2:1@(0,1)',
        'Gxpi2:0Gxpi2:0Gypi2:0@(0,1)', 'Gxpi2:1Gxpi2:1Gypi2:1@(0,1)',
        'Gxpi2:1Gypi2:1Gcphase:0:1@(0,1)',
        'Gcphase:0:1Gxpi2:1Gxpi2:0Gxpi2:0@(0,1)',
        'Gxpi2:0Gxpi2:1Gypi2:1Gxpi2:0Gypi2:1Gypi2:0@(0,1)',
        'Gxpi2:0Gypi2:1Gxpi2:1Gypi2:0Gxpi2:1Gxpi2:1@(0,1)',
        'Gcphase:0:1Gxpi2:1Gypi2:0Gcphase:0:1Gypi2:1Gxpi2:0@(0,1)',
        'Gypi2:0Gxpi2:0Gypi2:1Gxpi2:0Gxpi2:1Gxpi2:0Gypi2:0Gypi2:1@(0,1)',
    ]
    _germs_lite = _germs
    _prep_fids = [
        '{}@(0,1)', 'Gxpi2:1@(0,1)', 'Gypi2:1@(0,1)', 'Gxpi2:1Gxpi2:1@(0,1)',
        'Gxpi2:0@(0,1)', 'Gxpi2:0Gxpi2:1@(0,1)', 'Gxpi2:0Gypi2:1@(0,1)',
        'Gxpi2:0Gxpi2:1Gxpi2:1@(0,1)', 'Gypi2:0@(0,1)', 'Gypi2:0Gxpi2:1@(0,1)',
        'Gypi2:0Gypi2:1@(0,1)', 'Gypi2:0Gxpi2:1Gxpi2:1@(0,1)', 'Gxpi2:0Gxpi2:0@(0,1)',
        'Gxpi2:0Gxpi2:0Gxpi2:1@(0,1)', 'Gxpi2:0Gxpi2:0Gypi2:1@(0,1)',
        'Gxpi2:0Gxpi2:0Gxpi2:1Gxpi2:1@(0,1)',
    ]
    _meas_fids = [
        '{}@(0,1)', 'Gxpi2:1@(0,1)', 'Gypi2:1@(0,1)', 'Gxpi2:1Gxpi2:1@(0,1)',
        'Gxpi2:0@(0,1)', 'Gypi2:0@(0,1)', 'Gxpi2:0Gxpi2:0@(0,1)',
        'Gxpi2:0Gxpi2:1@(0,1)', 'Gxpi2:0Gypi2:1@(0,1)', 'Gypi2:0Gxpi2:1@(0,1)',
        'Gypi2:0Gypi2:1@(0,1)',
    ]

    _op_order = [('Gxpi2', (1,)), ('Gypi2', (1,)),
                 ('Gxpi2', (0,)), ('Gypi2', (0,)), ('Gcphase', (0, 1))]


target_model = _Pack.target_model
germs = _Pack.germs
prep_fiducials = _Pack.prep_fiducials
meas_fiducials = _Pack.meas_fiducials
create_gst_experiment_design = _Pack.create_gst_experiment_design
