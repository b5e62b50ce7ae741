"""run_long_sequence_gst from a dataset file on a card against the CPU
path, and a results directory written on the card read back.

Imports nothing of JAX, so it also runs on a machine without JAX:
    python -m pytest tests/test_torch_drivers_cuda.py --noconftest -q
Without a card the tests skip.
"""

import numpy as np
import pytest
import torch

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as mp
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists
from pygsti_tpu_torch.data.datasetconstruction import simulate_data
from pygsti_tpu_torch.drivers.longsequence import run_long_sequence_gst
from pygsti_tpu_torch.io import write_dataset
from pygsti_tpu_torch.io.readers import read_results_from_dir
from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_driver_from_a_file_on_the_card(card, tmp_path, monkeypatch):
    """The 1-qubit fit at maxL 1..8 from a file: 2DeltaLogL and N_sigma
    within 1e-9 relative of the CPU path, through the kernel; the results
    written and read back with the same parameters."""
    monkeypatch.chdir(tmp_path)
    target = mp.target_model('full TP')
    args = (mp.prep_fiducials(), mp.meas_fiducials(), mp.germs(), [1, 2, 4, 8])
    final = list(create_lsgst_circuit_lists(target, *args)[-1])
    ds = simulate_data(target.depolarize(op_noise=0.03, spam_noise=0.01), final, 1000, seed=8,
                       device='cpu')
    path = str(tmp_path / 'dataset.txt')
    write_dataset(path, ds)
    runs = {}
    for dev in ('cuda', 'cpu'):
        bwd_jacobian_accumulate.launches = 0
        runs[dev] = run_long_sequence_gst(path, mp.target_model('full TP'), *args, verbosity=0,
                                          device=dev)
        if dev == 'cuda':
            assert bwd_jacobian_accumulate.launches > 0
    card_est, cpu_est = (runs[d].estimates['GateSetTomography'] for d in ('cuda', 'cpu'))
    f_card, f_cpu = (e.parameters['final_objfn_value'] for e in (card_est, cpu_est))
    assert abs(f_card - f_cpu) / abs(f_cpu) < 1e-9
    assert abs(card_est.misfit_sigma() - cpu_est.misfit_sigma()) \
        < 1e-9 * max(abs(cpu_est.misfit_sigma()), 1.0)
    runs['cuda'].write(str(tmp_path / 'results'))
    back = read_results_from_dir(str(tmp_path / 'results'), 'GateSetTomography')
    best = back.estimates['GateSetTomography']
    for k in ('final iteration estimate', 'stdgaugeopt'):
        assert np.array_equal(best.models[k].to_vector(), card_est.models[k].to_vector())
    assert best.misfit_sigma() == card_est.misfit_sigma()
