"""The FOGI-reparameterized model and the leakage gauge group on a card
against their CPU paths.

Imports nothing of JAX, so it also runs on a machine without JAX:
    python -m pytest tests/test_torch_fogi_cuda.py --noconftest -q
Without a card the tests skip.
"""

import numpy as np
import pytest
import torch

from pygsti_tpu_torch import leakage
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists
from pygsti_tpu_torch.modelpacks import smq2Q_XYICNOT as mp
from pygsti_tpu_torch.objectivefns.objectivefns import ObjectiveFunctionBuilder
from pygsti_tpu_torch.data.datasetconstruction import simulate_data


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.cuda
def test_reparameterized_tv_and_objective_card_against_cpu(card):
    """smq2Q_XYICNOT 'H+s' in FOGI coordinates (174 parameters): the flat
    tensors and Tv = Tv_members(M v) @ M on the card within 1e-12 of the
    CPU path; the blocked lsvec / J^T J / J^T f on the maxL-1 list within
    1e-9 relative."""
    model = mp.target_model('H+s')
    model.setup_fogi(include_spam=True, reparameterize=True)
    theta = 2e-3 * np.random.RandomState(7).randn(model.num_params)
    model.from_vector(theta)
    out = {}
    for dev in ('cuda', 'cpu'):
        v = torch.as_tensor(theta, dtype=torch.float64, device=dev)
        out[dev] = (model.flat_tensors_fn()(v).cpu().numpy(),
                    model.flat_tensors_jacobian_fn()(v).cpu().numpy())
    assert out['cuda'][1].shape == (6 * 256 + 16 + 64, 174)
    assert _rel(out['cuda'][0], out['cpu'][0]) < 1e-12
    assert _rel(out['cuda'][1], out['cpu'][1]) < 1e-12
    circuits = list(create_lsgst_circuit_lists(mp.target_model('full'), mp.prep_fiducials(),
                                               mp.meas_fiducials(), mp.germs(), [1])[-1])
    ds = simulate_data(model, circuits, 1000, seed=3, device='cpu')
    res = [ObjectiveFunctionBuilder('logl').build(model, ds, circuits, device=dev).jtj_jtf(theta)
           for dev in ('cuda', 'cpu')]
    assert max(_rel(np.asarray(a), np.asarray(b)) for a, b in zip(*res)) < 1e-9


@pytest.mark.cuda
def test_lago_element_card_against_cpu(card):
    """The direct-sum unitary element and its gradient on the card within
    1e-12 of the CPU path, at 0 and at a random point."""
    group = leakage.DirectSumUnitaryGaugeGroup(9, 'gm')
    for v in (np.zeros(5), 0.3 * np.random.RandomState(2).randn(5)):
        res = []
        for dev in ('cuda', 'cpu'):
            x = torch.as_tensor(v, dtype=torch.float64, device=dev).requires_grad_(True)
            S = group.element_matrix(x)
            (S[1:, 1:] ** 3).sum().backward()
            res.append((S.detach().cpu().numpy(), x.grad.cpu().numpy()))
        assert np.max(np.abs(res[0][0] - res[1][0])) < 1e-12
        assert np.max(np.abs(res[0][1] - res[1][1])) < 1e-12
