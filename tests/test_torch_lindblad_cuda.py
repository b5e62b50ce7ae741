"""The Lindblad members of pygsti_tpu_torch on a card against the CPU path.

Imports nothing of JAX, so it also runs on a machine without JAX:
    python -m pytest tests/test_torch_lindblad_cuda.py --noconftest -q
(``--noconftest`` skips tests/conftest.py, which imports JAX).  Without a
card the tests skip.
"""

import numpy as np
import pytest
import torch

import pygsti_tpu_torch.modelpacks.smq2Q_XYICNOT as mp
from pygsti_tpu_torch.modelmembers.operations import _matrix_exp


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("gate_type", ['CPTPLND', 'GLND', 'H+S', 'full unitary'])
def test_tensors_and_tv_on_the_card_match_the_cpu(card, gate_type):
    """The tensors and Tv = d tensors / d theta (forward mode through the
    matrix exponential) of the 2-qubit model at parameters perturbed by
    0.05: the card within 1e-10 of the CPU path, entry by entry, and the
    model's block-wise Tv within 1e-10 of plain jacfwd over every parameter."""
    model = mp.target_model(gate_type)
    rng = np.random.RandomState(11)
    theta = model.to_vector() + 0.05 * rng.randn(model.num_params)
    flat, jac = model.flat_tensors_fn(), model.flat_tensors_jacobian_fn()
    v_cpu = torch.as_tensor(theta)
    v_card = v_cpu.to('cuda')
    t_card, t_cpu = flat(v_card), flat(v_cpu)
    assert t_card.device.type == 'cuda' and t_card.dtype == torch.float64
    assert float((t_card.cpu() - t_cpu).abs().max()) < 1e-10
    tv_card, tv_cpu = jac(v_card), jac(v_cpu)
    assert tv_card.device.type == 'cuda'
    assert tv_card.shape == (t_cpu.numel(), model.num_params)
    assert float((tv_card.cpu() - tv_cpu).abs().max()) < 1e-10
    assert float((tv_card - torch.func.jacfwd(flat)(v_card)).abs().max()) < 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("norm", [0.0, 1e-7, 1e-3, 0.01, 0.03, 0.045, 0.2, 1.0, 3.0])
def test_matrix_exp_on_the_card(card, norm):
    """The port's matrix exponential on the card against scipy at 1-norms
    across the library routine's polynomial switches: 1e-13 times
    max(1, exp(norm))."""
    import scipy.linalg
    rng = np.random.RandomState(5)
    a = rng.randn(16, 16)
    a *= norm / np.linalg.norm(a, 1)
    out = _matrix_exp(torch.as_tensor(a, device='cuda')).cpu().numpy()
    assert np.max(np.abs(out - scipy.linalg.expm(a))) < 1e-13 * max(1.0, np.exp(norm))
