"""The Taylor-term simulator on a card against its CPU path: the order-2
coefficients of 2-qubit circuits, their probabilities and derivatives, and
tape evaluation in torch.

Imports nothing of JAX, so it also runs on a machine without JAX:
    python -m pytest tests/test_torch_termsim_cuda.py --noconftest -q
Without a card the tests skip.
"""

import numpy as np
import pytest
import torch

from pygsti_tpu_torch.baseobjs import opcalc
from pygsti_tpu_torch.baseobjs.polynomial import Polynomial, compact_polynomial_list
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists
from pygsti_tpu_torch.forwardsims.termforwardsim import TermForwardSimulator
from pygsti_tpu_torch.modelpacks import smq2Q_XYICNOT as mp


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope='module')
def model_and_circuits():
    model = mp.target_model('H+s')
    model.from_vector(model.to_vector()
                      + np.random.RandomState(3).randn(model.num_params) * 0.001)
    lists = create_lsgst_circuit_lists(mp.target_model('full'), mp.prep_fiducials(),
                                       mp.meas_fiducials(), mp.germs(), [1, 2, 4])
    return model, list(lists[-1])[::9]


@pytest.mark.cuda
def test_coefficients_card_against_cpu(card, model_and_circuits):
    """c0, c1, c2 within 1e-12 of max(1, the circuit's largest coefficient);
    probabilities and dprobs within 1e-12."""
    model, circuits = model_and_circuits
    a = TermForwardSimulator(model, device='cuda').bulk_coefficients(circuits)
    b = TermForwardSimulator(model, device='cpu').bulk_coefficients(circuits)
    for x, y in ((a.c0, b.c0), (a.c1, b.c1), (a.c2, b.c2)):
        scale = torch.clamp(y.abs().flatten(1).max(dim=1).values, min=1.0)
        assert float(((x.cpu() - y).abs().flatten(1).max(dim=1).values / scale).max()) < 1e-12
    v = model.to_vector()
    assert float((a.probs(v).cpu() - b.probs(v)).abs().max()) < 1e-12
    assert float((a.dprobs(v).cpu() - b.dprobs(v)).abs().max()) < 1e-12


@pytest.mark.cuda
def test_single_circuit_paths_on_the_card(card, model_and_circuits):
    """probs / dprobs / prob_polynomials on the card against the CPU
    (1e-12), and bulk_probs against the single-circuit path."""
    model, circuits = model_and_circuits
    gpu, cpu = TermForwardSimulator(model, device='cuda'), TermForwardSimulator(model, device='cpu')
    bulk = gpu.bulk_probs(circuits[:5])
    for c in circuits[:5]:
        pa, pb = gpu.probs(c), cpu.probs(c)
        assert all(abs(pa[o] - pb[o]) < 1e-12 and abs(bulk[c][o] - pb[o]) < 1e-12 for o in pb)
        da, db = gpu.dprobs(c), cpu.dprobs(c)
        assert all(np.abs(da[o] - db[o]).max() < 1e-12 for o in db)
        qa, _ = gpu.prob_polynomials(c)
        qb, _ = cpu.prob_polynomials(c)
        assert [set(x) for x in qa] == [set(y) for y in qb]


@pytest.mark.cuda
def test_tape_evaluation_on_the_card(card):
    """Values and derivative matrices of random tapes, card against CPU
    (1e-13)."""
    rng = np.random.RandomState(0)
    polys = [Polynomial({tuple(sorted(rng.randint(0, 20, rng.randint(0, 5)))): complex(*rng.randn(2))
                         for _ in range(rng.randint(1, 9))}) for _ in range(500)]
    vt, ct = compact_polynomial_list(polys)
    x = rng.randn(20).astype(complex)
    a = opcalc.bulk_eval_compact_polynomials_complex(vt, ct, x, (500,), device='cuda')
    b = opcalc.bulk_eval_compact_polynomials_complex(vt, ct, x, (500,), device='cpu')
    assert np.abs(a - b).max() < 1e-13
    a = opcalc.bulk_eval_compact_polynomials_derivs_complex(vt, ct, range(20), x, (500, 20),
                                                            device='cuda')
    b = opcalc.bulk_eval_compact_polynomials_derivs_complex(vt, ct, range(20), x, (500, 20),
                                                            device='cpu')
    assert np.abs(a - b).max() < 1e-13
