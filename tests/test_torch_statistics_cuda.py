"""The weighted Gram of the error bars and the Fisher information, and the
batched water-fill of the wildcard budgets, on a card against the CPU path.

Imports nothing of JAX, so it also runs on a machine without JAX:
    python -m pytest tests/test_torch_statistics_cuda.py --noconftest -q
Without a card the tests skip.
"""

import numpy as np
import pytest
import torch

import pygsti_tpu_torch.modelpacks.smq2Q_XYICNOT as mp
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists
from pygsti_tpu_torch.data.datasetconstruction import simulate_data
from pygsti_tpu_torch.objectivefns.objectivefns import (RawPoissonPicDeltaLogLFunction,
                                                        TimeIndependentMDCObjectiveFunction)
from pygsti_tpu_torch.objectivefns.wildcardbudget import PrimitiveOpsWildcardBudget, WaterfillPlan
from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _objectives(maxl, stride):
    target = mp.target_model('full')
    circuits = list(create_lsgst_circuit_lists(target, mp.prep_fiducials(), mp.meas_fiducials(),
                                               mp.germs(), [1, 2, 4, 8][:maxl])[-1])[::stride]
    datagen = mp.target_model('full TP').depolarize(op_noise=0.01, spam_noise=0.01)
    ds = simulate_data(datagen, circuits, 1000, seed=7, device='cpu')
    model = target.copy()
    model.from_vector(model.to_vector() + 1e-3 * np.random.RandomState(3).randn(model.num_params))
    return [TimeIndependentMDCObjectiveFunction(RawPoissonPicDeltaLogLFunction(), model, ds,
                                                circuits, device=dev) for dev in ('cuda', 'cpu')]


@pytest.mark.cuda
def test_weighted_gram_on_the_card(card):
    """The weighted Gram with signed weights through the kernel on the card
    against the plain version on the CPU, within 1e-12 relative, and the
    kernel launched once per bucket; the Gauss-Newton and exact Hessians
    against the CPU's within 1e-10."""
    on_card, on_cpu = _objectives(3, 3)
    assert on_card.jac_mode == 'blocked'
    w = np.random.RandomState(5).randn(on_card.num_elements)
    bwd_jacobian_accumulate.launches = 0
    G = on_card.weighted_gram(w)
    assert bwd_jacobian_accumulate.launches > 0
    assert _rel(G, on_cpu.weighted_gram(w)) < 1e-12
    for approximate in (True, False):
        assert _rel(on_card.hessian(approximate=approximate),
                    on_cpu.hessian(approximate=approximate)) < 1e-10


@pytest.mark.cuda
def test_waterfill_on_the_card(card):
    """Every circuit's water-filled probabilities and dp/dW on the card
    against the CPU's, within 1e-13, at budgets that leave each branch in
    use."""
    on_card, on_cpu = _objectives(4, 1)
    budget = PrimitiveOpsWildcardBudget(list(on_cpu.model.operations.keys()) + ['SPAM'])
    lay = on_cpu.layout
    plans = [WaterfillPlan(budget, lay.element_slices, lay.circuits, on_cpu.freqs, dev)
             for dev in ('cuda', 'cpu')]
    probs = on_cpu.probs()
    for scale in (0.0, 1e-4, 1e-3, 1e-2, 1.0):
        budget.from_vector(scale * np.array([1.0, 2.0, 0.5, 1.5, 1.0, 3.0, 0.7]))
        (pc, dc), (pp, dp) = [plan.update(probs, budget.wildcard_vector, True) for plan in plans]
        assert torch.max(torch.abs(pc.cpu() - pp)) < 1e-13
        assert torch.max(torch.abs(dc.cpu() - dp)) < 1e-13
