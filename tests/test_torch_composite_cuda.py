"""Composite (parallel) layers of pygsti_tpu_torch on a card: the kernel at a
K1 = 9 op stack that holds three composite layers, against its plain version,
and the blocked objective on the card against the CPU path.

Imports nothing of JAX, so it also runs on a machine without JAX:
    python -m pytest tests/test_torch_composite_cuda.py --noconftest -q
(``--noconftest`` skips tests/conftest.py, which imports JAX).  Without a
card the tests skip.
"""

import numpy as np
import pytest
import torch

import pygsti_tpu_torch.modelpacks.smq2Q_XXYYII as mp
from pygsti_tpu_torch.data.datasetconstruction import simulate_data
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.objectivefns.objectivefns import ObjectiveFunctionBuilder, bucket_plan
from pygsti_tpu_torch.ops.bwd_jacobian import (bwd_jacobian_accumulate,
                                               bwd_jacobian_accumulate_plain)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _design():
    """smq2Q_XXYYII at maxL <= 4, a fifth of the fiducial pairs: 1,000-odd
    circuits whose layout registers the three parallel layers."""
    model = mp.target_model('full').depolarize(op_noise=0.02, spam_noise=0.01)
    circuits = list(mp.create_gst_experiment_design(
        4, keep_fraction=0.2, keep_seed=1).circuit_lists[-1])
    return model, circuits


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_kernel_at_the_composite_layer_buckets(card, dtype, tol):
    """At every bucket shape of the layout (K1 = 9: 5 operations, 3
    composite layers, the identity), the kernel's A and B_final against the
    plain version's, on the model's own op stack and random E and F."""
    model, circuits = _design()
    layout = SimpleForwardSimulator(model, 'cuda').create_layout(circuits)
    K1, d = len(model.op_keys) + 1, model.dim
    assert K1 == 9 and len(model.operations) == 5
    NT = (K1 - 1) * d * d + d + 4 * d
    buckets, _ = bucket_plan(layout, 4, NT, torch.device('cuda'))
    G = torch.cat([model.tensors_fn()(torch.as_tensor(model.to_vector())).ops,
                   torch.eye(d, dtype=torch.float64)[None]]).to('cuda', dtype)
    gen = torch.Generator().manual_seed(5)
    for bk in buckets:
        B, D = bk['cols'].shape
        E = torch.randn((B, 4, d), generator=gen, dtype=torch.float64).to('cuda', dtype)
        F = torch.randn((B, D, d), generator=gen, dtype=torch.float64).to('cuda', dtype)
        A, Bf = bwd_jacobian_accumulate(bk['cols'], G, E, F)
        A2, Bf2 = bwd_jacobian_accumulate_plain(bk['cols'].long(), G.double(), E.double(),
                                                F.double())
        scale = max(float(A2.abs().max()), float(Bf2.abs().max()))
        err = max(float((A.double() - A2).abs().max()), float((Bf.double() - Bf2).abs().max()))
        assert err <= tol * scale, (B, D, err, scale)
        # the composite layers' slots do receive gradient blocks
        assert float(A[:, :, 5:8].abs().max()) > 0


@pytest.mark.cuda
def test_blocked_objective_with_composite_layers_matches_the_cpu(card):
    """lsvec, J^T J and J^T f of the blocked objective on the card within
    1e-9 relative of the CPU path's; the card's run launches the kernel."""
    model, circuits = _design()
    ds = simulate_data(model, circuits, 1000, seed=3, device='cpu')
    theta = model.to_vector() + 1e-3 * np.random.RandomState(2).randn(model.num_params)
    before = bwd_jacobian_accumulate.launches
    card_obj, cpu_obj = (ObjectiveFunctionBuilder('logl').build(model, ds, circuits, device=dev)
                         for dev in ('cuda', 'cpu'))
    card_out = card_obj.jtj_jtf(theta)
    assert card_obj.jac_mode == 'blocked' and bwd_jacobian_accumulate.launches > before
    for a, b in zip(card_out, cpu_obj.jtj_jtf(theta)):
        assert a.shape == b.shape and _rel(a, b) < 1e-9
