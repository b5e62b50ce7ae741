"""Implicit models of pygsti_tpu_torch on a card: the kernel at the 2-qubit
cloud-noise layout's bucket shapes (K1 11, four parallel layers) against
its plain version, the cloud model's tensors, Tv and blocked objective on
the card against the CPU path, and the 5-qubit scan grouped by op.

Imports nothing of JAX, so it also runs on a machine without JAX:
    python -m pytest tests/test_torch_implicit_cuda.py --noconftest -q
(``--noconftest`` skips tests/conftest.py, which imports JAX).  Without a
card the tests skip.
"""

import numpy as np
import pytest
import torch

from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.circuits.cloudcircuitconstruction import create_cloudnoise_circuits
from pygsti_tpu_torch.data.datasetconstruction import simulate_data
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.models.cloudnoisemodel import \
    create_cloud_crosstalk_model_from_hops_and_weights
from pygsti_tpu_torch.objectivefns.objectivefns import ObjectiveFunctionBuilder, bucket_plan
from pygsti_tpu_torch.ops.bwd_jacobian import (bwd_jacobian_accumulate,
                                               bwd_jacobian_accumulate_plain)
from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec

FIDS = [(), ('Gxpi2',), ('Gypi2',), ('Gxpi2', 'Gxpi2')]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _cloud2(seed=4):
    """The 2-qubit cloud model of 162 parameters at seeded rates and the
    cloud-noise design at maxL 8 (its Jacobians taken on the card)."""
    spec = QubitProcessorSpec(2, ['Gxpi2', 'Gypi2', 'Gcnot'], geometry='line')
    model = create_cloud_crosstalk_model_from_hops_and_weights(
        spec, maxhops=1, max_idle_weight=1, extra_gate_weight=1, gate_type='H+s')
    model.from_vector(0.01 * np.random.RandomState(seed).randn(model.num_params))
    circuits = list(create_cloudnoise_circuits(spec, [1, 2, 4, 8], FIDS, max_idle_weight=1,
                                               maxhops=1, extra_gate_weight=1, seed=3,
                                               device='cuda'))
    return model, circuits


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_kernel_at_the_cloud_layout_buckets(card, dtype, tol):
    """At every bucket shape of the cloud-noise layout (d 16, NOUT 4, K1 11:
    the empty layer, five gate layers, four parallel ones, the identity),
    the kernel's A and B_final against the plain version's."""
    model, circuits = _cloud2()
    layout = SimpleForwardSimulator(model, 'cuda').create_layout(circuits)
    K1, d = len(model.op_keys) + 1, model.dim
    assert K1 == 11 and sum(len(k.components) > 1 for k in model.op_keys) == 4
    NT = (K1 - 1) * d * d + d + 4 * d
    buckets, _ = bucket_plan(layout, 4, NT, torch.device('cuda'))
    G = torch.cat([model.tensors_fn()(torch.as_tensor(model.to_vector())).ops,
                   torch.eye(d, dtype=torch.float64)[None]]).to('cuda', dtype)
    gen = torch.Generator().manual_seed(6)
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


@pytest.mark.cuda
def test_cloud_tensors_and_tv_on_the_card(card):
    """tensors_fn and Tv of the cloud model on the card within 1e-12 of the
    CPU path's; Tv against torch.func.jacfwd on the card within 1e-12."""
    model, circuits = _cloud2()
    SimpleForwardSimulator(model, 'cpu').create_layout(circuits)
    v = model.to_vector()
    outs = {}
    for dev in ('cuda', 'cpu'):
        x = torch.as_tensor(v, device=dev)
        outs[dev] = (model.flat_tensors_fn()(x), model.flat_tensors_jacobian_fn()(x))
    for a, b in zip(outs['cuda'], outs['cpu']):
        assert float((a.cpu() - b).abs().max()) < 1e-12
    x = torch.as_tensor(v, device='cuda')
    full = torch.func.jacfwd(model.flat_tensors_fn())(x)
    assert float((outs['cuda'][1] - full).abs().max()) < 1e-12


@pytest.mark.cuda
def test_cloud_blocked_objective_matches_the_cpu(card):
    """lsvec, J^T J and J^T f of the blocked objective on the card within
    1e-9 relative of the CPU path's; the card's run launches the kernel."""
    model, circuits = _cloud2()
    ds = simulate_data(model, circuits, 1000, seed=3, device='cpu')
    theta = model.to_vector() + 1e-3 * np.random.RandomState(2).randn(model.num_params)
    before = bwd_jacobian_accumulate.launches
    card_obj, cpu_obj = (ObjectiveFunctionBuilder('chi2').build(model, ds, circuits, device=dev)
                         for dev in ('cuda', 'cpu'))
    card_out = card_obj.jtj_jtf(theta)
    assert card_obj.jac_mode == 'blocked' and bwd_jacobian_accumulate.launches > before
    for a, b in zip(card_out, cpu_obj.jtj_jtf(theta)):
        assert a.shape == b.shape and _rel(a, b) < 1e-9


@pytest.mark.cuda
def test_five_qubit_grouped_scan_on_the_card(card):
    """The 5-qubit cloud model (594 parameters, d 1,024), 40 circuits on
    the card (the scan grouped by op) against 4 of them on the CPU: 1e-12;
    each circuit's probabilities sum to 1 within 1e-12."""
    spec = QubitProcessorSpec(5, ['Gxpi2', 'Gypi2', 'Gcnot'], geometry='line')
    model = create_cloud_crosstalk_model_from_hops_and_weights(
        spec, maxhops=1, max_idle_weight=1, extra_gate_weight=0, gate_type='H+s')
    v = np.zeros(model.num_params)
    v[:8] = 0.005
    model.from_vector(v)
    rng = np.random.RandomState(1)
    strs = []
    for _ in range(40):
        layers = []
        for t in range(6):
            layers.append('%s:%d' % (['Gxpi2', 'Gypi2'][rng.randint(2)], rng.randint(5)))
            if t % 2 == 1:
                c = rng.randint(4)
                layers.append('Gcnot:%d:%d' % (c, c + 1))
        strs.append(''.join(layers) + '@(0,1,2,3,4)')
    circuits = [Circuit(s) for s in strs]
    card = SimpleForwardSimulator(model, 'cuda')
    p_card = card.bulk_fill_probs(None, card.create_layout(circuits))
    cpu = SimpleForwardSimulator(model, 'cpu')
    p_cpu = cpu.bulk_fill_probs(None, cpu.create_layout(circuits[:4]))
    assert np.max(np.abs(p_card[:4 * 32] - p_cpu)) < 1e-12
    assert np.max(np.abs(p_card.reshape(40, 32).sum(axis=1) - 1)) < 1e-12
