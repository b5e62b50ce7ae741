"""The blocked Jacobian's chain through Tv = d tensors / d v packed by op
slot (objectivefns.tv_chain): the model's map of each slot's parameter
columns is exact and tight, and the packed chain equals the dense
(dls * Jt) @ Tv in jtj_jtf, dlsvec, the weighted Gram and the probability
Jacobian, bit for bit between calls; a model without a map takes the
dense route.  The 3-qubit cases are in test_torch_blocked3q.py."""

import itertools

import numpy as np
import pytest
import torch

from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.data.datasetconstruction import simulate_data
from pygsti_tpu_torch.models import cloudnoisemodel as tcnm
from pygsti_tpu_torch.models import modelconstruction as tmc
from pygsti_tpu_torch.modelpacks import smq1Q_XYI
from pygsti_tpu_torch.objectivefns import objectivefns as tof
from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec as TSpec

GATES = ['Gxpi2', 'Gypi2', 'Gcnot']
CIRCUITS_1Q = ['Gxpi2:0Gypi2:0@(0)', 'Gypi2:0Gypi2:0Gxpi2:0@(0)', '{}@(0)', 'Gxpi2:0@(0)']
CIRCUITS_2Q = ['Gxpi2:0Gcnot:0:1@(0,1)', '[Gxpi2:0Gypi2:1]Gcnot:0:1@(0,1)',
               'Gypi2:1[Gxpi2:0Gxpi2:1]@(0,1)', 'Gcnot:0:1Gcnot:0:1Gypi2:0@(0,1)',
               '[Gypi2:0Gxpi2:1]Gxpi2:1Gypi2:1@(0,1)', '{}@(0,1)']


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """torch on one thread in this module, beside the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def local_1q():
    """A 1-qubit local-noise model with Lindblad and depolarizing noise."""
    return tmc.create_crosstalk_free_model(
        TSpec(1, ['Gxpi2', 'Gypi2']), depolarization_strengths={'Gypi2': 0.01},
        lindblad_error_coeffs={'Gxpi2': {('H', 'X'): 0.05, ('S', 'Y'): 0.01}}), CIRCUITS_1Q


def cloud_2q():
    """A 2-qubit cloud-noise model, 'H+s' clouds and 'H+S' SPAM."""
    return tcnm.create_cloud_crosstalk_model_from_hops_and_weights(
        TSpec(2, GATES, geometry='line'), maxhops=1, max_idle_weight=1, extra_gate_weight=1,
        gate_type='H+s', spam_type='H+S'), CIRCUITS_2Q


def seeded(model, seed=5):
    """A parameter vector with no zero entry."""
    return 0.01 + 0.02 * np.random.RandomState(seed).rand(model.num_params)


def check_map(model, theta):
    """Every entry of Tv outside a slot's mapped columns is exactly 0, and
    every mapped column is nonzero somewhere in the slot's block."""
    Tv = model.flat_tensors_jacobian_fn()(torch.as_tensor(theta)).numpy()
    d2 = model.dim * model.dim
    cols_by_slot = model.op_param_indices()
    assert len(cols_by_slot) == len(model.op_keys)
    for k, cols in enumerate(cols_by_slot):
        assert np.all(np.diff(cols) > 0)
        block = Tv[k * d2:(k + 1) * d2]
        outside = np.setdiff1d(np.arange(model.num_params), cols)
        assert np.all(block[:, outside] == 0)
        assert np.all(np.any(block[:, cols] != 0, axis=0))
    return cols_by_slot


@pytest.mark.parametrize("make", [local_1q, cloud_2q])
def test_op_param_indices_are_exact_and_tight(make):
    """The map of a 1-qubit local-noise and a 2-qubit cloud-noise model over
    their circuits' layers, at a seeded point with no zero entry."""
    model, circuits = make()
    model.register_circuit_layers([Circuit(s) for s in circuits])
    cols = check_map(model, seeded(model))
    assert 0 < sum(len(c) for c in cols) < len(cols) * model.num_params


def dense_chain(op_params, n_ops, dim, P, device):
    """The chain before packing: (diag(scale) Jt) @ Tv."""
    def bind(Tv):
        def chain(Jt, scale=None):
            return (Jt if scale is None else scale[:, None] * Jt) @ Tv
        return chain
    return bind


def four_results(obj, theta):
    """jtj_jtf, dlsvec, the weighted Gram and the probability Jacobian."""
    w = np.cos(np.arange(obj.layout.num_elements))
    return list(obj.jtj_jtf(theta)) + [obj.dlsvec(theta), obj.weighted_gram(w, theta),
                                       obj.probs_jacobian(theta)]


def packed_against_dense(monkeypatch, model, circuits, theta, name='chi2'):
    """(objective, packed results); each within 1e-13 of the dense chain's,
    relative to its largest entry."""
    circuits = [Circuit(s) for s in circuits]
    ds = simulate_data(model, circuits, 1000, seed=7, device='cpu')
    obj = tof.ObjectiveFunctionBuilder(name).build(model, ds, circuits, device='cpu')
    assert obj.jac_mode == 'blocked'
    packed = four_results(obj, theta)
    with monkeypatch.context() as m:
        m.setattr(tof, 'tv_chain', dense_chain)
        dense = four_results(tof.ObjectiveFunctionBuilder(name).build(
            model, ds, circuits, device='cpu'), theta)
    for a, b in zip(packed, dense):
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) <= 1e-13 * np.max(np.abs(b))
    return obj, packed


def num_buckets(obj):
    """The blocked Jacobian's row blocks on the objective's layout."""
    m, layout = obj.model, obj.layout
    n_eff = sum(m.povms[k].num_outcomes for k in m.povm_keys)
    NT = len(m.op_keys) * m.dim ** 2 + (len(m.prep_keys) + n_eff) * m.dim
    n_out = layout.num_elements // layout.op_indices.shape[0]
    return len(tof.bucket_plan(layout, n_out, NT, 'cpu')[0])


@pytest.mark.parametrize("name", ['chi2', 'logl'])
def test_packed_chain_equals_the_dense_one_chain_first(monkeypatch, name):
    """The 2-qubit cloud model with the chain-first Gram forced (a small
    JAC_BLOCK_BYTES): the packed chain against the dense one, bit for bit
    between two calls, one packed chain per bucket per call."""
    monkeypatch.setattr(tof, 'JAC_BLOCK_BYTES', 1024 * 1024)
    model, _ = cloud_2q()
    # 70 circuits of two and three layers: two row blocks of at most 64
    layers = ['Gxpi2:0', 'Gcnot:0:1', '[Gxpi2:0Gypi2:1]', 'Gypi2:1', '[Gypi2:0Gxpi2:1]']
    circuits = [''.join(c) + '@(0,1)' for c in itertools.product(layers, repeat=2)] \
        + [''.join(c) + '@(0,1)' for c in itertools.product(layers, repeat=3)][:45]
    theta = seeded(model)
    obj, packed = packed_against_dense(monkeypatch, model, circuits, theta, name)
    nb = num_buckets(obj)
    assert nb > 1
    monkeypatch.setattr(tof.tv_chain, 'packed', 0)
    monkeypatch.setattr(tof.tv_chain, 'dense', 0)
    again = four_results(obj, theta)
    assert all(np.array_equal(a, b) for a, b in zip(packed, again))
    # jtj_jtf, dlsvec, the Gram and the Jacobian each chain every bucket once
    assert (tof.tv_chain.packed, tof.tv_chain.dense) == (4 * nb, 0)
    assert 0 < tof.tv_chain.density < 1


def test_packed_chain_without_chain_first(monkeypatch):
    """A 1-qubit local-noise model, whose jtj_jtf takes the Gram over the
    tensor entries: dlsvec and the Jacobian still chain packed."""
    model, circuits = local_1q()
    packed_against_dense(monkeypatch, model, circuits, seeded(model))


def test_an_explicit_model_takes_the_dense_route(monkeypatch):
    """An explicit model states no map: every chain dense, none packed."""
    model = smq1Q_XYI.target_model('full TP')
    assert model.op_param_indices() is None
    circuits = [Circuit(s) for s in ('Gxpi2:0Gypi2:0@(0)', 'Gxpi2:0@(0)', '{}@(0)')]
    ds = simulate_data(model, circuits, 1000, seed=3, device='cpu')
    obj = tof.ObjectiveFunctionBuilder('chi2').build(model, ds, circuits, device='cpu')
    monkeypatch.setattr(tof.tv_chain, 'packed', 0)
    monkeypatch.setattr(tof.tv_chain, 'dense', 0)
    obj.dlsvec()
    obj.jtj_jtf()
    assert tof.tv_chain.packed == 0 and tof.tv_chain.dense == num_buckets(obj)


def test_tv_chain_alone(monkeypatch):
    """tv_chain on a random Jt: the row scale after the product equals it
    before, and a map whose slots hold every parameter takes the dense
    route."""
    model, circuits = cloud_2q()
    model.register_circuit_layers([Circuit(s) for s in circuits])
    v = torch.as_tensor(seeded(model))
    Tv = model.flat_tensors_jacobian_fn()(v)
    n_ops, P = len(model.op_keys), model.num_params
    Jt = torch.as_tensor(np.random.RandomState(2).randn(128, Tv.shape[0]))
    s = torch.as_tensor(np.random.RandomState(3).randn(128))
    want = (s[:, None] * Jt) @ Tv
    got = tof.tv_chain(model.op_param_indices(), n_ops, model.dim, P, 'cpu')(Tv)(Jt, s)
    assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max())
    monkeypatch.setattr(tof.tv_chain, 'dense', 0)
    every = [np.arange(P)] * n_ops
    got = tof.tv_chain(every, n_ops, model.dim, P, 'cpu')(Tv)(Jt, s)
    assert tof.tv_chain.dense == 1
    assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max())
