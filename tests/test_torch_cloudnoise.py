"""Cloud-noise models in the port against the JAX package: parameter
counts and order, probabilities at seeded parameters (2, 3 and 5 qubits),
the grouped scan, stencils on spectator qubits, Tv against
torch.func.jacfwd, the conversion of a JAX model and the options both
packages refuse.  The designs, the blocked objective and a fit are in
tests/test_torch_cloudnoise_designs.py."""

import numpy as np
import pytest
import torch

from pygsti_tpu.circuits import Circuit as JCircuit
from pygsti_tpu.models import cloudnoisemodel as jcnm
from pygsti_tpu.models import modelconstruction as jmc
from pygsti_tpu.processors import QubitProcessorSpec as JSpec

from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.convert import implicit_model_from_vector
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.models import cloudnoisemodel as tcnm
from pygsti_tpu_torch.models import modelconstruction as tmc
from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec as TSpec

GATES = ['Gxpi2', 'Gypi2', 'Gcnot']
# (qubits, maxhops, max_idle_weight, extra_gate_weight, gate_type)
CONFIGS = [(2, 0, 1, 0, 'H+s'), (2, 1, 1, 1, 'H+s'), (3, 1, 1, 0, 'H+s'),
           (3, 0, 2, 0, 'H'), (3, 1, 0, 1, 'H+S')]


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """torch on one thread in this module, beside the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(nq, hops, idle_w, extra_w, gate_type, seed=None, scale=0.01):
    jm = jcnm.create_cloud_crosstalk_model_from_hops_and_weights(
        JSpec(nq, GATES, geometry='line'), maxhops=hops, max_idle_weight=idle_w,
        extra_gate_weight=extra_w, gate_type=gate_type)
    tm = tcnm.create_cloud_crosstalk_model_from_hops_and_weights(
        TSpec(nq, GATES, geometry='line'), maxhops=hops, max_idle_weight=idle_w,
        extra_gate_weight=extra_w, gate_type=gate_type)
    if seed is not None:
        theta = scale * np.random.RandomState(seed).randn(jm.num_params)
        jm.from_vector(theta)
        tm.from_vector(theta)
    return jm, tm


def _circuits(nq, n, seed, depth=6):
    """Random circuits of 1-qubit gates, CNOTs and parallel layers on a
    line of nq qubits, with the empty layer now and then."""
    rng = np.random.RandomState(seed)
    lines = '@(%s)' % ','.join(str(q) for q in range(nq))
    out = []
    for _ in range(n):
        layers = []
        for t in range(depth):
            r = rng.randint(4)
            if r == 0:
                c = rng.randint(nq - 1)
                layers.append('Gcnot:%d:%d' % (c, c + 1))
            elif r == 1 and nq > 1:
                a, b = rng.choice(nq, 2, replace=False)
                layers.append('[Gxpi2:%d%s:%d]' % (min(a, b), ['Gypi2', 'Gxpi2'][t % 2],
                                                   max(a, b)))
            elif r == 2 and t % 3 == 0:
                layers.append('[]')
            else:
                layers.append('%s:%d' % (['Gxpi2', 'Gypi2'][rng.randint(2)], rng.randint(nq)))
        out.append(''.join(layers) + lines)
    return out


@pytest.mark.parametrize("config", CONFIGS, ids=[str(c) for c in CONFIGS])
def test_parameter_count_and_order(config):
    """The same number of parameters, each member at the same slice, each
    error generator over the same basis elements."""
    jm, tm = _models(*config)
    assert tm.num_params == jm.num_params
    jidle, tidle = jm.idle_member, tm.idle_member
    assert (jidle is None) == (tidle is None)
    if tidle is not None:
        assert tidle.gpindices == jidle.gpindices
    jclouds, tclouds = jm.operation_blks['cloudnoise'], tm.operation_blks['cloudnoise']
    assert list(tclouds.keys()) == list(jclouds.keys())
    for key in tclouds:
        assert tclouds[key].gpindices == jclouds[key].gpindices
        assert [b.basis_element_labels for b in tclouds[key].errorgen.blocks] == \
            [list(b.basis_element_labels) for b in jclouds[key].errorgen.blocks]
        assert [b.block_type for b in tclouds[key].errorgen.blocks] == \
            [b.block_type for b in jclouds[key].errorgen.blocks]
    assert tm._cloud_map_by_targets.keys() == jm._cloud_map_by_targets.keys()


@pytest.mark.parametrize("config", CONFIGS, ids=[str(c) for c in CONFIGS])
def test_probabilities_at_seeded_parameters(config):
    """Every outcome probability of random circuits (parallel and empty
    layers included) at seeded parameters, within 1e-12; the op stacks
    register the same layers in the same order."""
    jm, tm = _models(*config, seed=11)
    strs = _circuits(config[0], 12, seed=5)
    jp = jm.sim.bulk_probs([JCircuit(s) for s in strs])
    tp = tm.bulk_probabilities([Circuit(s) for s in strs], device='cpu')
    assert [str(k) for k in tm.op_keys] == [str(k) for k in jm.op_keys]
    for s in strs:
        jd, td = jp[JCircuit(s)], tp[Circuit(s)]
        assert list(td.keys()) == list(jd.keys())
        assert max(abs(jd[o] - td[o]) for o in jd) < 1e-12


def test_five_qubit_probabilities(monkeypatch):
    """A 5-qubit cloud model at d = 1,024 (clouds on the targets, so that the
    JAX package builds it in seconds) at seeded parameters: four circuits
    of bench.py's recipe within 1e-12 of the JAX package's, each summing to
    1 within 1e-12, by the gathered scan and by the scan grouped by op
    (which 40 circuits and more take)."""
    from pygsti_tpu_torch.forwardsims import forwardsim
    jm, tm = _models(5, 0, 0, 1, 'H+s', seed=12)
    assert tm.dim == 1024 and tm.num_params == jm.num_params
    strs = ['Gxpi2:3Gypi2:0Gcnot:1:2Gxpi2:4@(0,1,2,3,4)',
            'Gypi2:2Gcnot:3:4Gxpi2:0Gcnot:0:1@(0,1,2,3,4)',
            'Gxpi2:1Gxpi2:1Gcnot:2:3@(0,1,2,3,4)', 'Gypi2:4@(0,1,2,3,4)']
    jl = jm.sim.create_layout([JCircuit(s) for s in strs])
    jp = np.asarray(jm.sim.bulk_fill_probs(None, jl))
    sim = SimpleForwardSimulator(tm, 'cpu')
    layout = sim.create_layout([Circuit(s) for s in strs])
    assert 40 * tm.dim ** 2 * 8 > forwardsim.GATHER_BYTES_MAX
    for gather_max in (forwardsim.GATHER_BYTES_MAX, 0):
        monkeypatch.setattr(forwardsim, 'GATHER_BYTES_MAX', gather_max)
        tp = sim.bulk_fill_probs(None, layout)
        assert np.max(np.abs(tp - jp)) < 1e-12
        assert np.max(np.abs(tp.reshape(4, 32).sum(axis=1) - 1)) < 1e-12


def test_five_qubit_cell_against_numpy():
    """The JAX package's 5-qubit cell (bench.py bench[q5]: maxhops 1, idle
    weight 1, 594 parameters, v[:8] = 0.005 on the idle's 1,024 x 1,024
    generator): two circuits within 1e-12 of a numpy product of the
    Kronecker-embedded leaves, I (x) M (x) I on each factor's contiguous
    qubits.  The JAX package's own build of this model takes half a minute
    of dense changes of basis, so the CPU test holds it to numpy; the card
    runs it in chip_smoke.py phase 15."""
    tm = tcnm.create_cloud_crosstalk_model_from_hops_and_weights(
        TSpec(5, GATES, geometry='line'), maxhops=1, max_idle_weight=1, extra_gate_weight=0,
        gate_type='H+s')
    assert tm.num_params == 594
    v = np.zeros(594)
    v[:8] = 0.005
    tm.from_vector(v)
    strs = ['[]Gxpi2:3Gcnot:1:2@(0,1,2,3,4)', 'Gypi2:0Gcnot:3:4[]Gxpi2:2@(0,1,2,3,4)']
    tp = tm.bulk_probabilities([Circuit(s) for s in strs], device='cpu')
    leaves = tm._leaves()
    for s in strs:
        rho = tm.preps['rho0'].dense()
        for layer in Circuit(s).layertup:
            for key, targets in tm._layer_recipes[tm.op_keys.index(layer)]:
                q = list(targets)
                assert q == list(range(q[0], q[0] + len(q)))
                rho = np.kron(np.kron(np.eye(4 ** q[0]), leaves[key].dense()),
                              np.eye(4 ** (5 - q[-1] - 1))) @ rho
        ref = tm.povms['Mdefault'].dense() @ rho
        got = np.array(list(tp[Circuit(s)].values()))
        assert np.max(np.abs(got - ref)) < 1e-12
        assert abs(got.sum() - 1) < 1e-12 and np.max(np.abs(got - np.eye(32)[0])) > 1e-4


def test_grouped_scan_equals_the_gather():
    """The scan grouped by op and the gathered one give the same
    probabilities (3 qubits, 40 circuits): 1e-14."""
    from pygsti_tpu_torch.forwardsims import forwardsim
    _, tm = _models(3, 1, 1, 0, 'H+s', seed=3)
    circuits = [Circuit(s) for s in _circuits(3, 40, seed=8, depth=9)]
    sim = SimpleForwardSimulator(tm, 'cpu')
    layout = sim.create_layout(circuits)
    gathered = sim.bulk_fill_probs(None, layout)
    idx = forwardsim.layout_tensors(layout, 'cpu')
    t = tm.tensors_fn()(torch.as_tensor(tm.to_vector()))
    G = torch.cat([t.ops, torch.eye(tm.dim, dtype=t.ops.dtype)[None]])
    rho0 = t.preps[idx['prep_index']]
    plan = forwardsim.grouped_plan(layout, 'cpu')
    for a, b in zip(forwardsim.propagate(G, rho0, idx['op_indices'], plan),
                    forwardsim.propagate(G, rho0, idx['op_indices'])):
        assert float((a - b).abs().max()) < 1e-14
    assert gathered.shape == (40 * 8,)


@pytest.mark.parametrize("stencil,rate", [(('H', 'X:1'), 0.08), (('S', 'X:@0'), 0.05),
                                          (('H', 'ZX:@0,1'), 0.03)])
def test_stencils_on_spectator_qubits(stencil, rate):
    """create_cloud_crosstalk_model: a stencil naming another qubit acts on
    it (the 'H X:1' rotation excites qubit 1 by sin^2(rate / sqrt 2)); the
    probabilities equal the JAX package's within 1e-12."""
    coeffs = {'Gxpi2': {stencil: rate}}
    jm = jmc.create_cloud_crosstalk_model(JSpec(2, ['Gxpi2', 'Gypi2'], geometry='line'),
                                          lindblad_error_coeffs=coeffs)
    tm = tmc.create_cloud_crosstalk_model(TSpec(2, ['Gxpi2', 'Gypi2'], geometry='line'),
                                          lindblad_error_coeffs=coeffs)
    assert tm.num_params == jm.num_params
    for s in ('Gxpi2:0@(0,1)', 'Gxpi2:1Gypi2:0@(0,1)', 'Gypi2:1Gxpi2:0Gxpi2:0@(0,1)'):
        jp, tp = jm.probabilities(JCircuit(s)), tm.probabilities(Circuit(s), device='cpu')
        assert max(abs(jp[o] - tp[o]) for o in jp) < 1e-12
    if stencil == ('H', 'X:1'):
        p = tm.probabilities(Circuit('Gxpi2:0@(0,1)'), device='cpu')
        excited = sum(v for k, v in p.items() if k[0][1] == '1')
        assert abs(excited - np.sin(rate / np.sqrt(2)) ** 2) < 1e-12


@pytest.mark.parametrize("config", [CONFIGS[1], CONFIGS[2]], ids=['2q', '3q'])
def test_tv_against_jacfwd(config):
    """Tv by the leaves' compressed jvp and the product rule over each
    layer's factors against torch.func.jacfwd of the flat tensors: 1e-12."""
    _, tm = _models(*config, seed=2)
    SimpleForwardSimulator(tm, 'cpu').create_layout(
        [Circuit(s) for s in _circuits(config[0], 6, seed=1)])
    v = torch.as_tensor(tm.to_vector())
    Tv = tm.flat_tensors_jacobian_fn()(v)
    full = torch.func.jacfwd(tm.flat_tensors_fn())(v)
    assert Tv.shape == full.shape
    assert float((Tv - full).abs().max()) < 1e-12
    assert float(Tv.abs().max()) > 0.1


def test_convert_carries_a_jax_implicit_model():
    """implicit_model_from_vector: the JAX model's vector and registered
    layers make the port's model of the same construction; the tensors
    agree within 1e-13."""
    jm, tm = _models(3, 1, 1, 0, 'H+s', seed=4)
    strs = _circuits(3, 5, seed=9)
    jm.sim.create_layout([JCircuit(s) for s in strs])
    fresh = tcnm.create_cloud_crosstalk_model_from_hops_and_weights(
        TSpec(3, GATES, geometry='line'), maxhops=1, max_idle_weight=1, extra_gate_weight=0,
        gate_type='H+s')
    carried = implicit_model_from_vector(fresh, jm.to_vector(),
                                         [str(k) for k in jm.op_keys])
    assert [str(k) for k in carried.op_keys] == [str(k) for k in jm.op_keys]
    jt = jm.tensors_fn()(jm.to_vector())
    tt = carried.tensors_fn()(torch.as_tensor(carried.to_vector()))
    for a, b in zip((tt.ops, tt.preps, tt.effects), (jt.ops, jt.preps, jt.effects)):
        assert np.max(np.abs(a.numpy() - np.asarray(b))) < 1e-13


def test_not_implemented_options_raise_in_both_packages():
    """The options the JAX package refuses raise NotImplementedError with
    the same words in the port."""
    for kw in (dict(independent_clouds=False), dict(connected_highweight_errors=True),
               dict(extra_weight_1_hops=1), dict(errcomp_type='errorgens'),
               dict(implicit_idle_mode='add_global'), dict(evotype='statevec')):
        with pytest.raises(NotImplementedError) as je:
            jcnm.create_cloud_crosstalk_model_from_hops_and_weights(
                JSpec(2, GATES, geometry='line'), **kw)
        with pytest.raises(NotImplementedError) as te:
            tcnm.create_cloud_crosstalk_model_from_hops_and_weights(
                TSpec(2, GATES, geometry='line'), **kw)
        assert str(te.value) == str(je.value)
