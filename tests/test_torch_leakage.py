"""The port's leakage modules against the JAX package's: the cases of
tests/test_leakage.py, the computational-subspace machinery, a 3-level GST
fit in both packages on the same counts, and leakage-aware gauge
optimization (LAGO) of that fit."""

import numpy as np
import pytest
import scipy.linalg as spl
import torch

import pygsti_tpu.leakage as jl
import pygsti_tpu.modelpacks.smq1Q_XYI as jmp
from pygsti_tpu.baseobjs.basis import Basis as JBasis
from pygsti_tpu.circuits import Circuit as JCircuit
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.objectivefns import objectivefns as jof

import pygsti_tpu_torch.leakage as tl
import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp
from pygsti_tpu_torch.baseobjs.basis import Basis as TBasis
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.objectivefns import objectivefns as tof
from pygsti_tpu_torch.tools.optools import unitary_to_superop

X = np.array([[0, 1], [1, 0]], dtype=complex)


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("gate_type", ['static', 'full', 'full TP'])
@pytest.mark.parametrize("leakage_in_povm", ['1', 'separate'])
def test_3level_models_match(gate_type, leakage_in_povm):
    """create_3level_model: the same members, parameter counts and vector
    (243 parameters for 'full TP')."""
    j = jl.create_3level_model(jmp.target_model(gate_type), gate_type=gate_type,
                               leakage_in_povm=leakage_in_povm)
    t = tl.create_3level_model(tmp.target_model(gate_type), gate_type=gate_type,
                               leakage_in_povm=leakage_in_povm)
    assert t.num_params == j.num_params and t.dim == 9
    if gate_type == 'full TP' and leakage_in_povm == '1':
        assert t.num_params == 243
    assert np.array_equal(t.to_vector(), np.asarray(j.to_vector()))
    for td, jd in ((t.operations, j.operations), (t.preps, j.preps), (t.povms, j.povms)):
        assert [str(k) for k in td] == [str(k) for k in jd]
        for a, b in zip(td.values(), jd.values()):
            assert type(a).__name__ == type(b).__name__
            assert np.max(np.abs(a.dense() - np.asarray(b.to_dense()))) < 1e-15
    with pytest.raises(ValueError):
        tl.create_3level_model(tmp.target_model('static'), leakage_in_povm='nope')


def test_embedding_preserves_probabilities():
    """tests/test_leakage.py: the ideal 3-level model gives the 2-level
    probabilities, and the JAX package's 3-level ones."""
    t2 = tmp.target_model('static')
    t3 = tl.create_3level_model(t2, gate_type='static')
    j3 = jl.create_3level_model(jmp.target_model('static'), gate_type='static')
    for cstr in ['Gxpi2:0@(0)', 'Gxpi2:0Gxpi2:0@(0)', 'Gxpi2:0Gypi2:0@(0)']:
        c = Circuit(cstr)
        p2, p3 = t2.probabilities(c, device='cpu'), t3.probabilities(c, device='cpu')
        pj = j3.probabilities(JCircuit(cstr))
        for o in ('0', '1'):
            assert np.isclose(p2[(o,)], p3[(o,)], atol=1e-9) and abs(p3[(o,)] - pj[(o,)]) < 1e-14


def _leaky_x(theta):
    h = np.zeros((3, 3), dtype=complex)
    h[1, 2] = h[2, 1] = theta
    return spl.expm(-1j * h) @ tl.to_3level_unitary(X)


@pytest.mark.parametrize("theta", [0.0, 0.05, 0.2, 0.3])
def test_leakage_and_seepage_rates(theta):
    """tests/test_leakage.py: a gate coupling |1> and |2> leaks (0.001 <
    rate < 0.1 at 0.2) and seeps; the ideal gate neither; both rates equal
    the JAX package's."""
    g = np.real(unitary_to_superop(_leaky_x(theta), 'gm'))
    for fn in ('gate_leakage_rate', 'gate_seepage_rate'):
        assert abs(getattr(tl, fn)(g) - getattr(jl, fn)(g)) < 1e-15
    if theta == 0.2:
        assert 0.001 < tl.gate_leakage_rate(g) < 0.1
    if theta == 0.0:
        assert tl.gate_leakage_rate(g) < 1e-12
    h = np.zeros((3, 3), dtype=complex)
    h[1, 2] = h[2, 1] = 0.3
    assert tl.gate_seepage_rate(np.real(unitary_to_superop(spl.expm(-1j * h), 'gm'))) > 0.001


def test_fit_3level_static_model():
    """tests/test_leakage.py: 2*DeltaLogL of the static 3-level model on
    its own simulated counts within the chi2 bound, and equal to the JAX
    package's on the same counts."""
    jm3 = jl.create_3level_model(jmp.target_model('static'), gate_type='static')
    tm3 = tl.create_3level_model(tmp.target_model('static'), gate_type='static')
    strs = ['Gxpi2:0@(0)', 'Gxpi2:0Gxpi2:0@(0)', 'Gypi2:0Gxpi2:0@(0)']
    jc, tc = [JCircuit(s) for s in strs], [Circuit(s) for s in strs]
    jds = j_simulate(jm3, jc, 1000, seed=2)
    tds = DataSet()
    for a, b in zip(jc, tc):
        tds.add_count_dict(b, dict(jds[a].counts))
    j_val = jof.two_delta_logl(jm3, jds, jc)
    t_val = tof.two_delta_logl(tm3, tds, tc, device='cpu')
    k = jds.degrees_of_freedom(jc)
    assert abs(t_val - j_val) < 1e-9 and t_val < k + 5 * np.sqrt(2 * max(k, 1))


def test_subspace_metrics():
    """tests/test_leakage.py: the restriction of an embedded unitary is its
    2-level superoperator; fidelities, distances and the restriction equal
    the JAX package's for the ideal and a leaky op."""
    theta = np.pi / 2
    u2 = np.array([[np.cos(theta / 2), -1j * np.sin(theta / 2)],
                   [-1j * np.sin(theta / 2), np.cos(theta / 2)]])
    u3 = tl.to_3level_unitary(u2)
    S = unitary_to_superop(u3, 'gm')
    assert abs(tl.subspace_entanglement_fidelity(S, S, 'gm') - 1.0) < 1e-9
    assert tl.subspace_jtracedist(S, S, 'gm') < 1e-9
    assert np.allclose(tl.subspace_restriction(S, 'gm'), unitary_to_superop(u2, 'pp'), atol=1e-9)
    eps = 0.1
    leak = np.eye(3, dtype=complex)
    leak[1, 1] = leak[2, 2] = np.cos(eps)
    leak[1, 2], leak[2, 1] = -np.sin(eps), np.sin(eps)
    S_leaky = unitary_to_superop(leak @ u3, 'gm')
    assert tl.subspace_entanglement_fidelity(S_leaky, S, 'gm') < 1.0 - 1e-4
    assert tl.subspace_superop_fro_dist(S_leaky, S, 'gm') > 1e-2
    for fn in ('subspace_entanglement_fidelity', 'subspace_jtracedist',
               'subspace_superop_fro_dist', 'subspace_diamonddist'):
        assert abs(getattr(tl, fn)(S_leaky, S, 'gm') - getattr(jl, fn)(S_leaky, S, 'gm')) < 1e-7, fn
    assert np.max(np.abs(tl.subspace_restriction(S_leaky, 'gm')
                         - jl.subspace_restriction(S_leaky, 'gm'))) < 1e-15


def test_direct_sum_gauge_group():
    """tests/test_leakage.py: U(2) + U(1) has 5 parameters; its element
    keeps the computational block (the restriction is orthogonal); the
    element matrix equals the JAX package's (expm there, _matrix_exp
    here) within 1e-14, and its autograd gradient is finite at 0."""
    t3 = tl.create_3level_model(tmp.target_model('full TP'))
    j3 = jl.create_3level_model(jmp.target_model('full TP'))
    g = tl.DirectSumUnitaryGaugeGroup(t3.dim, 'gm')
    gj = jl.DirectSumUnitaryGaugeGroup(j3.state_space, 'gm')
    assert g.num_params == gj.num_params == 5
    import jax.numpy as jnp
    for seed in range(3):
        v = np.random.RandomState(seed).randn(5) * 0.1
        S = g.element_matrix(torch.as_tensor(v)).numpy()
        assert S.shape == (9, 9)
        assert np.max(np.abs(S - np.asarray(gj.element_matrix_jax(jnp.asarray(v))))) < 1e-14
        R = tl.subspace_restriction(S, 'gm')
        assert np.allclose(R @ R.T, np.eye(4), atol=1e-8)
    x = torch.zeros(5, dtype=torch.float64, requires_grad=True)
    (g.element_matrix(x) ** 2).sum().backward()
    assert torch.all(torch.isfinite(x.grad))


def test_computational_subspace_machinery():
    """computational_effect / superkets / projector of the leakage basis
    l2p1, and augment_for_leakage_modeling of 'gm' with the projector onto
    levels 0 and 1: the JAX package's labels and elements."""
    jb, tb = JBasis.cast('l2p1', 9), TBasis.cast('l2p1', 9)
    assert np.max(np.abs(tl.computational_effect(tb) - jl.computational_effect(jb))) < 1e-15
    assert np.max(np.abs(tl.computational_superkets(tb) - jl.computational_superkets(jb))) < 1e-14
    assert np.max(np.abs(tl.computational_projector(tb) - jl.computational_projector(jb))) < 1e-14
    assert np.array_equal(tl.computational_superkets(TBasis.cast('gm', 9)), np.eye(9))
    E = np.diag([1.0, 1.0, 0.0])
    ja = jl.augment_for_leakage_modeling(JBasis.cast('gm', 9), E)
    ta = tl.augment_for_leakage_modeling(TBasis.cast('gm', 9), E)
    assert ta.labels == ja.labels and ta.name == ja.name
    assert np.max(np.abs(ta.elements - ja.elements)) < 1e-15
    assert ta.implies_leakage_modeling()
    with pytest.raises(ValueError):
        tl.augment_for_leakage_modeling(TBasis.cast('gm', 9), np.diag([1.0, 0.5, 0.0]))


@pytest.fixture(scope='module')
def leakage_fits():
    """A 3-level 'full TP' fit of smq1Q_XYI's design at maxL [1, 2] in both
    packages on the same counts: the truth depolarized 0.01 with Gxpi2:0
    followed by a 0.05 rad rotation of |1> toward |2>, 1,000 shots, level 2
    counted as '1'; then LAGO of each fit."""
    from pygsti_tpu.protocols.gst import (GateSetTomography as JGST,
                                          GateSetTomographyDesign as JDesign,
                                          GSTInitialModel as JInit)
    from pygsti_tpu.protocols.protocol import ProtocolData as JData
    from pygsti_tpu_torch.protocols.gst import (GateSetTomography as TGST,
                                                GateSetTomographyDesign as TDesign,
                                                GSTInitialModel as TInit)
    from pygsti_tpu_torch.protocols.protocol import ProtocolData as TData
    jt = jl.create_3level_model(jmp.target_model('full TP'), gate_type='full TP')
    tt = tl.create_3level_model(tmp.target_model('full TP'), gate_type='full TP')
    truth = jt.depolarize(op_noise=0.01)
    gx = truth.operations[('Gxpi2', 0)]
    rot = np.eye(3, dtype=complex)
    rot[1, 1] = rot[2, 2] = np.cos(0.05)
    rot[1, 2], rot[2, 1] = -np.sin(0.05), np.sin(0.05)
    leak = np.real(unitary_to_superop(rot, 'gm'))
    truth.operations[('Gxpi2', 0)] = type(gx)(leak @ np.asarray(gx.to_dense()))
    jlists = j_lists(jt, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), [1, 2])
    tlists = t_lists(tt, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), [1, 2])
    jds = j_simulate(truth, list(jlists[-1]), 1000, seed=1234)
    tds = DataSet()
    for a, b in zip(jlists[-1], tlists[-1]):
        tds.add_count_dict(b, dict(jds[a].counts))
    jr = JGST(JInit(model=jt.copy()), gaugeopt_suite=None, verbosity=0).run(
        JData(JDesign(jt, jlists), jds), disable_checkpointing=True)
    tr = TGST(TInit(model=tt.copy()), gaugeopt_suite=None, verbosity=0, device='cpu').run(
        TData(TDesign(tt, tlists), tds), disable_checkpointing=True)
    jl.add_lago_models(jr)
    tl.add_lago_models(tr, device='cpu')
    return (jr.estimates['GateSetTomography'], tr.estimates['GateSetTomography'],
            list(jlists[-1]), list(tlists[-1]), jds, truth)


def test_3level_fit_reaches_the_jax_optimum(leakage_fits):
    """2*DeltaLogL within 1e-3 (scored by the JAX package's objective),
    probabilities within 1e-4, N_sigma alike."""
    jest, test, jc, tc, jds, _ = leakage_fits
    jm, tm = jest.models['final iteration estimate'], test.models['final iteration estimate']
    port_in_jax = jm.copy()
    port_in_jax.from_vector(tm.to_vector())
    assert abs(jof.two_delta_logl(port_in_jax, jds, jc) - jof.two_delta_logl(jm, jds, jc)) < 1e-3
    jp = jm.sim.bulk_probs(jc)
    tp = SimpleForwardSimulator(tm, 'cpu').bulk_probs(tc)
    assert max(abs(jp[a][o] - tp[b][o]) for a, b in zip(jc, tc) for o in jp[a]) < 1e-4
    assert abs(test.misfit_sigma() - jest.misfit_sigma()) < 1e-3


def test_lago(leakage_fits):
    """The LAGO model leaves every probability as the fit had it (1e-9);
    its objective (the weighted squared distance to the target) and
    probabilities equal the JAX package's LAGO (1e-6 and 1e-4), and so does
    its leakage rate of Gxpi2:0."""
    jest, test, jc, tc, jds, truth = leakage_fits
    fit, lago = test.models['final iteration estimate'], test.models['LAGO']
    pf = SimpleForwardSimulator(fit, 'cpu').bulk_probs(tc)
    pl = SimpleForwardSimulator(lago, 'cpu').bulk_probs(tc)
    assert max(abs(pf[c][o] - pl[c][o]) for c in tc for o in pf[c]) < 1e-9
    jp = jest.models['LAGO'].sim.bulk_probs(jc)
    assert max(abs(jp[a][o] - pl[b][o]) for a, b in zip(jc, tc) for o in jp[a]) < 1e-4

    def objective(m):
        members = [o.dense() if hasattr(o, 'dense') else np.asarray(o.to_dense())
                   for d in (m.operations, m.preps, m.povms) for o in d.values()]
        target = test.models['target']
        ref = [o.dense() for d in (target.operations, target.preps, target.povms)
               for o in d.values()]
        diffs = [a - b for a, b in zip(members, ref)]
        return sum(np.sum(d ** 2) for d in diffs) / sum(d.size for d in diffs)
    assert objective(lago) <= objective(fit) + 1e-12
    assert abs(objective(lago) - objective(jest.models['LAGO'])) < 1e-6
    rate = tl.gate_leakage_rate(lago.operations[('Gxpi2', 0)].dense())
    assert abs(rate - jl.gate_leakage_rate(
        np.asarray(jest.models['LAGO'].operations[('Gxpi2', 0)].to_dense()))) < 1e-4


def test_leakage_rate_needs_the_tp_frame():
    """The LAGO group U(2) + U(1) fixes only the unitary part of the frame:
    the leaky truth moved by a non-unitary TP gauge transformation keeps
    every probability, and after LAGO alone its leakage rate is not the
    truth's (ROADMAP.md section 3).  Put through one frame -- TP gauge
    optimization to the target, then the LAGO suite -- the moved model and
    the truth give one rate."""
    from pygsti_tpu_torch.algorithms.gaugeopt import gaugeopt_to_target
    from pygsti_tpu_torch.models.gaugegroup import TPGaugeGroup
    target = tl.create_3level_model(tmp.target_model('full TP'), gate_type='full TP')
    truth = target.depolarize(op_noise=0.01)
    rot = np.eye(3, dtype=complex)
    rot[1, 1] = rot[2, 2] = np.cos(0.05)
    rot[1, 2], rot[2, 1] = -np.sin(0.05), np.sin(0.05)
    gx = ('Gxpi2', 0)
    truth.operations[gx] = type(truth.operations[gx])(
        np.real(unitary_to_superop(rot, 'gm')) @ truth.operations[gx].dense())
    group = TPGaugeGroup(9)
    moved = truth.copy()
    moved.transform_inplace(group.compute_element(
        group.initial_params() + 0.05 * np.random.RandomState(5).randn(group.num_params)))
    circuits = [Circuit(s) for s in ('Gxpi2:0@(0)', 'Gxpi2:0Gxpi2:0Gypi2:0@(0)',
                                     'Gypi2:0Gxpi2:0Gxpi2:0Gxpi2:0@(0)')]
    pt = SimpleForwardSimulator(truth, 'cpu').bulk_probs(circuits)
    pm = SimpleForwardSimulator(moved, 'cpu').bulk_probs(circuits)
    assert max(abs(pt[c][o] - pm[c][o]) for c in circuits for o in pt[c]) < 1e-12
    suite = tl.std_lago_gopsuite(target)['LAGO'][0]

    def lago(m):
        return gaugeopt_to_target(m, target, item_weights=suite['item_weights'],
                                  gauge_group=suite['gauge_group'], device='cpu')

    def rate(m):
        return tl.gate_leakage_rate(m.operations[gx].dense())
    true_rate = rate(truth)
    assert abs(rate(lago(moved)) - true_rate) > 0.3 * true_rate, (rate(lago(moved)), true_rate)
    framed = [rate(lago(gaugeopt_to_target(m, target, gauge_group=group, device='cpu')))
              for m in (truth, moved)]
    assert abs(framed[0] - framed[1]) < 1e-3 * framed[0], framed
