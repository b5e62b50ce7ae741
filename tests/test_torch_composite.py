"""Composite (parallel) layers in the port against the JAX package: a layer
such as [Gxpi2:0Gypi2:1] is a slot of the op stack holding the product of its
components.  smq2Q_XXYYII and smq2Q_XXII, 'full', at a point off the target:
probabilities, Tv = d tensors / d theta, the blocked and forward-mode
objectives, penalty rows, gauge invariance, LGST, the small model methods,
and a small 2-qubit fit in both packages on the same counts."""

import importlib

import numpy as np
import pytest
import torch

from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.objectivefns import objectivefns as jof

from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.objectivefns import objectivefns as tof

PACKS = ['smq2Q_XXYYII', 'smq2Q_XXII']
REGS = {'min_prob_clip': 1e-4, 'radius': 1e-4}


def _packs(name):
    return (importlib.import_module('pygsti_tpu.modelpacks.' + name),
            importlib.import_module('pygsti_tpu_torch.modelpacks.' + name))


def _same_counts(jds, jcircuits, tcircuits):
    tds = DataSet()
    for jc, tc in zip(jcircuits, tcircuits):
        tds.add_count_dict(tc, dict(jds[jc].counts))
    return tds


def _parallel(circuit):
    """Whether the circuit has a layer of more than one gate."""
    return any(len(l.components) > 1 for l in circuit.layertup)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """torch on one thread in this module: beside other test processes a
    pool of spinning threads slowed the 2-qubit fit below 20-fold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module', params=PACKS)
def setup(request):
    """maxL <= 2 without the LGST circuits, a tenth of the fiducial pairs of
    each plaquette (the same draw in both packages), the JAX package's counts
    from a depolarized model, and a point off the target where no frequency
    lies within 1e-7 of its probability: at a tie the signed square root of
    the logL terms takes its slope's sign from the last bit of p
    (tests/test_torch_sparse.py keeps 1e-4 at 40 shots; at 1000 shots a
    frequency is a multiple of 1e-3, and a fifth of all probabilities lie
    within 1e-4 of one)."""
    jp, tp = _packs(request.param)
    jt, tt = jp.target_model('full'), tp.target_model('full')
    kw = dict(keep_fraction=0.1, keep_seed=2, include_lgst=False)
    jc = list(j_lists(jt, jp.prep_fiducials(), jp.meas_fiducials(), jp.germs(), [1, 2],
                      **kw)[-1])
    tc = list(t_lists(tt, tp.prep_fiducials(), tp.meas_fiducials(), tp.germs(), [1, 2],
                      **kw)[-1])
    jgen = jp.target_model('full TP').depolarize(op_noise=0.01, spam_noise=0.01)
    jds = j_simulate(jgen, jc, 1000, seed=1234)
    tds = _same_counts(jds, jc, tc)
    lay = SimpleForwardSimulator(tt, 'cpu').create_layout(tc, tds)
    jt.sim.create_layout(jc, jds)
    counts, totals = lay.counts_arrays(tds)
    for seed in range(1, 20):
        theta = jt.to_vector() + 1e-3 * np.random.RandomState(seed).randn(jt.num_params)
        m = tt.copy()
        m.from_vector(theta)
        if np.min(np.abs(SimpleForwardSimulator(m, 'cpu').bulk_fill_probs(None, lay)
                         - counts / totals)) > 1e-7:
            break
    else:
        raise AssertionError("no point off the ties")
    jm, tm = jt.copy(), tt.copy()
    jm.from_vector(theta)
    tm.from_vector(theta)
    return dict(name=request.param, jp=jp, tp=tp, jt=jt, tt=tt, jc=jc, tc=tc, jds=jds,
                tds=tds, theta=theta, jm=jm, tm=tm)


def test_op_stack_has_the_jax_packages_composite_layers(setup):
    """The layout registers the design's parallel layers, in the order the
    circuits first show them, between the operations and the instruments."""
    tt, jt = setup['tt'], setup['jt']
    assert [str(k) for k in tt.op_keys] == [str(k) for k in jt.op_keys]
    n_derived = {'smq2Q_XXYYII': 3, 'smq2Q_XXII': 1}[setup['name']]
    assert len(tt.op_keys) == len(tt.operations) + n_derived
    assert all(len(k.components) == 2 for k in tt.op_keys[len(tt.operations):])


def test_probabilities_of_parallel_layers(setup):
    """Every outcome probability at the point off the target within 1e-10."""
    jp_ = setup['jm'].sim.bulk_probs(setup['jc'])
    tp_ = setup['tm'].bulk_probabilities(setup['tc'], device='cpu')
    parallel = [tc for tc in setup['tc'] if _parallel(tc)]
    assert len(parallel) > 20
    assert max(abs(jp_[jc][o] - tp_[tc][o]) for jc, tc in zip(setup['jc'], setup['tc'])
               for o in jp_[jc]) < 1e-10


def test_tv_against_jacfwd(setup):
    """Tv, whose composite-layer rows come from the product rule, against
    plain forward mode over all parameters in torch and against the JAX
    package's jax.jacfwd of its flat tensors: within 1e-12."""
    import jax
    import jax.numpy as jnp
    tm, jm, theta = setup['tm'], setup['jm'], setup['theta']
    v = torch.as_tensor(theta)
    Tv = tm.flat_tensors_jacobian_fn()(v).numpy()
    full = torch.func.jacfwd(tm.flat_tensors_fn())(v).numpy()
    compute = jm.tensors_fn()

    def jflat(x):
        t = compute(x)
        return jnp.concatenate([t.ops.reshape(-1), t.preps.reshape(-1), t.effects.reshape(-1)])
    jTv = np.asarray(jax.jacfwd(jflat)(jnp.asarray(theta)))
    n_gate_rows = len(tm.operations) * tm.dim ** 2
    assert Tv.shape == full.shape == jTv.shape
    assert np.any(Tv[n_gate_rows:n_gate_rows + tm.dim ** 2] != 0)
    assert np.max(np.abs(Tv - full)) < 1e-12
    assert np.max(np.abs(Tv - jTv)) < 1e-12
    assert np.max(np.abs(tm.flat_tensors_fn()(v).numpy() - np.asarray(jflat(theta)))) < 1e-12


def _objectives(setup, jac_mode=None, penalties=None):
    raw = jof.ObjectiveFunctionBuilder('logl', regularization=REGS).build_raw()
    jobj = jof.TimeIndependentMDCObjectiveFunction(raw, setup['jt'], setup['jds'], setup['jc'],
                                                   penalties=penalties)
    tobj = tof.ObjectiveFunctionBuilder('logl', regularization=REGS, penalties=penalties,
                                        jac_mode=jac_mode).build(
        setup['tt'], setup['tds'], setup['tc'], device='cpu')
    return jobj, tobj


def test_blocked_objective(setup):
    """The blocked lsvec, J^T J and J^T f on the K1 = 9 (or 7) op stack
    against the JAX package's objective: 1e-9 relative."""
    jobj, tobj = _objectives(setup)
    assert tobj.jac_mode == 'blocked'
    theta = setup['theta']
    assert np.isclose(tobj.fn(theta), jobj.fn(theta), rtol=1e-9, atol=0)
    for a, b in zip(tobj.jtj_jtf(theta), jobj.jtj_jtf(theta)):
        assert a.shape == b.shape and _rel(a, b) < 1e-9


def test_linearize_matches_blocked(setup):
    """The forward-mode Jacobian reads the same Tv: its J^T J and J^T f
    equal the blocked ones within 1e-9 relative."""
    _, blocked = _objectives(setup)
    _, fwd = _objectives(setup, jac_mode='linearize')
    assert fwd.jac_mode == 'linearize'
    for a, b in zip(fwd.jtj_jtf(setup['theta']), blocked.jtj_jtf(setup['theta'])):
        assert _rel(a, b) < 1e-9


def test_penalty_rows_take_the_primary_operations_only(setup):
    """CPTP and SPAM penalty rows: one per operation (none for a composite
    layer), one per prep and effect, equal to the JAX package's within
    1e-9, with their J^T J."""
    pens = {'cptp_penalty_factor': 1.0, 'spam_penalty_factor': 1.0}
    jobj, tobj = _objectives(setup, penalties=pens)
    theta = setup['theta']
    tt = setup['tt']
    n_rows = len(tobj.lsvec(theta)) - tobj.num_elements
    assert n_rows == len(tt.operations) + 1 + 4
    assert _rel(tobj.lsvec(theta), jobj.lsvec(theta)) < 1e-9
    for a, b in zip(tobj.jtj_jtf(theta), jobj.jtj_jtf(theta)):
        assert _rel(a, b) < 1e-9


def test_gauge_invariance_and_copy(setup):
    """A gauge transformation near the identity moves the operations only;
    the composite layers are recomputed from them, so no probability of a
    circuit with parallel layers moves beyond 1e-9.  copy() keeps the
    composite layers."""
    from pygsti_tpu_torch.models.gaugegroup import FullGaugeGroup
    tm = setup['tm']
    group = FullGaugeGroup(tm.dim)
    el = group.compute_element(group.initial_params()
                               + 0.01 * np.random.RandomState(4).randn(group.num_params))
    moved = tm.copy()
    assert moved.op_keys == tm.op_keys
    moved.transform_inplace(el)
    assert moved.frobeniusdist(tm) > 1e-4
    circuits = [c for c in setup['tc'] if _parallel(c)]
    p0 = tm.bulk_probabilities(circuits, device='cpu')
    p1 = moved.bulk_probabilities(circuits, device='cpu')
    assert max(abs(p0[c][o] - p1[c][o]) for c in circuits for o in p0[c]) < 1e-9


def test_gaugeopt_and_lgst_touch_the_operations_only(setup):
    """gaugeopt_to_target and run_lgst on a model with composite layers:
    the gauge-optimized model keeps them and every probability; LGST
    estimates only the operations, its circuits hold no composite layer, and
    its estimate equals the JAX package's within 1e-8."""
    from pygsti_tpu.algorithms.core import run_lgst as j_lgst
    from pygsti_tpu.circuits.gstcircuits import create_lgst_circuits as j_lgst_circuits
    from pygsti_tpu_torch.algorithms.core import run_lgst as t_lgst
    from pygsti_tpu_torch.algorithms.gaugeopt import gaugeopt_to_target
    from pygsti_tpu_torch.circuits.gstcircuits import create_lgst_circuits
    jp, tp, tt, tm = setup['jp'], setup['tp'], setup['tt'], setup['tm']
    go = gaugeopt_to_target(tm, tt, maxiter=30, device='cpu')
    assert go.op_keys == tm.op_keys
    circuits = [c for c in setup['tc'] if _parallel(c)][:50]
    p0 = tm.bulk_probabilities(circuits, device='cpu')
    p1 = go.bulk_probabilities(circuits, device='cpu')
    assert max(abs(p0[c][o] - p1[c][o]) for c in circuits for o in p0[c]) < 1e-9
    tlc = create_lgst_circuits(tp.prep_fiducials(), tp.meas_fiducials(), tt)
    jlc = j_lgst_circuits(jp.prep_fiducials(), jp.meas_fiducials(), setup['jt'])
    assert [c.str for c in tlc] == [c.str for c in jlc]
    assert not any(_parallel(c) for c in tlc)
    jds = j_simulate(jp.target_model('full TP').depolarize(op_noise=0.01), jlc, 1000, seed=9)
    tds = _same_counts(jds, jlc, tlc)
    jl = j_lgst(jds, jp.prep_fiducials(), jp.meas_fiducials(), setup['jt'])
    tl = t_lgst(tds, tp.prep_fiducials(), tp.meas_fiducials(), tt)
    assert list(tl.operations) == list(tt.operations)
    assert tl.op_keys == tt.op_keys
    assert np.max(np.abs(tl.to_vector() - np.asarray(jl.to_vector()))) < 1e-8


def test_layout_of_another_op_stack_is_refused(setup):
    """A layout's op indices mean the op stack it was built for: a model
    that never saw its circuits gets their composite layers registered, and
    a layout built before the model's op stack grew is refused instead of
    read at the wrong slots (its identity padding now names a composite
    layer)."""
    from pygsti_tpu_torch.circuits.circuit import Circuit
    tp = setup['tp']
    fresh = tp.target_model('full')
    plain = SimpleForwardSimulator(fresh, 'cpu').create_layout([Circuit('Gxpi2:0@(0,1)')])
    other = tp.target_model('full')
    lay = SimpleForwardSimulator(other, 'cpu').create_layout(setup['tc'])
    p = SimpleForwardSimulator(fresh, 'cpu').bulk_fill_probs(None, lay)
    assert fresh.op_keys == other.op_keys and len(fresh.op_keys) > len(fresh.operations)
    assert np.array_equal(p, SimpleForwardSimulator(other, 'cpu').bulk_fill_probs(None, lay))
    with pytest.raises(ValueError, match="another op stack"):
        SimpleForwardSimulator(fresh, 'cpu').bulk_fill_probs(None, plain)


def test_model_methods_against_the_jax_package(setup):
    """bulk_probabilities, circuit_outcomes and strdiff on the 2-qubit
    models; rotate on a 1-qubit pack (the JAX package's 1-qubit-only method)
    with given and with drawn angles; rotate of a unitary member raises
    TypeError, as depolarize does."""
    import pygsti_tpu.modelpacks.smq1Q_XYI as j1
    import pygsti_tpu_torch.modelpacks.smq1Q_XYI as t1
    jm, tm, jt, tt = setup['jm'], setup['tm'], setup['jt'], setup['tt']
    c = setup['tc'][-1]
    assert tm.circuit_outcomes(c) == [tuple(o) for o in jm.circuit_outcomes(setup['jc'][-1])]
    jb = jm.bulk_probabilities(setup['jc'][:5])
    tb = tm.bulk_probabilities(setup['tc'][:5], device='cpu')
    assert max(abs(jb[a][o] - tb[b][o]) for a, b in zip(setup['jc'][:5], setup['tc'][:5])
               for o in jb[a]) < 1e-10
    jd, td = jm.strdiff(jt), tm.strdiff(tt)
    assert [l.split(':')[0] for l in td.splitlines()] == \
        [l.split(':')[0] for l in jd.splitlines()]
    assert np.allclose([float(l.rsplit(':', 1)[1]) for l in td.splitlines()],
                       [float(l.rsplit(':', 1)[1]) for l in jd.splitlines()], rtol=1e-9)
    for gt in ('full TP', 'static'):
        for kw in (dict(rotate=(0.01, 0.02, 0.03)), dict(max_rotate=0.05, seed=11)):
            jr, tr = j1.target_model(gt).rotate(**kw), t1.target_model(gt).rotate(**kw)
            assert [type(o).__name__ for o in tr.operations.values()] == \
                [type(o).__name__ for o in jr.operations.values()]
            assert np.allclose(tr.to_vector(), np.asarray(jr.to_vector()), rtol=0, atol=1e-12)
            for k in jr.operations:
                assert np.max(np.abs(tr.operations[k].dense()
                                     - np.asarray(jr.operations[k].to_dense()))) < 1e-12
    with pytest.raises(TypeError, match="rotate cannot rebuild"):
        t1.target_model('full unitary').rotate((0.01, 0.0, 0.0))
    with pytest.raises(ValueError, match="1-qubit"):
        tt.rotate((0.01, 0.0, 0.0))


def test_convert_carries_composite_layers(setup):
    """A JAX model whose layout registered composite layers converts, with
    its dense members and its _derived_layers, to a port model with the same
    op_keys and the same op stack."""
    from pygsti_tpu_torch.convert import model_from_dense, register_composite_layers
    jm = setup['jm']
    port = register_composite_layers(model_from_dense(
        {str(k): np.asarray(o.to_dense()) for k, o in jm.operations.items()},
        {str(k): np.asarray(p.to_dense()) for k, p in jm.preps.items()},
        {str(k): dict(zip(p.outcome_labels, np.asarray(p.to_dense())))
         for k, p in jm.povms.items()}), [str(k) for k in jm._derived_layers])
    assert [str(k) for k in port.op_keys] == [str(k) for k in jm.op_keys]
    ops = port.tensors_fn()(torch.as_tensor(port.to_vector())).ops.numpy()
    assert np.max(np.abs(ops - np.asarray(jm.tensors_fn()(jm.to_vector()).ops))) < 1e-12


def test_small_fit_matches_the_jax_package():
    """smq2Q_XXII 'full TP' from the target on the fiducial-pair-reduced
    design at maxL 1 (752 circuits, the parallel-layer germ included), chi2
    then Poisson logL, in both packages on the same counts: every stage's
    objective within 1e-3 relative, the final models' probabilities within
    1e-4, and the port's op stack holding the composite layer.  (XXII's
    one composite layer keeps the CPU's Gram smaller than XXYYII's three;
    chip_smoke.py phase 10 fits XXYYII at full size.)"""
    from pygsti_tpu.algorithms.core import run_iterative_gst as j_run
    from pygsti_tpu_torch.algorithms.core import run_iterative_gst as t_run
    jp, tp = _packs('smq2Q_XXII')
    jl = jp.create_gst_experiment_design(1, fpr=True).circuit_lists
    tl = tp.create_gst_experiment_design(1, fpr=True).circuit_lists
    assert [len(l) for l in tl] == [len(l) for l in jl] == [752]
    jt, tt = jp.target_model('full TP'), tp.target_model('full TP')
    jds = j_simulate(jp.target_model('full TP').depolarize(op_noise=0.01, spam_noise=0.01),
                     list(jl[-1]), 1000, seed=1234)
    tds = _same_counts(jds, jl[-1], tl[-1])
    jmodels, jres = j_run(jds, jt, jl, None, ['chi2'], ['logl'])
    tmodels, tres = t_run(tds, tt, tl, None, ['chi2'], ['logl'], device='cpu')
    jvals = [r.f for r in sum(jres, [])]
    tvals = [r.f for r in sum(tres, [])]
    assert len(tvals) == len(jvals) == 2
    assert np.allclose(tvals, jvals, rtol=1e-3)
    assert len(tmodels[-1].op_keys) == len(tmodels[-1].operations) + 1
    jp_ = jmodels[-1].sim.bulk_probs(list(jl[-1]))
    tp_ = tmodels[-1].bulk_probabilities(list(tl[-1]), device='cpu')
    assert max(abs(jp_[a][o] - tp_[b][o]) for a, b in zip(jl[-1], tl[-1]) for o in jp_[a]) < 1e-4
