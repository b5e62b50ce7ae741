"""The port's time-resolved GST against the JAX package's, on the CPU at
float64: time labels (equality, hash, pickle), LinearTimeDriftOp's dense
form at several times (1e-13), tensors_fn_t and Tv(t) (against the JAX
package and central differences, 1e-7), the time-resolved objective's fn,
lsvec, J^T J and J^T f against objectivefns/timedep.py on smq1Q_XYI with a
'static' and a 'full TP' base (1e-10 relative, the Jacobian through
block_probs_jac and the kernel's plain version), the JAX package's
test_fit_drift_rate fitted in both packages, and the host-side
time-dependent classes of objectivefns.py (the JAX package's take every
element at t = 0: ROADMAP.md section 3)."""

import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import pygsti_tpu.modelpacks.smq1Q_XYI as jmp
from pygsti_tpu.baseobjs import label as jlabel
from pygsti_tpu.circuits import Circuit as JCircuit
from pygsti_tpu.data import DataSet as JDataSet
from pygsti_tpu.modelmembers import operations as jops
from pygsti_tpu.objectivefns import objectivefns as jobjfns
from pygsti_tpu.objectivefns import timedep as jtimedep
from pygsti_tpu.optimize.simplerlm import SimplerLMOptimizer as JLM

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp
from pygsti_tpu_torch.baseobjs import label as tlabel
from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
from pygsti_tpu_torch.circuits.circuit import Circuit as TCircuit
from pygsti_tpu_torch.data.dataset import DataSet as TDataSet
from pygsti_tpu_torch.modelmembers import operations as tops
from pygsti_tpu_torch.objectivefns import objectivefns as tobjfns
from pygsti_tpu_torch.objectivefns import timedep as ttimedep
from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate_plain
from pygsti_tpu_torch.optimize.simplerlm import SimplerLMOptimizer as TLM

TIMES = [0.0, 2.0, 4.0, 8.0]
CIRCUITS = ['Gxpi2:0@(0)', 'Gxpi2:0Gxpi2:0@(0)', 'Gypi2:0Gxpi2:0@(0)',
            'Gxpi2:0Gxpi2:0Gxpi2:0Gypi2:0@(0)', '{}@(0)', 'Gypi2:0Gypi2:0Gxpi2:0@(0)']


def drifting_models(rate, base_kind):
    """The JAX test's model in both packages: Gxpi2:0 a LinearTimeDriftOp
    over the pack's Gxpi2 ('static': StaticArbitraryOp, 'full TP': FullTPOp)
    with an 'H' drift generator of H_X rate `rate`."""
    out = []
    for mp, ops, lbl in ((jmp, jops, jlabel.Label), (tmp, tops, tlabel.Label)):
        m = mp.target_model(base_kind)
        key = lbl('Gxpi2', 0)
        op = m.operations[key]
        mx = np.asarray(op.to_dense() if mp is jmp else op.dense())
        base = ops.StaticArbitraryOp(mx) if base_kind == 'static' else ops.FullTPOp(mx)
        eg = ops.build_lindblad_errorgen('pp', 'H', dim=4, initial_coeffs={('H', 'X'): rate})
        m.operations[key] = ops.LinearTimeDriftOp(base, eg)
        m._mark_for_rebuild()
        out.append(m)
    return out


def timed_datasets(seed, circuits=CIRCUITS, times=TIMES, shots=1000):
    """The same random time series in both packages' DataSets: two
    outcomes per time, counts from a numpy RandomState."""
    rng = np.random.RandomState(seed)
    jd, td = JDataSet(), TDataSet()
    for s in circuits:
        ols, ts, reps = [], [], []
        for t in times:
            n0 = rng.binomial(shots, 0.2 + 0.6 * rng.rand())
            ols += ['0', '1']
            ts += [t, t]
            reps += [n0, shots - n0]
        jd.add_raw_series_data(JCircuit(s), ols, ts, reps)
        td.add_raw_series_data(TCircuit(s), ols, ts, reps)
    return jd, td


# -- time labels ---------------------------------------------------------------

@pytest.mark.parametrize('name,sslbls,time', [('Gxpi2', (0,), 0.0), ('Gcnot', (0, 1), 2.5),
                                              ('Gi', ('Q0',), 1e-3)])
def test_time_labels_match_jax(name, sslbls, time):
    """The same tuples as the JAX package's: equal, same hash, same string,
    and a pickle of either reads back equal to both."""
    jl = jlabel.LabelTupWithTime.init(name, sslbls, time)
    tl = tlabel.LabelTupWithTime.init(name, sslbls, time)
    assert tuple(jl) == tuple(tl) and jl == tl and hash(jl) == hash(tl)
    assert str(jl) == str(tl) and tl.time == time and tl.sslbls == sslbls
    assert tl.name == name and tl.args == ()
    back = pickle.loads(pickle.dumps(tl))
    assert type(back) is tlabel.LabelTupWithTime and back == jl and hash(back) == hash(jl)
    comps = (tlabel.Label(name, sslbls), tlabel.Label('Gypi2', (7,)))
    jcomps = (jlabel.Label(name, sslbls), jlabel.Label('Gypi2', (7,)))
    jtt = jlabel.LabelTupTupWithTime.init(jcomps, time)
    ttt = tlabel.LabelTupTupWithTime.init(comps, time)
    assert tuple(jtt) == tuple(ttt) and hash(jtt) == hash(ttt) and str(jtt) == str(ttt)
    assert ttt.components == comps and ttt.time == time and ttt.sslbls == jtt.sslbls
    assert pickle.loads(pickle.dumps(ttt)) == jtt
    # the factory takes time= and ignores it, as the JAX package's does
    assert tlabel.Label(name, sslbls, time=time) == jlabel.Label(name, sslbls, time=time)
    assert type(tlabel.Label(name, sslbls, time=time)) is tlabel.LabelTup


# -- LinearTimeDriftOp and the time-resolved tensors --------------------------

@pytest.mark.parametrize('base_kind', ['static', 'full TP'])
@pytest.mark.parametrize('t', [0.0, 0.5, 3.0, 10.0])
def test_linear_time_drift_op_dense(base_kind, t):
    """G(t) = exp(t L) G_base against the JAX package's to_dense_jax_t at a
    random parameter vector: 1e-13; to_dense is G(0); serialization reads
    back the same member."""
    jm, tm = drifting_models(0.03, base_kind)
    jop, top = jm.operations[jlabel.Label('Gxpi2', 0)], tm.operations[tlabel.Label('Gxpi2', 0)]
    v = top.to_vector() + 0.02 * np.random.RandomState(5).randn(top.num_params)
    a = np.asarray(jop.to_dense_jax_t(jnp.asarray(v), t))
    b = top.to_dense_t(torch.as_tensor(v), t).numpy()
    assert np.max(np.abs(a - b)) < 1e-13
    assert np.max(np.abs(top.to_dense(torch.as_tensor(v)).numpy()
                         - np.asarray(jop.to_dense_jax(jnp.asarray(v))))) < 1e-13
    back = NicelySerializable.from_nice_serialization(top.to_nice_serialization())
    assert type(back) is tops.LinearTimeDriftOp
    assert np.array_equal(back.to_vector(), top.to_vector())
    assert np.max(np.abs(back.to_dense_t(torch.as_tensor(v), t).numpy() - b)) < 1e-15


@pytest.mark.parametrize('base_kind', ['static', 'full TP'])
def test_tensors_fn_t_and_tv(base_kind):
    """tensors_fn_t against the JAX package's at three times (1e-13), the
    idle unchanged in time, and Tv(t) against central differences of the
    flat tensors at t = 3 (1e-7)."""
    jm, tm = drifting_models(0.05, base_kind)
    v = tm.to_vector() + 0.01 * np.random.RandomState(2).randn(tm.num_params)
    jc, tc = jm.tensors_fn_t(), tm.tensors_fn_t()
    for t in (0.0, 1.5, 6.0):
        a, b = jc(jnp.asarray(v), t), tc(torch.as_tensor(v), t)
        for x, y in zip((a.ops, a.preps, a.effects), (b.ops, b.preps, b.effects)):
            assert np.max(np.abs(np.asarray(x) - y.numpy())) < 1e-13
    ops0 = tc(torch.as_tensor(v), 0.0).ops.numpy()
    ops5 = tc(torch.as_tensor(v), 5.0).ops.numpy()
    gx, idle = tm.op_keys.index(tlabel.Label('Gxpi2', 0)), tm.op_keys.index(tlabel.Label(()))
    assert not np.allclose(ops0[gx], ops5[gx]) and np.array_equal(ops0[idle], ops5[idle])
    flat, jac = tm.flat_tensors_fn_t(), tm.flat_tensors_jacobian_fn_t()
    Tv = jac(torch.as_tensor(v), 3.0).numpy()
    h = 1e-5
    fd = np.stack([(flat(torch.as_tensor(v + h * e), 3.0) - flat(torch.as_tensor(v - h * e), 3.0))
                   .numpy() / (2 * h) for e in np.eye(len(v))], axis=1)
    assert Tv.shape == fd.shape and np.max(np.abs(Tv - fd)) < 1e-7
    # the static Tv is Tv(t) of the members' static forms
    assert np.array_equal(tm.flat_tensors_jacobian_fn()(torch.as_tensor(v)).numpy(),
                          jac(torch.as_tensor(v), None).numpy())


# -- the time-resolved objective -------------------------------------------------

def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-300)


@pytest.mark.parametrize('base_kind', ['static', 'full TP'])
@pytest.mark.parametrize('objective', ['logl', 'chi2'])
def test_timedep_objective_matches_jax(base_kind, objective, monkeypatch):
    """fn, lsvec, J^T J and J^T f against the JAX package's timedep.py at
    a point off the truth (6 circuits, 4 times, one circuit without data at
    one time): 1e-10 relative.  The Jacobian is the blocked one: the
    kernel's plain version runs once per (time, bucket) and no forward-mode
    Jacobian of the probabilities is taken."""
    jd, td = timed_datasets(3)
    # one circuit with no data at t = 8: that time's rows are a subset
    c_gap = CIRCUITS[2]
    row = jd[JCircuit(c_gap)]
    keep = [i for i, t in enumerate(row.time) if t != 8.0]
    for ds, C in ((jd, JCircuit), (td, TCircuit)):
        r = ds[C(c_gap)]
        ols = [r.outcome_series[i] for i in keep]
        ds.add_raw_series_data(C(c_gap), ols, [r.time[i] for i in keep],
                               [int(r.reps[i]) for i in keep])
    jm, tm = drifting_models(0.04, base_kind)
    v = tm.to_vector() + 0.01 * np.random.RandomState(7).randn(tm.num_params)
    jf = {'logl': jtimedep.TimeDependentPoissonPicLogLFunction,
          'chi2': jtimedep.TimeDependentChi2Function}[objective]
    tf = {'logl': ttimedep.TimeDependentPoissonPicLogLFunction,
          'chi2': ttimedep.TimeDependentChi2Function}[objective]
    jo = jf(jm, jd, [JCircuit(s) for s in CIRCUITS])
    to = tf(tm, td, [TCircuit(s) for s in CIRCUITS], device='cpu')
    assert to.times == jo.times and to.num_elements == jo.num_elements
    assert np.array_equal(to.counts, np.asarray(jo._counts))
    assert np.array_equal(to.total_counts, np.asarray(jo._totals))
    assert abs(to.fn(v) - jo.fn(v)) <= 1e-10 * abs(jo.fn(v))
    assert _rel(jo.lsvec(v), to.lsvec(v)) < 1e-10
    calls = []

    def counted(*args):
        calls.append(1)
        return bwd_jacobian_accumulate_plain(*args)

    monkeypatch.setattr(tobjfns, 'bwd_jacobian_accumulate', counted)
    monkeypatch.setattr(torch.func, 'jacfwd', None)
    ls_j, jtj_j, jtf_j = jo.jtj_jtf(v)
    ls_t, jtj_t, jtf_t = to.jtj_jtf(v)
    assert _rel(ls_j, ls_t) < 1e-10 and _rel(jtj_j, jtj_t) < 1e-10 and _rel(jtf_j, jtf_t) < 1e-10
    assert len(calls) == len(to.times) * 1 == to.num_buckets


def test_fit_drift_rate_in_both_packages():
    """The JAX package's test_fit_drift_rate: 3 circuits, 4 times, 5,000
    shots of a truth with H_X drift rate 0.05, fitted from rate 0 by each
    package's SimplerLMOptimizer (the port's device loop on the CPU): the
    final objectives within 1e-3 relative, the fitted rates within 1e-4,
    and the rate recovered within 0.01."""
    jtruth, _ = drifting_models(0.05, 'static')
    rng = np.random.RandomState(0)
    circs = [[('Gxpi2', 0)] * k for k in (1, 2, 4)]
    jd, td = JDataSet(), TDataSet()
    compute_t = jtruth.tensors_fn_t()
    keys = jtruth.op_keys
    for layers in circs:
        ols, ts, reps = [], [], []
        for t in [0.0, 2.0, 4.0, 8.0]:
            ten = compute_t(jnp.asarray(jtruth.to_vector()), t)
            rho = np.asarray(ten.preps)[0]
            for l in layers:
                rho = np.asarray(ten.ops)[keys.index(jlabel.Label(*l))] @ rho
            p = float(np.asarray(ten.effects)[0] @ rho)
            n0 = rng.binomial(5000, min(max(p, 0), 1))
            ols += ['0', '1']
            ts += [t, t]
            reps += [n0, 5000 - n0]
        jd.add_raw_series_data(JCircuit(layers, (0,)), ols, ts, reps)
        td.add_raw_series_data(TCircuit(layers, (0,)), ols, ts, reps)
    jfit, tfit = drifting_models(0.0, 'static')
    jo = jtimedep.TimeDependentPoissonPicLogLFunction(jfit, jd, [JCircuit(l, (0,)) for l in circs])
    to = ttimedep.TimeDependentPoissonPicLogLFunction(tfit, td, [TCircuit(l, (0,)) for l in circs],
                                                      device='cpu')
    jr = JLM(maxiter=50).run(jo, printer=0)
    tr = TLM(maxiter=50).run(to, printer=0)
    jrate = np.asarray(jfit.operations[jlabel.Label('Gxpi2', 0)].drift_errorgen.to_vector())
    trate = tfit.operations[tlabel.Label('Gxpi2', 0)].drift_errorgen.to_vector()
    assert abs(to.fn(tr.x) - jo.fn(jr.x)) <= 1e-3 * abs(jo.fn(jr.x))
    assert np.max(np.abs(jrate - trate)) < 1e-4
    assert abs(trate[0] - 0.05) < 0.01


# -- the host-side classes of objectivefns.py ---------------------------------

def test_host_timedep_classes_take_each_element_at_its_time():
    """The JAX package's objectivefns.TimeDependentPoissonPicLogLFunction
    sets a member's time through ``set_time``, which no member defines:
    its probabilities are the t = 0 ones at every time (the fault this
    test confirms).  The port's class takes each element at its own time:
    its terms equal those of the time-resolved objective's probabilities,
    on the observed elements in the JAX package's order; without drift
    both packages' classes agree (terms 1e-12), and the port's exact
    dterms matches central differences."""
    jd, td = timed_datasets(11, CIRCUITS[:3])
    circs_j, circs_t = [JCircuit(s) for s in CIRCUITS[:3]], [TCircuit(s) for s in CIRCUITS[:3]]
    jm, tm = drifting_models(0.08, 'full TP')
    v = tm.to_vector()
    jo = jobjfns.TimeDependentPoissonPicLogLFunction(jm, jd, circs_j)
    to = tobjfns.TimeDependentPoissonPicLogLFunction(tm, td, circs_t, device='cpu')
    assert to.num_elements == jo.num_elements
    assert np.array_equal(to.counts, jo.counts) and np.array_equal(to.total_counts,
                                                                   jo.total_counts)
    # the fault: the JAX package's probabilities do not move with time
    pj = jo.probs_vector(v)
    pj0 = np.array([jm.probabilities(c)[ol] for c, t, ol, _, _ in jo._elements])
    assert np.max(np.abs(pj - pj0)) == 0.0
    # the port: each element at its time, as the time-resolved objective
    pt = to.probs_vector(v)
    ref = ttimedep.TimeDependentPoissonPicLogLFunction(tm, td, circs_t, device='cpu')
    p_ref = ref.probs(v)
    lookup = {}
    for ti, t in enumerate(ref.times):
        for ci in ref._rows_at[ti]:
            sl = ref.layout.element_slices[ci]
            for k, o in enumerate(ref.layout.outcomes[ci]):
                lookup[(int(ci), t, o)] = p_ref[ref._loc[ti][sl.start + k]]
    want = np.array([lookup[(ci, t, o)] for ci, t, o, _, _ in to._elements])
    assert np.max(np.abs(pt - want)) < 1e-14
    assert np.max(np.abs(pt - pj)) > 1e-3
    # without drift both classes agree; the JAX package's slope along the
    # drift rates is 0 (t = 0), so those columns are left out
    jm0, tm0 = drifting_models(0.0, 'full TP')
    drift = np.arange(tm0.num_params)[tm0.operations[tlabel.Label('Gxpi2', 0)].gpindices][-3:]
    static = np.setdiff1d(np.arange(tm0.num_params), drift)
    v0 = tm0.to_vector() + 0.01 * np.random.RandomState(1).randn(tm0.num_params)
    v0[drift] = 0.0
    jo0 = jobjfns.TimeDependentChi2Function(jm0, jd, circs_j)
    to0 = tobjfns.TimeDependentChi2Function(tm0, td, circs_t, device='cpu')
    tj, tt = jo0.terms(v0), to0.terms(v0)
    assert np.max(np.abs(tj - tt)) < 1e-12 * np.abs(tj).max()
    # dterms is exact (the JAX package's: forward differences of step 1e-7,
    # 47 host evaluations here): held to central differences of the port's
    # terms along the static parameters
    dt, h = to0.dterms(v0), 1e-6
    fd = np.stack([(to0.terms(v0 + h * e) - to0.terms(v0 - h * e)) / (2 * h)
                   for e in np.eye(len(v0))[static]], axis=1)
    assert np.max(np.abs(fd - dt[:, static])) < 1e-6 * np.max(np.abs(dt))
    assert to0.fn(v0) == pytest.approx(jo0.fn(v0), rel=1e-12)
    assert np.allclose(to0.lsvec(v0), jo0.lsvec(v0), rtol=1e-12, atol=0)
