"""The port's raw objectives, the objective classes bound to them,
TermWeighted, CachedObjectiveFunction and the frequency-weighted chi2 fit
against the JAX package's."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.objectivefns import objectivefns as jof

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.objectivefns import objectivefns as tof

# (name, regularization) for every raw objective of the JAX package
RAWS = [('chi2', None), ('chi2', {'min_prob_clip_for_weighting': 1e-3}),
        ('fwchi2', None), ('freq-weighted-chi2', {'min_freq_clip_for_weighting': 1e-3}),
        ('logl', None), ('dlogl', {'min_prob_clip': 1e-3, 'radius': 1e-3}),
        ('dlogl-nonpoisson', None), ('dlogl-nonpoisson', {'min_prob_clip': 1e-3}),
        ('tvd', None), ('chialpha', None),
        ('chialpha', {'pfratio_stitchpt': 0.1, 'pfratio_derivpt': 0.05, 'radius': 1e-3}),
        ('chialpha', {'fmin': 1e-3}), ('cwchi2', None), ('maxlogl', None)]
METHODS = ('terms', 'dterms', 'lsvec', 'dlsvec', 'fn')


def arrays():
    """Probabilities from 0 to 1 (some below the clips), counts with zeros,
    totals, frequencies; no observed frequency within 1e-4 of its
    probability (ROADMAP.md section 3: the logL's ties)."""
    rng = np.random.RandomState(8)
    n = 400
    t = rng.choice([10.0, 100.0, 1000.0], n)
    p = np.concatenate([rng.uniform(0, 1e-3, 60), rng.uniform(0, 1, n - 60)])
    c = np.floor(rng.uniform(0, 1, n) * t)
    c[rng.rand(n) < 0.15] = 0
    f = c / t
    near = (c > 0) & (np.abs(p - f) < 1e-4)
    p[near] += 2e-4
    return p, c, t, f


def both(make_j, make_t, method, arrs):
    jr, tr = make_j(), make_t()
    ja = getattr(jr, method)(*[jnp.asarray(a) for a in arrs])
    ta = getattr(tr, method)(*[torch.as_tensor(a) for a in arrs])
    return np.asarray(ja, dtype=float), ta.numpy()


def close(a, b, tol=1e-12):
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(b)
    scale = max(np.max(np.abs(b[ok])), 1e-300) if ok.any() else 1.0
    assert np.max(np.abs(a[ok] - b[ok]), initial=0.0) <= tol * scale


def test_raw_class_names():
    assert sorted(tof._RAW_CLASSES) == sorted(jof._RAW_CLASSES)
    for name in jof._RAW_CLASSES:
        assert tof._RAW_CLASSES[name].__name__ == jof._RAW_CLASSES[name].__name__


@pytest.mark.parametrize("method", METHODS + ('zero_freq_terms', 'zero_freq_dterms'))
@pytest.mark.parametrize("name,reg", RAWS, ids=lambda x: str(x))
def test_raw_objectives(name, reg, method):
    """Each raw objective's method on the same arrays within 1e-12 of the
    largest entry; NaNs in the same places (maxlogl's lsvec is the square
    root of negative terms in both packages); a method one package lacks
    raises NotImplementedError in both."""
    p, c, t, f = arrays()
    args = (t, p) if method.startswith('zero_freq') else (p, c, t, f)

    def make_j():
        return jof._RAW_CLASSES[name](reg)

    def make_t():
        return tof._RAW_CLASSES[name](reg)
    try:
        expected = both(make_j, make_t, method, args)
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            getattr(make_j(), method)(*[jnp.asarray(a) for a in args])
        with pytest.raises(NotImplementedError):
            getattr(make_t(), method)(*[torch.as_tensor(a) for a in args])
        return
    close(expected[1], expected[0])
    assert make_t().name == make_j().name
    assert make_t().chi2k_distributed_qty(3.5) == make_j().chi2k_distributed_qty(3.5)


@pytest.mark.parametrize("kind", ['abspower1', 'abspower3.5', 'chialpha0.5', 'cwchi2_weights'])
def test_raw_objectives_with_arguments(kind):
    """RawAbsPower, chi-alpha at alpha 0.5 and the custom-weighted chi2
    with weights: every method within 1e-12."""
    p, c, t, f = arrays()
    w = np.random.RandomState(1).uniform(0.5, 2, len(p))
    makers = {'abspower1': lambda m: m.RawAbsPower(1),
              'abspower3.5': lambda m: m.RawAbsPower(3.5),
              'chialpha0.5': lambda m: m.RawChiAlphaFunction(alpha=0.5),
              'cwchi2_weights': lambda m: m.RawCustomWeightedChi2Function(custom_weights=w)}
    for method in METHODS:
        a, b = both(lambda: makers[kind](jof), lambda: makers[kind](tof), method, (p, c, t, f))
        close(b, a)
    assert tof.LpNormToPowerP is tof.RawAbsPower and tof.RawAbsPower(2).name == 'Lp^p'
    assert tof.RawAbsPower(2).chi2k_distributed_qty(1.0) == -1
    with pytest.raises(ValueError):
        tof.RawAbsPower(0.5)


@pytest.fixture(scope='module')
def one_qubit():
    """A 1-qubit model at a perturbed point (the closest observed frequency
    lies 8.9e-5 from its probability: no tie, ROADMAP.md section 3), maxL
    <= 2 circuits and the same counts in both packages."""
    jt, tt = jmp.target_model('full TP'), tmp.target_model('full TP')
    jl = j_lists(jt, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), [1, 2])
    tl = t_lists(tt, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), [1, 2])
    jds = j_simulate(jmp.target_model('full TP').depolarize(op_noise=0.05, spam_noise=0.02),
                     list(jl[-1]), 1000, seed=12)
    tds = DataSet()
    for jc, tc in zip(jl[-1], tl[-1]):
        tds.add_count_dict(tc, dict(jds[jc].counts))
    theta = jt.to_vector() + 0.03 * np.random.RandomState(2).randn(jt.num_params)
    jt.from_vector(theta)
    tt.from_vector(theta)
    return jt, tt, theta, list(jl[-1]), list(tl[-1]), jds, tds


BOUND = ['Chi2Function', 'FreqWeightedChi2Function', 'ChiAlphaFunction',
         'CustomWeightedChi2Function', 'PoissonPicDeltaLogLFunction', 'DeltaLogLFunction',
         'MaxLogLFunction', 'TVDFunction']


@pytest.mark.parametrize("cls", BOUND)
def test_bound_objectives(one_qubit, cls):
    """fn, and lsvec / J^T J / J^T f where they are finite, within 1e-9
    relative; the name and create_from."""
    jt, tt, theta, jc, tc, jds, tds = one_qubit
    jo = getattr(jof, cls).create_from(jt, jds, jc)
    to = getattr(tof, cls).create_from(tt, tds, tc, device='cpu')
    assert to.name == jo.name
    assert abs(to.fn(theta) - jo.fn(theta)) <= 1e-9 * abs(jo.fn(theta))
    for a, b in zip(to.jtj_jtf(theta), jo.jtj_jtf(theta)):
        close(a, np.asarray(b), 1e-9)
    assert to.chi2k_distributed_qty(2.0) == jo.chi2k_distributed_qty(2.0)


def test_term_weighted_and_logl_max(one_qubit):
    """TermWeighted with weights: terms, fn, lsvec and the unweighted
    jtj_jtf within 1e-9; logl_max equal."""
    jt, tt, theta, jc, tc, jds, tds = one_qubit
    jo = jof.TermWeighted(jof.RawChi2Function(), jt, jds, jc)
    to = tof.TermWeighted(tof.RawChi2Function(), tt, tds, tc, device='cpu')
    w = np.random.RandomState(4).uniform(0.2, 3, to.layout.num_elements)
    jo.terms_weights, to.terms_weights = w, w
    for m in ('terms', 'lsvec'):
        close(getattr(to, m)(theta), getattr(jo, m)(theta), 1e-9)
    assert abs(to.fn(theta) - jo.fn(theta)) <= 1e-9 * jo.fn(theta)
    for a, b in zip(to.jtj_jtf(theta), jo.jtj_jtf(theta)):
        close(a, np.asarray(b), 1e-9)
    for pp in (True, False):
        assert abs(tof.logl_max(tt, tds, tc, pp) - jof.logl_max(jt, jds, jc, pp)) < 1e-9


def test_cached_objective_round_trip(one_qubit, tmp_path):
    """The port's record written and read back, the JAX package's record
    read by the port, and the two records of one objective alike."""
    jt, tt, theta, jc, tc, jds, tds = one_qubit
    to = tof.ObjectiveFunctionBuilder('logl').build(tt, tds, tc, device='cpu')
    jo = jof.ObjectiveFunctionBuilder('logl').build(jt, jds, jc)
    tcache, jcache = tof.CachedObjectiveFunction(to), jof.CachedObjectiveFunction(jo)
    tcache.write(tmp_path / 'port')
    jcache.write(tmp_path / 'jax')
    for back in (tof.CachedObjectiveFunction.from_dir(tmp_path / 'port'),
                 tof.CachedObjectiveFunction.from_dir(tmp_path / 'jax')):
        assert [c.str for c in back.circuits] == [c.str for c in tc]
        assert back.name == 'logl' and back.num_elements == tcache.num_elements
        assert abs(back.fn - tcache.fn) <= 1e-9 * tcache.fn
        assert abs(back.lsvec_norm2 - tcache.lsvec_norm2) <= 1e-9 * tcache.lsvec_norm2
        assert np.max(np.abs(back.percircuit - tcache.percircuit)) <= 1e-9 * tcache.fn
        assert np.array_equal(back.model_paramvec, theta)
    with open(tmp_path / 'port' / 'cached_objfn.json') as f:
        assert set(json.load(f)) == {'name', 'fn', 'chi2k_distributed_fn', 'num_elements',
                                     'lsvec_norm2', 'circuits', 'model_paramvec', 'percircuit'}


def test_builders():
    """create_from and cast: 'chi2' with freq_weighted_chi2 is 'fwchi2';
    GSTObjFnBuilders.create_from(freq_weighted_chi2=True) in both
    packages."""
    from pygsti_tpu.protocols.gst import GSTObjFnBuilders as JB
    from pygsti_tpu_torch.protocols.gst import GSTObjFnBuilders as TB
    assert tof.ObjectiveFunctionBuilder.create_from('chi2', True).name == 'fwchi2'
    assert tof.ObjectiveFunctionBuilder.cast({'objective': 'tvd'}).name == 'tvd'
    assert tof.ObjectiveFunctionBuilder.cast(None).name == 'logl'
    b = tof.ObjectiveFunctionBuilder('chialpha', 'desc', {'fmin': 1e-3})
    assert (b.description, b.build_raw().fmin) == ('desc', 1e-3)
    for kw in ({}, {'freq_weighted_chi2': True}, {'objective': 'chi2'},
               {'always_perform_mle': True}):
        j, t = JB.create_from(**kw), TB.create_from(**kw)
        assert [b.name for b in t.iteration_builders] == [b.name for b in j.iteration_builders]
        assert [b.name for b in t.final_builders] == [b.name for b in j.final_builders]
    with pytest.raises(ValueError):
        tof.ObjectiveFunctionBuilder('nosuch')


@pytest.fixture(scope='module')
def fwchi2_fits():
    """A 1-qubit fit with freq_weighted_chi2=True in both packages on the
    same counts."""
    from pygsti_tpu.algorithms.core import run_iterative_gst as j_run
    from pygsti_tpu.protocols.gst import GSTObjFnBuilders as JB
    from pygsti_tpu_torch.algorithms.core import run_iterative_gst as t_run
    from pygsti_tpu_torch.protocols.gst import GSTObjFnBuilders as TB
    jt, tt = jmp.target_model('full TP'), tmp.target_model('full TP')
    jl = j_lists(jt, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), [1, 2, 4])
    tl = t_lists(tt, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), [1, 2, 4])
    jds = j_simulate(jmp.target_model('full TP').depolarize(op_noise=0.05, spam_noise=0.02),
                     list(jl[-1]), 1000, seed=1234)
    tds = DataSet()
    for jc, tc in zip(jl[-1], tl[-1]):
        tds.add_count_dict(tc, dict(jds[jc].counts))
    jb, tb = JB.create_from(freq_weighted_chi2=True), TB.create_from(freq_weighted_chi2=True)
    jmodels, jres = j_run(jds, jt, jl, None, jb.iteration_builders, jb.final_builders)
    tmodels, tres = t_run(tds, tt, tl, None, tb.iteration_builders, tb.final_builders,
                          device='cpu')
    return jt, jl, tl, jds, jmodels, jres, tmodels, tres


def test_fwchi2_fit_reaches_the_jax_optimum(fwchi2_fits):
    """Stage values within 1e-3 relative, the final 2*DeltaLogL (scored by
    the JAX package) within 1e-3, per-circuit probabilities within 1e-4."""
    jt, jl, tl, jds, jmodels, jres, tmodels, tres = fwchi2_fits
    assert [[r.objective.name for r in rs] for rs in tres] == \
        [['fwchi2']] * (len(tl) - 1) + [['fwchi2', 'logl']]
    for jr, tr in zip(sum(jres, []), sum(tres, [])):
        assert np.isclose(tr.f, jr.f, rtol=1e-3)
    port_in_jax = jt.copy()
    port_in_jax.from_vector(tmodels[-1].to_vector())
    circuits = list(jl[-1])
    assert abs(jof.two_delta_logl(port_in_jax, jds, circuits)
               - jof.two_delta_logl(jmodels[-1], jds, circuits)) < 1e-3
    jp = jmodels[-1].sim.bulk_probs(circuits)
    tp = SimpleForwardSimulator(tmodels[-1], 'cpu').bulk_probs(list(tl[-1]))
    assert max(abs(jp[a][o] - tp[b][o]) for a, b in zip(circuits, tl[-1]) for o in jp[a]) < 1e-4
