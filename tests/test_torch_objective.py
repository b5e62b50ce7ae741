"""The port's probabilities, data and blocked-Jacobian objective against the
JAX package's on a small 2-qubit design (smq2Q_XYICNOT, maxL <= 2)."""

import numpy as np
import pytest

import pygsti_tpu.modelpacks.smq2Q_XYICNOT as jmp
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.objectivefns.objectivefns import ObjectiveFunctionBuilder as JBuilder

import pygsti_tpu_torch.modelpacks.smq2Q_XYICNOT as tmp
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.data.datasetconstruction import simulate_data as t_simulate
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.objectivefns.objectivefns import ObjectiveFunctionBuilder as TBuilder

MINCLIP = 1e-4
REGS = {'chi2': {'min_prob_clip_for_weighting': MINCLIP},
        'logl': {'min_prob_clip': MINCLIP, 'radius': MINCLIP}}


@pytest.fixture(scope='module')
def design():
    jt = jmp.target_model('full')
    tt = tmp.target_model('full')
    jlists = j_lists(jt, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), [1, 2])
    tlists = t_lists(tt, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), [1, 2])
    jgen = jmp.target_model('full TP').depolarize(op_noise=0.01, spam_noise=0.01)
    tgen = tmp.target_model('full TP').depolarize(op_noise=0.01, spam_noise=0.01)
    jds = j_simulate(jgen, list(jlists[-1]), 1000, seed=1234)
    sim_ds = t_simulate(tgen, list(tlists[-1]), 1000, seed=1234, device="cpu")
    # the objective tests see the JAX package's counts (see
    # test_simulated_counts_agree for why sampled counts may differ)
    tds = DataSet()
    for jc, tc in zip(jlists[-1], tlists[-1]):
        tds.add_count_dict(tc, dict(jds[jc].counts))
    # the fit point: target perturbed by numpy noise, the same in both
    theta = jt.to_vector() + 1e-3 * np.random.RandomState(3).randn(jt.num_params)
    return jt, tt, jgen, tgen, jlists, tlists, jds, tds, theta, sim_ds


def test_bulk_probs(design):
    """Outcome probabilities of the datagen model: within 1e-10 (float64
    products of depth <= 20, taken in another order)."""
    _, _, jgen, tgen, jlists, tlists = design[:6]
    jp = jgen.sim.bulk_probs(list(jlists[-1]))
    tp = SimpleForwardSimulator(tgen, device="cpu").bulk_probs(list(tlists[-1]))
    diffs = [abs(jp[jc][o] - tp[tc][o]) for jc, tc in zip(jlists[-1], tlists[-1])
             for o in jp[jc]]
    assert len(diffs) == 4 * len(jlists[-1])
    assert max(diffs) < 1e-10


def test_simulated_counts_agree(design):
    """The same seed draws the same multinomial counts for most circuits.
    Not for all: numpy's binomial draws from p or from 1 - p depending on
    which side of 0.5 p lies, so where two outcomes are (nearly) equally
    likely a last-bit difference in the probabilities changes that
    circuit's draw (about 2% of the circuits here).  So: at least 95% of the
    circuits agree exactly and every circuit has all its shots."""
    jlists, tlists, jds = design[4], design[5], design[6]
    sim_ds = design[-1]
    same = [dict(jds[jc].counts) == dict(sim_ds[tc].counts)
            for jc, tc in zip(jlists[-1], tlists[-1])]
    assert sum(same) >= 0.95 * len(same)
    assert all(sim_ds[tc].total == 1000 for tc in tlists[-1])
    assert jds.degrees_of_freedom() == sim_ds.degrees_of_freedom()


@pytest.mark.parametrize("objective", ["chi2", "logl"])
def test_blocked_objective(design, objective):
    """lsvec, J^T J and J^T f of the blocked path, relative to their largest
    entry: 1e-9, as the JAX package holds its objective against pyGSTi
    (float64 sums over ~7,000 elements in another order)."""
    jt, tt, _, _, jlists, tlists, jds, tds, theta = design[:9]
    jobj = JBuilder(objective, regularization=REGS[objective]).build(
        jt, jds, list(jlists[-1]))
    tobj = TBuilder(objective, regularization=REGS[objective]).build(
        tt, tds, list(tlists[-1]), device="cpu")
    assert np.isclose(tobj.fn(theta), jobj.fn(theta), rtol=1e-9, atol=0)
    jls, jjtj, jjtf = jobj.jtj_jtf(theta)
    tls, tjtj, tjtf = tobj.jtj_jtf(theta)
    for a, b in ((tls, jls), (tjtj, jjtj), (tjtf, jjtf)):
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) < 1e-9 * np.max(np.abs(b))
    assert np.max(np.abs(tobj.lsvec(theta) - jobj.lsvec(theta))) \
        < 1e-9 * np.max(np.abs(jls))


def test_dlsvec_and_nested_masking(design):
    """The blocked dlsvec of a nested (masked) stage against the JAX
    package's, and the masked rows are exactly zero."""
    jt, tt, _, _, jlists, tlists, jds, tds, theta = design[:9]
    from pygsti_tpu.objectivefns.objectivefns import \
        TimeIndependentMDCObjectiveFunction as JObj
    from pygsti_tpu_torch.objectivefns.objectivefns import \
        TimeIndependentMDCObjectiveFunction as TObj
    n0 = len(jlists[0])
    jobj = JObj(JBuilder('logl').build_raw(), jt, jds, list(jlists[-1]),
                num_active_circuits=n0)
    tobj = TObj(TBuilder('logl').build_raw(), tt, tds, list(tlists[-1]),
                num_active_circuits=n0, device="cpu")
    jJ, tJ = jobj.dlsvec(theta), tobj.dlsvec(theta)
    assert tJ.shape == jJ.shape
    assert np.max(np.abs(tJ - jJ)) < 1e-9 * np.max(np.abs(jJ))
    assert not np.any(tJ[4 * n0:])


def test_dataset_from_jax_counts(design):
    """A DataSet filled with the JAX package's counts gives the same
    objective value on the first list."""
    jt, tt, _, _, jlists, tlists, jds, _, theta = design[:9]
    ds = DataSet()
    for jc, tc in zip(jlists[-1], tlists[-1]):
        ds.add_count_dict(tc, {k: v for k, v in jds[jc].counts.items()})
    jv = JBuilder('logl').build(jt, jds, list(jlists[0])).fn(theta)
    tv = TBuilder('logl').build(tt, ds, list(tlists[0]), device="cpu").fn(theta)
    assert np.isclose(tv, jv, rtol=1e-9, atol=0)


def _logl_inputs(counts, rel_offsets):
    """p = f (1 + y) for each count and offset y, 1000 shots, float64."""
    c = np.repeat(np.asarray(counts, dtype=float), len(rel_offsets))
    t = np.full_like(c, 1000.0)
    f = c / t
    p = f * (1.0 + np.tile(rel_offsets, len(counts)))
    return p, c, t, f


@pytest.mark.parametrize('counts', [[1, 37], [489, 500], [963, 999]])
def test_logl_terms_exact_near_ties(counts):
    """The Poisson logL terms and lsvec near p = f against 50-digit
    arithmetic: within 1e-13 relative to the exact c*(y - log1p(y)) of the
    same float inputs.  The JAX package's form, c*log(f/p) - c + t*p,
    cancels there and is off by up to 1e-13 absolute, i.e. 1e-3 relative
    at y = 1e-6 and all digits below."""
    import mpmath
    import torch
    from pygsti_tpu_torch.objectivefns.objectivefns import _sw_logl_lsvec, _sw_logl_terms
    ys = np.concatenate([-np.logspace(-12, 0, 25)[:-1] * 0.9, np.logspace(-12, 1, 27)])
    p, c, t, f = _logl_inputs(counts, ys)
    args = [torch.as_tensor(a) for a in (p, c, t, f)]
    terms = _sw_logl_terms(*args, MINCLIP, MINCLIP).numpy()
    ls = _sw_logl_lsvec(*args, MINCLIP, MINCLIP).numpy()
    with mpmath.workdps(50):
        for i in range(len(p)):
            y = (mpmath.mpf(p[i]) - mpmath.mpf(f[i])) / mpmath.mpf(f[i])
            exact = mpmath.mpf(c[i]) * (y - mpmath.log1p(y))
            assert abs(terms[i] - exact) <= 1e-13 * exact, (p[i], c[i])
            assert abs(ls[i] - mpmath.sqrt(exact)) <= 1e-13 * mpmath.sqrt(exact), (p[i], c[i])


def test_logl_terms_match_jax_off_ties():
    """Away from p = f (|p - f| >= 1e-3 f), across the minp patch and for
    zero counts, the terms equal the JAX package's within that form's own
    rounding: 1e-15 of the summands it cancels (c*|log f|, c*|log p|, t*p),
    beside 1e-12 relative."""
    import torch
    from pygsti_tpu.objectivefns.objectivefns import _sw_logl_terms as j_terms
    from pygsti_tpu_torch.objectivefns.objectivefns import _sw_logl_terms
    rng = np.random.RandomState(5)
    ys = np.sign(rng.randn(400)) * np.logspace(-3, 0.5, 400)
    p, c, t, f = _logl_inputs([0, 1, 2, 37, 489, 999, 1000], ys)
    p = np.concatenate([p, rng.uniform(-1e-3, 2e-4, 50)])     # below minp
    c, t, f = (np.concatenate([a, np.full(50, v)]) for a, v in ((c, 3.0), (t, 1000.0),
                                                                  (f, 3e-3)))
    tt = _sw_logl_terms(*[torch.as_tensor(a) for a in (p, c, t, f)], MINCLIP, MINCLIP).numpy()
    jt = np.asarray(j_terms(p, c, t, f, MINCLIP, MINCLIP))
    pos = np.maximum(p, MINCLIP)
    summands = c * (np.abs(np.log(np.where(c > 0, f, 1.0))) + 1 + np.abs(np.log(pos))) + t * pos
    assert np.all(np.abs(tt - jt) <= 1e-12 * np.abs(jt) + 1e-15 * summands)
