"""The port's design selection (germselection, fiducialselection,
fiducialpairreduction, the eLGST lists) against the JAX package's, at one
qubit (smq1Q_XYI) and, without the searches, at two (smq2Q_XYICNOT 'full',
1,616 parameters), float64 on the CPU.

What is held and how closely:

- the numbers: twirled derivatives and the non-gauge projector within 1e-10
  (1e-9 at two qubits), relative to the largest entry; scores of complete
  sets within 1e-8 relative; the low-rank update helpers within 1e-10;
  ``depolarize(max_op_noise=, max_spam_noise=, seed=)`` within 1e-15;
- the searches: fed the JAX package's own Grams, factors, fiducial rows
  and pair sensitivities, every search of the port (germs greedy, GRASP
  and slack in 'allJac' and 'compactEVD', the four standalone germ
  searches, fiducials greedy, GRASP and slack, the four fiducial-pair
  searches) chooses what the JAX package chooses, circuit for circuit and
  pair for pair;
- end to end, on its own numbers: the fiducial searches choose the JAX
  package's fiducials (the CPU path computes their rows with numpy's
  products in the JAX package's order, bit for bit); each germ set and
  pair set is complete and scores (or ranks) as the JAX package's does.
  A set that does not yet amplify every direction scores by reciprocals
  of eigenvalues at rounding level, so among such sets rounding decides
  the winner in either package (ROADMAP.md section 3); the twirled
  derivatives come from jax.jacfwd in one package and the product rule
  in the other, and there the germ and pair lists can differ, and do.
"""

import importlib

import numpy as np
import pytest
import torch

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp
import pygsti_tpu.modelpacks.smq2Q_XYICNOT as jmp2
from pygsti_tpu.algorithms import fiducialselection as jfs, fiducialpairreduction as jfpr
from pygsti_tpu.circuits.circuit import Circuit as JCircuit
from pygsti_tpu.circuits.gstcircuits import create_elgst_lists as j_elgst

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp
import pygsti_tpu_torch.modelpacks.smq2Q_XYICNOT as tmp2
from pygsti_tpu_torch.algorithms import (germselection as tgs, fiducialselection as tfs,
                                         fiducialpairreduction as tfpr)
from pygsti_tpu_torch.circuits.gstcircuits import create_elgst_lists as t_elgst

# the JAX package's algorithms/__init__ binds 'germselection' names to functions
jgs = importlib.import_module('pygsti_tpu.algorithms.germselection')

TWIRL_TOL = 1e-10
SCORE_TOL = 1e-8


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """torch on one thread in this module, beside the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def strs(circuits):
    return [c.str for c in circuits]


def pair_keys(d):
    return {(k.str if hasattr(k, 'str') else (k[0].str, k[1])): list(map(tuple, v))
            for k, v in d.items()}


def jax_twin(jpack, model, mtype):
    """The JAX package's model at the port model's parameter vector (one
    vector means one model in both packages)."""
    jm = jpack.target_model(mtype)
    jm.from_vector(model.to_vector())
    return jm


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-300))


@pytest.fixture
def jax_numbers(monkeypatch):
    """Make the port's searches run on the JAX package's numbers: the germ
    Grams and compact factors, the fiducial rows and the pair
    sensitivities, each computed by the JAX package at the port model's
    parameters.  `mtype` is set by the test before a search."""
    state = {'mtype': 'full TP', 'pack': jmp}

    def twin(model):
        return jax_twin(state['pack'], model, state['mtype'])

    def twirls(scorer, germs):
        jm = twin(scorer.model)
        pj = jgs._nongauge_projector(jm)
        return jm, [jgs.twirled_deriv(jm, JCircuit(g.str), scorer.eps) @ pj for g in germs]

    def grams(scorer, germs):
        _, Ts = twirls(scorer, germs)
        return torch.as_tensor(np.stack([np.real(T.conj().T @ T) for T in Ts]))

    def factors(scorer, germs):
        out = []
        for T in twirls(scorer, germs)[1]:
            _, s, Vh = np.linalg.svd(np.real(T), full_matrices=False)
            keep = s > 1e-10 * max(s[0], 1e-30)
            out.append(torch.as_tensor(s[keep, None] * Vh[keep]))
        return out

    def ensure(self, fiducials):
        jm = twin(self.model)
        fn = jfs._prep_vectors if self.kind == 'prep' else jfs._meas_vectors
        for f in fiducials:
            if f not in self._rows:
                self._rows[f] = torch.as_tensor(np.asarray(fn(jm, [JCircuit(f.str)])))

    def sensitivities(model, germs, prep_fids, meas_fids, proj, eps=1e-6, device="cuda"):
        jm = twin(model)
        pj = jgs._nongauge_projector(jm)
        jp = [JCircuit(f.str) for f in prep_fids]
        jq = [JCircuit(f.str) for f in meas_fids]
        out = []
        for g in germs:
            rows, pidx, n_amp, dirs = jfpr._germ_pair_sensitivities(jm, JCircuit(g.str),
                                                                    jp, jq, pj)
            out.append((torch.as_tensor(rows), pidx, n_amp, torch.as_tensor(dirs)))
        return out

    monkeypatch.setattr(tgs, '_germ_grams', grams)
    monkeypatch.setattr(tgs, '_germ_compact_factors', factors)
    monkeypatch.setattr(tfs._FiducialRows, 'ensure', ensure)
    monkeypatch.setattr(tfpr, '_sensitivities', sensitivities)
    return state


# -- depolarize (the repaired port fault) -------------------------------------

@pytest.mark.parametrize('mtype', ['full', 'full TP'])
@pytest.mark.parametrize('seed', [3, 1234])
def test_depolarize_max_noise_matches_jax(mtype, seed):
    a = jmp2.target_model(mtype).depolarize(max_op_noise=1e-2, max_spam_noise=1e-2, seed=seed)
    b = tmp2.target_model(mtype).depolarize(max_op_noise=1e-2, max_spam_noise=1e-2, seed=seed)
    for lbl, op in b.operations.items():
        assert np.max(np.abs(np.asarray(a.operations[lbl].to_dense()) - op.dense())) <= 1e-15
    for lbl, p in b.preps.items():
        assert np.max(np.abs(np.asarray(a.preps[lbl].to_dense()) - p.dense())) <= 1e-15
    for lbl, p in b.povms.items():
        assert np.array_equal(np.asarray(a.povms[lbl].to_dense()), p.dense())
    assert not np.allclose(b.to_vector(), tmp2.target_model(mtype).to_vector())


# -- the numbers --------------------------------------------------------------

@pytest.mark.parametrize('mtype', ['full', 'full TP'])
def test_twirled_deriv_and_projector_match_jax(mtype):
    tm = tmp.target_model(mtype).rotate(max_rotate=1e-2, seed=1)
    jm = jmp.target_model(mtype).rotate(max_rotate=1e-2, seed=1)
    pj = jgs._nongauge_projector(jm)
    pt = tgs._nongauge_projector(tm, device='cpu')
    assert np.max(np.abs(pj - pt)) <= TWIRL_TOL
    for jg, tg in zip(jmp.germs(), tmp.germs()):
        a = jgs.twirled_deriv(jm, jg)
        b = tgs.twirled_deriv(tm, tg, device='cpu')
        assert rel(a, b) <= TWIRL_TOL, tg.str
        M, J = jgs._germ_product_and_jacobian(jm, jg)
        M2, J2 = tgs._germ_product_and_jacobian(tm, tg, device='cpu')
        assert rel(M, M2) <= 1e-14 and rel(J, J2) <= 1e-14
    sj = jgs.compute_composite_germ_set_score(jm, jmp.germs(), non_gauge_projector=pj)
    st = tgs.compute_composite_germ_set_score(tm, tmp.germs(), non_gauge_projector=pt,
                                              device='cpu')
    same_amplified(sj, st)


def same_amplified(sj, st):
    """Equal amplified counts and, for the amplified directions, equal
    eigenvalues within SCORE_TOL of the largest (the score also sums the
    reciprocals of the eigenvalues at rounding level, which no two
    computations share)."""
    n = sj[1]
    assert n == st[1] and np.max(np.abs(sj[2][:n] - st[2][:n])) <= SCORE_TOL * sj[2][0]
    score_j, score_t = np.sum(1.0 / sj[2][:n]), np.sum(1.0 / st[2][:n])
    assert abs(score_j - score_t) <= SCORE_TOL * score_j


def test_twirled_deriv_and_projector_match_jax_2q():
    """Two of the 2-qubit pack's germs and the projector at full width."""
    tm = tmp2.target_model('full').depolarize(max_op_noise=1e-2, seed=3)
    jm = jmp2.target_model('full').depolarize(max_op_noise=1e-2, seed=3)
    assert tm.num_params == 1616
    pj = jgs._nongauge_projector(jm)
    pt = tgs._nongauge_projector(tm, device='cpu')
    assert np.max(np.abs(pj - pt)) <= 1e-9
    for k in (6, 12):
        a = jgs.twirled_deriv(jm, jmp2.germs()[k])
        b = tgs.twirled_deriv(tm, tmp2.germs()[k], device='cpu')
        assert rel(a, b) <= 1e-9, tmp2.germs()[k].str


def test_low_rank_helpers_match_jax():
    rng = np.random.RandomState(0)
    B = rng.randn(16, 6)
    M = B @ B.T
    A, A_in = rng.randn(16, 2), B @ rng.randn(6, 2)
    cj, ct = jgs.construct_update_cache(M), tgs.construct_update_cache(M)
    for x, y in zip(cj, ct):
        assert np.max(np.abs(x - y)) <= 1e-10
    for upd in (A, A_in):
        a, b = jgs.symmetric_low_rank_spectrum_update(upd, *cj), \
            tgs.symmetric_low_rank_spectrum_update(upd, *ct)
        assert a[1] == b[1] and (a[0] is None or np.max(np.abs(a[0] - b[0])) <= 1e-10)
        for force in (False, True):
            a, b = jgs.minamide_style_inverse_trace(upd, *cj, force_rank_increase=force), \
                tgs.minamide_style_inverse_trace(upd, *ct, force_rank_increase=force)
            assert a[1:] == b[1:] and (a[0] is None or abs(a[0] - b[0]) <= 1e-10 * abs(a[0]))
    tr, rank, inc = tgs.minamide_style_inverse_trace(A, *ct)
    assert inc and rank == 8 and np.isclose(tr, np.trace(np.linalg.pinv(M + A @ A.T)))
    B = rng.randn(12, 5)
    M = B @ B.T
    v = rng.randn(12, 1)
    cj, ct = jgs.construct_update_cache_rank_one(M), tgs.construct_update_cache_rank_one(M)
    assert cj[3] == ct[3] and all(np.max(np.abs(np.asarray(x) - y)) <= 1e-10
                                  for x, y in zip(cj[:3], ct[:3]))
    a, b = jgs.rank_one_inverse_trace_update(v, *cj[:3]), \
        tgs.rank_one_inverse_trace_update(v, *ct[:3])
    assert a[1] == b[1] and abs(a[0] - b[0]) <= 1e-10 * abs(a[0])
    a, b = jgs.rank_one_psuedoinverse_update(v, cj[0], cj[1]), \
        tgs.rank_one_psuedoinverse_update(v, ct[0], ct[1])
    assert a[1] == b[1] and np.max(np.abs(a[0] - b[0])) <= 1e-10
    c2 = tgs.construct_update_cache_rank_one(M + v @ v.T, prev_update_cache=ct,
                                             rank_one_update=v)
    assert np.allclose(c2[0], tgs.construct_update_cache_rank_one(M + v @ v.T)[0], atol=1e-8)
    X = rng.randn(6, 4)
    assert np.max(np.abs(jgs.stable_pinv(X) - tgs.stable_pinv(X))) <= 1e-10
    a, b = rng.randn(3, 2), rng.randn(4, 5)
    assert np.array_equal(jgs.fast_kron(a, b), tgs.fast_kron(a, b))
    B = rng.randn(10, 4)
    for x, y in zip(jgs.compact_EVD(B @ B.T, assume_hermitian=True),
                    tgs.compact_EVD(B @ B.T, assume_hermitian=True)):
        assert np.max(np.abs(x - y)) <= 1e-10
    for x, y in zip(jgs.compact_EVD_via_SVD(B.T), tgs.compact_EVD_via_SVD(B.T)):
        assert np.max(np.abs(np.abs(x) - np.abs(y))) <= 1e-10


def test_composite_score_variants_match_jax():
    rng = np.random.RandomState(3)
    B = rng.randn(12, 4)
    cache_j, cache_t = jgs.construct_update_cache(B @ B.T), tgs.construct_update_cache(B @ B.T)
    upd = rng.randn(12, 2)
    kw = dict(num_nongauge_params=8, num_params=12, l1_penalty=0.1, num_germs=3)
    a = jgs.compute_composite_germ_set_score_compactevd(cache_j, upd, **kw)
    b = tgs.compute_composite_germ_set_score_compactevd(cache_t, upd, **kw)
    assert (a.major, a.N) == (b.major, b.N) and abs(a.minor - b.minor) <= 1e-10 * abs(a.minor)
    kw.pop('num_params')
    a = jgs.compute_composite_germ_set_score_low_rank_trace(cache_j, upd, **kw)
    b = tgs.compute_composite_germ_set_score_low_rank_trace(cache_t, upd, **kw)
    assert (a.major, a.N) == (b.major, b.N) and abs(a.minor - b.minor) <= 1e-10 * abs(a.minor)
    r1j = jgs.construct_update_cache_rank_one(B @ B.T)
    r1t = tgs.construct_update_cache_rank_one(B @ B.T)
    v = rng.randn(12, 1)
    a = jgs.compute_composite_vector_set_score(r1j, v, num_nongauge_params=8)
    b = tgs.compute_composite_vector_set_score(r1t, v, num_nongauge_params=8)
    assert (a.major, a.N) == (b.major, b.N) and abs(a.minor - b.minor) <= 1e-10 * abs(a.minor)
    germs = tmp.germs()[:3]
    assert jgs._penalty_terms(0.1, 0.5, {'Gxpi2': 2.0}, [1, 1, 2], None, jmp.germs()[:3]) == \
        tgs._penalty_terms(0.1, 0.5, {'Gxpi2': 2.0}, [1, 1, 2], None, germs)


# -- the test_selection.py cases, through both packages -----------------------

def test_fiducial_lists_complete_and_scored_alike():
    jm, tm = jmp.target_model('full TP'), tmp.target_model('full TP')
    for kind, jf, tf in (('prep', jmp.prep_fiducials(), tmp.prep_fiducials()),
                         ('meas', jmp.meas_fiducials(), tmp.meas_fiducials())):
        a = jfs.test_fiducial_list(jm, jf, kind, return_all=True)
        b = tfs.test_fiducial_list(tm, tf, kind, return_all=True, device='cpu')
        assert a[0] and b[0] and abs(a[1] - b[1]) <= SCORE_TOL * a[1]
        assert np.max(np.abs(a[2] - b[2])) <= 1e-12
    assert not tfs.test_fiducial_list(tm, tmp.prep_fiducials()[:2], 'prep', device='cpu')
    assert not jfs.test_fiducial_list(jm, jmp.prep_fiducials()[:2], 'prep')


def test_standard_germs_beat_singletons_alike():
    jm = jmp.target_model('full TP').rotate(max_rotate=0.01, seed=0)
    tm = tmp.target_model('full TP').rotate(max_rotate=0.01, seed=0)
    pj = jgs._nongauge_projector(jm)
    pt = tgs._nongauge_projector(tm, device='cpu')
    singles_j = [JCircuit((l,), (0,)) for l in jm.operations.keys()]
    singles_t = [tgs.Circuit((l,), (0,)) for l in tm.operations.keys()]
    nj = [jgs.compute_composite_germ_set_score(jm, g, non_gauge_projector=pj)[1]
          for g in (singles_j, jmp.germs())]
    nt = [tgs.compute_composite_germ_set_score(tm, g, non_gauge_projector=pt, device='cpu')[1]
          for g in (singles_t, tmp.germs())]
    assert nj == nt and nt[1] > nt[0]
    assert jgs.max_amplified_directions(jm, non_gauge_projector=pj) == \
        tgs.max_amplified_directions(tm, non_gauge_projector=pt, device='cpu')


GERM_SEARCHES = [
    ('full', dict()),
    ('full TP', dict()),
    ('full', dict(mode='compactEVD')),
    ('full TP', dict(algorithm='grasp')),
    ('full TP', dict(candidate_germ_counts={2: 'all upto'}, algorithm='slack',
                     fixed_slack=0.5, mode='compactEVD')),
    ('full TP', dict(candidate_germ_counts={2: 'all upto'}, algorithm='slack', slack_frac=0.1)),
    ('full TP', dict(candidate_germ_counts={2: 'all upto'}, op_penalty=1.0)),
    ('full TP', dict(candidate_germ_counts={3: 10, 2: 'all upto'}, candidate_seed=5)),
]


@pytest.mark.parametrize('mtype,kw', GERM_SEARCHES)
def test_find_germs_search_matches_jax(jax_numbers, mtype, kw):
    """Fed the JAX package's Grams, the port's search chooses the JAX
    package's germs, circuit for circuit."""
    jax_numbers['mtype'] = mtype
    a = jgs.find_germs(jmp.target_model(mtype), seed=2, verbosity=0, **kw)
    b = tgs.find_germs(tmp.target_model(mtype), seed=2, verbosity=0, device='cpu', **kw)
    assert strs(a) == strs(b)


@pytest.mark.parametrize('mtype', ['full', 'full TP'])
def test_find_germs_complete_and_scored_alike(mtype):
    """On its own numbers the port's greedy set is complete, and the JAX
    package's set scores the same in both packages."""
    stats = {}
    b = tgs.find_germs(tmp.target_model(mtype), seed=1, verbosity=0, device='cpu', stats=stats)
    a = jgs.find_germs(jmp.target_model(mtype), seed=1, verbosity=0)
    jm = jmp.target_model(mtype).rotate(max_rotate=1e-2, seed=1)
    tm = tmp.target_model(mtype).rotate(max_rotate=1e-2, seed=1)
    pj = jgs._nongauge_projector(jm)
    n_max = jgs.max_amplified_directions(jm, non_gauge_projector=pj)
    assert stats['target_directions'] == n_max and stats['candidates'] == 20
    assert stats['near_eps_gap_candidates'] == 0 and stats['score'] < 1e6
    assert tgs.compute_composite_germ_set_score(tm, b, non_gauge_projector=pj,
                                                device='cpu')[1] >= n_max
    for germs_j in (a, jmp.germs()):
        sj = jgs.compute_composite_germ_set_score(jm, germs_j, non_gauge_projector=pj)
        st = tgs.compute_composite_germ_set_score(
            tm, [tgs.Circuit(g.str) for g in germs_j], non_gauge_projector=pj, device='cpu')
        assert st[1] >= (n_max if germs_j is a else 0)
        same_amplified(sj, st)


@pytest.mark.parametrize('search', ['breadthfirst', 'depthfirst', 'grasp', 'integer_slack'])
def test_standalone_germ_searches_match_jax(jax_numbers, search):
    import itertools
    jm = jgs.randomize_model_list([jmp.target_model('full TP')], 1e-2, 1, seed=4)[0]
    tm = tgs.randomize_model_list([tmp.target_model('full TP')], 1e-2, 1, seed=4)[0]
    assert np.max(np.abs(np.asarray(jm.to_vector()) - tm.to_vector())) <= 1e-15
    jc = [JCircuit(c, (0,)) for L in (1, 2, 3)
          for c in itertools.product(list(jm.operations.keys()), repeat=L)]
    tc = [tgs.Circuit(c, (0,)) for L in (1, 2, 3)
          for c in itertools.product(list(tm.operations.keys()), repeat=L)]
    kw = {'breadthfirst': dict(threshold=1e8), 'depthfirst': dict(threshold=1e8),
          'grasp': dict(iterations=2, seed=1, threshold=1e8),
          'integer_slack': dict(slack_frac=0.2)}[search]
    a = getattr(jgs, 'find_germs_' + search)(jm, jc, **kw)
    b = getattr(tgs, 'find_germs_' + search)(tm, tc, device='cpu', **kw)
    assert strs(a) == strs(b)


def test_germ_set_tests_and_helpers_match_jax():
    import itertools
    jm = jgs.randomize_model_list([jmp.target_model('full TP')], 1e-2, 1, seed=4)[0]
    tm = tgs.randomize_model_list([tmp.target_model('full TP')], 1e-2, 1, seed=4)[0]
    tc = [tgs.Circuit(c, (0,)) for L in (1, 2, 3)
          for c in itertools.product(list(tm.operations.keys()), repeat=L)]
    jc = [JCircuit(c.str) for c in tc]
    assert tgs.test_germ_set_infl(tm, tmp.germs(), device='cpu') and \
        jgs.test_germ_set_infl(jm, jmp.germs())
    assert not tgs.test_germ_set_infl(tm, [tc[0]], device='cpu')
    ok_j, spec_j = jgs.test_germ_set_finitel(jm, jmp.germs(), 16, return_spectrum=True)
    ok_t, spec_t = tgs.test_germ_set_finitel(tm, tmp.germs(), 16, return_spectrum=True,
                                             device='cpu')
    assert ok_j and ok_t and len(spec_t) == tm.num_params
    assert np.max(np.abs(spec_j - spec_t)) <= 1e-10 * np.max(spec_j)
    # the pack's germs amplify no SPAM direction, so both scores sum
    # reciprocals of eigenvalues at rounding level: far above the threshold
    sj = jgs.compute_germ_set_score(list(jmp.germs()), target_model=jm, neighborhood_size=2,
                                    seed=1)
    st = tgs.compute_germ_set_score(list(tmp.germs()), target_model=tm, neighborhood_size=2,
                                    seed=1, device='cpu')
    assert np.isfinite(st) and sj > 1e12 and st > 1e12
    cj, ct = jgs.create_circuit_cache(jm, jc[:12]), tgs.create_circuit_cache(tm, tc[:12],
                                                                             device='cpu')
    assert all(np.max(np.abs(np.asarray(cj[a]) - ct[b])) <= 1e-14 for a, b in zip(jc, tc[:12]))
    assert strs(jgs.clean_germ_list(jm, cj)[0]) == strs(tgs.clean_germ_list(tm, ct)[0])
    assert strs(jgs.drop_random_germs(jc, 0.5, jm, seed=2)) == \
        strs(tgs.drop_random_germs(tc, 0.5, tm, seed=2))
    vj, Dj = jgs.germ_set_spanning_vectors(jmp.target_model('full TP'), list(jmp.germs()),
                                           verbosity=0)
    vt, Dt = tgs.germ_set_spanning_vectors(tmp.target_model('full TP'), list(tmp.germs()),
                                           verbosity=0, device='cpu')
    assert sum(len(v) for v in vj.values()) == sum(len(v) for v in vt.values()) == \
        tgs._resolve_nongauge(None, tmp.target_model('full TP'), 'cpu') == \
        jgs._resolve_nongauge(None, jmp.target_model('full TP'))
    # which amplified vectors the greedy takes depends on each package's
    # eigenbases; the span it reaches does not
    assert int(np.count_nonzero(np.linalg.eigvalsh(Dj) > 1e-7)) == \
        int(np.count_nonzero(np.linalg.eigvalsh(Dt) > 1e-7))
    _, D2 = tgs.germ_set_spanning_vectors(tmp.target_model('full TP'), list(tmp.germs()),
                                          verbosity=0, mode='RRQR', device='cpu')
    assert int(np.count_nonzero(np.linalg.eigvalsh(D2) > 1e-7)) == \
        sum(len(v) for v in vt.values())
    with pytest.raises(NotImplementedError):
        tgs.find_germs(tmp.target_model(), num_gs_copies=2, device='cpu')


FIDUCIAL_SEARCHES = [('full TP', 'greedy', {}, 3), ('full', 'greedy', {}, 4),
                     ('full TP', 'slack', {'slack_frac': 0.2}, 3),
                     ('full', 'grasp', {'iterations': 2, 'seed': 4}, 2)]


@pytest.mark.parametrize('mtype,alg,kw,count', FIDUCIAL_SEARCHES)
def test_find_fiducials_search_matches_jax(jax_numbers, mtype, alg, kw, count):
    jax_numbers['mtype'] = mtype
    a = jfs.find_fiducials(jmp.target_model(mtype), candidate_fid_counts=count, algorithm=alg,
                           algorithm_kwargs=kw, verbosity=0)
    b = tfs.find_fiducials(tmp.target_model(mtype), candidate_fid_counts=count, algorithm=alg,
                           algorithm_kwargs=kw, verbosity=0, device='cpu')
    assert strs(a[0]) == strs(b[0]) and strs(a[1]) == strs(b[1])


@pytest.mark.parametrize('mtype,alg,kw,count', FIDUCIAL_SEARCHES)
def test_find_fiducials_complete(mtype, alg, kw, count):
    """On its own numbers (numpy's products and LAPACK on the CPU, as the
    JAX package computes) the port chooses the JAX package's fiducials,
    circuit for circuit; each set is complete and scores alike in both."""
    tm, jm = tmp.target_model(mtype), jmp.target_model(mtype)
    prep, meas = tfs.find_fiducials(tm, candidate_fid_counts=count, algorithm=alg,
                                    algorithm_kwargs=kw, verbosity=0, device='cpu')
    jprep, jmeas = jfs.find_fiducials(jm, candidate_fid_counts=count, algorithm=alg,
                                      algorithm_kwargs=kw, verbosity=0)
    assert strs(prep) == strs(jprep) and strs(meas) == strs(jmeas)
    for kind, fids in (('prep', prep), ('meas', meas)):
        ok, s, _ = tfs.test_fiducial_list(tm, fids, kind, return_all=True, device='cpu')
        okj, sj, _ = jfs.test_fiducial_list(jm, [JCircuit(f.str) for f in fids], kind,
                                            return_all=True)
        assert ok and okj and abs(s - sj) <= SCORE_TOL * sj


def test_fiducial_caches_and_cleaning_match_jax():
    jm, tm = jmp.target_model(), tmp.target_model()
    jc = jfs.create_candidate_fiducial_list(jm, candidate_fid_counts=3)
    tc = tfs.create_candidate_fiducial_list(tm, candidate_fid_counts=3, device='cpu')
    assert strs(jc) == strs(tc)
    jcache = jfs.create_circuit_cache(jm, jc)
    tcache = tfs.create_circuit_cache(tm, tc, device='cpu')
    assert set(jcache) == set(tcache)
    assert max(np.max(np.abs(np.asarray(jcache[k]) - tcache[k])) for k in tcache) <= 1e-14
    jcl, jcache2 = jfs.clean_fid_list(jm, jcache, jc)
    tcl, tcache2 = tfs.clean_fid_list(tm, tcache, tc)
    assert strs(jcl) == strs(tcl) and set(jcache2) == set(tcache2)
    pj, kj = jfs.create_prep_cache(jm, jcl, jcache2)
    pt, kt = tfs.create_prep_cache(tm, tcl, tcache2)
    assert kj == kt and set(pj) == set(pt)
    mj, qj = jfs.create_meas_cache(jm, jcl, jcache2)
    mt, qt = tfs.create_meas_cache(tm, tcl, tcache2)
    assert qj == qt and set(mj) == set(mt)
    sq = tfs.construct_compact_evd_cache(tm, tcl[:3], 'prep', pt, device='cpu')
    fm = np.concatenate(tfs.create_prep_mxs(tm, [tcl[0]], pt, device='cpu'), axis=1)
    assert np.allclose(sq[tcl[0]] @ sq[tcl[0]].conj().T, fm @ fm.conj().T)
    fj = np.concatenate(jfs.create_meas_mxs(jm, jcl[:4]), axis=1)
    ft = np.concatenate(tfs.create_meas_mxs(tm, tcl[:4], device='cpu'), axis=1)
    assert np.max(np.abs(fj - ft)) <= 1e-14
    assert np.array_equal(jfs.build_bitvec_mx(5, 2), tfs.build_bitvec_mx(5, 2))
    assert tfs.xor(True, False) and not tfs.xor(True, True)
    assert jfs.add_penalties_greedy(1.0, jcl[:3], 0.5, 0.25, {'Gxpi2': 1.0}) == \
        tfs.add_penalties_greedy(1.0, tcl[:3], 0.5, 0.25, {'Gxpi2': 1.0})


FPR_SEARCHES = ['per_germ', 'per_germ_greedy', 'per_germ_power', 'per_germ_global']


def _fpr(mod, pack, search, mtype, **dev):
    args = (pack.target_model(mtype), pack.prep_fiducials(), pack.meas_fiducials())
    if search == 'per_germ':
        return mod.find_sufficient_fiducial_pairs_per_germ(*args, pack.germs(), seed=0, **dev)
    if search == 'per_germ_greedy':
        return mod.find_sufficient_fiducial_pairs_per_germ_greedy(*args, pack.germs()[:3],
                                                                 seed=7, **dev)
    if search == 'per_germ_power':
        return mod.find_sufficient_fiducial_pairs_per_germ_power(
            *args, pack.germs()[:2], max_lengths=[1, 2], seed=7, **dev)
    return mod.find_sufficient_fiducial_pairs_per_germ_global(*args, pack.germs(), **dev)


@pytest.mark.parametrize('mtype', ['full TP'])
@pytest.mark.parametrize('search', FPR_SEARCHES)
def test_fiducial_pair_searches_match_jax(jax_numbers, search, mtype):
    """Fed the JAX package's pair sensitivities, each of the port's
    fiducial-pair searches chooses the JAX package's pairs."""
    jax_numbers['mtype'] = mtype
    assert pair_keys(_fpr(jfpr, jmp, search, mtype)) == \
        pair_keys(_fpr(tfpr, tmp, search, mtype, device='cpu'))


def test_fiducial_pair_search_workers_match_jax(jax_numbers, monkeypatch):
    """With the searches' SVDs split over three worker processes (forced by
    a zero start-up price), the per-germ search still chooses the JAX
    package's pairs."""
    jax_numbers['mtype'] = 'full TP'
    monkeypatch.setattr(tfpr, 'WORKER_START_S', 0.0)
    monkeypatch.setattr(tfpr.os, 'cpu_count', lambda: 3)
    stats = {}
    pt = tfpr.find_sufficient_fiducial_pairs_per_germ(
        tmp.target_model('full TP'), tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(),
        seed=0, device='cpu', stats=stats)
    assert stats['workers'] == 3
    assert pair_keys(_fpr(jfpr, jmp, 'per_germ', 'full TP')) == pair_keys(pt)


@pytest.mark.parametrize('mtype', ['full', 'full TP'])
def test_fiducial_pairs_amplify_alike(mtype):
    """On its own numbers the port's reduced pairs amplify as many
    parameters as the JAX package's (test_fiducial_pairs of both), the
    global union equals the per-germ one's, and the sensitivities agree."""
    args_j = (jmp.target_model(mtype), jmp.prep_fiducials(), jmp.meas_fiducials())
    args_t = (tmp.target_model(mtype), tmp.prep_fiducials(), tmp.meas_fiducials())
    pj = jfpr.find_sufficient_fiducial_pairs_per_germ(*args_j, jmp.germs(), seed=0)
    pt = tfpr.find_sufficient_fiducial_pairs_per_germ(*args_t, tmp.germs(), seed=0,
                                                      device='cpu')
    n_j = jfpr.test_fiducial_pairs(pj, *args_j, jmp.germs())
    n_t = tfpr.test_fiducial_pairs(pt, *args_t, tmp.germs(), device='cpu')
    assert n_j == n_t == tfpr.test_fiducial_pairs(
        {g: list(map(tuple, pj[jg])) for g, jg in zip(tmp.germs(), jmp.germs())},
        *args_t, tmp.germs(), device='cpu')
    total = len(tmp.prep_fiducials()) * len(tmp.meas_fiducials())
    assert all(0 < len(p) < total for p in pt.values())
    union = tfpr.find_sufficient_fiducial_pairs(*args_t, tmp.germs(), seed=0, device='cpu')
    assert union == sorted(set(p for v in pt.values() for p in v))
    germ_t, germ_j = tmp.germs()[4], jmp.germs()[4]
    rj = jfpr._germ_pair_sensitivities(args_j[0], germ_j, *args_j[1:])
    rt = tfpr._germ_pair_sensitivities(args_t[0], germ_t, *args_t[1:], device='cpu')
    # the rows are the real parts of sensitivities in each solver's basis of
    # amplified directions (degenerate singular values at the target leave
    # it free), so only what does not depend on that basis is compared
    assert rj[1] == rt[1] and rj[2] == rt[2]
    assert np.linalg.matrix_rank(rj[0], 1e-8) == np.linalg.matrix_rank(rt[0], 1e-8)
    assert tfpr.filter_useless_fid_pairs(list(pt[germ_t]), *args_t, germ_t, device='cpu') == \
        list(pt[germ_t])


def test_compute_jacobian_dicts_repaired():
    """The JAX package's compute_jacobian_dicts unpacks three of four values
    and raises; the port returns the dicts (ROADMAP.md section 3)."""
    args_j = (jmp.target_model('full TP'), jmp.germs()[:2], jmp.prep_fiducials(),
              jmp.meas_fiducials())
    with pytest.raises(ValueError):
        jfpr.compute_jacobian_dicts(*args_j)
    t = tmp.target_model('full TP')
    out = tfpr.compute_jacobian_dicts(t, tmp.germs()[:2], tmp.prep_fiducials(),
                                      tmp.meas_fiducials(), device='cpu')
    for g in tmp.germs()[:2]:
        rows, pidx, n_amp, _ = tfpr._germ_pair_sensitivities(t, g, tmp.prep_fiducials(),
                                                             tmp.meas_fiducials(),
                                                             device='cpu')
        assert np.array_equal(out[g]['jacobian'], rows) and out[g]['num_amplified'] == n_amp
        assert out[g]['pair_index'] == pidx


@pytest.mark.parametrize('scheme', ['whole germ powers', 'truncated germ powers',
                                    'length as exponent'])
@pytest.mark.parametrize('nest', [True, False])
def test_create_elgst_lists_match_jax(scheme, nest):
    a = j_elgst(jmp.target_model(), jmp.germs(), [0, 1, 2, 4, 8], scheme, nest)
    b = t_elgst(tmp.target_model(), tmp.germs(), [0, 1, 2, 4, 8], scheme, nest)
    assert [strs(l) for l in a] == [strs(l) for l in b]
    a = j_elgst(list(jmp.target_model().operations.keys()), jmp.germs(), [1, 4], scheme, nest,
                include_lgst=False)
    b = t_elgst(list(tmp.target_model().operations.keys()), tmp.germs(), [1, 4], scheme, nest,
                include_lgst=False)
    assert [strs(l) for l in a] == [strs(l) for l in b]


@pytest.mark.slow
def test_find_germs_and_pairs_2q_against_jax():
    """find_germs and find_sufficient_fiducial_pairs_per_germ on
    smq2Q_XYICNOT 'full' (1,616 parameters, 103 candidates) with
    chip_smoke.py's phase-23 seed, in both packages on the CPU: each
    package's germ set is complete and scores alike in both packages (within
    1e-8 relative), and each package's pairs amplify alike.  Whether the
    lists are equal is printed: ties among incomplete sets are decided by
    rounding (ROADMAP.md section 3)."""
    import time
    seed = 2026
    t0 = time.time()
    jg = jgs.find_germs(jmp2.target_model('full'), seed=seed, verbosity=0)
    t_jax = time.time() - t0
    stats = {}
    t0 = time.time()
    tg = tgs.find_germs(tmp2.target_model('full'), seed=seed, verbosity=0, device='cpu',
                        stats=stats)
    t_port = time.time() - t0
    print("2-qubit find_germs: JAX package %.1f s, port %.1f s on the CPU; %d and %d germs; "
          "lists equal: %s" % (t_jax, t_port, len(jg), len(tg), strs(jg) == strs(tg)))
    print("JAX:", strs(jg))
    print("port:", strs(tg), stats)
    jm = jmp2.target_model('full').depolarize(max_op_noise=1e-2, seed=seed)
    tm = tmp2.target_model('full').depolarize(max_op_noise=1e-2, seed=seed)
    pj = jgs._nongauge_projector(jm)
    n = stats['target_directions']
    for germs in (strs(jg), strs(tg)):
        sj = jgs.compute_composite_germ_set_score(jm, [JCircuit(g) for g in germs],
                                                  non_gauge_projector=pj)
        st = tgs.compute_composite_germ_set_score(tm, [tgs.Circuit(g) for g in germs],
                                                  non_gauge_projector=pj, device='cpu')
        assert st[1] >= n
        same_amplified(sj, st)
        top_j = np.sum(1.0 / sj[2][:n])
        top_t = np.sum(1.0 / st[2][:n])
        assert abs(top_j - top_t) <= SCORE_TOL * top_j
    args_j = (jmp2.target_model('full'), jmp2.prep_fiducials(), jmp2.meas_fiducials())
    args_t = (tmp2.target_model('full'), tmp2.prep_fiducials(), tmp2.meas_fiducials())
    t0 = time.time()
    pairs_j = jfpr.find_sufficient_fiducial_pairs_per_germ(*args_j, jg, seed=seed)
    t_jax = time.time() - t0
    t0 = time.time()
    pairs_t = tfpr.find_sufficient_fiducial_pairs_per_germ(
        *args_t, [tgs.Circuit(g.str) for g in jg], seed=seed, device='cpu')
    t_port = time.time() - t0
    same = pair_keys(pairs_j) == pair_keys(pairs_t)
    print("2-qubit pairs per germ of the JAX package's germs: JAX package %.1f s, port %.1f s; "
          "equal: %s" % (t_jax, t_port, same))
    tgerms = [tgs.Circuit(g.str) for g in jg]
    amp_t = tfpr.test_fiducial_pairs({g: pairs_t[g] for g in tgerms}, *args_t, tgerms,
                                     device='cpu')
    amp_tj = tfpr.test_fiducial_pairs({g: list(map(tuple, pairs_j[jgg]))
                                       for g, jgg in zip(tgerms, jg)}, *args_t, tgerms,
                                      device='cpu')
    print("test_fiducial_pairs: port's pairs %d, JAX package's pairs %d" % (amp_t, amp_tj))
    assert amp_t == amp_tj > 0
