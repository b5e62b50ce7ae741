"""The germ-power product cache of the port (layouts/prodcache.py) against
the JAX package's: the cases of tests/test_prodcache.py run through both
packages with the plans equal array for array, the plans of two GST designs,
and the factorized probabilities (probs_kernel='fact') against the JAX
package's PYGSTI_TPU_PROBS_KERNEL=fact ones and the port's scan."""

import numpy as np
import pytest

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp1
import pygsti_tpu.modelpacks.smq2Q_XYICNOT as jmp2
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.layouts import prodcache as jpc
from pygsti_tpu.layouts.layout import CircuitOutcomeProbabilityLayout as JLayout

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp1
import pygsti_tpu_torch.modelpacks.smq2Q_XYICNOT as tmp2
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.layouts import prodcache as tpc


class _FakeModel:
    def __init__(self, dim):
        self.dim = dim


class _FakeLayout:
    """The JAX test's layout stand-in (its `model` for the JAX package,
    `dim` for the port)."""

    def __init__(self, seqs, n_ops, dim, n_prep=2, n_eff=3, rng=None):
        rng = rng or np.random.default_rng(0)
        B = len(seqs)
        D = max((len(s) for s in seqs), default=1)
        self.op_indices = np.full((B, max(D, 1)), n_ops, np.int32)
        for r, s in enumerate(seqs):
            self.op_indices[r, :len(s)] = s
        self.depths = np.array([len(s) for s in seqs], np.int32)
        self.identity_index = n_ops
        self.prep_index = rng.integers(0, n_prep, B).astype(np.int32)
        self.elem_circuit = np.repeat(np.arange(B, dtype=np.int32), n_eff)
        self.elem_effect = np.tile(np.arange(n_eff, dtype=np.int32), B)
        self.num_elements = B * n_eff
        self.model = _FakeModel(dim)
        self.dim = dim


def _assert_same_plan(t, j):
    """Every field of two LayoutFactorizations (and of their element group
    tables) equal, array for array."""
    assert len(t.levels) == len(j.levels)
    for (tl, tr), (jl, jr) in zip(t.levels, j.levels):
        assert np.array_equal(tl, jl) and np.array_equal(tr, jr)
    for name in t._fields:
        if name != 'levels':
            assert np.array_equal(np.asarray(getattr(t, name)), np.asarray(getattr(j, name))), name
    for chunk in (4, 64):
        tg, jg = tpc.build_element_group_tables(t, chunk), jpc.build_element_group_tables(j, chunk)
        for name in tg._fields:
            assert np.array_equal(getattr(tg, name), getattr(jg, name)), (chunk, name)


def _eval_factorized(F, Gx, preps, effs):
    T = list(Gx)
    for lefts, rights in F.levels:
        for l, r in zip(lefts, rights):
            T.append(T[l] @ T[r])
    T = np.array(T)
    a = np.einsum('mij,rj->mri', T[F.a_pfx_cache], preps[:F.n_preps]).reshape(-1, preps.shape[1])
    e = np.einsum('oi,mij->moj', effs[:F.n_effects], T[F.e_sfx_cache]).reshape(-1, preps.shape[1])
    X = np.einsum('qij,qj->qi', T[F.pair_g], a[F.pair_a])
    return np.sum(e[F.elem_erow] * X[F.elem_pair], axis=1)


def _eval_direct(L, Gx, preps, effs):
    p = np.empty(L.num_elements)
    for el in range(L.num_elements):
        r = L.elem_circuit[el]
        rho = preps[L.prep_index[r]]
        for op in L.op_indices[r, :L.depths[r]]:
            rho = Gx[op] @ rho
        p[el] = effs[L.elem_effect[el]] @ rho
    return p


@pytest.mark.parametrize("ops, depth", [
    ([0, 1, 2, 1, 2, 1, 2, 3], 8),      # simple power
    ([0, 1, 2, 3], 4),                  # none
    ([3, 3, 3, 3, 3], 5),               # single-op power
    ([0, 1, 9, 9, 9, 9], 2),            # identity padding ignored
])
def test_power_blocks_match_jax(ops, depth):
    ops = np.array([ops], np.int32)
    for a, b in zip(tpc._best_power_blocks(ops, np.array([depth])),
                    jpc._best_power_blocks(ops, np.array([depth]))):
        assert np.array_equal(a, b)
    start, period, mult = tpc._best_power_blocks(ops, np.array([depth]))
    expect = {8: (1, 2, 3), 4: (None, None, 0), 5: (0, 1, 5), 2: (None, None, 0)}[depth]
    assert mult[0] == expect[2]
    if expect[0] is not None:
        assert (start[0], period[0]) == expect[:2]


def _deep_powers():
    germ = [1, 2]
    return [pf + germ * k + mf for k in (1, 2, 4, 8, 16, 32)
            for pf in ([0], [3, 4], []) for mf in ([2], [0, 1], [])]


def _random_and_edge():
    rng = np.random.default_rng(7)
    seqs = [list(rng.integers(0, 5, rng.integers(0, 9))) for _ in range(25)]
    return seqs + [[], [0], [4, 4], [0, 1, 0, 1, 0]]


def _known_word():
    germ = [1, 2, 3]
    return [[0] + germ * 4 + [4]] + [pf + germ + mf for pf in ([0], [4]) for mf in ([0], [4])]


@pytest.mark.parametrize("case", ['deep powers', 'random and edge rows', 'known word'])
def test_plans_match_jax_and_evaluate_exactly(case):
    """The JAX test's layouts: the plans equal the JAX package's; the plan
    evaluates to the direct product within 1e-12; the JAX test's bounds
    on levels, cache entries and prefixes."""
    seqs = {'deep powers': _deep_powers, 'random and edge rows': _random_and_edge,
            'known word': _known_word}[case]()
    n_ops, dim = 5, 4
    rng = np.random.default_rng(1)
    L = _FakeLayout(seqs, n_ops, dim, rng=rng)
    F = tpc.factorize_layout(L)
    _assert_same_plan(F, jpc.factorize_layout(L))
    G = np.array([np.linalg.qr(rng.standard_normal((dim, dim)))[0] for _ in range(n_ops)])
    Gx = np.concatenate([G, np.eye(dim)[None]], 0)
    preps, effs = rng.standard_normal((2, dim)), rng.standard_normal((3, dim))
    assert np.abs(_eval_factorized(F, Gx, preps, effs) - _eval_direct(L, Gx, preps, effs)).max() \
        < 1e-12
    if case == 'deep powers':
        assert len(F.levels) <= 10 and F.n_cache < 40 and len(F.a_pfx_cache) <= 8
    if case == 'known word':
        assert len(F.a_pfx_cache) <= 2


def test_empty_layout_has_no_plan():
    assert tpc.factorize_layout(_FakeLayout([], 3, 4)) is None


def _designs(pack):
    if pack == '1Q':
        jm, tm, maxl = jmp1, tmp1, [1, 2, 4, 8]
    else:
        jm, tm, maxl = jmp2, tmp2, [1, 2, 4]
    jt, tt = jm.target_model('full TP'), tm.target_model('full TP')
    jc = list(j_lists(jt, jm.prep_fiducials(), jm.meas_fiducials(), jm.germs(), maxl)[-1])
    tc = list(t_lists(tt, tm.prep_fiducials(), tm.meas_fiducials(), tm.germs(), maxl)[-1])
    return jt, tt, jc, tc


@pytest.mark.parametrize("pack", ['1Q', '2Q'])
def test_gst_design_plans_match_jax(pack):
    """smq1Q_XYI to maxL 8 and smq2Q_XYICNOT to maxL 4: the port's layout
    factorizes into the JAX package's plan."""
    jt, tt, jc, tc = _designs(pack)
    jlay = JLayout(jc, jt)
    tlay = SimpleForwardSimulator(tt, 'cpu').create_layout(tc)
    assert np.array_equal(tlay.op_indices, jlay.op_indices)
    _assert_same_plan(tlay.factorization, jlay.factorization)
    assert tlay.factorization is tlay.factorization          # made once


@pytest.mark.parametrize("pack", ['1Q', '2Q'])
def test_factorized_probs_match_jax_and_scan(pack, monkeypatch):
    """A depolarized model's factorized probabilities against the JAX
    package's (PYGSTI_TPU_PROBS_KERNEL=fact) and the port's scan, within
    1e-12."""
    jt, tt, jc, tc = _designs(pack)
    jgen = jt.copy().depolarize(op_noise=0.03, spam_noise=0.01)
    tgen = tt.copy()
    tgen.from_vector(jgen.to_vector())
    monkeypatch.setenv('PYGSTI_TPU_PROBS_KERNEL', 'fact')
    jp = jgen.sim.bulk_fill_probs(None, JLayout(jc, jgen))
    fact = SimpleForwardSimulator(tgen, 'cpu', probs_kernel='fact')
    scan = SimpleForwardSimulator(tgen, 'cpu')
    lay = scan.create_layout(tc)
    tp = fact.bulk_fill_probs(None, lay)
    assert np.max(np.abs(tp - jp)) < 1e-12
    assert np.max(np.abs(tp - scan.bulk_fill_probs(None, lay))) < 1e-12
    with pytest.raises(ValueError, match='probs_kernel'):
        SimpleForwardSimulator(tgen, 'cpu', probs_kernel='tree')
