"""Design selection on a card against the CPU path, at one qubit
(smq1Q_XYI).

Imports nothing of JAX, so it also runs on a machine without JAX:
    python -m pytest tests/test_torch_selection_cuda.py --noconftest -q
Without a card the tests skip.

The twirled derivatives agree within 1e-10, the projector (finite
differences at 1e-7) within 1e-8, and the batched scores of complete sets
within 1e-10 relative, or 16 eps times the set's condition number where
that is larger, which must stay at or below 1e-6.  Which of several
sets that do not yet amplify every direction wins a greedy step is decided
by eigenvalues at rounding level (ROADMAP.md section 3), which a card's
solver and the host's LAPACK round differently, so the selections are held
to completeness and the CPU's scores, and compared list for list only in
the report.
"""

import numpy as np
import pytest
import torch

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as mp
from pygsti_tpu_torch.algorithms import (fiducialpairreduction as fpr,
                                         fiducialselection as fs, germselection as gs)

CUDA = 'cuda'


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize('mtype', ['full', 'full TP'])
def test_twirls_projector_and_scores_on_the_card(card, mtype):
    m = mp.target_model(mtype).rotate(max_rotate=1e-2, seed=1)
    p_cpu = gs._nongauge_projector(m, device='cpu')
    # finite differences at 1e-7: a rounding of S^-1 G S at 1e-16 moves a
    # gauge direction by 1e-9, so the projector is held at 1e-8
    assert np.max(np.abs(gs._nongauge_projector(m, device=CUDA) - p_cpu)) <= 1e-8
    for g in mp.germs():
        a, b = gs.twirled_deriv(m, g, device='cpu'), gs.twirled_deriv(m, g, device=CUDA)
        assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(a))
    n = gs.max_amplified_directions(m, non_gauge_projector=p_cpu, device='cpu')
    germs = gs.find_germs(mp.target_model(mtype), seed=1, verbosity=0, device='cpu')
    lists = [list(mp.germs()), germs, germs + list(mp.germs())[3:6], germs[:-1]
             + [germs[-1]]]
    cpu = gs._GermScorer(m, p_cpu, n, 'cpu', l1_penalty=1e-2)
    s_cpu = cpu.score_many(lists)
    s_card = gs._GermScorer(m, p_cpu, n, CUDA, l1_penalty=1e-2).score_many(lists)
    for (a, na), (b, nb), ev in zip(s_cpu, s_card, cpu.top_evals(lists)):
        assert na == nb
        if na >= n:
            # each device forms the Grams in its own rounding, at 1e-16 of
            # the largest eigenvalue: the score, led by the smallest, moves
            # by that times the set's condition number
            cond = ev[0] / ev[n - 1]
            tol = max(1e-10, 16 * np.finfo(float).eps * cond)
            print("score rel diff %.3e, cond %.3e, tol %.3e" % (abs(a - b) / abs(a), cond, tol))
            # a set so ill-conditioned that its tolerance passes 1e-6 would
            # let a wrong card result through
            assert tol <= 1e-6
            assert abs(a - b) <= tol * abs(a)


@pytest.mark.cuda
@pytest.mark.parametrize('mtype', ['full', 'full TP'])
def test_selections_on_the_card(card, mtype):
    target = mp.target_model(mtype)
    m = target.rotate(max_rotate=1e-2, seed=1)
    p = gs._nongauge_projector(m, device='cpu')
    n = gs.max_amplified_directions(m, non_gauge_projector=p, device='cpu')
    stats = {}
    card_germs = gs.find_germs(target, seed=1, verbosity=0, device=CUDA, stats=stats)
    cpu_germs = gs.find_germs(target, seed=1, verbosity=0, device='cpu')
    for germs in (card_germs, cpu_germs):
        assert gs.compute_composite_germ_set_score(m, germs, non_gauge_projector=p,
                                                   device='cpu')[1] >= n
    assert stats['score'] < 1e6 and stats['target_directions'] == n
    print("germs equal card/CPU:", [g.str for g in card_germs] == [g.str for g in cpu_germs])
    prep, meas = fs.find_fiducials(target, candidate_fid_counts=3, verbosity=0, device=CUDA)
    assert fs.test_fiducial_list(target, prep, 'prep', device='cpu')
    assert fs.test_fiducial_list(target, meas, 'meas', device='cpu')
    pairs = fpr.find_sufficient_fiducial_pairs_per_germ(
        target, mp.prep_fiducials(), mp.meas_fiducials(), mp.germs(), seed=0, device=CUDA)
    cpu_pairs = fpr.find_sufficient_fiducial_pairs_per_germ(
        target, mp.prep_fiducials(), mp.meas_fiducials(), mp.germs(), seed=0, device='cpu')
    # each germ's pairs reach the rank of all its pairs' sensitivities on the
    # model the search randomized, the search's own criterion
    fmodel = fpr._randomized_for_fpr(target, 0)
    for chosen in (pairs, cpu_pairs):
        for g, (rows, pidx, n_amp, _) in zip(mp.germs(), fpr._sensitivities(
                fmodel, mp.germs(), mp.prep_fiducials(), mp.meas_fiducials(),
                gs._nongauge_projector(fmodel, device='cpu'), device='cpu')):
            sel = [k for k, p in enumerate(pidx) if p in set(chosen[g])]
            assert fpr._rank(rows[sel]) == fpr._rank(rows) == n_amp
    print("pairs equal card/CPU:", pairs == cpu_pairs)
