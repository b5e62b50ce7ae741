"""Eigenvalue-based candidate scoring (reference:
pygsti/algorithms/scoring.py; counterpart of pygsti_tpu/algorithms/scoring.py,
host numpy)."""

from __future__ import annotations

import functools

import numpy as np


def list_score(input_array, score_func='all'):
    """Score eigenvalues; smaller is better.  'all' = sum(1/|ev|), 'worst'
    = 1/min(|ev|) (reference: scoring.list_score:18)."""
    with np.errstate(divide='ignore'):
        a = np.abs(np.asarray(input_array, float))
        if score_func == 'all':
            return float(np.sum(1.0 / a))
        if score_func == 'worst':
            return float(1.0 / np.min(a))
    raise ValueError("score_func must be 'all' or 'worst'")


@functools.total_ordering
class CompositeScore(object):
    """(major, minor) lexicographic score; lower compares better
    (reference: scoring.CompositeScore:58).  `major` is typically the
    negative number of nonzero eigenvalues; `minor` the list_score."""

    def __init__(self, major, minor, n):
        self.major = major
        self.minor = minor
        self.N = n

    def __lt__(self, other):
        if self.major != other.major:
            return self.major < other.major
        return self.minor < other.minor

    def __eq__(self, other):
        return isinstance(other, CompositeScore) and \
            self.major == other.major and self.minor == other.minor

    def __repr__(self):
        return "Score: major=%s minor=%s, N: %s" % (self.major, self.minor,
                                                    self.N)


def composite_rcl_fn(candidate_scores, alpha):
    """Restricted-candidate-list indices for GRASP: scores within `alpha`
    of the best (0 = only the best, 1 = all) (reference:
    scoring.composite_rcl_fn / filter_composite_rcl:110)."""
    majors = np.array([s.major for s in candidate_scores], float)
    minors = np.array([s.minor for s in candidate_scores], float)
    best_major = majors.min()
    in_best = majors == best_major
    mn = minors[in_best]
    lo, hi = mn.min(), mn.max()
    thresh = lo + alpha * (hi - lo)
    return [i for i, s in enumerate(candidate_scores)
            if s.major == best_major and s.minor <= thresh + 1e-15]


def filter_composite_rcl(candidate_scores, alpha):
    """Indices of the restricted candidate list (RCL) for GRASP: candidates
    whose CompositeScore beats the alpha-interpolated threshold between the
    best and worst scores; thresholding is on the major part unless all
    majors tie, in which case the minor part (reference:
    scoring.filter_composite_rcl:110)."""
    max_score = max(candidate_scores)
    min_score = min(candidate_scores)
    if max_score.major == min_score.major:
        threshold = CompositeScore(
            max_score.major,
            (1 - alpha) * min_score.minor + alpha * max_score.minor, None)
    else:
        max_minor = max(s.minor for s in candidate_scores)
        threshold = CompositeScore(
            (1 - alpha) * min_score.major + alpha * max_score.major,
            max_minor, None)
    return np.array([i for i, s in enumerate(candidate_scores)
                     if s <= threshold])
