"""Multiple-comparison corrections (counterpart of pygsti_tpu/tools/hypothesis.py)."""

from __future__ import annotations

import numpy as np


def bonferroni_correction(significance, numtests):
    """Per-test significance under Bonferroni."""
    return significance / numtests


def sidak_correction(significance, numtests):
    """Per-test significance under Sidak."""
    return 1 - (1 - significance) ** (1 / numtests)


def generalized_bonferroni_correction(significance, weights, numtests=None,
                                      nested_method='bonferroni',
                                      tol=1e-10):
    """Weighted Bonferroni: split the budget by `weights` (summing to 1
    within `tol`), then apply the nested correction ('bonferroni' or
    Sidak) within each group of `numtests`."""
    weights = np.asarray(weights, float)
    if not abs(weights.sum() - 1.0) < tol:
        raise ValueError("weights must sum to 1")
    budgets = significance * weights
    if numtests is None:
        return budgets
    out = []
    for b, n in zip(budgets, np.atleast_1d(numtests)):
        out.append(bonferroni_correction(b, n) if nested_method == 'bonferroni'
                   else sidak_correction(b, n))
    return np.array(out)
