"""Robust phase estimation (counterpart of
pygsti_tpu/algorithms/robust_phase_estimation.py): a rotation angle theta
from cosine and sine counts at depths 2^k, each generation's raw angle
(2^k theta mod 2 pi) resolved to the branch nearest the previous estimate
(Kimmel, Low and Yoder, PRA 92, 062315)."""

from __future__ import annotations

import numpy as np


class RobustPhaseEstimation(object):
    """Angle estimates per generation from ``q.measured``: generation k ->
    (cos_plus, cos_minus, sin_plus, sin_minus) counts at depth 2^k."""

    def __init__(self, q):
        self.Q = q
        measured = q.measured
        self.raw_angles = {}
        for k in range(len(measured)):
            cp, cm, sp, sm = measured[k]
            p_cos = cp / (cp + cm) if (cp + cm) > 0 else 0.5
            p_sin = sp / (sp + sm) if (sp + sm) > 0 else 0.5
            self.raw_angles[k] = np.arctan2(2 * p_sin - 1, 2 * p_cos - 1) % (2 * np.pi)
        self.angle_estimates = self._resolve()

    def _resolve(self):
        """At generation k the raw angle is 2^k theta mod 2 pi; of the
        candidates (raw + 2 pi j) / 2^k take the one nearest the previous
        estimate."""
        estimates = [self.raw_angles[0]]
        for k in range(1, len(self.raw_angles)):
            mult, raw = 2 ** k, self.raw_angles[k]
            j = np.round((estimates[-1] * mult - raw) / (2 * np.pi))
            estimates.append(((raw + 2 * np.pi * j) / mult) % (2 * np.pi))
        return np.array(estimates)

    @property
    def angle_estimate(self):
        return self.angle_estimates[-1]


def rpe_phase_estimate(cos_counts, sin_counts):
    """The final angle estimate from (plus, minus) count pairs per
    generation, at depths 1, 2, 4, ..."""
    class _Q:
        measured = {k: (cos_counts[k][0], cos_counts[k][1], sin_counts[k][0], sin_counts[k][1])
                    for k in range(len(cos_counts))}
    return RobustPhaseEstimation(_Q()).angle_estimate
