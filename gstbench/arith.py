"""The benchmark's yardstick arithmetic: the card's peaks, the bytes and
operations the blocked Jacobian's kernel needs, the Gauss-Newton work of
one LM iteration, and the device's busy time from its activity intervals.
Everything here is computed from shapes and intervals alone, so a change to
the program cannot move it.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12          # HBM3
PEAK_F64_FLOPS = 33.5e12            # FP64 outside the tensor cores (the kernel's FMAs)
PEAK_F64_TENSOR_FLOPS = 67e12       # FP64 Tensor Core (the f64 Grams, sm90_xmma_gemm_f64)
ITEM = 8                            # bytes of a float64
COL = 4                             # bytes of an int32 op index


def jacobian_bytes_flops(depths, d, k1, nout):
    """(bytes, flops) one blocked Jacobian needs from the kernel over
    circuits of `depths`, op stack G [k1, d, d] (k1 counts the identity
    that pads short circuits), nout outcomes each: each circuit's op
    indices [D], states F [D, d] and effects E [nout, d] read once, G read
    once, and the op blocks A [nout, k1 - 1, d, d] (the identity's block is
    not needed) and B_final [nout, d] written once; per layer and outcome
    d^2 multiply-adds into A and d^2 into the back-propagated effect.
    Each circuit counts at its own depth: no padding of buckets."""
    total_depth = int(sum(depths))
    n = len(depths)
    nbytes = (COL * total_depth + ITEM * total_depth * d + ITEM * n * nout * d
              + ITEM * n * nout * (k1 - 1) * d * d + ITEM * n * nout * d
              + ITEM * k1 * d * d)
    flops = 4 * nout * d * d * total_depth
    return nbytes, flops


def jacobian_min_seconds(depths, d, k1, nout):
    """The least time the card could take for those bytes and operations."""
    nbytes, flops = jacobian_bytes_flops(depths, d, k1, nout)
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F64_FLOPS)


def lm_step_flops(elements, params):
    """Operations of one Gauss-Newton LM iteration at E elements and P
    parameters: J^T J (2 E P^2), J^T f (2 E P) and the Cholesky solve
    (P^3 / 3)."""
    E, P = float(elements), float(params)
    return 2 * E * P * P + 2 * E * P + P ** 3 / 3


def union_and_gaps(start, end):
    """(busy, gaps [n], the interval after each gap [n]) of intervals
    [start, end) sorted by start, in their own unit: the union's length,
    and each idle stretch between its pieces."""
    start, end = np.asarray(start), np.asarray(end)
    if len(start) == 0:
        return 0, np.zeros(0, start.dtype), np.zeros(0, np.int64)
    reach = np.maximum.accumulate(end)
    gap = start[1:] - reach[:-1]
    after = np.nonzero(gap > 0)[0] + 1
    gaps = gap[gap > 0]
    return reach[-1] - start[0] - gaps.sum(), gaps, after
