"""RB decay-constant <-> error-rate conversions (reference:
pygsti/tools/rbtools.py)."""

from __future__ import annotations


def p_to_r(p, d, rtype='EI'):
    """Decay constant -> error rate.  'EI' (entanglement infidelity):
    r = (1 - p)(d^2 - 1)/d^2;  'AGI': r = (1 - p)(d - 1)/d (reference:
    rbtools.p_to_r:16)."""
    if rtype == 'EI':
        return (1 - p) * (d ** 2 - 1) / d ** 2
    if rtype == 'AGI':
        return (1 - p) * (d - 1) / d
    raise ValueError("Unknown rtype %r" % rtype)


def r_to_p(r, d, rtype='EI'):
    """Inverse of p_to_r (reference: rbtools.r_to_p:66)."""
    if rtype == 'EI':
        return 1 - d ** 2 * r / (d ** 2 - 1)
    if rtype == 'AGI':
        return 1 - d * r / (d - 1)
    raise ValueError("Unknown rtype %r" % rtype)


def hamming_distance(bs1, bs2):
    """Hamming distance between two equal-length bit strings (reference:
    rbtools.hamming_distance:163)."""
    return sum(1 for a, b in zip(bs1, bs2) if a != b)


def adjusted_success_probability(hamming_distance_pdf):
    """Hamming-weight-adjusted success probability
    sum_n (-1/2)^n pdf[n] (reference: rbtools.adjusted_success_probability:94)."""
    return float(sum((-0.5) ** n * pn
                     for n, pn in enumerate(hamming_distance_pdf)))


def marginalized_success_counts(dsrow, circ, target, qubits):
    """Success counts of `target` marginalized onto `qubits` (reference:
    rbtools.marginalized_success_counts:115)."""
    if dsrow.total == 0:
        return 0
    indices = [circ.line_labels.index(q) for q in qubits]
    margtarget = ''.join(target[i] for i in indices)
    if tuple(qubits) == tuple(circ.line_labels):
        return dsrow.counts.get((target,), dsrow.counts.get(target, 0))
    success = 0
    for outcome, counts in dsrow.counts.items():
        bits = outcome[0] if isinstance(outcome, tuple) else outcome
        if ''.join(bits[i] for i in indices) == margtarget:
            success += counts
    return success


def marginalized_hamming_distance_counts(dsrow, circ, target, qubits):
    """Histogram of Hamming distances to `target`, marginalized onto
    `qubits` (reference: rbtools.marginalized_hamming_distance_counts:182)."""
    if dsrow.total == 0:
        return [0 for _ in range(len(qubits) + 1)]
    indices = [circ.line_labels.index(q) for q in qubits]
    margtarget = ''.join(target[i] for i in indices)
    counts_hist = [0.0] * (len(qubits) + 1)
    for outcome, counts in dsrow.counts.items():
        bits = outcome[0] if isinstance(outcome, tuple) else outcome
        d = hamming_distance(''.join(bits[i] for i in indices), margtarget)
        counts_hist[d] += counts
    return counts_hist


def rescaling_factor(lengths, quantity, offset=2):
    """Mean ratio quantity / (length + offset), for converting an RB decay
    to a per-layer/per-gate rate (reference: rbtools.rescaling_factor:223)."""
    import numpy as _np
    assert len(lengths) == len(quantity), "Data format incorrect!"
    per_length = [
        _np.mean(_np.array(q) / (l + offset))
        for l, q in zip(lengths, quantity)]
    return float(_np.mean(_np.array(per_length)))
