"""Mirror-circuit fidelity estimation (MCFE) arithmetic (counterpart of
pygsti_tpu/tools/mcfetools.py; arXiv:2204.07568).

Converts Hamming-distance count data from mirror-circuit families into
effective polarizations and process-fidelity estimates.  Host numpy: a
handful of numbers per circuit, nothing for the card.
"""

from __future__ import annotations

import numpy as np


def success_probability_to_polarization(s, n):
    """p = (s - 1/2^n) / (1 - 1/2^n) (reference: mcfetools.py:23)."""
    return (s - 1 / 2 ** n) / (1 - 1 / 2 ** n)


def polarization_to_success_probability(p, n):
    """s = p + (1 - p)/2^n (reference: mcfetools.py:54)."""
    return p + (1 - p) / 2 ** n


def polarization_to_fidelity(p, n):
    """f = 1 - (4^n - 1)/4^n * (1 - p) (reference: mcfetools.py:85)."""
    return 1 - (4 ** n - 1) / 4 ** n * (1 - p)


def fidelity_to_polarization(f, n):
    """Inverse of polarization_to_fidelity (reference: mcfetools.py:116)."""
    return 1 - 4 ** n / (4 ** n - 1) * (1 - f)


def hamming_distance_counts(dsrow, circ, idealout):
    """Array of outcome counts binned by Hamming distance from `idealout`
    (reference: mcfetools.py:147)."""
    nq = len(circ.line_labels)
    bins = np.zeros(nq + 1, float)
    ideal = str(idealout)
    for outcome, cnt in dsrow.counts.items():
        bits = outcome[-1] if isinstance(outcome, tuple) else outcome
        hd = sum(b != i for b, i in zip(bits, ideal))
        bins[hd] += cnt
    return bins


def adjusted_success_probability(hd_counts):
    """adjSP = sum_k (-1/2)^k h_k (reference: mcfetools.py:194)."""
    total = np.sum(hd_counts)
    if total == 0.0:
        return 0.0
    pdf = np.asarray(hd_counts, float) / total
    return float(sum((-0.5) ** k * pdf[k] for k in range(len(pdf))))


def effective_polarization(hd_counts):
    """p = (4^n adjSP - 1)/(4^n - 1), n inferred from len(hd_counts)-1
    (reference: mcfetools.py:227)."""
    n = len(hd_counts) - 1
    asp = adjusted_success_probability(hd_counts)
    return float((4 ** n * asp - 1) / (4 ** n - 1))


def rc_predicted_process_fidelity(bare_rc_effective_pols,
                                  rc_rc_effective_pols,
                                  reference_effective_pols, n):
    """MCFE process fidelity: f(p) with p = E[p1]/sqrt(E[p2] E[p3]), clamped
    to [0, 1] (reference: mcfetools.py:262)."""
    a = np.mean(bare_rc_effective_pols)
    b = np.mean(rc_rc_effective_pols)
    c = np.mean(reference_effective_pols)
    if c <= 0.0:
        return np.nan
    if b <= 0.0:
        return 0.0
    pfid = polarization_to_fidelity(a / np.sqrt(b * c), n)
    return float(min(max(pfid, 0.0), 1.0))


def predicted_process_fidelity_for_central_pauli_mcs(central_pauli_effective_pols,
                                                     reference_effective_pols, n):
    """Central-Pauli MCFE: p = sqrt(E[p_cp]/E[p_ref]) -> fidelity, clamped
    (reference: mcfetools.py:328)."""
    a = np.mean(central_pauli_effective_pols)
    c = np.mean(reference_effective_pols)
    if c <= 0.0:
        return np.nan
    if a <= 0.0:
        return 0.0
    pfid = polarization_to_fidelity(np.sqrt(a / c), n)
    return float(min(max(pfid, 0.0), 1.0))


def rc_bootstrap_predicted_pfid(brs, rrs, refs, n, num_bootstraps=500,
                                rand_state=None):
    """Bootstrap resampled process-fidelity estimates (reference:
    mcfetools.py:374)."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    brs, rrs, refs = (np.asarray(x, float) for x in (brs, rrs, refs))
    out = []
    for _ in range(num_bootstraps):
        b = brs[rng.randint(len(brs), size=len(brs))]
        r = rrs[rng.randint(len(rrs), size=len(rrs))]
        f = refs[rng.randint(len(refs), size=len(refs))]
        out.append(rc_predicted_process_fidelity(b, r, f, n))
    return np.asarray(out)
