"""Tools for classical probability distributions given as outcome->prob dicts
(counterpart of pygsti_tpu/tools/pdftools.py)."""

import numpy as _np


def tvd(p, q):
    """Total variational distance 0.5 * sum_x |p(x) - q(x)| between two
    dict-valued distributions; missing keys count as probability zero
    (reference pdftools.py:15)."""
    events = set(p) | set(q)
    return 0.5 * sum(abs(p.get(e, 0.0) - q.get(e, 0.0)) for e in events)


def classical_fidelity(p, q):
    """Classical (Bhattacharyya) fidelity (sum_x sqrt(p(x) q(x)))^2
    (reference pdftools.py:50)."""
    return float(sum(_np.sqrt(p.get(e, 0.0) * q.get(e, 0.0))
                     for e in set(p) | set(q))) ** 2
