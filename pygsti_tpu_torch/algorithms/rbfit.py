"""RB decay-curve fitting (reference: pygsti/algorithms/rbfit.py:20)."""

from __future__ import annotations

import numpy as np
import scipy.optimize as spo


def std_least_squares_fit(lengths, asps, n, seed=None, asymptote=None, ftype='full',
                          rtype='EI'):
    """Fit averaged success probabilities to A + B p^m (reference:
    rbfit.std_least_squares_fit).

    ftype: 'full' (fit A, B, p), 'FA' (fixed asymptote A), or 'full+FA'
    handled by the caller.  Returns dict with 'estimates' {'a','b','p','r'}
    and 'success'.
    """
    lengths = np.asarray(lengths, dtype=float)
    asps = np.asarray(asps, dtype=float)
    if asymptote is None:
        asymptote = 1.0 / 2 ** n

    # seed: A = asymptote, b = first - asymptote, p from endpoints
    if seed is None:
        a0 = asymptote
        b0 = max(asps[0] - a0, 1e-6)
        if len(lengths) >= 2 and asps[-1] - a0 > 0 and b0 > 0:
            span = max(lengths[-1] - lengths[0], 1)
            p0 = ((asps[-1] - a0) / b0) ** (1.0 / span)
            p0 = min(max(p0, 0.0), 1.0)
        else:
            p0 = 0.9
        seed = [a0, b0, p0]

    def curve(m, a, b, p):
        return a + b * p ** m

    try:
        if ftype == 'FA':
            popt, _ = spo.curve_fit(lambda m, b, p: curve(m, asymptote, b, p),
                                    lengths, asps, p0=seed[1:],
                                    bounds=([-np.inf, 0.0], [np.inf, 1.0]),
                                    maxfev=10000)
            a, b, p = asymptote, popt[0], popt[1]
        else:
            popt, _ = spo.curve_fit(curve, lengths, asps, p0=seed,
                                    bounds=([-np.inf, -np.inf, 0.0],
                                            [np.inf, np.inf, 1.0]),
                                    maxfev=10000)
            a, b, p = popt
        success = True
    except RuntimeError:
        a, b, p = seed
        success = False

    r = p_to_r(p, 2 ** n, rtype)
    return {'estimates': {'a': a, 'b': b, 'p': p, 'r': r}, 'success': success,
            'seed': seed}


def p_to_r(p, d, rtype='EI'):
    """Decay constant -> error rate.  'EI' (entanglement infidelity):
    r = (1 - p)(d^2 - 1)/d^2;  'AGI': r = (1 - p)(d - 1)/d (reference:
    tools/rbtools.p_to_r)."""
    if rtype == 'EI':
        return (1 - p) * (d ** 2 - 1) / d ** 2
    if rtype == 'AGI':
        return (1 - p) * (d - 1) / d
    raise ValueError("Unknown rtype %r" % rtype)


def r_to_p(r, d, rtype='EI'):
    if rtype == 'EI':
        return 1 - d ** 2 * r / (d ** 2 - 1)
    if rtype == 'AGI':
        return 1 - d * r / (d - 1)
    raise ValueError("Unknown rtype %r" % rtype)


class FitResults(object):
    """Container for RB fit results (reference: rbfit.FitResults:236)."""

    def __init__(self, fittype, seed, rtype, success, estimates, variable,
                 stds=None, bootstraps=None, bootstraps_failrate=None):
        self.fittype = fittype
        self.seed = seed
        self.rtype = rtype
        self.success = success
        self.estimates = dict(estimates)
        self.variable = dict(variable) if isinstance(variable, dict) \
            else variable
        self.stds = dict(stds) if stds else None
        self.bootstraps = bootstraps
        self.bootstraps_failrate = bootstraps_failrate

    def __str__(self):
        if not self.success:
            return "Fit failed!"
        return "Fit results: " + ", ".join(
            "%s = %g" % (k, v) for k, v in self.estimates.items())


def custom_least_squares_fit(lengths, asps, n, a=None, b=None, seed=None,
                             rtype='EI'):
    """Least-squares fit of RB decay data to a + B p^m, with `a` and/or `b`
    optionally FIXED (reference: rbfit.custom_least_squares_fit:86).
    Returns a FitResults."""
    import scipy.optimize as spo
    lengths = np.asarray(lengths, float)
    asps = np.asarray(asps, float)
    fixed_a = a is not None
    fixed_b = b is not None

    a0 = a if fixed_a else 1.0 / 2 ** n
    b0 = b if fixed_b else max(asps[0] - a0, 1e-6)
    if len(lengths) >= 2 and asps[-1] - a0 > 0 and b0 > 0:
        span = max(lengths[-1] - lengths[0], 1)
        p0 = min(max(((asps[-1] - a0) / b0) ** (1.0 / span), 0.0), 1.0)
    else:
        p0 = 0.9
    if seed is not None:
        if fixed_a and fixed_b:
            p0 = seed[0] if np.ndim(seed) else seed
        elif fixed_a:
            b0, p0 = seed
        elif fixed_b:
            a0, p0 = seed
        else:
            a0, b0, p0 = seed

    def curve(m, *params):
        i = 0
        av = a if fixed_a else params[(i := i + 1) - 1]
        bv = b if fixed_b else params[(i := i + 1) - 1]
        pv = params[i]
        return av + bv * pv ** m

    x0 = [v for v, fixed in ((a0, fixed_a), (b0, fixed_b)) if not fixed] + [p0]
    try:
        popt, _ = spo.curve_fit(curve, lengths, asps, p0=x0, maxfev=10000)
        i = 0
        a_fit = a if fixed_a else popt[(i := i + 1) - 1]
        b_fit = b if fixed_b else popt[(i := i + 1) - 1]
        p_fit = popt[i]
        estimates = {'a': float(a_fit), 'b': float(b_fit), 'p': float(p_fit),
                     'r': float(p_to_r(p_fit, 2 ** n, rtype))}
        success = True
    except Exception:
        estimates = {}
        success = False
    variable = {'a': not fixed_a, 'b': not fixed_b, 'p': True, 'r': True}
    return FitResults('LS', seed, rtype, success, estimates, variable)
