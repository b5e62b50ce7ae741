"""Objective functions and their Jacobians, in torch (counterpart of
pygsti_tpu/objectivefns/objectivefns.py: every raw objective of
_RAW_CLASSES and RawAbsPower, the switched forms of chi2 and the
Poisson-picture logL, ObjectiveFunctionBuilder,
TimeIndependentMDCObjectiveFunction with the omitted-probability
correction, the penalty rows, and the 'blocked' and forward-mode
Jacobians; the classes bound to one raw objective, TermWeighted and
CachedObjectiveFunction; the standalone logl, two_delta_logl and chi2).

The objective evaluates, on one device:
  fn(v)      -> objective value
  lsvec(v)   -> least-squares residual vector [n_elements (+ penalty rows)]
  jtj_jtf(v) -> (lsvec, J^T J, J^T lsvec), what the LM optimizer consumes,
with J = d lsvec / dv from one of two Jacobians, chosen by the JAX
package's rule (``jac_mode=None``):
  'blocked'   every row has the same number of elements and none is
              omitted: rows grouped into depth buckets, a forward scan per
              bucket, the backward accumulation of ops/bwd_jacobian.py, a
              per-bucket Gram, and one chain through Tv = d tensors / d v;
  'linearize' any other layout (sparse outcomes): P forward-mode tangents
              of the probabilities, pushed through the scan in chunks,
              then one Gram.  The JAX package's 'fwd' computes the same J
              without a mesh, so here both names run this one function.
"""

from __future__ import annotations

import numpy as np
import torch

from pygsti_tpu_torch import DTYPE
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator, layout_tensors
from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate

DEFAULT_MIN_PROB_CLIP = 1e-4
DEFAULT_RADIUS = 1e-4
DEFAULT_MIN_PROB_CLIP_FOR_WEIGHTING = 1e-4
# bytes of one Jacobian block (the JAX package's default budget)
JAC_BLOCK_BYTES = 256 * 1024 * 1024
# parameter count from which the device LM loop solves by conjugate gradients
# when no solver is named (the JAX package's default threshold)
CG_MIN_PARAMS = 8192
# bytes of one layer's op-tangent products dG s in one chunk of forward-mode
# tangents, by device type: few large launches on the card; on the CPU
# chunks that stay near its caches (a 2-qubit LM fit of 16 iterations took
# 51 s with 1 GiB chunks there, 1.8 s with 16 MiB ones)
JVP_CHUNK_BYTES = {'cuda': 1024 * 1024 * 1024, 'cpu': 16 * 1024 * 1024}


# -- raw objectives -----------------------------------------------------------
# The formulas are those of the JAX package, which reproduces the reference
# pyGSTi's; only the Poisson logL terms are summed in another, equal form
# (_sw_logl_terms).  p: probabilities, c: counts, t: total counts, f:
# frequencies.

def _sw_chi2_lsvec(p, c, t, f, mpc):
    return (p - f) * torch.sqrt(t / torch.clamp(p, min=mpc))


def _sw_chi2_dlsvec(p, c, t, f, mpc):
    cp = torch.clamp(p, min=mpc)
    w = torch.sqrt(t / cp)
    dw = torch.where(p > mpc, -0.5 * torch.sqrt(t) / cp ** 1.5,
                     torch.zeros_like(p))
    return w + (p - f) * dw


# Coefficients of y - log1p(y) = y^2 (1/2 - y/3 + y^2/4 - ...), summed up to
# y^18: below |y| = 0.1 the truncation is under 1e-16 of the sum.
_LOGL_SERIES = [(-1.0) ** k / k for k in range(2, 19)]
_LOGL_SERIES_MAX_Y = 0.1


def _sw_logl_terms(p, c, t, f, minp, radius):
    """The JAX package's c*log(f/p) - c + t*p, written as c*(y - log1p(y))
    with y = (p - f) / f (t = c / f).  The JAX form is a difference of
    numbers of size c that cancel to c*y^2/2 near p = f, so there its value,
    and more so its square root lsvec, is only as good as the platform's
    log, and the card and a host's CPU can differ there beyond 1e-9 of the
    largest entry.  Near p = f the series is summed instead, with no log at
    all, so the terms keep their relative precision (1e-13) at every y."""
    fnz = torch.where(c == 0, torch.ones_like(f), f)
    pos = torch.where(p < minp, torch.full_like(p, minp), p)
    y = (pos - fnz) / fnz
    small = torch.abs(y) < _LOGL_SERIES_MAX_Y
    ys = torch.where(small, y, torch.zeros_like(y))
    g = torch.full_like(y, _LOGL_SERIES[-1])
    for a in reversed(_LOGL_SERIES[:-1]):
        g = g * ys + a
    terms = c * torch.where(small, ys * ys * g, y - torch.log1p(y))
    c0 = t - c / minp
    c1 = 0.5 * c / (minp ** 2)
    terms = torch.where(p < minp, terms + c0 * (p - minp) + c1 * (p - minp) ** 2,
                        terms)
    zf = t * torch.where(p >= radius, p,
                         (-1.0 / (3 * radius ** 2)) * p ** 3 + p ** 2 / radius
                         + radius / 3.0)
    return torch.where(c == 0, zf, terms)


def _sw_logl_dterms(p, c, t, f, minp, radius):
    pos = torch.where(p < minp, torch.full_like(p, minp), p)
    c0 = t - c / minp
    c1 = 0.5 * c / (minp ** 2)
    d = torch.where(p < minp, c0 + 2 * c1 * (p - minp), t - c / pos)
    zf = t * torch.where(p >= radius, torch.ones_like(p),
                         (-1.0 / radius ** 2) * p ** 2 + 2 * p / radius)
    return torch.where(c == 0, zf, d)


def _sw_logl_hterms(p, c, t, f, minp, radius):
    pos = torch.where(p < minp, torch.full_like(p, minp), p)
    c1 = 0.5 * c / (minp ** 2)
    d2 = torch.where(p < minp, 2 * c1, c / pos ** 2)
    zf = torch.where(p >= radius, torch.zeros_like(p),
                     t * ((-2.0 / radius ** 2) * p + 2.0 / radius))
    return torch.where(c == 0, zf, d2)


def _sw_logl_lsvec(p, c, t, f, minp, radius):
    return torch.sqrt(_sw_logl_terms(p, c, t, f, minp, radius))


def _sw_logl_dlsvec(p, c, t, f, minp, radius):
    """d sqrt(terms) / dp, stable near the per-element minimum: below the
    roundoff floor of the terms it switches to the exact quadratic-regime
    limit sqrt(h/2)*sign(dterms) (see the JAX package's
    RawPoissonPicDeltaLogLFunction.dlsvec)."""
    terms = _sw_logl_terms(p, c, t, f, minp, radius)
    dterms = _sw_logl_dterms(p, c, t, f, minp, radius)
    h = _sw_logl_hterms(p, c, t, f, minp, radius)
    eps = torch.finfo(p.dtype).eps
    noise_floor = 100.0 * eps * torch.clamp(t, min=1.0)
    lsvec = torch.sqrt(torch.clamp(terms, min=1e-300))
    std = 0.5 * dterms / torch.clamp(lsvec, min=1e-150)
    quad = torch.sqrt(torch.clamp(h, min=0.0) / 2.0) * torch.sign(dterms)
    return torch.where(terms < noise_floor, quad, std)


def _chi2_zero_freq_terms(n, p, mpc):
    return n * p ** 2 / torch.clamp(p, min=mpc)


def _chi2_zero_freq_dterms(n, p, mpc):
    return torch.where(p >= mpc, n, 2 * n * p / torch.clamp(p, min=mpc))


def _logl_zero_freq_terms(n, p, radius):
    return n * torch.where(p >= radius, p, (-1.0 / (3 * radius ** 2)) * p ** 3
                           + p ** 2 / radius + radius / 3.0)


def _logl_zero_freq_dterms(n, p, radius):
    return n * torch.where(p >= radius, torch.ones_like(p),
                           (-1.0 / radius ** 2) * p ** 2 + 2 * p / radius)


class RawObjectiveFunction(object):
    """Base of the raw objectives: per-element terms of (p, c, t, f), with
    lsvec = sqrt(terms) and its slope 0.5 dterms / lsvec (0 where lsvec
    vanishes)."""

    def lsvec(self, p, c, t, f):
        return torch.sqrt(self.terms(p, c, t, f))

    def dlsvec(self, p, c, t, f):
        ls = self.lsvec(p, c, t, f)
        return torch.where(ls < 1e-100, torch.zeros_like(ls),
                           0.5 / torch.clamp(ls, min=1e-100)) * self.dterms(p, c, t, f)

    def terms(self, p, c, t, f):
        raise NotImplementedError()

    def dterms(self, p, c, t, f):
        raise NotImplementedError()

    def fn(self, p, c, t, f):
        return torch.sum(self.terms(p, c, t, f))

    def zero_freq_terms(self, n, p):
        """The terms of an outcome with no counts (also the omitted-outcome
        correction of a sparse layout); ``zero_freq_dterms`` their slope."""
        raise NotImplementedError("Derived classes must implement this!")

    def zero_freq_dterms(self, n, p):
        raise NotImplementedError("Derived classes must implement this!")

    def chi2k_distributed_qty(self, objective_function_value):
        return objective_function_value

    def set_regularization(self, **kwargs):
        pass


class RawChi2Function(RawObjectiveFunction):
    """N(p-f)^2 / max(p, minp) with its signed square-root lsvec."""

    def __init__(self, regularization=None, name='chi2'):
        self.name = name
        self.min_prob_clip_for_weighting = DEFAULT_MIN_PROB_CLIP_FOR_WEIGHTING
        if regularization:
            self.set_regularization(**regularization)

    def set_regularization(self, min_prob_clip_for_weighting=None):
        self.min_prob_clip_for_weighting = (
            min_prob_clip_for_weighting if min_prob_clip_for_weighting is not None
            else DEFAULT_MIN_PROB_CLIP_FOR_WEIGHTING)

    def lsvec(self, p, c, t, f):
        return _sw_chi2_lsvec(p, c, t, f, self.min_prob_clip_for_weighting)

    def dlsvec(self, p, c, t, f):
        return _sw_chi2_dlsvec(p, c, t, f, self.min_prob_clip_for_weighting)

    def terms(self, p, c, t, f):
        return self.lsvec(p, c, t, f) ** 2

    def dterms(self, p, c, t, f):
        return 2 * self.lsvec(p, c, t, f) * self.dlsvec(p, c, t, f)

    def zero_freq_terms(self, n, p):
        return _chi2_zero_freq_terms(n, p, self.min_prob_clip_for_weighting)

    def zero_freq_dterms(self, n, p):
        return _chi2_zero_freq_dterms(n, p, self.min_prob_clip_for_weighting)


class RawFreqWeightedChi2Function(RawChi2Function):
    """N(p-f)^2 / max(f, minf): the chi2 weighted by the frequencies, whose
    weights do not depend on p."""

    def __init__(self, regularization=None, name='fwchi2'):
        self.name = name
        self.min_freq_clip_for_weighting = 1e-4
        if regularization:
            self.set_regularization(**regularization)

    def set_regularization(self, min_freq_clip_for_weighting=None):
        if min_freq_clip_for_weighting is not None:
            self.min_freq_clip_for_weighting = min_freq_clip_for_weighting

    def lsvec(self, p, c, t, f):
        return (p - f) * torch.sqrt(t / torch.clamp(f, min=self.min_freq_clip_for_weighting))

    def dlsvec(self, p, c, t, f):
        return torch.sqrt(t / torch.clamp(f, min=self.min_freq_clip_for_weighting))

    def zero_freq_terms(self, n, p):
        return n * p ** 2 / self.min_freq_clip_for_weighting

    def zero_freq_dterms(self, n, p):
        return 2 * n * p / self.min_freq_clip_for_weighting


class RawPoissonPicDeltaLogLFunction(RawObjectiveFunction):
    """2*Delta(logL) in the Poisson picture, N*f*log(f/p) - N*(f-p), with the
    'minp' Taylor patch and the cubic zero-frequency terms."""

    def __init__(self, regularization=None, name='dlogl'):
        self.name = name
        self.min_p = DEFAULT_MIN_PROB_CLIP
        self.radius = DEFAULT_RADIUS
        if regularization:
            self.set_regularization(**regularization)

    def set_regularization(self, min_prob_clip=DEFAULT_MIN_PROB_CLIP,
                           radius=DEFAULT_RADIUS, pfratio_stitchpt=None,
                           pfratio_derivpt=None, fmin=None):
        if pfratio_stitchpt is not None:
            raise ValueError("only the 'minp' regularization is implemented")
        self.min_p = min_prob_clip
        self.radius = radius

    def lsvec(self, p, c, t, f):
        return _sw_logl_lsvec(p, c, t, f, self.min_p, self.radius)

    def dlsvec(self, p, c, t, f):
        return _sw_logl_dlsvec(p, c, t, f, self.min_p, self.radius)

    def terms(self, p, c, t, f):
        return _sw_logl_terms(p, c, t, f, self.min_p, self.radius)

    def dterms(self, p, c, t, f):
        return _sw_logl_dterms(p, c, t, f, self.min_p, self.radius)

    def zero_freq_terms(self, n, p):
        return _logl_zero_freq_terms(n, p, self.radius)

    def zero_freq_dterms(self, n, p):
        return _logl_zero_freq_dterms(n, p, self.radius)

    def chi2k_distributed_qty(self, objective_function_value):
        return 2 * objective_function_value


class RawDeltaLogLFunction(RawObjectiveFunction):
    """Delta logL outside the Poisson picture, N*f*log(f/p), with the 'minp'
    Taylor patch.  Its terms are legitimately negative where p > f, so fn
    and terms are not clamped; lsvec clamps inside the square root."""

    def __init__(self, regularization=None, name='dlogl-nonpoisson'):
        self.name = name
        self.min_p = DEFAULT_MIN_PROB_CLIP
        if regularization:
            self.set_regularization(**regularization)

    def set_regularization(self, min_prob_clip=DEFAULT_MIN_PROB_CLIP):
        self.min_p = min_prob_clip

    def terms(self, p, c, t, f):
        minp = self.min_p
        fnz = torch.where(c == 0, torch.ones_like(f), f)
        pos = torch.where(p < minp, torch.full_like(p, minp), p)
        terms = c * (torch.log(fnz) - torch.log(pos))
        terms = torch.where(p < minp, terms - c / minp * (p - minp)
                            + 0.5 * c / minp ** 2 * (p - minp) ** 2, terms)
        return torch.where(c == 0, torch.zeros_like(p), terms)

    def lsvec(self, p, c, t, f):
        terms = self.terms(p, c, t, f)
        return torch.sqrt(torch.where(terms < 0, torch.zeros_like(terms), terms))

    def dterms(self, p, c, t, f):
        minp = self.min_p
        pos = torch.where(p < minp, torch.full_like(p, minp), p)
        d = torch.where(p < minp, -c / minp + c / minp ** 2 * (p - minp), -c / pos)
        return torch.where(c == 0, torch.zeros_like(p), d)

    def zero_freq_terms(self, n, p):
        return torch.zeros_like(p)

    def zero_freq_dterms(self, n, p):
        return torch.zeros_like(p)

    def chi2k_distributed_qty(self, objective_function_value):
        return 2 * objective_function_value


class RawTVDFunction(RawObjectiveFunction):
    """Total variation distance terms 0.5 N |p - f|."""

    def __init__(self, regularization=None, name='tvd'):
        self.name = name

    def terms(self, p, c, t, f):
        return 0.5 * t * torch.abs(p - f)

    def dterms(self, p, c, t, f):
        return 0.5 * t * torch.sign(p - f)

    def zero_freq_terms(self, n, p):
        return 0.5 * torch.abs(p)

    def zero_freq_dterms(self, n, p):
        return 0.5 * torch.sign(p)


class RawChiAlphaFunction(RawObjectiveFunction):
    """N [x + 1/(alpha x^alpha) - (1 + 1/alpha)] with x = p/f, between logL
    (alpha -> 0) and chi2 (alpha = 1).  Below the stitch point x0 the terms
    follow their Taylor expansion about x1; zero-count terms use the cubic
    patch of `radius` or, with `fmin`, a quadratic one."""

    def __init__(self, regularization=None, name='chialpha', alpha=1):
        self.name = name
        self.alpha = alpha
        self.x0 = 0.01
        self.x1 = 0.01
        self.radius = 1e-4
        self.fmin = None
        if regularization:
            self.set_regularization(**regularization)

    def set_regularization(self, pfratio_stitchpt=0.01, pfratio_derivpt=0.01, radius=None,
                           fmin=None):
        self.x0 = pfratio_stitchpt
        self.x1 = pfratio_derivpt
        self.radius = 1e-4 if radius is None and fmin is None else radius
        self.fmin = fmin

    def _fmin_c1(self):
        return (0.5 / self.fmin) * (1. + self.alpha) / (self.x1 ** (2 + self.alpha))

    def zero_freq_terms(self, n, p):
        if self.radius is not None:
            return _logl_zero_freq_terms(n, p, self.radius)
        c1 = self._fmin_c1()
        return n * torch.where(p > 1.0 / c1, p, c1 * p ** 2)

    def zero_freq_dterms(self, n, p):
        if self.radius is not None:
            return _logl_zero_freq_dterms(n, p, self.radius)
        c1 = self._fmin_c1()
        return n * torch.where(p > 1.0 / c1, torch.ones_like(p), 2 * c1 * p)

    def terms(self, p, c, t, f):
        alpha, x0 = self.alpha, self.x0
        x = p / torch.where(c == 0, torch.ones_like(f), f)
        itaylor = x < x0
        c0 = 1. - 1. / (self.x1 ** (1 + alpha))
        c1 = 0.5 * (1. + alpha) / self.x1 ** (2 + alpha)
        xt = torch.where(itaylor, torch.full_like(x, x0), x)
        terms = c * (xt + 1.0 / (alpha * xt ** alpha) - (1.0 + 1.0 / alpha))
        terms = torch.where(itaylor, terms + c0 * c * (x - x0) + c1 * c * (x - x0) ** 2, terms)
        return torch.where(c == 0, self.zero_freq_terms(t, p), terms)

    def dterms(self, p, c, t, f):
        alpha, x0 = self.alpha, self.x0
        x = p / torch.where(c == 0, torch.ones_like(f), f)
        c0 = 1. - 1. / (self.x1 ** (1 + alpha))
        c1 = 0.5 * (1. + alpha) / self.x1 ** (2 + alpha)
        x_safe = torch.where(x <= 0, torch.full_like(x, x0), x)
        d = torch.where(x < x0, t * (c0 + 2 * c1 * (x - x0)),
                        t * (1 - 1. / x_safe ** (1. + alpha)))
        return torch.where(c == 0, self.zero_freq_dterms(t, p), d)


class RawCustomWeightedChi2Function(RawObjectiveFunction):
    """w^2 (p - f)^2 with per-element weights w (default 1)."""

    def __init__(self, regularization=None, name='cwchi2', custom_weights=None):
        self.name = name
        self.custom_weights = custom_weights

    def _w(self, p):
        if self.custom_weights is None:
            return torch.ones_like(p)
        return torch.as_tensor(self.custom_weights, dtype=p.dtype, device=p.device)

    def lsvec(self, p, c, t, f):
        return self._w(p) * (p - f)

    def dlsvec(self, p, c, t, f):
        return self._w(p)

    def terms(self, p, c, t, f):
        return self.lsvec(p, c, t, f) ** 2

    def dterms(self, p, c, t, f):
        w = self._w(p)
        return 2 * w * w * (p - f)


class RawMaxLogLFunction(RawObjectiveFunction):
    """N f log(f) (less N f in the Poisson picture): the terms of the
    largest log-likelihood any model could reach, independent of p."""

    def __init__(self, regularization=None, name='maxlogl', poisson_picture=True):
        self.name = name
        self.poisson_picture = poisson_picture

    def terms(self, p, c, t, f):
        logf = torch.log(torch.where(c == 0, torch.ones_like(f), f))
        return c * (logf - 1.0) if self.poisson_picture else c * logf

    def dterms(self, p, c, t, f):
        return torch.zeros_like(p)


class RawAbsPower(RawObjectiveFunction):
    """|p - f|^power elementwise (power >= 1)."""

    def __init__(self, power, regularization=None, name='Lp^p'):
        if not power >= 1:
            raise ValueError("power must be at least 1")
        self.name = name
        self.power = power

    def chi2k_distributed_qty(self, objective_function_value):
        return -1

    def terms(self, p, c, t, f):
        return torch.abs(p - f) ** self.power

    def dterms(self, p, c, t, f):
        d = p - f
        return self.power * torch.sign(d) * torch.abs(d) ** (self.power - 1)


class _SwitchedRaw(object):
    """chi2 (flag 0, regs[0] = min_prob_clip_for_weighting) or Poisson logL
    (flag 1, regs[1] = min_prob_clip, regs[2] = radius).  The JAX package
    traces the flag to share one compiled graph between GST stages; torch
    runs eagerly, so here the flag is a Python int and only the selected
    form is computed."""

    def lsvec(self, p, c, t, f, flag, regs):
        if flag == 0:
            return _sw_chi2_lsvec(p, c, t, f, regs[0])
        return _sw_logl_lsvec(p, c, t, f, regs[1], regs[2])

    def dlsvec(self, p, c, t, f, flag, regs):
        if flag == 0:
            return _sw_chi2_dlsvec(p, c, t, f, regs[0])
        return _sw_logl_dlsvec(p, c, t, f, regs[1], regs[2])

    def terms(self, p, c, t, f, flag, regs):
        if flag == 0:
            return _sw_chi2_lsvec(p, c, t, f, regs[0]) ** 2
        return _sw_logl_terms(p, c, t, f, regs[1], regs[2])

    def dterms(self, p, c, t, f, flag, regs):
        if flag == 0:
            return 2 * _sw_chi2_lsvec(p, c, t, f, regs[0]) * _sw_chi2_dlsvec(p, c, t, f, regs[0])
        return _sw_logl_dterms(p, c, t, f, regs[1], regs[2])

    def zero_freq_terms(self, n, p, flag, regs):
        if flag == 0:
            return _chi2_zero_freq_terms(n, p, regs[0])
        return _logl_zero_freq_terms(n, p, regs[2])

    def zero_freq_dterms(self, n, p, flag, regs):
        if flag == 0:
            return _chi2_zero_freq_dterms(n, p, regs[0])
        return _logl_zero_freq_dterms(n, p, regs[2])


class _PassthroughRaw(object):
    """Any other raw objective behind the switched signature."""

    def __init__(self, raw):
        self._raw = raw

    def __getattr__(self, name):
        method = getattr(self._raw, name)
        return lambda *args: method(*args[:-2])


def _switch_config(raw):
    """(adapter, flag, regs) of a raw objective: _SwitchedRaw for chi2 and
    the Poisson-picture logL, whose stages then share one set of functions,
    and a pass-through for any other."""
    if type(raw) is RawChi2Function:
        return _SwitchedRaw(), 0, (raw.min_prob_clip_for_weighting, 1e-4, 1e-4)
    if type(raw) is RawPoissonPicDeltaLogLFunction:
        return _SwitchedRaw(), 1, (1e-4, raw.min_p, raw.radius)
    return _PassthroughRaw(raw), 0, (1e-4, 1e-4, 1e-4)


_RAW_CLASSES = {
    'chi2': RawChi2Function,
    'fwchi2': RawFreqWeightedChi2Function,
    'freq-weighted-chi2': RawFreqWeightedChi2Function,
    'logl': RawPoissonPicDeltaLogLFunction,
    'dlogl': RawPoissonPicDeltaLogLFunction,
    'dlogl-nonpoisson': RawDeltaLogLFunction,
    'tvd': RawTVDFunction,
    'chialpha': RawChiAlphaFunction,
    'cwchi2': RawCustomWeightedChi2Function,
    'maxlogl': RawMaxLogLFunction,
}
_PENALTY_KEYS = ('cptp_penalty_factor', 'spam_penalty_factor', 'regularize_factor')
JAC_MODES = ('blocked', 'linearize', 'fwd')


class ObjectiveFunctionBuilder(object):
    """Recipe for building an MDC objective: a raw objective named in
    _RAW_CLASSES with its `regularization`, optional `penalties`
    (cptp_penalty_factor, spam_penalty_factor, regularize_factor) and
    `jac_mode` (None for the JAX package's rule, or one of JAC_MODES)."""

    @classmethod
    def cast(cls, obj):
        if isinstance(obj, cls):
            return obj
        if obj is None:
            return cls.create_from('logl')
        if isinstance(obj, str):
            return cls.create_from(obj)
        if isinstance(obj, dict):
            return cls.create_from(**obj)
        raise ValueError("Cannot cast %r to ObjectiveFunctionBuilder" % (obj,))

    @classmethod
    def create_from(cls, objective='logl', freq_weighted_chi2=False, **kwargs):
        """The builder of `objective`; 'chi2' with freq_weighted_chi2 is
        the frequency-weighted chi2, 'fwchi2'."""
        if objective == 'chi2' and freq_weighted_chi2:
            objective = 'fwchi2'
        return cls(objective, **kwargs)

    def __init__(self, name='logl', description=None, regularization=None, penalties=None,
                 jac_mode=None):
        if name not in _RAW_CLASSES:
            raise ValueError("unsupported objective %r (the port has %s)"
                             % (name, sorted(_RAW_CLASSES)))
        unknown = sorted(set(penalties or {}) - set(_PENALTY_KEYS))
        if unknown:
            raise ValueError("unknown penalties %s (the port has %s)" % (unknown, _PENALTY_KEYS))
        self.name = name
        self.description = description
        self.regularization = regularization or {}
        self.penalties = dict(penalties or {})
        self.jac_mode = jac_mode

    def build_raw(self):
        return _RAW_CLASSES[self.name](self.regularization)

    def build(self, model, dataset, circuits, device="cuda", layout=None,
              num_active_circuits=None):
        return TimeIndependentMDCObjectiveFunction(
            self.build_raw(), model, dataset, circuits, name=self.name, layout=layout,
            num_active_circuits=num_active_circuits, penalties=self.penalties,
            jac_mode=self.jac_mode, device=device)

    def build_from_store(self, mdc_store):
        return self.build(mdc_store.model, mdc_store.dataset, mdc_store.circuits,
                          device=mdc_store.device, layout=mdc_store.layout)


class ModelDatasetCircuitsStore(object):
    """Bundles model + dataset + circuits + layout on one device."""

    def __init__(self, model, dataset, circuits=None, device="cuda",
                 precomp_layout=None):
        self.model = model
        self.dataset = dataset
        self.device = device
        self.circuits = list(circuits) if circuits is not None else list(dataset.keys())
        self.layout = precomp_layout if precomp_layout is not None else \
            SimpleForwardSimulator(model, device).create_layout(self.circuits, dataset)


class TimeIndependentMDCObjectiveFunction(object):
    """Model + dataset + circuits objective on one device.

    With ``num_active_circuits`` the counts and totals of the layout's
    circuits beyond that prefix are zeroed: those elements then contribute
    nothing to any value or Jacobian row, so the stages of a nested GST fit
    share the final list's layout.  `penalties` add rows to the residual
    (module _make_penalty_fn); `jac_mode` picks the Jacobian (module note),
    and ``self.jac_mode`` names the one chosen."""

    def __init__(self, raw_objfn, model, dataset, circuits, name=None,
                 layout=None, num_active_circuits=None, penalties=None,
                 jac_mode=None, device="cuda"):
        self.raw_objfn = raw_objfn
        self.model = model
        self.dataset = dataset
        self.circuits = list(circuits)
        self.name = name or raw_objfn.name
        self.penalties = dict(penalties or {})
        self.device = torch.device(device)
        sim = SimpleForwardSimulator(model, self.device)
        self.layout = layout if layout is not None else \
            sim.create_layout(self.circuits, dataset)
        counts, totals = self.layout.counts_arrays(dataset)
        if num_active_circuits is not None:
            cutoff = self.layout.element_slices[num_active_circuits - 1].stop \
                if num_active_circuits > 0 else 0
            counts[cutoff:] = 0
            totals[cutoff:] = 0
            self.num_active_elements = cutoff
        else:
            self.num_active_elements = self.layout.num_elements
        with np.errstate(invalid='ignore', divide='ignore'):
            freqs = np.where(totals > 0, counts / np.where(totals > 0, totals, 1.0), 0.0)
        self.counts, self.total_counts, self.freqs = counts, totals, freqs
        self._data = tuple(torch.as_tensor(a, dtype=DTYPE, device=self.device)
                           for a in (counts, totals, freqs))
        raw, self._flag, self._regs = _switch_config(raw_objfn)
        self._fns = _objective_fns(model, self.layout, sim, raw, self.penalties, jac_mode)
        self.jac_mode = self._fns['jac_mode']

    def _v(self, paramvec):
        v = paramvec if paramvec is not None else self.model.to_vector()
        return torch.as_tensor(v, dtype=DTYPE, device=self.device)

    def _args(self):
        return self._data + (self._flag, self._regs)

    def fn(self, paramvec=None):
        return float(self._fns['fn'](self._v(paramvec), *self._args()))

    def lsvec(self, paramvec=None, oob_check=False):
        """The residual vector.  No point of a dense objective is out of
        bounds, so `oob_check` never raises here, as in the JAX package."""
        return self._fns['lsvec'](self._v(paramvec), *self._args()).cpu().numpy()

    def dlsvec(self, paramvec=None):
        return self._fns['dlsvec'](self._v(paramvec), *self._args()).cpu().numpy()

    def jtj_jtf(self, paramvec=None):
        ls, jtj, jtf = self._fns['jtj_jtf'](self._v(paramvec), *self._args())
        return ls.cpu().numpy(), jtj.cpu().numpy(), jtf.cpu().numpy()

    def probs(self, paramvec=None):
        with torch.no_grad():
            return self._fns['probs'](self._v(paramvec)).cpu().numpy()

    def terms(self, paramvec=None):
        """The raw objective's terms per element (no omitted-outcome
        correction, no penalties)."""
        with torch.no_grad():
            p = self._fns['probs'](self._v(paramvec))
            return self.raw_objfn.terms(p, *self._data).cpu().numpy()

    def percircuit(self, paramvec=None):
        """Objective contribution per circuit.  A circuit with omitted
        outcomes carries its correction, so with no penalties
        sum(percircuit()) == fn()."""
        terms = self.terms(paramvec)
        lay = self.layout
        if lay.has_omitted:
            p = self.probs(paramvec)
            psum = np.zeros(len(lay.circuits))
            np.add.at(psum, lay.elem_to_circuit, p)
            firsts = lay.omitted_firsts
            with torch.no_grad():
                zf = self.raw_objfn.zero_freq_terms(
                    torch.as_tensor(self.total_counts[firsts], dtype=DTYPE),
                    torch.as_tensor(1.0 - psum[lay.omitted_circuits], dtype=DTYPE)).numpy()
            terms[firsts] += zf
        return np.array([np.sum(terms[sl]) for sl in lay.element_slices])

    # The out-of-bounds predicate (v -> bool tensor) of the device loop, or
    # None: no point of the dense objective is out of bounds.
    device_oob_fn = None

    def run_device_lm(self, x0, maxiter=100, tol=None, linesearch=None, oob_check_interval=0,
                      solver=None):
        """The Levenberg-Marquardt loop with every state tensor on the
        objective's device.  `solver` is 'cholesky' or 'cg'; None takes
        'cg' from 8,192 parameters up, the JAX package's rule.  Returns (x,
        converged, msg, mu, nu, norm_f, f, iterations)."""
        from pygsti_tpu_torch.optimize.device_lm import make_device_lm, EXIT_MESSAGES
        tol = tol or {}
        linesearch = linesearch or {}
        if solver is None:
            solver = 'cg' if len(x0) >= CG_MIN_PARAMS else 'cholesky'
        args = self._args()
        oob = self.device_oob_fn
        lm_init, lm_run, lm_finalize = make_device_lm(
            lambda x: self._fns['jtj_jtf'](x, *args),
            lambda x: self._fns['lsvec'](x, *args),
            ls_beta=linesearch.get('beta', 0.25),
            ls_max_evals=linesearch.get('max_evals', 6),
            ls_kappa=linesearch.get('kappa', 1.0),
            oob_fn=None if oob is None else (lambda x: oob(x, *args)), solver=solver)
        maxdx = tol.get('maxdx', 1.0)
        tols = (tol.get('f', 1.0), tol.get('jac', 1e-6), tol.get('relf', 1e-6),
                tol.get('relx', 1e-8),
                (maxdx ** 2) * len(x0) if maxdx else float('inf'))
        state = lm_run(lm_init(self._v(x0), oob_interval=oob_check_interval), maxiter, tols)
        x, f, norm_f, mu, nu, code, k = lm_finalize(state, maxiter)
        return (x, code in (1, 2, 3, 4, 5), EXIT_MESSAGES.get(code, "exit code %d" % code),
                mu, nu, norm_f, f, k)

    def chi2k_distributed_qty(self, objective_function_value):
        return self.raw_objfn.chi2k_distributed_qty(objective_function_value)

    @property
    def num_elements(self):
        return self.layout.num_elements

    def num_data_params(self):
        return self.dataset.degrees_of_freedom(self.circuits)


# -- standalone functions --------------------------------------------------------
# The tools-level default min_prob_clip is 1e-6, not the GST objective's 1e-4
# (as in the JAX package and the reference).

def _logl_raw(min_prob_clip, radius, poisson_picture):
    if poisson_picture:
        return RawPoissonPicDeltaLogLFunction({'min_prob_clip': min_prob_clip,
                                               'radius': radius})
    return RawDeltaLogLFunction({'min_prob_clip': min_prob_clip})


def logl_max(model, dataset, circuits=None, poisson_picture=True):
    """The largest log-likelihood any model could reach on the data."""
    circuits = list(circuits) if circuits is not None else list(dataset.keys())
    total = 0.0
    for c in circuits:
        row = dataset[c]
        N = row.total
        for cnt in row.counts.values():
            if cnt > 0:
                total += cnt * np.log(cnt / N)
        if poisson_picture:
            total -= N
    return total


def logl(model, dataset, circuits=None, min_prob_clip=1e-6, radius=DEFAULT_RADIUS,
         poisson_picture=True, device="cuda"):
    """The model's log-likelihood: logl_max less the objective's Delta logL."""
    circuits = list(circuits) if circuits is not None else list(dataset.keys())
    obj = TimeIndependentMDCObjectiveFunction(
        _logl_raw(min_prob_clip, radius, poisson_picture), model, dataset, circuits,
        device=device)
    return logl_max(model, dataset, circuits, poisson_picture) - obj.fn()


def two_delta_logl(model, dataset, circuits=None, min_prob_clip=1e-6,
                   radius=DEFAULT_RADIUS, poisson_picture=True, device="cuda"):
    circuits = list(circuits) if circuits is not None else list(dataset.keys())
    obj = TimeIndependentMDCObjectiveFunction(
        _logl_raw(min_prob_clip, radius, poisson_picture), model, dataset, circuits,
        device=device)
    return 2 * obj.fn()


def chi2(model, dataset, circuits=None, min_prob_clip_for_weighting=1e-4, device="cuda"):
    circuits = list(circuits) if circuits is not None else list(dataset.keys())
    raw = RawChi2Function({'min_prob_clip_for_weighting': min_prob_clip_for_weighting})
    return TimeIndependentMDCObjectiveFunction(raw, model, dataset, circuits,
                                               device=device).fn()


class CachedObjectiveFunction(object):
    """A serializable record of an objective's values at the model's point:
    fn, its chi2-distributed form, |lsvec|^2, the per-circuit sums of the
    squared residuals, the circuits and the parameter vector."""

    collection_name = "pygsti_cached_objective_fns"

    def __init__(self, objective_function):
        objfn = objective_function
        self.name = getattr(objfn, 'name', 'objfn')
        self.description = getattr(objfn, 'description', None)
        self.circuits = list(objfn.circuits)
        self.model_paramvec = np.array(objfn.model.to_vector())
        self.fn = float(objfn.fn())
        ls = objfn.lsvec()
        self.chi2k_distributed_fn = float(objfn.chi2k_distributed_qty(self.fn))
        self.num_elements = len(ls)
        self.lsvec_norm2 = float(np.dot(ls, ls))
        terms = np.asarray(ls) ** 2
        self.percircuit = np.array([float(np.sum(terms[objfn.layout.element_slices[i]]))
                                    for i in range(len(self.circuits))])
        self.chi2k_distributed_percircuit = np.array(
            [objfn.chi2k_distributed_qty(x) for x in self.percircuit])

    def write(self, dirname):
        """Write ``cached_objfn.json`` into `dirname` (made if missing)."""
        import json
        import pathlib
        path = pathlib.Path(dirname)
        path.mkdir(parents=True, exist_ok=True)
        with open(path / 'cached_objfn.json', 'w') as f:
            json.dump({'name': self.name, 'fn': self.fn,
                       'chi2k_distributed_fn': self.chi2k_distributed_fn,
                       'num_elements': self.num_elements, 'lsvec_norm2': self.lsvec_norm2,
                       'circuits': [c.str for c in self.circuits],
                       'model_paramvec': self.model_paramvec.tolist(),
                       'percircuit': self.percircuit.tolist()}, f)

    @classmethod
    def from_dir(cls, dirname, quick_load=False):
        """Read what `write` wrote (either package's)."""
        import json
        import pathlib
        from pygsti_tpu_torch.circuits.circuit import Circuit
        with open(pathlib.Path(dirname) / 'cached_objfn.json') as f:
            state = json.load(f)
        obj = cls.__new__(cls)
        obj.name, obj.description = state['name'], None
        obj.fn = state['fn']
        obj.chi2k_distributed_fn = state['chi2k_distributed_fn']
        obj.num_elements = state['num_elements']
        obj.lsvec_norm2 = state['lsvec_norm2']
        obj.circuits = [Circuit(s) for s in state['circuits']]
        obj.model_paramvec = np.array(state['model_paramvec'])
        obj.percircuit = np.array(state['percircuit'])
        obj.chi2k_distributed_percircuit = obj.percircuit.copy()
        return obj


# -- the objective classes under their reference names: each binds a raw
#    objective to TimeIndependentMDCObjectiveFunction ---------------------------
ObjectiveFunction = RawObjectiveFunction
MDCObjectiveFunction = TimeIndependentMDCObjectiveFunction
LpNormToPowerP = RawAbsPower


def _bound_objective(raw_cls, default_name):
    class _Bound(TimeIndependentMDCObjectiveFunction):
        def __init__(self, model, dataset, circuits, regularization=None, penalties=None,
                     name=None, **kwargs):
            super().__init__(raw_cls(regularization), model, dataset, circuits,
                             penalties=penalties, name=name or default_name, **kwargs)

        @classmethod
        def create_from(cls, model, dataset, circuits, regularization=None, penalties=None,
                        **kwargs):
            return cls(model, dataset, circuits, regularization, penalties, **kwargs)

    return _Bound


class Chi2Function(_bound_objective(RawChi2Function, 'chi2')):
    """The chi2 objective."""


class FreqWeightedChi2Function(_bound_objective(RawFreqWeightedChi2Function, 'fwchi2')):
    """The frequency-weighted chi2 objective."""


class ChiAlphaFunction(_bound_objective(RawChiAlphaFunction, 'chialpha')):
    """The chi-alpha objective."""


class CustomWeightedChi2Function(_bound_objective(RawCustomWeightedChi2Function, 'cwchi2')):
    """The custom-weighted chi2 objective."""


class PoissonPicDeltaLogLFunction(_bound_objective(RawPoissonPicDeltaLogLFunction, 'dlogl')):
    """The Poisson-picture Delta logL objective."""


class DeltaLogLFunction(_bound_objective(RawDeltaLogLFunction, 'dlogl-nonpoisson')):
    """The Delta logL objective outside the Poisson picture."""


class MaxLogLFunction(_bound_objective(RawMaxLogLFunction, 'maxlogl')):
    """The terms of the largest log-likelihood any model could reach."""


class TVDFunction(_bound_objective(RawTVDFunction, 'tvd')):
    """The total-variation-distance objective."""


class TermWeighted(TimeIndependentMDCObjectiveFunction):
    """An objective whose per-element terms are scaled by the constant
    weights ``terms_weights`` (ones at first): fn = sum_i w_i terms_i and
    lsvec = sqrt(w terms); jtj_jtf is the unweighted objective's."""

    def __init__(self, raw_objfn, model, dataset, circuits, penalties=None, name=None,
                 **kwargs):
        super().__init__(raw_objfn, model, dataset, circuits, penalties=penalties, name=name,
                         **kwargs)
        self.terms_weights = np.ones(self.layout.num_elements)

    def terms(self, paramvec=None):
        return self.terms_weights * super().terms(paramvec)

    def fn(self, paramvec=None):
        return float(np.sum(self.terms(paramvec)))

    def lsvec(self, paramvec=None):
        return np.sqrt(np.clip(self.terms(paramvec), 0.0, None))


# -- CPTP / SPAM penalty pieces -------------------------------------------------
# (used by the gauge objective and by the penalty rows of the fit's objective)
_NEG_EIG_SQRT_SHIFT = 1e-6


class HermitianSpectralSum(torch.autograd.Function):
    """sum_i g(ev_i) over the eigenvalues of a Hermitian matrix [..., n, n]
    (one value per matrix of the batch), for g(x) = -min(x, 0) (`which` =
    'neg') or g(x) = |x| ('abs').  The backward is the first-order formula
    d = sum_i g'(ev_i) u_i^dag dA u_i, i.e. the gradient U diag(g') U^dag:
    the derivative of eigenvectors divides by eigenvalue gaps and is not
    finite at the degenerate spectra of rank-deficient Choi and density
    matrices, which is also why the JAX package writes these two by hand."""

    @staticmethod
    def forward(ctx, A, which):
        ev, U = torch.linalg.eigh(A)
        if which == 'neg':
            val, slopes = -torch.sum(torch.clamp(ev, max=0.0), dim=-1), -(ev < 0).to(ev.dtype)
        elif which == 'abs':
            val, slopes = torch.sum(torch.abs(ev), dim=-1), torch.sign(ev)
        else:
            raise ValueError("unknown spectral sum %r" % (which,))
        ctx.save_for_backward(U, slopes)
        return val

    @staticmethod
    def backward(ctx, grad_out):
        U, slopes = ctx.saved_tensors
        grad = (U * slopes[..., None, :].to(U.dtype)) @ U.conj().transpose(-1, -2)
        return grad_out[..., None, None] * grad, None


def _sum_neg_evals(A):
    """-sum of the negative eigenvalues of a Hermitian matrix (or of each
    of a batch), with a derivative that stays finite at degenerate
    eigenvalues."""
    return HermitianSpectralSum.apply(A, 'neg')


def _make_penalty_fn(model, penalties):
    """The extra residual rows of cptp_penalty_factor and
    spam_penalty_factor as a function of the parameter vector, or None when
    neither is on: per operation (the instruments' members are not
    penalized), factor * sqrt(1e-6 + sum of the negative eigenvalues of its
    Choi matrix), then the same of each prep's and effect's matrix.  A
    composite layer is not penalized, as in the JAX package."""
    cptp_factor = penalties.get('cptp_penalty_factor', 0)
    spam_factor = penalties.get('spam_penalty_factor', 0)
    if not (cptp_factor or spam_factor):
        return None
    dim = model.dim
    udim = int(round(np.sqrt(dim)))
    M = np.asarray(model.basis.create_transform_matrix('std')).astype(complex)
    host = (M, np.linalg.inv(M), np.asarray(model.basis.elements).astype(complex))
    compute = model.tensors_fn()
    # the primary operations only: the op stack holds them first, then the
    # composite layers (products of them) and the instruments' members
    n_ops = len(model.operations)
    consts = {}

    def pen_fn(v):
        key = str(v.device)
        if key not in consts:
            consts[key] = tuple(torch.as_tensor(a, dtype=torch.complex128, device=v.device)
                                for a in host)
        M, Minv, els = consts[key]
        t = compute(v)
        rows = []
        if cptp_factor:
            s_std = (M @ t.ops[:n_ops].to(M.dtype)) @ Minv
            choi = s_std.reshape(-1, udim, udim, udim, udim).permute(
                0, 1, 3, 2, 4).reshape(-1, dim, dim) / udim
            rows.append(cptp_factor * torch.sqrt(_NEG_EIG_SQRT_SHIFT + _sum_neg_evals(
                (choi + choi.conj().transpose(-1, -2)) / 2)))
        if spam_factor:
            vecs = torch.cat([t.preps, t.effects], dim=0)
            mx = torch.tensordot(vecs.to(els.dtype), els, dims=1)
            rows.append(spam_factor * torch.sqrt(_NEG_EIG_SQRT_SHIFT + _sum_neg_evals(
                (mx + mx.conj().transpose(-1, -2)) / 2)))
        return torch.cat(rows)

    return pen_fn


# -- the blocked Jacobian ------------------------------------------------------

def bucket_plan(layout, n_out, NT, device):
    """Depth-bucketed circuit blocks, cached on the layout per device.

    Rows (one per circuit, or per combination of its instruments' members)
    are sorted by depth and cut at the 50/75/90th depth
    percentiles; each bucket is scanned at its own padded depth, in blocks
    of at most JAC_BLOCK_BYTES of Jacobian (NT columns) padded to a multiple of 64 with identity ops
    and effect row 0 (padded rows get zero counts, so they add nothing).
    Returns (buckets, inv_perm): each bucket is a dict of device tensors
    plus its element indices; inv_perm puts the concatenated bucket
    residuals back in layout element order."""
    cache = layout.__dict__.setdefault('_bucket_plans', {})
    key = (str(device), n_out, NT)
    if key in cache:
        return cache[key]
    B, D = layout.op_indices.shape
    # rows per block: the JAX package's budget rule, never beyond the batch
    blk = min(max(64, JAC_BLOCK_BYTES
                  // (max(n_out, 1) * NT * torch.finfo(DTYPE).bits // 8)), B)
    depths = np.asarray(layout.depths)
    order = np.argsort(depths, kind='stable')
    if B < 256:
        edges = [D]
    else:
        qs = sorted({int(np.ceil(np.percentile(depths, p))) for p in (50, 75, 90)})
        edges = [e for e in qs if 0 < e < D] + [D]
    align = 64
    eff_rows_all = layout.elem_effect.reshape(B, n_out)
    buckets, elem_sorted = [], []
    lo = -1
    for e in edges:
        sel = order[(depths[order] > lo) & (depths[order] <= e)]
        lo = e
        Dk = max(int(e), 1)
        step = max(blk, align)
        for s in range(0, len(sel), step):
            rows = sel[s:s + step]
            nk = len(rows)
            nk_pad = -(-nk // align) * align
            op_b = np.full((nk_pad, Dk), layout.identity_index, np.int32)
            op_b[:nk] = layout.op_indices[rows][:, :Dk]
            prep_b = np.zeros(nk_pad, np.int64)
            prep_b[:nk] = layout.prep_index[rows]
            eff_b = np.zeros((nk_pad, n_out), np.int64)
            eff_b[:nk] = eff_rows_all[rows]
            elem_idx = (rows[:, None] * n_out + np.arange(n_out)).ravel()
            elem_sorted.append(elem_idx)
            buckets.append({
                'cols': torch.as_tensor(op_b, device=device),
                'cols64': torch.as_tensor(op_b, dtype=torch.int64, device=device),
                'prep': torch.as_tensor(prep_b, device=device),
                'eff': torch.as_tensor(eff_b, device=device),
                'elem_idx': torch.as_tensor(elem_idx, dtype=torch.int64, device=device),
                'nk': nk, 'nk_pad': nk_pad})
    inv_perm = torch.as_tensor(np.argsort(np.concatenate(elem_sorted)),
                               dtype=torch.int64, device=device)
    cache[key] = (buckets, inv_perm)
    return cache[key]


def choose_jac_mode(layout, jac_mode=None):
    """The Jacobian for `layout`: the JAX package's rule without a mesh
    when `jac_mode` is None ('blocked' when every row has the same number
    of elements and no outcome is omitted, else 'linearize', or 'fwd' for
    a layout without rows), else `jac_mode` itself when it can serve."""
    rows = layout.op_indices.shape[0]
    uniform = (rows > 0 and layout.num_elements % rows == 0 and layout.rows_uniform_n_out
               and not layout.has_omitted)
    if jac_mode is None:
        return 'blocked' if uniform else ('linearize' if rows > 0 else 'fwd')
    if jac_mode == 'prodjac':
        raise NotImplementedError("jac_mode 'prodjac' (the germ-power product cache) is not "
                                  "ported yet: ROADMAP.md, queue 1")
    if jac_mode not in JAC_MODES:
        raise ValueError("unknown jac_mode %r (the port has %s)" % (jac_mode, JAC_MODES))
    if jac_mode == 'blocked' and not uniform:
        raise ValueError("the blocked Jacobian needs every row to have the same number of "
                         "elements and no omitted outcomes")
    return jac_mode


def _omitted_correction(layout, raw, device):
    """(terms_of_p, lsvec_of_p, weighted_jac_t) of the objective on
    `layout`.  Each circuit with omitted outcomes gets
    zero_freq_terms(N, 1 - sum of its elements' probabilities) added at its
    first element, and that element's Jacobian row takes the slope of the
    omitted mass through every element of the circuit."""
    if not layout.has_omitted:
        def terms_of_p(p, c, t, f, flag, regs):
            return raw.terms(p, c, t, f, flag, regs)

        def lsvec_of_p(p, c, t, f, flag, regs):
            return raw.lsvec(p, c, t, f, flag, regs)

        def weighted_jac_t(Jt, p, ls, c, t, f, flag, regs):
            return Jt * raw.dlsvec(p, c, t, f, flag, regs)[None, :]

        return terms_of_p, lsvec_of_p, weighted_jac_t

    firsts, circs, seg = (torch.as_tensor(a, dtype=torch.int64, device=device)
                          for a in (layout.omitted_firsts, layout.omitted_circuits,
                                    layout.elem_to_circuit))
    n_circuits = len(layout.circuits)

    def omitted_probs(p):
        psum = torch.zeros(n_circuits, dtype=p.dtype, device=p.device).index_add_(0, seg, p)
        return 1.0 - psum[circs]

    def terms_of_p(p, c, t, f, flag, regs):
        zf = raw.zero_freq_terms(t[firsts], omitted_probs(p), flag, regs)
        return raw.terms(p, c, t, f, flag, regs).index_add(0, firsts, zf)

    def lsvec_of_p(p, c, t, f, flag, regs):
        ls = torch.sqrt(torch.clamp(terms_of_p(p, c, t, f, flag, regs), min=0.0))
        # the raw objective's signs (chi2's lsvec is a signed square root)
        return torch.where(raw.lsvec(p, c, t, f, flag, regs) < 0, -ls, ls)

    def weighted_jac_t(Jt, p, ls, c, t, f, flag, regs):
        """Jw = d lsvec / dv [P, E] from Jt = dp / dv [P, E].  Elements
        other than the firsts take the raw objective's own dlsvec, which
        holds the right limit where terms -> 0 (d sqrt(terms) does not);
        each first is rebuilt from sqrt(terms + zero_freq_terms)."""
        Jw = Jt * raw.dlsvec(p, c, t, f, flag, regs)[None, :]
        dterms_f = raw.dterms(p, c, t, f, flag, regs)[firsts]
        zfd = raw.zero_freq_dterms(t[firsts], omitted_probs(p), flag, regs)
        rowsum = torch.zeros((Jt.shape[0], n_circuits), dtype=Jt.dtype,
                             device=Jt.device).index_add_(1, seg, Jt)      # [P, C]
        ls_f = ls[firsts]
        tiny = torch.abs(ls_f) < 1e-100
        w = torch.where(tiny, 0.0, 0.5 / torch.where(tiny, 1.0, ls_f))
        Jw[:, firsts] = (Jt[:, firsts] * dterms_f[None, :]
                         - zfd[None, :] * rowsum[:, circs]) * w[None, :]
        return Jw

    return terms_of_p, lsvec_of_p, weighted_jac_t


def _forward_jacobian_fns(model, layout, sim, correction):
    """jtj_jtf and dlsvec from forward mode: the tangents of the model's
    tensors along each parameter (Tv's columns, in chunks of c) are pushed
    through the scan beside the states, ds <- G ds + dG s, then one Gram.
    dG s is formed for every op, [K1, B, c*d], and each row's op picked
    after: a layer then writes K1 * B * c * d numbers, not the
    B * c * d * d of gathered op tangents.  Chunks keep that under the
    device type's JVP_CHUNK_BYTES.  The tangent states are kept as [B, c, d], so that both
    products are batched matrix products without a transpose."""
    _, lsvec_of_p, weighted_jac_t = correction
    device, dim = sim.device, model.dim
    compute_flat = model.flat_tensors_fn()
    tensors_jacobian = model.flat_tensors_jacobian_fn()
    n_ops, n_preps = len(model.op_keys), len(model.prep_keys)
    o_sz, p_sz = n_ops * dim * dim, n_preps * dim
    idx = layout_tensors(layout, device)
    op_idx, prep_idx = idx['op_indices'], idx['prep_index']
    elem_row, elem_eff = idx['elem_circuit'], idx['elem_effect']
    B, D = op_idx.shape
    rows = torch.arange(B, device=device)
    per_tangent = (n_ops + 1) * max(B, 1) * dim * torch.finfo(DTYPE).bits // 8

    def probs_and_jac_t(v):
        """(p [E], Jt = dp / dv [P, E])."""
        tf, Tv = compute_flat(v), tensors_jacobian(v)
        G = torch.cat([tf[:o_sz].reshape(n_ops, dim, dim),
                       torch.eye(dim, dtype=v.dtype, device=device)[None]])
        preps = tf[o_sz:o_sz + p_sz].reshape(n_preps, dim)
        effects = tf[o_sz + p_sz:].reshape(-1, dim)
        chunk = max(1, JVP_CHUNK_BYTES[device.type] // per_tangent)
        Jt = []
        for j in range(0, v.shape[0], chunk):
            T = Tv[:, j:j + chunk]                                     # [NT, c]
            c = T.shape[1]
            # W[k, j', (c, i)] = dG[c, k, i, j'], the identity's slot zero
            W = torch.cat([T[:o_sz].reshape(n_ops, dim, dim, c).permute(0, 2, 3, 1),
                           torch.zeros((1, dim, c, dim), dtype=v.dtype, device=device)]
                          ).reshape(n_ops + 1, dim, c * dim)
            s = preps[prep_idx]                                        # [B, d]
            ds = T[o_sz:o_sz + p_sz].reshape(n_preps, dim, c).transpose(1, 2)[prep_idx]
            for t in range(D):                                         # ds: [B, c, d]
                Gt = G[op_idx[:, t]]                                   # [B, d, d]
                dGs = torch.matmul(s, W)[op_idx[:, t], rows]           # [B, c*d]
                ds = torch.bmm(ds, Gt.transpose(1, 2)) + dGs.view(B, c, dim)
                s = torch.bmm(Gt, s.unsqueeze(-1)).squeeze(-1)
            dE = T[o_sz + p_sz:].reshape(-1, dim, c)                   # [n_eff, d, c]
            Jt.append(torch.einsum('eic,ei->ce', dE[elem_eff], s[elem_row])
                      + torch.einsum('eci,ei->ce', ds[elem_row], effects[elem_eff]))
        return (effects[elem_eff] * s[elem_row]).sum(-1), torch.cat(Jt)

    @torch.no_grad()
    def jtj_jtf_fn(v, counts, totals, freqs, flag, regs):
        p, Jt = probs_and_jac_t(v)
        ls = lsvec_of_p(p, counts, totals, freqs, flag, regs)
        Jw = weighted_jac_t(Jt, p, ls, counts, totals, freqs, flag, regs)
        return ls, Jw @ Jw.T, Jw @ ls

    @torch.no_grad()
    def dlsvec_fn(v, counts, totals, freqs, flag, regs):
        p, Jt = probs_and_jac_t(v)
        ls = lsvec_of_p(p, counts, totals, freqs, flag, regs)
        return weighted_jac_t(Jt, p, ls, counts, totals, freqs, flag, regs).T

    return jtj_jtf_fn, dlsvec_fn


def _blocked_jacobian_fns(model, layout, sim, raw):
    """jtj_jtf and dlsvec from the blocked Jacobian (module note)."""
    device = sim.device
    compute_flat = model.flat_tensors_fn()
    tensors_jacobian = model.flat_tensors_jacobian_fn()
    dim = model.dim
    n_out = layout.num_elements // layout.op_indices.shape[0]
    n_ops = len(model.op_keys)
    n_preps = len(model.prep_keys)
    n_eff = sum(model.povms[k].num_outcomes for k in model.povm_keys)
    NT = n_ops * dim * dim + n_preps * dim + n_eff * dim
    o_sz, p_sz = n_ops * dim * dim, n_preps * dim
    j_dtype = DTYPE
    buckets, inv_perm = bucket_plan(layout, n_out, NT, device)

    def block_probs_jac(tf, bk):
        """(probs [nb*n_out], Jt [nb*n_out, NT]) for one row block:
        forward scan stashing the state before each layer, then the
        backward accumulation kernel bins per-op gradients."""
        ops = tf[:o_sz].reshape(n_ops, dim, dim).to(j_dtype)
        preps = tf[o_sz:o_sz + p_sz].reshape(n_preps, dim).to(j_dtype)
        effects = tf[o_sz + p_sz:].reshape(n_eff, dim).to(j_dtype)
        eye = torch.eye(dim, dtype=j_dtype, device=device)[None]
        G = torch.cat([ops, eye], dim=0)                  # [K+1, d, d]
        cols64 = bk['cols64']
        nb, Dk = cols64.shape
        E = effects[bk['eff']]                            # [nb, n_out, d]
        F = torch.empty((nb, Dk, dim), dtype=j_dtype, device=device)
        S = preps[bk['prep']]                             # [nb, d]
        for t in range(Dk):
            F[:, t] = S
            S = torch.bmm(G[cols64[:, t]], S.unsqueeze(-1)).squeeze(-1)
        A, B_final = bwd_jacobian_accumulate(bk['cols'], G, E, F)
        p = torch.einsum('bni,bi->bn', E, S)
        J_ops = A[:, :, :n_ops].reshape(nb, n_out, o_sz)
        prep_oh = torch.nn.functional.one_hot(bk['prep'], n_preps).to(j_dtype)
        J_preps = torch.einsum('br,bnj->bnrj', prep_oh, B_final).reshape(nb, n_out, p_sz)
        eff_oh = torch.nn.functional.one_hot(bk['eff'], n_eff).to(j_dtype)
        J_eff = torch.einsum('bne,bj->bnej', eff_oh, S).reshape(nb, n_out, n_eff * dim)
        Jt = torch.cat([J_ops, J_preps, J_eff], dim=2)
        return p.reshape(-1), Jt.reshape(nb * n_out, NT)

    def bucket_data(bk, counts, totals, freqs):
        pad = (bk['nk_pad'] - bk['nk']) * n_out
        idx = bk['elem_idx']
        return tuple(torch.nn.functional.pad(a[idx], (0, pad))
                     for a in (counts, totals, freqs))

    @torch.no_grad()
    def jtj_jtf_fn(v, counts, totals, freqs, flag, regs):
        tf = compute_flat(v)
        Tv = tensors_jacobian(v)                          # [NT, P]
        M = torch.zeros((NT, NT), dtype=v.dtype, device=device)
        q = torch.zeros(NT, dtype=v.dtype, device=device)
        ls_parts = []
        for bk in buckets:
            cb, tb, fb = bucket_data(bk, counts, totals, freqs)
            p, Jt = block_probs_jac(tf, bk)
            p = p.to(v.dtype)
            ls = raw.lsvec(p, cb, tb, fb, flag, regs)
            Jw = raw.dlsvec(p, cb, tb, fb, flag, regs).to(j_dtype)[:, None] * Jt
            # the per-bucket Gram runs at the Jacobian dtype, the sum across
            # buckets at the model dtype: float32 accumulation of the partial
            # Grams degraded LM convergence on the TPU (Nsigma 500 -> 1039)
            M += (Jw.T @ Jw).to(v.dtype)
            q += (Jw.T @ ls.to(j_dtype)).to(v.dtype)
            ls_parts.append(ls[:bk['nk'] * n_out])
        ls = torch.cat(ls_parts)[inv_perm]
        return ls, Tv.T @ (M @ Tv), Tv.T @ q

    @torch.no_grad()
    def dlsvec_fn(v, counts, totals, freqs, flag, regs):
        tf = compute_flat(v)
        Tv = tensors_jacobian(v).to(j_dtype)
        J_parts = []
        for bk in buckets:
            cb, tb, fb = bucket_data(bk, counts, totals, freqs)
            p, Jt = block_probs_jac(tf, bk)
            dls = raw.dlsvec(p.to(v.dtype), cb, tb, fb, flag, regs)
            Jb = ((dls.to(j_dtype)[:, None] * Jt) @ Tv).to(v.dtype)
            J_parts.append(Jb[:bk['nk'] * n_out])
        return torch.cat(J_parts, dim=0)[inv_perm]

    return jtj_jtf_fn, dlsvec_fn


def _objective_fns(model, layout, sim, raw, penalties, jac_mode):
    """The objective's functions of (v, counts, totals, freqs, flag, regs),
    plus 'probs' of v and the name of the Jacobian chosen."""
    jac_mode = choose_jac_mode(layout, jac_mode)
    probs_fn = sim.probs_fn(layout)
    correction = _omitted_correction(layout, raw, sim.device)
    terms_of_p, lsvec_of_p, _ = correction
    if jac_mode == 'blocked':
        jtj_jtf_fn, dlsvec_fn = _blocked_jacobian_fns(model, layout, sim, raw)
    else:
        jtj_jtf_fn, dlsvec_fn = _forward_jacobian_fns(model, layout, sim, correction)

    @torch.no_grad()
    def lsvec_fn(v, counts, totals, freqs, flag, regs):
        return lsvec_of_p(probs_fn(v), counts, totals, freqs, flag, regs)

    @torch.no_grad()
    def fn_fn(v, counts, totals, freqs, flag, regs):
        return terms_of_p(probs_fn(v), counts, totals, freqs, flag, regs).sum()

    fns = {'lsvec': lsvec_fn, 'fn': fn_fn, 'jtj_jtf': jtj_jtf_fn, 'dlsvec': dlsvec_fn}
    rf = penalties.get('regularize_factor', 0)
    if rf > 0:
        # J^T J gains rf^2 I, also where v = 0 and the rows' slope sign(v)
        # is 0: the JAX package's choice
        fns = _with_rows(fns, lambda v: rf * torch.abs(v),
                         lambda v: rf * torch.diag(torch.sign(v)),
                         lambda v, Jr: rf ** 2 * torch.eye(v.shape[0], dtype=v.dtype,
                                                           device=v.device))
    pen_fn = _make_penalty_fn(model, penalties)
    if pen_fn is not None:
        def pen_jac(v):
            with torch.enable_grad():
                return torch.autograd.functional.jacobian(pen_fn, v)
        fns = _with_rows(fns, pen_fn, pen_jac)
    fns['probs'] = probs_fn
    fns['jac_mode'] = jac_mode
    return fns


def _with_rows(fns, rows_fn, rows_jac, gram=lambda v, Jr: Jr.T @ Jr):
    """`fns` with residual rows rows_fn(v), of Jacobian rows_jac(v),
    appended (the regularization rows rf * |v| and the penalty rows), whose
    share of J^T J is gram(v, rows_jac(v))."""
    base = dict(fns)

    @torch.no_grad()
    def lsvec_fn(v, *args):
        return torch.cat([base['lsvec'](v, *args), rows_fn(v)])

    @torch.no_grad()
    def fn_fn(v, *args):
        return base['fn'](v, *args) + torch.sum(rows_fn(v) ** 2)

    @torch.no_grad()
    def jtj_jtf_fn(v, *args):
        ls, jtj, jtf = base['jtj_jtf'](v, *args)
        rows, Jr = rows_fn(v), rows_jac(v)
        return torch.cat([ls, rows]), jtj + gram(v, Jr), jtf + Jr.T @ rows

    @torch.no_grad()
    def dlsvec_fn(v, *args):
        return torch.cat([base['dlsvec'](v, *args), rows_jac(v)], dim=0)

    return {'lsvec': lsvec_fn, 'fn': fn_fn, 'jtj_jtf': jtj_jtf_fn, 'dlsvec': dlsvec_fn}
