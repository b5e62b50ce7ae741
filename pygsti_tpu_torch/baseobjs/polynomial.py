"""Sparse multivariate polynomials over model-parameter indices, with a
compact int-array "tape" form for bulk evaluation (counterpart of
pygsti_tpu/baseobjs/polynomial.py; tapes are evaluated by baseobjs/opcalc.py
in torch on a device).

Tape format (per polynomial, concatenatable):
  vtape = [n_terms, (n_vars, v0 <= v1 <= ...), ...]
  ctape = [coeff_term0, coeff_term1, ...]

Host Python: a Polynomial is a dict, built where a term simulator writes
symbolic results (orders above 2, the 'pruned' mode, one circuit at a time).
"""

from __future__ import annotations

import numpy as np


class Polynomial(dict):
    """A polynomial as {sorted-tuple-of-variable-indices: coefficient}.

    The empty tuple () keys the constant term.  Variables are identified by
    integer indices (a model's parameter indices); a repeated index denotes a
    power, e.g. {(0, 0): 2.0} = 2 x0^2.
    """

    def __init__(self, coeffs=None, max_num_vars=100):
        super().__init__()
        self.max_num_vars = max_num_vars
        if coeffs:
            for k, v in coeffs.items():
                self[tuple(sorted(k))] = v

    @property
    def coeffs(self):
        return dict(self)

    def degree(self):
        return max((len(k) for k in self.keys()), default=0)

    def evaluate(self, variable_values):
        ret = 0
        for ivar, coeff in self.items():
            term = coeff
            for i in ivar:
                term = term * variable_values[i]
            ret += term
        return ret

    def copy(self):
        return Polynomial(dict(self), self.max_num_vars)

    def map_indices(self, mapfn):
        return Polynomial({mapfn(k): v for k, v in self.items()},
                          self.max_num_vars)

    def map_indices_inplace(self, mapfn):
        new = {tuple(sorted(mapfn(k))): v for k, v in self.items()}
        self.clear()
        self.update(new)

    def mult(self, other):
        out = Polynomial(max_num_vars=self.max_num_vars)
        for k1, v1 in self.items():
            for k2, v2 in other.items():
                k = tuple(sorted(k1 + k2))
                out[k] = out.get(k, 0) + v1 * v2
        return out

    def scale(self, x):
        for k in self:
            self[k] *= x

    def scalar_mult(self, x):
        out = self.copy()
        out.scale(x)
        return out

    def add(self, other):
        out = self.copy()
        for k, v in other.items():
            out[k] = out.get(k, 0) + v
        return out

    def __add__(self, x):
        if isinstance(x, Polynomial):
            return self.add(x)
        out = self.copy()
        out[()] = out.get((), 0) + x
        return out

    __radd__ = __add__

    def __mul__(self, x):
        if isinstance(x, Polynomial):
            return self.mult(x)
        return self.scalar_mult(x)

    __rmul__ = __mul__

    def __pow__(self, n):
        ret = Polynomial({(): 1.0}, self.max_num_vars)
        cur = self
        while n > 0:
            if n % 2 == 1:
                ret = ret.mult(cur)
            cur = cur.mult(cur)
            n //= 2
        return ret

    def deriv(self, wrt_param):
        """Analytic derivative polynomial w.r.t. one variable index."""
        out = Polynomial(max_num_vars=self.max_num_vars)
        for ivar, coeff in self.items():
            cnt = ivar.count(wrt_param)
            if cnt:
                l = list(ivar)
                l.remove(wrt_param)
                k = tuple(l)
                out[k] = out.get(k, 0) + cnt * coeff
        return out

    def compact(self, complex_coeff_tape=True):
        """(vtape, ctape) in the bulk-evaluation format."""
        keys = sorted(self.keys())
        vtape = [len(keys)]
        ctape = []
        for k in keys:
            vtape.append(len(k))
            vtape.extend(k)
            ctape.append(self[k])
        v = np.array(vtape, np.int64)
        c = np.array(ctape, complex if complex_coeff_tape
                     else float)
        if not complex_coeff_tape:
            c = c.real
        return v, c

    def __str__(self):
        def fmt(k):
            if not k:
                return ""
            return "*" + "*".join("x%d" % i for i in k)
        return " + ".join("%s%s" % (c, fmt(k)) for k, c in sorted(self.items()))

    def __repr__(self):
        return "Poly[" + str(self) + "]"


def bulk_load_compact_polynomials(vtape, ctape, keep_compact=False,
                                  max_num_vars=100):
    """Inverse of concatenated Polynomial.compact() calls (reference:
    polynomial.py:698)."""
    result = []
    i = 0
    c = 0
    while i < vtape.size:
        if keep_compact:
            i2 = i
            n_terms = vtape[i2]; i2 += 1
            for _ in range(n_terms):
                n_vars = vtape[i2]
                i2 += n_vars + 1
            result.append((vtape[i:i2], ctape[c:c + n_terms]))
            i = i2; c += n_terms
        else:
            coeffs = {}
            n_terms = vtape[i]; i += 1
            for _ in range(n_terms):
                n_vars = vtape[i]; i += 1
                a = ctape[c]; c += 1
                coeffs[tuple(vtape[i:i + n_vars])] = a
                i += n_vars
            result.append(Polynomial(coeffs, max_num_vars))
    return result


def compact_polynomial_list(list_of_polys):
    """Single concatenated (vtape, ctape) from a list of Polynomials
    (reference: polynomial.py:752)."""
    tapes = [p.compact() for p in list_of_polys]
    vtape = np.concatenate([t[0] for t in tapes]) if tapes else \
        np.empty(0, np.int64)
    ctape = np.concatenate([t[1] for t in tapes]) if tapes else \
        np.empty(0, complex)
    return vtape, ctape


FASTPolynomial = Polynomial  # reference alias (polynomial.py:694)
