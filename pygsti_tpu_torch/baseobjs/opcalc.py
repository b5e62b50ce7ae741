"""Compact-polynomial tape evaluation in torch on a device (counterpart of
pygsti_tpu/baseobjs/opcalc.py, whose host C++ and Python loops it replaces).

A tape (baseobjs/polynomial.py) is parsed once on the host into one row per
term: its polynomial, its coefficient and its variables padded to the
largest degree (``CompactTape``).  On the device a value is then a gather of
the variables, a product along the row and an ``index_add_`` into the
polynomials; a derivative matrix scatters, for each variable slot of a
term, the product of the term's other factors into (polynomial, variable).
There is one implementation and no fallback: the work runs on `device`
(default "cuda"; "cpu" runs the same torch code on the host).
"""

from __future__ import annotations

import numpy as np
import torch


class CompactTape(object):
    """A concatenated tape parsed into per-term rows on `device`:
    ``poly`` [T] (index of each term's polynomial), ``coeff`` [T], the
    variables [T, max degree] (a padded slot points at a constant 1 one past
    the last parameter), ``num_polys``."""

    def __init__(self, vtape, ctape, device="cuda"):
        vtape = np.asarray(vtape, np.int64)
        ctape = np.asarray(ctape)
        polys, rows = [], []
        i = r = 0
        while i < vtape.size:
            n_terms = int(vtape[i])
            i += 1
            for _ in range(n_terms):
                n_vars = int(vtape[i])
                rows.append(vtape[i + 1:i + 1 + n_vars])
                polys.append(r)
                i += n_vars + 1
            r += 1
        if len(rows) != ctape.size:
            raise ValueError("the tapes disagree: %d terms for %d coefficients"
                             % (len(rows), ctape.size))
        self.num_polys = r
        self.max_var = int(max((v.max() for v in rows if v.size), default=-1))
        deg = max((v.size for v in rows), default=0)
        pad = np.full((len(rows), deg), -1, np.int64)
        for t, v in enumerate(rows):
            pad[t, :v.size] = v
        self.device = torch.device(device)
        self.degree = deg
        self._pad = pad
        self.poly = torch.as_tensor(np.asarray(polys, np.int64), device=self.device)
        self.coeff = torch.as_tensor(ctape, device=self.device)

    def _vars(self, n_params):
        """The padded variable rows with padding at index `n_params`."""
        if self.max_var >= n_params:
            raise ValueError("the tape names variable %d of a %d-parameter vector"
                             % (self.max_var, n_params))
        v = np.where(self._pad < 0, n_params, self._pad)
        return torch.as_tensor(v, device=self.device)

    def _operands(self, paramvec, complex_values):
        """(coefficients, parameters with a trailing 1) in complex128 or, for
        real values, the real parts in float64."""
        c = self.coeff
        if complex_values:
            dtype, c = torch.complex128, c.to(torch.complex128)
        else:
            dtype, c = torch.float64, (c.real if c.is_complex() else c).to(torch.float64)
            paramvec = np.real(paramvec)
        x = torch.as_tensor(paramvec, dtype=dtype, device=self.device)
        return c, torch.cat([x, torch.ones(1, dtype=dtype, device=self.device)])

    def evaluate(self, paramvec, complex_values=True):
        """The polynomials' values at `paramvec`, a tensor [num_polys]."""
        coeff, x = self._operands(paramvec, complex_values)
        terms = coeff * x[self._vars(len(x) - 1)].prod(dim=1)
        out = torch.zeros(self.num_polys, dtype=x.dtype, device=self.device)
        return out.index_add_(0, self.poly, terms)

    def derivatives(self, paramvec, wrt_params, complex_values=True):
        """d value / d x_w for each w of `wrt_params`: a tensor
        [num_polys, len(wrt_params)]."""
        coeff, x = self._operands(paramvec, complex_values)
        n = len(x) - 1
        vars_ = self._vars(n)
        full = torch.zeros(self.num_polys * (n + 1), dtype=x.dtype, device=self.device)
        factors = x[vars_]                                   # [T, deg]
        for k in range(self.degree):
            others = torch.cat([factors[:, :k], factors[:, k + 1:]], dim=1).prod(dim=1)
            # a padded slot points at column n, which is dropped below
            full.index_add_(0, self.poly * (n + 1) + vars_[:, k], coeff * others)
        full = full.view(self.num_polys, n + 1)
        wrt = torch.as_tensor(np.asarray(wrt_params, np.int64), device=self.device)
        return full[:, wrt]


def bulk_eval_compact_polynomials_complex(vtape, ctape, paramvec, dest_shape, device="cuda"):
    """Complex values of the tape's polynomials, a numpy array of `dest_shape`."""
    out = CompactTape(vtape, np.asarray(ctape, complex), device).evaluate(
        np.asarray(paramvec, complex), complex_values=True)
    return out.cpu().numpy().reshape(dest_shape)


def bulk_eval_compact_polynomials_real(vtape, ctape, paramvec, dest_shape, device="cuda"):
    """Real values (real parts of the coefficients and parameters)."""
    out = CompactTape(vtape, np.real(ctape), device).evaluate(
        np.real(paramvec), complex_values=False)
    return out.cpu().numpy().reshape(dest_shape)


def bulk_eval_compact_polynomials(vtape, ctape, paramvec, dest_shape, device="cuda"):
    if np.iscomplexobj(ctape):
        return bulk_eval_compact_polynomials_complex(vtape, ctape, paramvec, dest_shape, device)
    return bulk_eval_compact_polynomials_real(vtape, ctape, paramvec, dest_shape, device)


def abs_sum_bulk_eval_compact_polynomials_complex(vtape, ctape, paramvec, dest_size,
                                                 device="cuda"):
    return float(np.sum(np.abs(bulk_eval_compact_polynomials_complex(
        vtape, ctape, paramvec, (dest_size,), device))))


def compact_deriv(vtape, ctape, wrt_params):
    """Derivative tapes: for each input polynomial, d/dx_w for each w in
    `wrt_params`, concatenated poly-major (host; the same tapes as the JAX
    package's)."""
    from pygsti_tpu_torch.baseobjs.polynomial import (bulk_load_compact_polynomials,
                                                      compact_polynomial_list)
    polys = bulk_load_compact_polynomials(np.asarray(vtape), np.asarray(ctape))
    return compact_polynomial_list([p.deriv(int(w)) for p in polys for w in wrt_params])


def bulk_eval_compact_polynomials_derivs_complex(vtape, ctape, wrt_params, paramvec,
                                                 dest_shape, device="cuda"):
    """Evaluated derivative matrix [n_polys, len(wrt_params)] (the columns
    in sorted order of `wrt_params`, as the JAX package gives them)."""
    wrt = np.sort(np.asarray(wrt_params, np.int64))
    out = CompactTape(vtape, np.asarray(ctape, complex), device).derivatives(
        np.asarray(paramvec, complex), wrt, complex_values=True)
    return out.cpu().numpy().reshape(dest_shape)


def bulk_eval_compact_polynomials_derivs_real(vtape, ctape, wrt_params, paramvec,
                                              dest_shape, device="cuda"):
    return np.real(bulk_eval_compact_polynomials_derivs_complex(
        vtape, np.asarray(ctape, complex), wrt_params, paramvec, dest_shape, device))
