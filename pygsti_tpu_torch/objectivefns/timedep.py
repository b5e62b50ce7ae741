"""Time-resolved objective functions (counterpart of
pygsti_tpu/objectivefns/timedep.py).

For timestamped data each circuit's counts are grouped by timestamp, and
the model's probabilities are taken at every distinct time from its tensors
at that time (``ExplicitOpModel.tensors_fn_t``).  The elements are the JAX
package's, in its order: time-major (the sorted distinct times), then the
circuits with data at that time in list order, then the layout's outcomes
of each.  The per-element objective is the raw chi2 or Poisson-picture
logL of the time-independent case.

The Jacobian is the blocked one of the static objective, time by time: for
each distinct time t the flat tensors G(t) and Tv(t) = d tensors(t) / d v,
the forward scan and the backward accumulation kernel over the buckets of
the circuits with data at t (``objectivefns.block_probs_jac``), and one
chain through Tv(t); J^T J and J^T f are the sums over the times of
Tv(t)^T M_t Tv(t) and Tv(t)^T q_t, under the static objective's bucket
budget and chain-first rule.  The JAX package takes jax.jacfwd over all
rows instead.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from pygsti_tpu_torch import DTYPE
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.objectivefns.objectivefns import (
    JAC_BLOCK_BYTES, CG_MIN_PARAMS, RawChi2Function, RawPoissonPicDeltaLogLFunction,
    _switch_config, block_probs_jac, bucket_plan)


def time_groups(dataset, circuits):
    """{time: [(circuit index, {outcome: count})]} of `circuits`' rows: a
    time series grouped by timestamp (repetitions summed), a row without
    times at time 0.0."""
    groups = collections.OrderedDict()
    for ci, c in enumerate(circuits):
        row = dataset[c]
        if row.time is None:
            groups.setdefault(0.0, []).append((ci, dict(row.counts)))
            continue
        by_t = collections.OrderedDict()
        series = row.outcome_series
        reps = row.reps if row.reps is not None else [1] * len(series)
        for t, ol, rep in zip(row.time, series, reps):
            by_t.setdefault(float(t), collections.Counter())[ol] += rep
        for t, counter in by_t.items():
            groups.setdefault(t, []).append((ci, dict(counter)))
    return groups


class TimeDependentMDCObjectiveFunction(object):
    """Objective over timestamped data whose elements are (time, circuit,
    outcome), on `device`: ``fn``, ``lsvec`` and ``jtj_jtf`` as the LM
    optimizers consume them, and ``run_device_lm``, the device loop of
    SimplerLMOptimizer.  The model must be an ExplicitOpModel without
    instruments (one layout row per circuit)."""

    def __init__(self, raw_objfn, model, dataset, circuits, verbosity=0, device="cuda"):
        self.raw_objfn = raw_objfn
        self.model = model
        self.dataset = dataset
        self.circuits = list(circuits)
        self.device = torch.device(device)
        groups = time_groups(dataset, self.circuits)
        self.times = sorted(groups.keys())
        sim = SimpleForwardSimulator(model, self.device)
        layout = sim.create_layout(self.circuits)
        if layout.num_rows != len(self.circuits) or not layout.rows_uniform_n_out:
            raise NotImplementedError("the time-resolved objective takes one layout row of "
                                      "equally many outcomes per circuit (no instruments)")
        self.layout = layout
        n_out = layout.num_elements // layout.num_rows

        # flat element data over all (time, circuit) rows, the JAX package's order
        counts, totals, self._rows_at, self._loc = [], [], [], []
        for t in self.times:
            present = dict(groups[t])
            rows = sorted(present)
            loc = np.full(layout.num_elements, -1, dtype=np.int64)
            for ci in rows:
                cnts = present[ci]
                total = sum(cnts.values())
                sl = layout.element_slices[ci]
                loc[sl] = len(counts) + np.arange(sl.stop - sl.start)
                counts.extend(cnts.get(outcome, 0) for outcome in layout.outcomes[ci])
                totals.extend([total] * (sl.stop - sl.start))
            self._rows_at.append(np.asarray(rows, dtype=np.int64))
            self._loc.append(loc)
        self.counts = np.asarray(counts, dtype=float)
        self.total_counts = np.asarray(totals, dtype=float)
        with np.errstate(invalid='ignore', divide='ignore'):
            self.freqs = np.where(self.total_counts > 0,
                                  self.counts / np.maximum(self.total_counts, 1), 0.0)
        self.num_elements = len(counts)
        self._data = tuple(torch.as_tensor(a, dtype=DTYPE, device=self.device)
                           for a in (self.counts, self.total_counts, self.freqs))
        # each time's layout elements, ascending (its share of the flat vector)
        self._elems = [torch.as_tensor(np.flatnonzero(loc >= 0), device=self.device)
                       for loc in self._loc]
        self._raw, self._flag, self._regs = _switch_config(raw_objfn)
        self._probs_fn = sim.probs_fn(layout)
        self._flat = model.flat_tensors_fn_t()
        self._tensors_jacobian = model.flat_tensors_jacobian_fn_t()

        dim = model.dim
        self._sizes = (dim, len(model.op_keys), len(model.prep_keys),
                       sum(model.povms[k].num_outcomes for k in model.povm_keys), n_out)
        NT = self._sizes[1] * dim * dim + (self._sizes[2] + self._sizes[3]) * dim
        # each time's buckets (the rows with data then), one plan per row set,
        # and where each bucket's elements sit in the flat vector
        plans = {}
        self._buckets = []
        for rows, loc in zip(self._rows_at, self._loc):
            key = rows.tobytes()
            if key not in plans:
                plans[key] = bucket_plan(layout, n_out, NT, self.device, rows=rows)[0]
            self._buckets.append([
                (bk, torch.as_tensor(loc[bk['elem_idx'].cpu().numpy()[:bk['nk'] * n_out]],
                                     device=self.device))
                for bk in plans[key]])
        self._chain_first = NT * NT * torch.finfo(DTYPE).bits // 8 > JAC_BLOCK_BYTES \
            and model.num_params < NT
        self.num_buckets = sum(len(b) for b in self._buckets)

    def _v(self, paramvec):
        v = paramvec if paramvec is not None else self.model.to_vector()
        return torch.as_tensor(v, dtype=DTYPE, device=self.device)

    @torch.no_grad()
    def _probs(self, v):
        return torch.cat([self._probs_fn(v, t)[elems]
                          for t, elems in zip(self.times, self._elems)])

    @torch.no_grad()
    def _lsvec(self, v):
        c, tot, f = self._data
        return self._raw.lsvec(self._probs(v), c, tot, f, self._flag, self._regs)

    @torch.no_grad()
    def _jtj_jtf(self, v):
        """(lsvec, J^T J, J^T lsvec), time by time through the kernel."""
        c, tot, f = self._data
        raw, flag, regs = self._raw, self._flag, self._regs
        n_out = self._sizes[-1]
        P = v.shape[0]
        ls_all = torch.empty(self.num_elements, dtype=v.dtype, device=v.device)
        jtj = torch.zeros((P, P), dtype=v.dtype, device=v.device)
        jtf = torch.zeros(P, dtype=v.dtype, device=v.device)
        for t, buckets in zip(self.times, self._buckets):
            tf = self._flat(v, t)
            Tv = self._tensors_jacobian(v, t)                 # [NT, P]
            side = P if self._chain_first else Tv.shape[0]
            M = torch.zeros((side, side), dtype=v.dtype, device=v.device)
            q = torch.zeros(side, dtype=v.dtype, device=v.device)
            for bk, gidx in buckets:
                pad = (bk['nk_pad'] - bk['nk']) * n_out
                cb, tb, fb = (torch.nn.functional.pad(a[gidx], (0, pad)) for a in (c, tot, f))
                p, Jt = block_probs_jac(tf, bk, *self._sizes)
                p = p.to(v.dtype)
                ls = raw.lsvec(p, cb, tb, fb, flag, regs)
                Jw = raw.dlsvec(p, cb, tb, fb, flag, regs).to(DTYPE)[:, None] * Jt
                if self._chain_first:
                    Jw = Jw @ Tv.to(DTYPE)
                M += (Jw.T @ Jw).to(v.dtype)
                q += (Jw.T @ ls.to(DTYPE)).to(v.dtype)
                ls_all[gidx] = ls[:len(gidx)]
            if self._chain_first:
                jtj += M
                jtf += q
            else:
                jtj += Tv.T @ (M @ Tv)
                jtf += Tv.T @ q
        return ls_all, jtj, jtf

    def fn(self, paramvec=None):
        c, tot, f = self._data
        with torch.no_grad():
            p = self._probs(self._v(paramvec))
            return float(self._raw.terms(p, c, tot, f, self._flag, self._regs).sum())

    def lsvec(self, paramvec=None, oob_check=False):
        return self._lsvec(self._v(paramvec)).cpu().numpy()

    def jtj_jtf(self, paramvec=None):
        ls, jtj, jtf = self._jtj_jtf(self._v(paramvec))
        return ls.cpu().numpy(), jtj.cpu().numpy(), jtf.cpu().numpy()

    def probs(self, paramvec=None):
        """The elements' probabilities, in element order."""
        return self._probs(self._v(paramvec)).cpu().numpy()

    def run_device_lm(self, x0, maxiter=100, tol=None, linesearch=None, oob_check_interval=0,
                      solver=None):
        """The Levenberg-Marquardt loop on the objective's device, as the
        static objective's (returns x, converged, msg, mu, nu, norm_f, f,
        iterations).  No point is out of bounds."""
        from pygsti_tpu_torch.optimize.device_lm import make_device_lm, EXIT_MESSAGES
        tol = tol or {}
        linesearch = linesearch or {}
        if solver is None:
            solver = 'cg' if len(x0) >= CG_MIN_PARAMS else 'cholesky'
        lm_init, lm_run, lm_finalize = make_device_lm(
            self._jtj_jtf, self._lsvec, ls_beta=linesearch.get('beta', 0.25),
            ls_max_evals=linesearch.get('max_evals', 6), ls_kappa=linesearch.get('kappa', 1.0),
            solver=solver)
        maxdx = tol.get('maxdx', 1.0)
        tols = (tol.get('f', 1.0), tol.get('jac', 1e-6), tol.get('relf', 1e-6),
                tol.get('relx', 1e-8), (maxdx ** 2) * len(x0) if maxdx else float('inf'))
        state = lm_run(lm_init(self._v(x0), oob_interval=oob_check_interval), maxiter, tols)
        x, f, norm_f, mu, nu, code, k = lm_finalize(state, maxiter)
        return (x, code in (1, 2, 3, 4, 5), EXIT_MESSAGES.get(code, "exit code %d" % code),
                mu, nu, norm_f, f, k)

    def chi2k_distributed_qty(self, val):
        return self.raw_objfn.chi2k_distributed_qty(val)


def TimeDependentChi2Function(model, dataset, circuits, regularization=None, device="cuda"):
    return TimeDependentMDCObjectiveFunction(
        RawChi2Function(regularization), model, dataset, circuits, device=device)


def TimeDependentPoissonPicLogLFunction(model, dataset, circuits, regularization=None,
                                        device="cuda"):
    return TimeDependentMDCObjectiveFunction(
        RawPoissonPicDeltaLogLFunction(regularization), model, dataset, circuits,
        device=device)
