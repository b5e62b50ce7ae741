"""Wildcard budgets: per-operation TVD slack that accounts for error the
model does not capture (counterpart of pygsti_tpu/objectivefns/wildcardbudget.py).

A circuit's budget W is the sum of its layers' budgets (plus SPAM's).  Its
probabilities q move toward the frequencies f within the TVD ball of radius
W, to the point of highest likelihood: the lowest ratios q/f rise to a
common alpha f, the highest fall to a common beta f, outcomes never seen
give up their mass first (the water-fill).  The JAX package fills one
circuit at a time in a Python loop; here ``waterfill`` fills every circuit
at once on the device -- outcomes padded to the widest circuit, one sort of
the ratios per row, cumulative sums for the raised set A and the lowered
set B, the zero-frequency and the ``tvd0 <= W`` branches as masks -- and
equals the JAX package's per-circuit result element for element.  An
objective evaluation of the optimizers below is then one water-fill and one
sum of terms on the device and one scalar read.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from pygsti_tpu_torch import DTYPE
from pygsti_tpu_torch.baseobjs.label import Label


def waterfill(q, f, W, valid=None, return_deriv=False):
    """The likelihood-optimal move of probabilities q [C, n] toward
    frequencies f [C, n] within TVD budgets W [C], for every circuit (row)
    at once: p maximizes sum_o f_o log p_o subject to 0.5 sum |p - q| <= W
    and sum p = sum q.  `valid` [C, n] marks real outcomes (padding is
    left as it is).  With `return_deriv`, also dp/dW at the active sets."""
    n = q.shape[1]
    valid = torch.ones_like(q, dtype=torch.bool) if valid is None else valid
    zero, inf = torch.zeros_like(q), torch.full_like(q, float('inf'))
    W = W[:, None]
    pos = valid & (f > 0)
    zset = valid & ~pos & (q > 0)            # no counts: their mass goes first
    # branch 1: no budget
    tiny = W <= 1e-15
    # branch 2: the budget covers the whole distance: p = f, the mass
    # difference put on the outcomes with no counts (or spread evenly)
    tvd0 = 0.5 * torch.where(valid, torch.abs(q - f), zero).sum(1, keepdim=True)
    covered = tvd0 <= W + 1e-15
    extra = torch.where(valid, q, zero).sum(1, keepdim=True) \
        - torch.where(valid, f, zero).sum(1, keepdim=True)
    zmask = valid & (f <= 0)
    nz = zmask.sum(1, keepdim=True)
    n_valid = valid.sum(1, keepdim=True)
    on_zeros = (extra > 0) & (nz > 0)
    share = torch.where(on_zeros, extra / torch.clamp(nz, min=1), extra / n_valid)
    p_cov = torch.where((torch.abs(extra) > 1e-15) & (zmask | ~on_zeros) & valid, f + share, f)
    p_cov = torch.where(valid, p_cov, q)

    # branch 3: raise the lowest ratios, lower the zero-count outcomes, then
    # the highest ratios; the positive-frequency outcomes sorted by q/f
    # (stable, as numpy's argsort of the JAX package)
    ratio = torch.where(pos, q / torch.where(pos, f, torch.ones_like(f)), inf)
    r_sorted, order = torch.sort(ratio, dim=1, stable=True)
    npos = pos.sum(1, keepdim=True)
    ks = torch.arange(1, n + 1, device=q.device)[None, :]          # prefix sizes
    in_pos = ks <= npos
    fs = torch.where(in_pos, torch.gather(f, 1, order), zero)
    qs = torch.where(in_pos, torch.gather(q, 1, order), zero)
    CF, CQ = torch.cumsum(fs, 1), torch.cumsum(qs, 1)
    alpha_k = (CQ + W) / torch.where(CF > 0, CF, torch.ones_like(CF))
    # A grows while alpha passes the next ratio: ia = 1 + leading passes
    r_next = torch.cat([r_sorted[:, 1:], inf[:, :1]], 1)
    grow = (ks < npos) & (alpha_k > r_next)
    ia = 1 + torch.cumprod(grow.to(torch.int64), 1).sum(1, keepdim=True)
    alpha = torch.gather(alpha_k, 1, ia - 1)
    FA = torch.gather(CF, 1, ia - 1)
    raise_s = ks <= ia
    p_s = torch.where(raise_s & in_pos, alpha * fs, qs)
    dp_s = torch.where(raise_s & in_pos, fs / FA, zero)
    # the outcomes with no counts
    QZ = torch.where(zset, q, zero).sum(1, keepdim=True)
    lower_done = QZ >= W
    W_lower = W - torch.minimum(QZ, W)
    # B grows from the highest ratio down while beta stays below the next
    # one: suffix sums, counted from the top of the positive outcomes
    ridx = torch.clamp(npos - ks, min=0)                             # [C, n]
    fr = torch.where(in_pos, torch.gather(fs, 1, ridx), zero)
    qr = torch.where(in_pos, torch.gather(qs, 1, ridx), zero)
    FB_k, QB_k = torch.cumsum(fr, 1), torch.cumsum(qr, 1)
    beta_k = (QB_k - W_lower) / torch.where(FB_k > 0, FB_k, torch.ones_like(FB_k))
    r_below = torch.gather(r_sorted, 1, torch.clamp(npos - ks - 1, min=0))
    shrink = (ks < npos - ia) & (beta_k < r_below)
    ib = 1 + torch.cumprod(shrink.to(torch.int64), 1).sum(1, keepdim=True)
    beta = torch.gather(beta_k, 1, ib - 1)
    FB = torch.gather(FB_k, 1, ib - 1)
    lower = ~lower_done & (W_lower > 1e-18)
    lower_s = lower & (ks > npos - ib) & in_pos
    p_s = torch.where(lower_s, beta * fs, p_s)
    dp_s = torch.where(lower_s, -fs / torch.where(lower, FB, torch.ones_like(FB)), dp_s)
    p3 = torch.zeros_like(q).scatter(1, order, p_s)
    dp3 = torch.zeros_like(q).scatter(1, order, dp_s)
    scale_z = 1.0 - W / torch.where(QZ > 0, QZ, torch.ones_like(QZ))
    p3 = torch.where(zset, torch.where(lower_done, q * scale_z, zero), p3)
    dp3 = torch.where(zset & lower_done, -q / torch.where(QZ > 0, QZ, torch.ones_like(QZ)),
                      dp3)
    p3 = torch.where(valid & ~pos & ~zset, q, p3)
    p3 = torch.where(valid, p3, q)

    p = torch.where(tiny, q, torch.where(covered, p_cov, p3))
    if not return_deriv:
        return p
    return p, torch.where(tiny | covered | ~valid, zero, dp3)


def _waterfill(q, f, W, return_deriv=False):
    """One circuit's water-fill, as the JAX package's function of that
    name: numpy in, numpy out."""
    out = waterfill(torch.as_tensor(np.asarray(q, dtype=float))[None],
                    torch.as_tensor(np.asarray(f, dtype=float))[None],
                    torch.as_tensor([float(W)], dtype=DTYPE), return_deriv=return_deriv)
    if return_deriv:
        return out[0][0].numpy(), out[1][0].numpy()
    return out[0].numpy()


def padded_rows(element_slices, device):
    """(rows, valid): rows [C, n] indexes each circuit's elements, padded
    to the widest circuit with the index E of a zero slot appended to any
    element vector (see ``as_rows``)."""
    sizes = [sl.stop - sl.start for sl in element_slices]
    E = element_slices[-1].stop if sizes else 0
    index = np.full((len(sizes), max(sizes, default=0)), E, dtype=np.int64)
    for i, sl in enumerate(element_slices):
        index[i, :sizes[i]] = np.arange(sl.start, sl.stop)
    index = torch.as_tensor(index, device=device)
    return index, index < E


def as_rows(x, rows):
    """The element vector x [E] as padded rows [C, n] (zero in the padding)."""
    return torch.cat([x, x.new_zeros(1)])[rows]


class WaterfillPlan(object):
    """The layout's elements as padded rows, one per circuit, with each
    circuit's budget as a linear function of the budget's |w|: built once
    on `device`, then ``update(probs, w)`` water-fills every circuit."""

    def __init__(self, budget, element_slices, circuits, freqs, device="cuda"):
        self.device = torch.device(device)
        self.index, self.valid = padded_rows(element_slices, self.device)
        self.budget_matrix = torch.as_tensor(budget._budget_matrix(circuits), dtype=DTYPE,
                                             device=self.device)
        self.freqs = as_rows(torch.as_tensor(np.asarray(freqs), dtype=DTYPE,
                                             device=self.device), self.index)

    def circuit_budgets(self, w):
        return self.budget_matrix @ torch.abs(torch.as_tensor(np.asarray(w, dtype=float),
                                                              dtype=DTYPE, device=self.device))

    def update(self, probs, w, return_deriv=False):
        """(probs moved within each circuit's budget [E], dp/dW [E] or
        None) for budget values `w` (the budget's wildcard_vector)."""
        probs = torch.as_tensor(probs, dtype=DTYPE, device=self.device)
        out = waterfill(as_rows(probs, self.index), self.freqs, self.circuit_budgets(w),
                        self.valid, return_deriv)
        p, dp = out if return_deriv else (out, None)
        flat = self.index[self.valid]
        new = torch.empty_like(probs)
        new[flat] = p[self.valid]
        if dp is None:
            return new, None
        dnew = torch.zeros_like(probs)
        dnew[flat] = dp[self.valid]
        return new, dnew


class PrimitiveOpsWildcardBudget(object):
    """A budget |w| per primitive operation (and 'SPAM'); an operation not
    listed takes SPAM's."""

    def __init__(self, primitive_op_labels, start_budget=0.0, idle_name=None):
        self.primitive_op_labels = list(primitive_op_labels)
        self.wildcard_vector = np.full(len(self.primitive_op_labels), float(start_budget))
        self._index = {lbl: i for i, lbl in enumerate(self.primitive_op_labels)}

    @property
    def num_params(self):
        return len(self.wildcard_vector)

    def to_vector(self):
        return self.wildcard_vector.copy()

    def from_vector(self, v):
        self.wildcard_vector = np.asarray(v, dtype=float).copy()

    def budget_for(self, op_label):
        if op_label in self._index:
            return abs(self.wildcard_vector[self._index[op_label]])
        if 'SPAM' in self._index:
            return abs(self.wildcard_vector[self._index['SPAM']])
        return 0.0

    def circuit_budget(self, circuit):
        """The sum of the layers' budgets, plus SPAM's when listed."""
        return float(self._budget_matrix([circuit])[0] @ np.abs(self.wildcard_vector))

    def _budget_matrix(self, circuits):
        """[C, n_labels]: how often each label's |w| enters each circuit's
        budget (circuit_budget's rule: an empty layer is Label(()), a label
        not listed counts as 'SPAM' when that is listed)."""
        spam = self._index.get('SPAM')
        A = np.zeros((len(circuits), len(self.primitive_op_labels)))
        for i, c in enumerate(circuits):
            for layer in c.layertup:
                comps = layer.components if not layer.is_simple else (layer,)
                for comp in (comps if len(comps) else (Label(()),)):
                    j = self._index.get(Label(comp), spam)
                    if j is not None:
                        A[i, j] += 1
            if spam is not None:
                A[i, spam] += 1
        return A

    def update_probs(self, probs, freqs, counts, total_counts, element_slices, circuits,
                     return_deriv=False, device="cuda"):
        """Each circuit's probabilities moved toward its frequencies within
        its budget (the water-fill, all circuits at once on `device`)."""
        plan = WaterfillPlan(self, element_slices, circuits, freqs, device)
        p, dp = plan.update(np.asarray(probs, dtype=float), self.wildcard_vector, return_deriv)
        if return_deriv:
            return p.cpu().numpy(), dp.cpu().numpy()
        return p.cpu().numpy()

    def precompute_for_same_circuits(self, circuits):
        """[C, num_params]: d(circuit budget) / d(|w|), the JAX package's
        occurrence counts (an empty layer counts only when Label(()) is
        listed)."""
        return self._occurrence_matrix(circuits)

    def _occurrence_matrix(self, circuits):
        A = np.zeros((len(circuits), len(self.primitive_op_labels)))
        spam = self._index.get('SPAM')
        for i, c in enumerate(circuits):
            for layer in c.layertup:
                comps = layer.components if not layer.is_simple else (layer,)
                if len(comps) == 0 and Label(()) in self._index:
                    A[i, self._index[Label(())]] += 1
                for comp in comps:
                    j = self._index.get(Label(comp), spam)
                    if j is not None:
                        A[i, j] += 1
            if spam is not None:
                A[i, spam] += 1
        return A

    def description(self):
        return collections.OrderedDict((lbl, abs(w)) for lbl, w in
                                       zip(self.primitive_op_labels, self.wildcard_vector))

    def __str__(self):
        return "Wildcard budget: " + ", ".join(
            "%s: %.3g" % (lbl, abs(w))
            for lbl, w in zip(self.primitive_op_labels, self.wildcard_vector))


class PrimitiveOpsSingleScaleWildcardBudget(PrimitiveOpsWildcardBudget):
    """A one-parameter budget: alpha times reference values (per-operation
    diamond distances, say)."""

    def __init__(self, primitive_op_labels, reference_values, alpha=0.0, idle_name=None,
                 reference_name='diamond distance'):
        super().__init__(primitive_op_labels, 0.0, idle_name)
        self.reference_values = np.asarray(reference_values, dtype=float)
        self.reference_name = reference_name
        self.alpha = alpha

    @property
    def alpha(self):
        return self._alpha

    @alpha.setter
    def alpha(self, val):
        self._alpha = float(val)
        self.wildcard_vector = self._alpha * self.reference_values

    @property
    def num_params(self):
        return 1

    def to_vector(self):
        return np.array([self._alpha])

    def from_vector(self, v):
        self.alpha = float(v[0])

    def precompute_for_same_circuits(self, circuits):
        return (self._occurrence_matrix(circuits) @ self.reference_values)[:, None]


# the JAX package's names for the base classes
WildcardBudget = PrimitiveOpsWildcardBudget
PrimitiveOpsWildcardBudgetBase = PrimitiveOpsWildcardBudget


class _WildcardObjective(object):
    """An objective's probabilities and data on its device, with the
    water-fill plan of `budget`, for the optimizers' evaluations; counts
    each evaluation in ``evaluations``."""

    def __init__(self, objective, budget):
        dev = objective.device
        self.objective = objective
        self.probs = torch.as_tensor(objective.probs(), dtype=DTYPE, device=dev)
        self.counts, self.totals, self.freqs = (
            torch.as_tensor(a, dtype=DTYPE, device=dev)
            for a in (objective.counts, objective.total_counts, objective.freqs))
        self.plan = WaterfillPlan(budget, objective.layout.element_slices,
                                  objective.layout.circuits, objective.freqs, dev)
        self.budget = budget
        self.evaluations = 0

    def moved(self, return_deriv=False):
        self.evaluations += 1
        return self.plan.update(self.probs, self.budget.wildcard_vector, return_deriv)

    def raw_two_dlogl(self):
        """2 sum of the objective's raw terms at the moved probabilities."""
        p, _ = self.moved()
        return 2 * float(self.objective.raw_objfn.terms(p, self.counts, self.totals,
                                                        self.freqs).sum())

    def clipped_two_dlogl(self, p=None):
        """2 Delta logL with probabilities clipped at 1e-10 and each term
        at 0 (the Nelder-Mead and barrier objectives of the JAX package)."""
        if p is None:
            p, _ = self.moved()
        return 2 * float(clipped_logl_terms(p, self.counts, self.totals, self.freqs).sum())


def clipped_logl_terms(p, n, N, f, min_p=1e-10):
    """The Poisson-picture 2 Delta logL terms / 2 with p clipped below at
    min_p and each term at 0."""
    f_nz = torch.where(n == 0, torch.ones_like(f), f)
    p_cl = torch.clamp(p, min=min_p)
    terms = torch.where(n == 0, N * p_cl, n * (torch.log(f_nz) - torch.log(p_cl)) + N * (p_cl - f))
    return torch.clamp(terms, min=0)


def optimize_wildcard_budget_1d(objective, budget, two_dlogl_threshold, redbox_threshold=None,
                                tol=1e-4, max_iters=50):
    """The least alpha (by bisection, to `tol` relative) at which the
    wildcard-adjusted 2 Delta logL is at or below the threshold.  The
    evaluations are counted in ``budget.evaluations``."""
    wo = _WildcardObjective(objective, budget)

    def two_dlogl_at(alpha):
        budget.alpha = alpha
        return wo.raw_two_dlogl()

    try:
        if two_dlogl_at(0.0) <= two_dlogl_threshold:
            budget.alpha = 0.0
            return budget
        lo, hi = 0.0, 1.0
        while two_dlogl_at(hi) > two_dlogl_threshold and hi < 1e3:
            hi *= 2
        for _ in range(max_iters):
            mid = 0.5 * (lo + hi)
            if two_dlogl_at(mid) > two_dlogl_threshold:
                lo = mid
            else:
                hi = mid
            if hi - lo < tol * max(hi, 1e-10):
                break
        budget.alpha = hi
        return budget
    finally:
        budget.evaluations = wo.evaluations


def optimize_wildcard_budget_neldermead(objective, budget, two_dlogl_threshold,
                                        redbox_threshold=None, l1_penalty=1e-2, tol=1e-6,
                                        max_iters=500):
    """Minimize sum |w| + 1e3 max(0, 2 Delta logL(w) - threshold) by
    Nelder-Mead on the host from w = 1e-3; each evaluation is one water-fill
    and one sum on the objective's device.  The evaluations are counted in
    ``budget.evaluations``."""
    import scipy.optimize as spo
    wo = _WildcardObjective(objective, budget)

    def penalized(vec):
        budget.from_vector(vec)
        excess = wo.clipped_two_dlogl() - two_dlogl_threshold
        return float(np.sum(np.abs(vec))) + (0.0 if excess <= 0 else 1e3 * excess)

    res = spo.minimize(penalized, np.full(budget.num_params, 1e-3), method='Nelder-Mead',
                       options={'maxiter': max_iters, 'xatol': tol, 'fatol': tol})
    budget.from_vector(np.abs(res.x))
    budget.evaluations = wo.evaluations
    return budget


def update_circuit_probs(probs, freqs, circuit_budget, circuit=None):
    """One circuit's probabilities moved toward its frequencies within the
    budget."""
    return _waterfill(probs, freqs, circuit_budget)
