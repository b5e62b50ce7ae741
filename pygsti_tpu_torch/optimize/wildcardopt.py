"""Wildcard-budget optimizers (counterpart of pygsti_tpu/optimize/wildcardopt.py).

Over the budget vector x >= 0:
  * ``optimize_wildcard_budget_barrier``: a log-barrier interior-point
    Newton method for  min L1weights . x  subject to 2 Delta logL(p(x)) <=
    threshold (aggregate), W_c(x) >= the critical budget of every circuit
    c (red box), x >= 0, with the gradient and Hessian through the
    water-filled probabilities;
  * ``optimize_wildcard_budget_percircuit_only_cvxpy``: the red-box
    constraints alone, a linear program (scipy's HiGHS; no cvxpy);
  * ``optimize_wildcard_bisect_alpha``: the one-parameter bisection.
The per-circuit quantities (critical budgets by bisection, the chain rule
through dp/dW) are batched over circuits on the objective's device; the
Newton steps over the few budget parameters run on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from pygsti_tpu_torch import DTYPE
from pygsti_tpu_torch.objectivefns.wildcardbudget import (  # noqa: F401 (re-exported)
    _WildcardObjective, _waterfill, as_rows, clipped_logl_terms, optimize_wildcard_budget_1d,
    optimize_wildcard_budget_neldermead, padded_rows, update_circuit_probs, waterfill)


def _data(objfn):
    dev = objfn.device
    return tuple(torch.as_tensor(np.asarray(a), dtype=DTYPE, device=dev)
                 for a in (objfn.counts, objfn.total_counts, objfn.freqs))


def _circuit_sums(objfn, x):
    """Per circuit sums of the per-element x."""
    lay = objfn.layout
    seg = torch.as_tensor(lay.elem_to_circuit, dtype=torch.int64, device=x.device)
    return torch.zeros(len(lay.circuits), dtype=x.dtype, device=x.device).index_add_(0, seg, x)


def _get_critical_circuit_budgets(objfn, redbox_threshold):
    """Per circuit, the budget at which its 2 Delta logL falls to the
    red-box threshold: 0 where it is already there, else bisection on
    [0, 1] to 1e-6 -- every circuit at once, each step one water-fill."""
    n, N, f = _data(objfn)
    dev = n.device
    q = torch.as_tensor(np.asarray(objfn.probs()), dtype=DTYPE, device=dev)
    index, valid = padded_rows(objfn.layout.element_slices, dev)
    C = index.shape[0]
    Q, F, Nr, Nc = (as_rows(x, index) for x in (q, f, N, n))

    def two_dlogl(W):
        p = waterfill(Q, F, W, valid)
        return 2 * torch.where(valid, clipped_logl_terms(p, Nc, Nr, F),
                               torch.zeros_like(p)).sum(1)

    lb = torch.zeros(C, dtype=DTYPE, device=dev)
    need = (Nr.sum(1) > 0) & (two_dlogl(lb) > redbox_threshold)
    ub = torch.ones(C, dtype=DTYPE, device=dev)
    while float((ub - lb).max()) > 1e-6:
        mid = 0.5 * (ub + lb)
        below = two_dlogl(mid) < redbox_threshold
        ub = torch.where(below, mid, ub)
        lb = torch.where(below, lb, mid)
    return torch.where(need, 0.5 * (ub + lb), torch.zeros_like(lb)).cpu().numpy()


def _agg_dlogl(current_probs, objfn, two_dlogl_threshold):
    """2 Delta logL (clipped terms) at the probabilities, less the threshold."""
    n, N, f = _data(objfn)
    p = torch.as_tensor(np.asarray(current_probs), dtype=DTYPE, device=n.device) \
        if not torch.is_tensor(current_probs) else current_probs
    return 2 * float(clipped_logl_terms(p, n, N, f).sum()) - two_dlogl_threshold


def _agg_dlogl_deriv(current_probs, objfn, percircuit_budget_deriv, dp_dW):
    """d (2 Delta logL) / dx through each circuit's budget: per circuit
    2 sum dterms dp/dW, then the chain through dW_c/dx."""
    n, N, _ = _data(objfn)
    p, dp = (torch.as_tensor(np.asarray(a), dtype=DTYPE, device=n.device)
             if not torch.is_tensor(a) else a for a in (current_probs, dp_dW))
    dlogl_dp = torch.where(n == 0, N, N - n / torch.clamp(p, min=1e-10))
    dW = 2 * _circuit_sums(objfn, dlogl_dp * dp).cpu().numpy()
    return dW @ percircuit_budget_deriv


def _agg_dlogl_hessian(current_probs, objfn, percircuit_budget_deriv, dp_dW):
    """The Gauss-Newton directional Hessian: per circuit 2 sum hterms
    (dp/dW)^2 (1e100 where that overflows), chained through dW_c/dx."""
    n, N, _ = _data(objfn)
    p, dp = (torch.as_tensor(np.asarray(a), dtype=DTYPE, device=n.device)
             if not torch.is_tensor(a) else a for a in (current_probs, dp_dW))
    hterms = torch.where(n == 0, torch.zeros_like(n), n / torch.clamp(p, min=1e-10) ** 2)
    hW = 2 * _circuit_sums(objfn, hterms * dp ** 2).cpu().numpy()
    hW[~np.isfinite(hW)] = 1e100
    return percircuit_budget_deriv.T @ (hW[:, None] * percircuit_budget_deriv)


def NewtonSolve(initial_x, fn, fn_with_derivs=None, dx_tol=1e-6, max_iters=20, printer=None,
                lmbda=0.0):
    """Damped Newton with backtracking on the iterates clipped to x >= 0."""
    x = initial_x.copy()
    x_list = [x.copy()]
    I = np.identity(len(x))
    i = 0
    while i < max_iters:
        obj, Dobj, Hobj = fn_with_derivs(x)
        Hobj = (Hobj + Hobj.T) / 2
        if not (np.all(np.isfinite(Hobj)) and np.all(np.isfinite(Dobj))):
            break    # the boundary of the feasible region: stop here
        if np.linalg.matrix_rank(Hobj) < Hobj.shape[0]:
            dx = -Dobj / max(np.linalg.norm(Dobj), 1e-300)
        else:
            dx = -np.dot((1 - lmbda) * np.linalg.inv(Hobj) + lmbda * I, Dobj)
        with np.errstate(divide='ignore', invalid='ignore'):
            while np.linalg.norm(dx) >= dx_tol:
                if fn(np.clip(x + dx, 0, None)) < obj:
                    break
                dx *= 0.1
            else:
                if printer:
                    printer.log("Newton converged at f=%g (no descent step)" % obj)
                break
        x = np.clip(x + dx, 0, None)
        x_list.append(x.copy())
        i += 1
        if np.linalg.norm(dx) < dx_tol:
            break
    return x, x_list


def optimize_wildcard_budget_barrier(budget, L1weights, objfn, two_dlogl_threshold,
                                     redbox_threshold, printer=None, tol=1e-7, max_iters=50,
                                     num_steps=3):
    """Newton on t |c . x| - sum log(-F(x)) for a geometric ladder of t,
    F the aggregate, red-box and x >= 0 constraints, from a strictly
    feasible point.  The water-fills, counted in ``budget.evaluations``,
    run on the objective's device."""
    from pygsti_tpu_torch.baseobjs.verbosityprinter import VerbosityPrinter
    printer = VerbosityPrinter.create_printer(printer if printer is not None else 0)
    wo = _WildcardObjective(objfn, budget)
    crit = _get_critical_circuit_budgets(objfn, redbox_threshold)
    dWdx = budget.precompute_for_same_circuits(list(objfn.layout.circuits))
    c = np.asarray(L1weights, dtype=float)

    def penalty_vec(x):
        budget.from_vector(np.asarray(x))
        q, _ = wo.moved()
        return np.concatenate(([_agg_dlogl(q, objfn, two_dlogl_threshold)], crit - dWdx @ x))

    def barrierF(x, compute_deriv=True):
        assert min(x) >= 0
        budget.from_vector(np.asarray(x))
        q, dp = wo.moved(True)
        f0 = np.array([_agg_dlogl(q, objfn, two_dlogl_threshold)])
        fi = crit - dWdx @ x
        f = np.concatenate((f0, fi, -x))
        # infeasible (a constraint active or violated): the barrier is +inf
        val = np.inf if np.any(f >= 0) else -np.sum(np.log(-f))
        if not compute_deriv:
            return val
        Df0 = _agg_dlogl_deriv(q, objfn, dWdx, dp)
        deriv = -1 / f0 * Df0 - (1 / fi) @ dWdx - 1 / x
        Hf0 = _agg_dlogl_hessian(q, objfn, dWdx, dp)
        hess = (1 / f0 ** 2) * np.outer(Df0, Df0) - (1 / f0) * Hf0 \
            + np.einsum('i,ij,ik->jk', 1 / fi ** 2, dWdx, dWdx) + np.diag(1 / x ** 2)
        return val, deriv, hess

    # a strictly feasible start (every coordinate positive, for -log x)
    x0 = np.maximum(budget.to_vector().astype(float), 1e-7)
    if not np.all(penalty_vec(x0) < 0):
        if np.linalg.norm(x0) < 1e-5:
            x0[:] = 1e-5
        for _ in range(100):
            if np.all(penalty_vec(x0) < 0):
                break
            x0 *= 2.0
        else:
            raise ValueError("Could not find feasible starting point!")
    printer.log("Barrier method initial feasible point: %s" % x0)
    x = x0.copy()
    num_constraints = 1 + len(crit) + 2 * len(x0)
    log10_end = int(np.ceil(np.log10(2 * num_constraints / tol)))
    for t in np.logspace(log10_end - (num_steps - 1), log10_end, num_steps):
        def newton_objective(xx):
            return float(t * np.sum(np.abs(c * xx)) + barrierF(xx, compute_deriv=False))

        def newton_objective_derivs(xx):
            barrier, Dbarrier, Hbarrier = barrierF(xx)
            return t * np.sum(np.abs(c * xx)) + barrier, t * c + Dbarrier, Hbarrier

        x, _ = NewtonSolve(x, newton_objective, newton_objective_derivs, tol, max_iters,
                           printer)
    budget.from_vector(x)
    budget.evaluations = wo.evaluations
    return budget


def optimize_wildcard_bisect_alpha(budget, objfn, two_dlogl_threshold, redbox_threshold,
                                   printer=None, guess=0.1, tol=1e-3):
    """The one-parameter bisection (optimize_wildcard_budget_1d)."""
    return optimize_wildcard_budget_1d(objfn, budget, two_dlogl_threshold)


def optimize_wildcard_budget_percircuit_only_cvxpy(budget, L1weights, objfn, redbox_threshold,
                                                   printer=None):
    """min L1weights . x subject to W_c(x) >= every circuit's critical
    budget and x >= 0: a linear program, solved by scipy's HiGHS."""
    from scipy.optimize import linprog
    crit = _get_critical_circuit_budgets(objfn, redbox_threshold)
    A = budget.precompute_for_same_circuits(list(objfn.layout.circuits))
    res = linprog(np.asarray(L1weights, float), A_ub=-A, b_ub=-crit,
                  bounds=[(0, None)] * A.shape[1], method='highs')
    if not res.success:
        raise RuntimeError("percircuit-only wildcard LP failed: %s" % res.message)
    budget.from_vector(res.x)
    return budget
