"""Gauge optimization (counterpart of pygsti_tpu/algorithms/gaugeopt.py).

``gaugeopt_to_target`` minimizes a weighted distance between the
gauge-transformed model and a target over a gauge group: Adam steps, then a
scipy L-BFGS-B polish, both on gradients from torch autograd.  The
objective is the JAX package's (squared element differences weighted per
item -- 'gates', 'spam' or specific labels -- normalized by the weighted
number of elements; or per-item fidelity / trace distance; plus the CPTP
and SPAM positivity penalties).

Where it runs: on ``device``, the card by default.  The objective's tensors
live there, the Adam loop reads no value back to the host, and L-BFGS-B
(scipy, on the host) reads one value and one gradient per evaluation.  The
JAX package pins gauge optimization to its CPU backend and caches compiled
executables by problem structure; both exist there to avoid compile time
and have no counterpart here, where torch runs eagerly.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.optimize as spo
import torch

from pygsti_tpu_torch import DTYPE
from pygsti_tpu_torch.baseobjs.verbosityprinter import VerbosityPrinter
from pygsti_tpu_torch.models.gaugegroup import (default_gauge_group_for_model,
                                                TrivialGaugeGroup)
from pygsti_tpu_torch.objectivefns.objectivefns import (
    HermitianSpectralSum, _sum_neg_evals, _NEG_EIG_SQRT_SHIFT)

ADAM_LEARNING_RATE = 3e-2
ADAM_MAX_STEPS = 2000
LBFGS_MAX_ITER = 200
_METRICS = ("frobenius", "frobeniussquared", "fidelity", "tracedist")


def _tracenorm_herm(A):
    """Trace norm (sum |eigenvalues|) of a Hermitian matrix (or of each of a
    batch), with the derivative sum_i sign(l_i) u_i^dag dA u_i, which stays
    finite at degenerate eigenvalues."""
    return HermitianSpectralSum.apply(A, 'abs')


def gaugeopt_to_target(model, target_model, item_weights=None, cptp_penalty_factor=0,
                       spam_penalty_factor=0, gates_metric="frobenius",
                       spam_metric="frobenius", gauge_group=None, method='auto',
                       maxiter=1000, maxfev=None, tol=1e-10, return_all=False,
                       comm=None, verbosity=0, check_jac=False, n_leak=0,
                       device="cuda", stats=None):
    """Optimize the gauge degrees of freedom so `model` best matches
    `target_model`; returns the transformed copy (with `return_all`, also
    the optimal parameters and the gauge group element).

    `maxfev` bounds the L-BFGS-B polish's function evaluations.  `check_jac`
    verifies the autograd gradient against central finite differences at the
    start and raises on mismatch.  `comm` is accepted for parity with the
    JAX package and ignored.  Leakage-aware optimization is not routed
    through `n_leak`.  A dict given as `stats` is filled with what the run
    did: parameter count, Adam steps and seconds, L-BFGS-B iterations,
    evaluations and seconds, and the objective before and after."""
    if n_leak:
        raise NotImplementedError(
            "n_leak > 0 is not supported here; the leakage-aware gauge-opt "
            "suite is not ported yet")
    return _gaugeopt_to_target_impl(
        model, target_model, item_weights, cptp_penalty_factor,
        spam_penalty_factor, gates_metric, spam_metric, gauge_group,
        method, maxiter, maxfev, tol, return_all, verbosity, check_jac,
        torch.device(device), stats)


def _make_objective(gauge_group, dim, gates_metric, spam_metric,
                    cptp_on, spam_on, basis_consts):
    """Build the pure gauge objective f(v, arrs) where arrs =
    (ops, tgt_ops, op_w, preps, tgt_preps, prep_w, effects, tgt_effects,
    effect_w, pen_factors) are tensors on v's device.  `basis_consts` =
    (M, Minv, els): the model basis -> std transform, its inverse and the
    basis elements [d, u, u], as complex tensors on that device (needed by
    the fidelity and trace-distance metrics and by both penalties)."""
    d = dim
    need_std = (gates_metric in ("fidelity", "tracedist")
                or spam_metric in ("fidelity", "tracedist")
                or cptp_on or spam_on)
    if need_std:
        M, Minv, els = basis_consts
        udim = int(round(np.sqrt(d)))

        def _choi_std(G):
            """Choi matrices [K, d, d] of the superoperators G [K, d, d]."""
            s_std = (M @ G.to(M.dtype)) @ Minv
            return s_std.reshape(-1, udim, udim, udim, udim).permute(
                0, 1, 3, 2, 4).reshape(-1, d, d) / udim

        def _vec_to_stdmx(vecs):
            """Matrices [n, u, u] of the superkets vecs [n, d]."""
            return torch.tensordot(vecs.to(els.dtype), els, dims=1)

        def _herm(H):
            return (H + H.conj().transpose(-1, -2)) / 2

        def _trace_of_product(A, B):
            return torch.real(torch.einsum('kij,kji->k', A, B))

        def _neg_eig_penalty(H):
            return torch.sum(torch.sqrt(_NEG_EIG_SQRT_SHIFT + _sum_neg_evals(_herm(H))))

    checked = []

    def objective(v, arrs):
        (ops, tgt_ops, op_w, preps, tgt_preps, prep_w,
         effects, tgt_effects, effect_w, pen_factors) = arrs
        total_weighted_count = (torch.sum(op_w) * d * d
                                + torch.sum(prep_w) * d + torch.sum(effect_w) * d)
        S = gauge_group.element_matrix(v)
        if not checked:
            # every tensor of the objective lies where the caller's data
            # lies: nothing may quietly run on another device
            for t in (S,) + tuple(basis_consts or ()):
                if t.device != ops.device:
                    raise RuntimeError("gauge objective: a tensor on %s, the "
                                       "model's on %s" % (t.device, ops.device))
            checked.append(True)
        Sinv = torch.linalg.inv(S)
        ops_t = torch.einsum('ij,kjl,lm->kim', Sinv, ops, S)
        preps_t = preps @ Sinv.T          # Sinv @ rho per prep
        effects_t = effects @ S           # E @ S per effect row

        val = torch.zeros((), dtype=v.dtype, device=v.device)
        # -- gates term ------------------------------------------------------
        if "frobenius" in gates_metric:
            val = val + torch.sum(op_w[:, None, None] * (ops_t - tgt_ops) ** 2) \
                / total_weighted_count
        elif gates_metric == "fidelity":
            # |1 - entanglement fidelity| per gate (unitary targets:
            # F_e = tr(T^T G)/d)
            fid = torch.einsum('kij,kij->k', tgt_ops, ops_t) / d
            val = val + torch.sum(op_w * torch.abs(1.0 - fid))
        elif gates_metric == "tracedist":
            # jtracedist = 0.5 * tracenorm(choi(G) - choi(T))
            val = val + torch.sum(op_w * 0.5 * _tracenorm_herm(
                _herm(_choi_std(ops_t) - _choi_std(tgt_ops))))

        # -- spam term ---------------------------------------------------------
        if "frobenius" in spam_metric:
            val = val + (torch.sum(prep_w[:, None] * (preps_t - tgt_preps) ** 2)
                         + torch.sum(effect_w[:, None] * (effects_t - tgt_effects) ** 2)) \
                / total_weighted_count
        elif spam_metric == "fidelity":
            # state fidelity to (near-pure) targets: F = tr(rho sigma)
            rho, rho_t = _vec_to_stdmx(preps_t), _vec_to_stdmx(tgt_preps)
            val = val + torch.sum(prep_w * torch.abs(1.0 - _trace_of_product(rho, rho_t)))
            E, E_t = _vec_to_stdmx(effects_t), _vec_to_stdmx(tgt_effects)
            val = val + torch.sum(effect_w * torch.abs(
                _trace_of_product(E_t, E_t) - _trace_of_product(E, E_t)))
        elif spam_metric == "tracedist":
            val = val + torch.sum(prep_w * 0.5 * _tracenorm_herm(
                _herm(_vec_to_stdmx(preps_t) - _vec_to_stdmx(tgt_preps))))
            val = val + torch.sum(effect_w * 0.5 * _tracenorm_herm(
                _herm(_vec_to_stdmx(effects_t) - _vec_to_stdmx(tgt_effects))))

        # -- positivity penalties ------------------------------------------------
        if cptp_on:
            val = val + pen_factors[0] * _neg_eig_penalty(_choi_std(ops_t))
        if spam_on:
            val = val + pen_factors[1] * (_neg_eig_penalty(_vec_to_stdmx(preps_t))
                                          + _neg_eig_penalty(_vec_to_stdmx(effects_t)))
        return val

    return objective


def _basis_consts(model, device):
    """(M, Minv, els) of the model's basis as complex tensors on `device`."""
    M = np.asarray(model.basis.create_transform_matrix('std')).astype(complex)
    els = np.asarray(model.basis.elements).astype(complex)  # [d, u, u]
    return tuple(torch.as_tensor(a, dtype=torch.complex128, device=device)
                 for a in (M, np.linalg.inv(M), els))


def _gaugeopt_to_target_impl(model, target_model, item_weights, cptp_penalty_factor,
                             spam_penalty_factor, gates_metric, spam_metric,
                             gauge_group, method, maxiter, maxfev, tol,
                             return_all, verbosity, check_jac, device, stats):
    printer = VerbosityPrinter.create_printer(verbosity)
    if gauge_group is None:
        gauge_group = default_gauge_group_for_model(model)
    if isinstance(gauge_group, TrivialGaugeGroup) or gauge_group.num_params == 0:
        return (model.copy(), None, model.copy()) if return_all else model.copy()

    if gates_metric not in _METRICS:
        raise ValueError("Invalid gates_metric: %r" % gates_metric)
    if spam_metric not in _METRICS:
        raise ValueError("Invalid spam_metric: %r" % spam_metric)

    item_weights = dict(item_weights or {})
    gates_weight = item_weights.get('gates', 1.0)
    spam_weight = item_weights.get('spam', 1.0)

    def on_device(a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=DTYPE, device=device)

    op_keys = list(model.operations.keys())
    prep_keys = list(model.preps.keys())
    povm_keys = list(model.povms.keys())
    effect_w = []
    for k in povm_keys:
        effect_w.extend([item_weights.get(k, spam_weight)] * model.povms[k].num_outcomes)
    arrs = tuple(on_device(a) for a in (
        np.stack([model.operations[k].dense() for k in op_keys]),
        np.stack([target_model.operations[k].dense() for k in op_keys]),
        [item_weights.get(k, gates_weight) for k in op_keys],
        np.stack([model.preps[k].dense() for k in prep_keys]),
        np.stack([target_model.preps[k].dense() for k in prep_keys]),
        [item_weights.get(k, spam_weight) for k in prep_keys],
        np.concatenate([model.povms[k].dense() for k in povm_keys], axis=0),
        np.concatenate([target_model.povms[k].dense() for k in povm_keys], axis=0),
        effect_w,
        [cptp_penalty_factor, spam_penalty_factor]))

    cptp_on = cptp_penalty_factor > 0
    spam_on = spam_penalty_factor > 0
    need_std = (gates_metric in ("fidelity", "tracedist")
                or spam_metric in ("fidelity", "tracedist")
                or cptp_on or spam_on)
    objective = _make_objective(
        gauge_group, model.dim, gates_metric, spam_metric, cptp_on, spam_on,
        _basis_consts(model, device) if need_std else None)

    def value_and_grad(x):
        """(value, gradient) of the objective at the host vector x, as a
        float and a host float64 array."""
        v = on_device(x).requires_grad_(True)
        f = objective(v, arrs)
        g, = torch.autograd.grad(f, v)
        if not (f.dtype == DTYPE and g.dtype == DTYPE):
            raise TypeError("gauge objective returned %s, gradient %s"
                            % (f.dtype, g.dtype))
        return float(f.detach()), g.cpu().numpy()

    x0 = np.asarray(gauge_group.initial_params(), dtype=float)

    if check_jac:
        # verify the autograd gradient against central finite differences at x0
        g = value_and_grad(x0)[1]
        eps = 1e-6
        fd = np.zeros_like(g)
        for i in range(len(g)):
            xp = x0.copy()
            xp[i] += eps
            xm = x0.copy()
            xm[i] -= eps
            fd[i] = (value_and_grad(xp)[0] - value_and_grad(xm)[0]) / (2 * eps)
        if not np.allclose(g, fd, atol=1e-4, rtol=1e-3):
            raise ValueError("check_jac: autograd gradient disagrees with finite "
                             "differences (max |diff| = %g)"
                             % float(np.max(np.abs(g - fd))))

    def run_adam(x_init, steps):
        """`steps` Adam steps on the device; no value comes back to the
        host until the loop has ended."""
        x = on_device(x_init).requires_grad_(True)
        opt = torch.optim.Adam([x], lr=ADAM_LEARNING_RATE)
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            objective(x, arrs).backward()
            opt.step()
        return x.detach().cpu().numpy()

    return _run_gaugeopt(run_adam, value_and_grad, gauge_group, x0, method,
                         maxiter, maxfev, tol, model, printer, return_all, stats)


def _run_gaugeopt(run_adam, value_and_grad, gauge_group, x0, method, maxiter,
                  maxfev, tol, model, printer, return_all, stats):
    f0 = value_and_grad(x0)[0]
    t0 = time.time()
    if method in ('auto', 'adam'):
        steps = min(maxiter, ADAM_MAX_STEPS)
        x_adam = run_adam(x0, steps)   # ends in a read of x: the card is done
    else:
        steps, x_adam = 0, x0
    t1 = time.time()

    lbfgs_opts = {'maxiter': min(maxiter, LBFGS_MAX_ITER), 'ftol': tol, 'gtol': 1e-10}
    if maxfev is not None:
        lbfgs_opts['maxfun'] = int(maxfev)
    res = spo.minimize(value_and_grad, x_adam, jac=True, method='L-BFGS-B',
                       options=lbfgs_opts)
    t2 = time.time()
    printer.log("Gauge optimization: %s -> %s (%d iters)" % (f0, res.fun, res.nit), 2)
    if stats is not None:
        stats.update({'group': gauge_group.name, 'num_params': gauge_group.num_params,
                      'adam_steps': steps, 'adam_s': t1 - t0,
                      'lbfgs_iterations': int(res.nit), 'lbfgs_evaluations': int(res.nfev),
                      'lbfgs_s': t2 - t1, 'objective_before': f0,
                      'objective_after': float(res.fun)})

    el = gauge_group.compute_element(res.x)
    new_model = model.copy()
    new_model.transform_inplace(el)
    if return_all:
        return new_model, res.x, el
    return new_model


def gaugeopt_custom(model, objective_fn, gauge_group=None, method='L-BFGS-B',
                    maxiter=100000, tol=1e-8, verbosity=0):
    """Gauge-optimize a custom objective_fn(model), which receives a
    transformed model copy and returns a number.  Derivative-free
    (Nelder-Mead) on the host, as in the JAX package."""
    if gauge_group is None:
        gauge_group = default_gauge_group_for_model(model)
    if gauge_group.num_params == 0:
        return model.copy()

    def transformed(x):
        m = model.copy()
        m.transform_inplace(gauge_group.compute_element(x))
        return m

    res = spo.minimize(lambda x: float(objective_fn(transformed(x))),
                       gauge_group.initial_params(), method='Nelder-Mead',
                       options={'maxiter': maxiter, 'fatol': tol})
    return transformed(res.x)


class GaugeoptToTargetArgs(object):
    """Argument container for gaugeopt_to_target calls: stores kwargs so
    gauge-opt suites can be built programmatically and replayed."""

    def __init__(self, **kwargs):
        self.args = dict(kwargs)

    def run(self, model, target_model):
        return gaugeopt_to_target(model, target_model, **self.args)


def gates_with_instruments(model):
    """The model's operation labels plus expanded instrument-member labels.
    (Gauge optimization of a model with an instrument fails where it
    transforms the model: instruments have no gauge transform, in both
    packages.)"""
    labels = list(model.operations.keys())
    for ilbl, inst in getattr(model, 'instruments', {}).items():
        for mlbl in inst.member_labels:
            labels.append((ilbl, mlbl))
    return labels
