"""Levenberg-Marquardt optimizers for GST (counterpart of
pygsti_tpu/optimize/simplerlm.py).

SimplerLMOptimizer.run takes the device loop (optimize/device_lm.py) when
it can, and otherwise the host loop, ``simplish_leastsq``: identity
damping, or (CustomLMOptimizer) 'JTJ' / 'invJTJ' damping with
``damping_clip``, uphill steps, ``x_limits``, and every out-of-bounds mode.
The host loop reads the objective's residual, J^T J and J^T f back from the
device once per evaluation; its iterates are float64 numpy.  As in the JAX
package, ``fditer`` sends a fit to the host loop, which takes no
finite-difference iterations (ROADMAP.md section 3).
"""

from __future__ import annotations

import time
import types

import numpy as np
import scipy.linalg as _spl

from pygsti_tpu_torch.baseobjs.profiler import span
from pygsti_tpu_torch.baseobjs.verbosityprinter import VerbosityPrinter

MACH_PRECISION = 1e-12


class OptimizerResult(object):
    """Result of one optimization."""

    def __init__(self, objective, opt_x, opt_f=None, opt_jtj=None, opt_unpenalized_f=None,
                 chi2_k_distributed_qty=None, optimizer_specific_qtys=None):
        self.objective = objective
        self.x = opt_x
        self.f = opt_f
        self.jtj = opt_jtj
        self.f_no_penalties = opt_unpenalized_f
        self.chi2_k_distributed_qty = chi2_k_distributed_qty
        self.optimizer_specific_qtys = optimizer_specific_qtys

    def __getstate__(self):
        # the objective holds its layout and closures over device tensors,
        # which pickle cannot take (drivers' output_pkl): a pickled result
        # keeps only the objective's name
        state = dict(self.__dict__)
        state['objective'] = types.SimpleNamespace(name=getattr(self.objective, 'name', None))
        return state


class SimplerLMOptimizer(object):
    """The LM optimizer.  ``run`` takes the device loop unless `fditer` is
    set, an out-of-bounds mode other than "reject" / mode 0 is checked, or
    (CustomLMOptimizer) the damping is not plain; `solver` picks the device
    loop's damped solve ('cholesky', 'cg', or None for the JAX package's
    rule by parameter count)."""

    @classmethod
    def cast(cls, obj):
        if isinstance(obj, cls):
            return obj
        if obj is None:
            return cls()
        if isinstance(obj, dict):
            return cls(**obj)
        raise ValueError("Cannot cast %r to SimplerLMOptimizer" % (obj,))

    def __init__(self, maxiter=100, maxfev=100, tol=1e-6, fditer=0, first_fditer=0,
                 init_munu="auto", oob_check_interval=0, oob_action="reject",
                 oob_check_mode=0, linesearch=None, serial_solve_proc_threshold=100,
                 lsvec_mode='normal', solver=None):
        if isinstance(tol, (float, int)):
            tol = {'relx': 1e-8, 'relf': float(tol), 'f': 1.0, 'jac': float(tol), 'maxdx': 1.0}
        else:
            tol = {'relx': 1e-8, 'relf': 1e-6, 'f': 1.0, 'jac': 1e-6, 'maxdx': 1.0, **tol}
        self.maxiter = maxiter
        self.maxfev = maxfev
        self.tol = tol
        self.fditer = fditer
        self.first_fditer = first_fditer
        self.init_munu = init_munu
        self.oob_check_interval = oob_check_interval
        self.oob_action = oob_action
        self.oob_check_mode = oob_check_mode
        self.linesearch = {'mode': 'guarded', 'beta': 0.25, 'max_evals': 6, 'kappa': 1.0,
                           **(linesearch or {})}
        self.solver = solver

    def _uses_device_loop(self):
        oob_on_device = self.oob_check_interval == 0 or (
            self.oob_action == 'reject' and self.oob_check_mode == 0)
        plain_damping = getattr(self, 'damping_mode', 'identity') == 'identity' and \
            getattr(self, 'uphill_step_threshold', 0.0) == 0.0
        return self.fditer == 0 and oob_on_device and plain_damping

    def run(self, objective, profiler=None, printer=None):
        """Minimize `objective`; the model takes the optimum.  Raises if the
        loop ends without converging.  ``optimizer_specific_qtys`` holds the
        loop ('device' or 'host'), its iterations, its wall seconds and, for
        the host loop, the objective's evaluations (each one read from the
        device)."""
        with span('lm.run'):
            printer = VerbosityPrinter.create_printer(printer if printer is not None else 1)
            x0 = objective.model.to_vector()
            t0 = time.time()
            if self._uses_device_loop():
                x, converged, msg, mu, nu, norm_f, f, iters = objective.run_device_lm(
                    x0, maxiter=self.maxiter, tol=self.tol, linesearch=self.linesearch,
                    oob_check_interval=self.oob_check_interval, solver=self.solver)
                extra = {'loop': 'device', 'iterations': iters}
            else:
                counts = {'lsvec': 0, 'jtj_jtf': 0}

                def obj_fn(x, oob_check=False):
                    counts['lsvec'] += 1
                    return objective.lsvec(x, oob_check)

                def jtj_jtf_fn(x):
                    counts['jtj_jtf'] += 1
                    return objective.jtj_jtf(x)

                x, converged, msg, mu, nu, norm_f, f = simplish_leastsq(
                    obj_fn, jtj_jtf_fn, x0, max_iter=self.maxiter, num_fd_iters=self.fditer,
                    f_norm2_tol=self.tol['f'], jac_norm_tol=self.tol['jac'],
                    rel_ftol=self.tol['relf'], rel_xtol=self.tol['relx'],
                    max_dx_scale=self.tol['maxdx'], init_munu=self.init_munu,
                    oob_check_interval=self.oob_check_interval, oob_action=self.oob_action,
                    oob_check_mode=self.oob_check_mode, linesearch=self.linesearch,
                    damping_mode=getattr(self, 'damping_mode', 'identity'),
                    damping_clip=getattr(self, 'damping_clip', None),
                    uphill_step_threshold=getattr(self, 'uphill_step_threshold', 0.0),
                    verbosity=printer.verbosity - 1)
                extra = {'loop': 'host', 'iterations': counts['jtj_jtf'],
                         'evaluations': counts['lsvec'] + counts['jtj_jtf']}
            wall = time.time() - t0
            printer.log("Least squares message = %s" % msg, 2)
            if not converged:
                raise RuntimeError("Failed to converge: %s" % msg)
            objective.model.from_vector(x)
            unpenalized_normf = float(np.sum(f[:objective.num_elements] ** 2))
            return OptimizerResult(
                objective, x, norm_f, None, unpenalized_normf,
                objective.chi2k_distributed_qty(unpenalized_normf),
                {'msg': msg, 'mu': mu, 'nu': nu, 'fvec': f, 'wall_s': wall, **extra})


def damp_coeff_update(mu, nu, half_max_nu, reject_msg, printer):
    """A rejected step: mu *= nu, nu *= 2, and a message once nu overflows."""
    mu *= nu
    msg = "Stopping after nu overflow!" if nu > half_max_nu else ""
    nu = 2 * nu
    printer.log("      Rejected%s!  mu => mu*nu = %g, nu => 2*nu = %g" % (reject_msg, mu, nu), 2)
    return mu, nu, msg


def simplish_leastsq(obj_fn, jtj_jtf_fn, x0, f_norm2_tol=1e-6, jac_norm_tol=1e-6,
                     rel_ftol=1e-6, rel_xtol=1e-8, max_iter=100, num_fd_iters=0,
                     max_dx_scale=1.0, init_munu="auto", oob_check_interval=0,
                     oob_action="reject", oob_check_mode=0, x_limits=None,
                     linesearch=None, verbosity=0, damping_mode="identity",
                     damping_clip=None, uphill_step_threshold=0.0):
    """The host LM loop, with the JAX package's update semantics.

    obj_fn(x, oob_check=False) -> f (raising ValueError when asked to check
    a point out of bounds); jtj_jtf_fn(x) -> (f, J^T J, J^T f).  Returns
    (x, converged, msg, mu, nu, norm_f, f) at the best point known in
    bounds.

    damping_mode 'identity' adds mu to the diagonal of J^T J, 'JTJ' adds
    mu * diag(J^T J) and 'invJTJ' mu / diag(J^T J), the added term clipped
    to `damping_clip` = (lo, hi) in those two; mu starts at 1e-3 max
    diag(J^T J) for 'identity' and at min(1e5, max diag(J^T J) / max |J^T f|)
    for the other two.  With uphill_step_threshold
    > 0 an uphill step is taken when (threshold - cos(dx, last dx)) |f_new|^2
    < min(best |f|^2, |f|^2).  `x_limits` [P, 2] clips every step.
    `num_fd_iters` is accepted and not used."""
    printer = VerbosityPrinter.create_printer(verbosity)
    if damping_mode not in ('identity', 'JTJ', 'invJTJ'):
        raise NotImplementedError(
            "damping_mode=%r is not implemented (supported: identity, JTJ, invJTJ; the "
            "reference's 'adaptive' mode is not)" % damping_mode)
    if damping_mode == 'identity' and damping_clip is not None:
        raise ValueError("damping_clip cannot be used with damping_mode == 'identity'")

    def _dclip(a):
        return a if damping_clip is None else np.clip(a, *damping_clip)

    linesearch = {'mode': 'guarded', 'beta': 0.25, 'max_evals': 6, 'kappa': 1.0,
                  **(linesearch or {})}
    ls_mode, ls_beta = linesearch['mode'], linesearch['beta']
    ls_max_evals, ls_kappa = linesearch['max_evals'], linesearch['kappa']

    msg = ""
    converged = False
    half_max_nu = 2 ** 62
    tau = 1e-3

    x = np.asarray(x0, dtype=float).copy()
    best_x = x.copy()
    max_norm_dx = (max_dx_scale ** 2) * len(x) if max_dx_scale else None

    f = obj_fn(x)
    norm_f = float(np.dot(f, f))
    if not np.isfinite(norm_f):
        msg = "Infinite norm of objective function at initial point!"
    if len(x) == 0:
        return x, True, "No parameters to optimize", 1, 2, norm_f, f

    mu, nu = (1, 2) if init_munu == 'auto' else init_munu
    min_norm_f = 1e100
    last_accepted_dx = None
    best_x_state = (mu, nu, norm_f, f.copy())

    def revert_to_best_x(verb):
        nonlocal oob_check_interval, mu, nu, norm_f, f
        printer.log("** %s out-of-bounds: reverting and setting interval=1 **" % verb, 2)
        oob_check_interval = 1
        x[:] = best_x
        mu, nu, norm_f, fbest = best_x_state
        f = fbest.copy()

    def eval_candidate(new_x, do_oob_check):
        if oob_check_mode == 0 and oob_check_interval > 0 and do_oob_check:
            try:
                new_f = obj_fn(new_x, oob_check=True)
            except ValueError:
                return None, False, False
            return new_f, True, True
        return obj_fn(new_x), (oob_check_interval == 0), True

    k = 0
    try:
        for k in range(max_iter):
            if len(msg) > 0:
                break
            if norm_f < f_norm2_tol:
                if oob_check_interval <= 1:
                    msg = "Sum of squares is at most %g" % f_norm2_tol
                    converged = True
                    break
                revert_to_best_x("Converged")
                continue

            tm = time.time()
            f, JTJ, JTf = jtj_jtf_fn(x)
            norm_f = float(np.dot(f, f))
            if not np.all(np.isfinite(JTJ)):
                msg = "Non-finite JTJ (out of model's numeric range)"
                converged = (k > 0)
                break
            minus_JTf = -JTf
            jtj_diag = np.diag(JTJ).copy()
            printer.log("--- Outer Iter %d: norm_f = %g, mu=%g (jac %.2fs)"
                        % (k, norm_f, mu, time.time() - tm), 2)
            norm_JTf = float(np.max(np.abs(minus_JTf)))
            norm_x = float(np.dot(x, x))
            if norm_JTf < jac_norm_tol:
                if oob_check_interval <= 1:
                    msg = "norm(J'f) is at most %g" % jac_norm_tol
                    converged = True
                    break
                revert_to_best_x("Converged")
                continue
            if k == 0:
                if init_munu == 'auto' and damping_mode == 'identity':
                    mu, nu = tau * float(np.max(jtj_diag)), 2
                elif init_munu == 'auto':
                    # multiplicative damping: the reference's rule, which
                    # keeps mu from making dx so small that the relative-change
                    # test ends the fit at once (the JAX package takes the
                    # identity rule here: ROADMAP.md section 3)
                    mu, nu = min(1.0e5, float(np.max(jtj_diag)) / norm_JTf), 2
                best_x_state = (mu, nu, norm_f, f.copy())

            while True:      # the damping loop
                step_clipped = False
                step_shrunk_by_ls = False
                A = JTJ.copy()
                idx = np.diag_indices_from(A)
                if damping_mode == 'JTJ':
                    A[idx] = jtj_diag + mu * _dclip(jtj_diag)
                elif damping_mode == 'invJTJ':
                    with np.errstate(divide='ignore'):
                        A[idx] = jtj_diag + mu * _dclip(1.0 / jtj_diag)
                else:
                    A[idx] = jtj_diag + mu
                try:
                    dx = _spl.cho_solve(_spl.cho_factor(A), minus_JTf)
                except (_spl.LinAlgError, np.linalg.LinAlgError):
                    try:
                        dx = _spl.solve(A, minus_JTf)
                    except Exception:
                        mu, nu, msg = damp_coeff_update(mu, nu, half_max_nu,
                                                        " (LinSolve Failure)", printer)
                        if len(msg) == 0:
                            continue
                        break
                if not np.all(np.isfinite(dx)):
                    mu, nu, msg = damp_coeff_update(mu, nu, half_max_nu,
                                                    " (LinSolve non-finite)", printer)
                    if len(msg) == 0:
                        continue
                    break

                new_x = x + dx
                norm_dx = float(np.dot(dx, dx))
                if max_norm_dx and norm_dx > max_norm_dx:
                    dx *= np.sqrt(max_norm_dx / norm_dx)
                    new_x = x + dx
                    norm_dx = float(np.dot(dx, dx))
                    step_clipped = True
                if x_limits is not None:
                    new_x = np.clip(new_x, x_limits[:, 0], x_limits[:, 1])
                    dx = new_x - x
                    norm_dx = float(np.dot(dx, dx))
                printer.log("  - Inner Loop: mu=%g, norm_dx=%g" % (mu, norm_dx), 3)

                if norm_dx < (rel_xtol ** 2) * norm_x:
                    if oob_check_interval <= 1:
                        msg = "Relative change, |dx|/|x|, is at most %g" % rel_xtol
                        converged = True
                        break
                    revert_to_best_x("Converged")
                    break
                elif (norm_x + rel_xtol) < norm_dx * (MACH_PRECISION ** 2):
                    msg = "(near-)singular linear system"
                    break

                do_oob_check = (oob_check_mode == 0 and oob_check_interval > 0
                                and k % oob_check_interval == 0)
                new_f, new_x_known_inbounds, oob_ok = eval_candidate(new_x, do_oob_check)
                if not oob_ok:
                    if oob_action == "reject" or k < 1:
                        mu, nu, msg = damp_coeff_update(mu, nu, half_max_nu,
                                                        " (out-of-bounds)", printer)
                        if len(msg) == 0:
                            continue
                        break
                    elif oob_action == "stop":
                        if oob_check_interval == 1:
                            msg = "Objective function out-of-bounds! STOP"
                            converged = True
                        else:
                            revert_to_best_x("Hit")
                        break
                    raise ValueError("Invalid oob_action: %r" % oob_action)

                norm_new_f = float(np.dot(new_f, new_f))
                if ls_mode == 'always':
                    do_linesearch = True
                elif ls_mode == 'guarded':
                    do_linesearch = (step_clipped or norm_dx > (ls_kappa ** 2) * norm_x
                                     or not np.isfinite(norm_new_f))
                else:
                    do_linesearch = False

                if do_linesearch:
                    best_t = 1.0
                    best_norm = norm_new_f if np.isfinite(norm_new_f) else np.inf
                    t = ls_beta
                    for _ in range(ls_max_evals):
                        trial_f = obj_fn(x + t * dx)
                        trial_norm = float(np.dot(trial_f, trial_f))
                        if np.isfinite(trial_norm) and trial_norm < best_norm:
                            best_t, best_norm = t, trial_norm
                            t *= ls_beta
                        else:
                            break
                    if best_t < 1.0:
                        dx = best_t * dx
                        norm_dx = float(np.dot(dx, dx))
                        step_shrunk_by_ls = True
                    new_x = x + dx
                    new_f, new_x_known_inbounds, oob_ok = eval_candidate(new_x, do_oob_check)
                    if not oob_ok:
                        mu, nu, msg = damp_coeff_update(mu, nu, half_max_nu,
                                                        " (out-of-bounds)", printer)
                        if len(msg) == 0:
                            continue
                        break
                    norm_new_f = float(np.dot(new_f, new_f))
                    if step_shrunk_by_ls:
                        printer.log("      Line search: t=%g, norm_f -> %g"
                                    % (best_t, norm_new_f), 3)

                if not np.isfinite(norm_new_f):
                    msg = "Infinite norm of objective function!"
                    break

                dL = float(np.dot(dx, mu * dx + minus_JTf))   # predicted decrease
                dF = norm_f - norm_new_f                       # actual decrease
                printer.log("      norm_new_f=%g, dL=%g, dF=%g" % (norm_new_f, dL, dF), 3)

                if dL / norm_f < rel_ftol and dF >= 0 and dF / norm_f < rel_ftol \
                        and dF / dL < 2.0:
                    if oob_check_interval <= 1:
                        msg = ("Both actual and predicted relative reductions in the sum "
                               "of squares are at most %g" % rel_ftol)
                        converged = True
                        break
                    revert_to_best_x("Converged")
                    break

                if uphill_step_threshold > 0 and last_accepted_dx is not None:
                    cosb = float(np.dot(dx, last_accepted_dx)) / max(
                        np.sqrt(norm_dx * float(np.dot(last_accepted_dx, last_accepted_dx))),
                        1e-300)
                    uphill_ok = ((uphill_step_threshold - cosb) * norm_new_f
                                 < min(min_norm_f, norm_f))
                else:
                    uphill_ok = False

                if (dL <= 0 or dF <= 0) and not uphill_ok:
                    mu, nu, msg = damp_coeff_update(mu, nu, half_max_nu,
                                                    " (dL or dF <= 0)", printer)
                    if len(msg) == 0:
                        continue
                    break

                if oob_check_mode == 1 and oob_check_interval > 0 \
                        and k % oob_check_interval == 0:
                    try:
                        obj_fn(new_x, oob_check=True)
                        new_x_known_inbounds = True
                    except ValueError:
                        if oob_action == "reject" or k < 1:
                            mu, nu, msg = damp_coeff_update(mu, nu, half_max_nu,
                                                            " (out-of-bounds)", printer)
                            if len(msg) == 0:
                                continue
                            break
                        elif oob_action == "stop":
                            if oob_check_interval == 1:
                                msg = "Objective function out-of-bounds! STOP"
                                converged = True
                            else:
                                revert_to_best_x("Hit")
                            break
                        raise ValueError("Invalid oob_action: %r" % oob_action)

                # accepted
                t = 1.0 - (2 * dF / dL - 1.0) ** 3
                mu_factor = max(t, 1.0 / 3.0) if norm_dx > 1e-8 else 0.3
                if step_shrunk_by_ls:
                    mu_factor = max(mu_factor, 1.0)
                mu *= mu_factor
                nu = 2
                x = new_x
                f = new_f
                norm_f = norm_new_f
                last_accepted_dx = dx.copy()
                printer.log("      Accepted!%s gain ratio=%g  mu => %g"
                            % (" UPHILL" if (dL <= 0 or dF <= 0) else "", dF / dL, mu), 3)
                if norm_f < min_norm_f:
                    if not new_x_known_inbounds and oob_check_interval > 0:
                        try:
                            obj_fn(x, oob_check=True)
                            new_x_known_inbounds = True
                        except ValueError:
                            pass
                    if new_x_known_inbounds or oob_check_interval == 0:
                        min_norm_f = norm_f
                        best_x[:] = x
                        best_x_state = (mu, nu, norm_f, f.copy())
                break
        else:
            msg = "Maximum iterations (%d) exceeded" % max_iter
            converged = True
            printer.warning("Treating result as *converged* after maximum iterations.")
    except KeyboardInterrupt:
        printer.log("Caught keyboard interrupt! Returning current solution as converged.")
        msg = "Keyboard interrupt!"
        converged = True

    # the best point known in bounds
    x = best_x.copy()
    mu, nu, norm_f, f = best_x_state
    return x, converged, msg, mu, nu, norm_f, f


class CustomLMOptimizer(SimplerLMOptimizer):
    """The LM optimizer with the reference's wider set of knobs: damping
    'identity' / 'JTJ' / 'invJTJ' with `damping_clip`, and
    `uphill_step_threshold`; any of them off its default sends the fit to
    the host loop.  'adaptive' damping, damping_basis='singular_values' and
    use_acceleration raise NotImplementedError, as in the JAX package."""

    def __init__(self, maxiter=100, maxfev=100, tol=1e-6, fditer=0, first_fditer=0,
                 damping_mode='identity', damping_basis='diagonal_values', damping_clip=None,
                 use_acceleration=False, uphill_step_threshold=0.0, init_munu='auto',
                 oob_check_interval=0, oob_action='reject', oob_check_mode=0,
                 serial_solve_proc_threshold=100, lsvec_mode='normal', solver=None):
        super().__init__(maxiter=maxiter, maxfev=maxfev, tol=tol, fditer=fditer,
                         first_fditer=first_fditer, init_munu=init_munu,
                         oob_check_interval=oob_check_interval, oob_action=oob_action,
                         oob_check_mode=oob_check_mode, solver=solver)
        if damping_mode not in ('identity', 'JTJ', 'invJTJ'):
            raise NotImplementedError("damping_mode=%r is not implemented (supported: "
                                      "identity, JTJ, invJTJ)" % damping_mode)
        if damping_basis != 'diagonal_values':
            raise NotImplementedError("damping_basis=%r is not implemented (only "
                                      "'diagonal_values')" % damping_basis)
        if use_acceleration:
            raise NotImplementedError("use_acceleration=True (geodesic acceleration) is not "
                                      "implemented")
        self.damping_mode = damping_mode
        self.damping_basis = damping_basis
        self.damping_clip = damping_clip
        self.use_acceleration = use_acceleration
        self.uphill_step_threshold = uphill_step_threshold
        self.lsvec_mode = lsvec_mode


Optimizer = SimplerLMOptimizer


def jac_guarded(k, num_fd_iters, obj_fn, jac_fn, f, ari, global_x, fdJac_work):
    """The analytic Jacobian jac_fn(x), or for the first `num_fd_iters`
    iterations a forward-difference one (step 1e-7) of obj_fn."""
    if k >= num_fd_iters:
        return jac_fn(global_x)
    eps = 1e-7
    f_fixed = np.array(f, copy=True)
    jac = fdJac_work if fdJac_work is not None else np.empty((len(f_fixed), len(global_x)))
    for i in range(len(global_x)):
        x_plus = np.array(global_x, copy=True)
        x_plus[i] += eps
        jac[:, i] = (np.asarray(obj_fn(x_plus)) - f_fixed) / eps
    return jac
