"""Levenberg-Marquardt with its state on the device (counterpart of
pygsti_tpu/optimize/device_lm.py: make_device_lm).

The update semantics are the JAX package's (and the reference's
simplish_leastsq): identity damping on the JTJ diagonal, the (mu, nu)
schedule with gain-ratio factor 1-(2 dF/dL-1)^3, a guarded backtracking line
search folded into one residual evaluation per inner iteration, and the same
convergence tests.  Every state tensor stays on the device; the host reads a
scalar only where a loop decides whether (and how) to go on: the outer exit
code, the inner loop's (phase, done) pair, and every 16 steps of the
conjugate-gradient solver.

The damped system is solved by Cholesky or ('cg') by Jacobi-preconditioned
conjugate gradients.  Out-of-bounds protocol (oob_action "reject",
oob_check_mode 0 of the host loop): with ``oob_interval`` > 0, every
``oob_interval``-th iteration checks its candidate against
``oob_fn(x) -> bool`` (True = out of bounds) and rejects it with the
damping update; the best point is recorded only where known in bounds; and
a convergence exit reached while ``oob_interval`` > 1 goes back to the best
point with the interval set to 1 instead of ending.  With ``oob_fn=None``
no point is out of bounds, so intervals 0 and 1 give the same iterates bit
for bit.

Exit codes: 0 = running, 1 = f_norm2_tol, 2 = jac_norm_tol, 3 = rel_xtol,
4 = rel_ftol, 5 = max_iter, 6 = nu overflow, 7 = singular, 8 = non-finite.
"""

from __future__ import annotations

from typing import NamedTuple, Any

import torch

from pygsti_tpu_torch.baseobjs.profiler import span


class _LMState(NamedTuple):
    k: int
    x: Any
    f: Any
    norm_f: Any
    mu: Any
    nu: Any
    best_x: Any
    best_norm_f: Any
    best_f: Any
    best_mu: Any
    best_nu: Any
    exit_code: Any
    oob_interval: int


def _solve_damped(JTJ, jtj_diag, mu, minus_JTf):
    """Solve (JTJ + mu*I) dx = -JTf via Cholesky; NaNs signal failure."""
    A = JTJ.clone()
    A.diagonal().copy_(jtj_diag + mu)
    L, info = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, minus_JTf[:, None], upper=False)
    dx = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    return torch.where(info == 0, dx, torch.full_like(dx, float('nan')))


def _solve_damped_cg(JTJ, jtj_diag, mu, minus_JTf, maxiter=250, tol=1e-12, check_every=16):
    """Solve (JTJ + mu*I) dx = -JTf by conjugate gradients preconditioned
    with the inverse diagonal, from dx = 0, until |r|^2 <= tol^2 |b|^2 or
    `maxiter` steps: the JAX package's jax.scipy.sparse.linalg.cg.  A step
    past convergence leaves the iterate unchanged, so reading the test only
    every `check_every` steps gives the same dx."""
    diag = jtj_diag + mu
    shift = diag - jtj_diag
    inv_diag = 1.0 / torch.clamp(diag, min=1e-300)

    def matvec(v):
        return JTJ @ v + shift * v

    b = minus_JTf
    atol2 = tol ** 2 * torch.dot(b, b)
    x = torch.zeros_like(b)
    r = b.clone()
    z = inv_diag * r
    p = z
    gamma = torch.dot(r, z)
    for k in range(maxiter):
        active = torch.dot(r, r) > atol2
        if k % check_every == 0 and not bool(active):
            break
        Ap = matvec(p)
        alpha = gamma / torch.dot(p, Ap)
        x = torch.where(active, x + alpha * p, x)
        r_new = r - alpha * Ap
        z = inv_diag * r_new
        gamma_new = torch.dot(r_new, z)
        p = torch.where(active, z + (gamma_new / gamma) * p, p)
        r = torch.where(active, r_new, r)
        gamma = torch.where(active, gamma_new, gamma)
    return x


SOLVERS = {'cholesky': _solve_damped, 'cg': _solve_damped_cg}


def make_device_lm(jtj_jtf_fn, lsvec_fn, ls_beta=0.25, ls_max_evals=6,
                   ls_kappa=1.0, max_inner=16, oob_fn=None, solver='cholesky'):
    """Build the LM loop from jtj_jtf_fn(x) -> (f, JTJ, JTf),
    lsvec_fn(x) -> f and, optionally, oob_fn(x) -> bool tensor (True = out
    of bounds).  Returns (lm_init, lm_run, lm_finalize); lm_init takes the
    out-of-bounds check interval, lm_run the iteration cap and tols =
    (f_norm2_tol, jac_norm_tol, rel_ftol, rel_xtol, max_norm_dx)."""
    tau = 1e-3
    half_max_nu = 2.0 ** 62
    max_evals = 3 * max_inner
    if solver not in SOLVERS:
        raise ValueError("unknown solver %r (the port has %s)" % (solver, sorted(SOLVERS)))
    solve_damped = SOLVERS[solver]

    def lm_init(x0, oob_interval=0):
        f0 = lsvec_fn(x0)
        norm_f0 = torch.dot(f0, f0)
        one = torch.ones((), dtype=x0.dtype, device=x0.device)
        return _LMState(0, x0, f0, norm_f0, one, 2 * one, x0, norm_f0, f0, one, 2 * one,
                        torch.zeros((), dtype=torch.int64, device=x0.device),
                        int(oob_interval))

    def iteration(st, tols):
        f_norm2_tol, jac_norm_tol, rel_ftol, rel_xtol, max_norm_dx = tols
        x = st.x
        _, JTJ, JTf = jtj_jtf_fn(x)
        f, norm_f = st.f, st.norm_f
        minus_JTf = -JTf
        jtj_diag = torch.diagonal(JTJ).clone()
        norm_JTf = minus_JTf.abs().max()
        norm_x = torch.dot(x, x)
        finite_jtj = torch.isfinite(JTJ).all()
        one_t = torch.ones((), dtype=x.dtype, device=x.device)
        true_t = torch.ones((), dtype=torch.bool, device=x.device)

        mu = tau * jtj_diag.max() if st.k == 0 else st.mu
        nu = 2 * one_t if st.k == 0 else st.nu
        interval = st.oob_interval
        do_oob_k = oob_fn is not None and interval > 0 and st.k % interval == 0
        accepted = ~true_t
        bx, bf, bnf = x, f, norm_f
        code = torch.zeros((), dtype=torch.int64, device=x.device)
        phase = 0
        dx = torch.zeros_like(x)
        solve_ok, clip, norm_dx = true_t, ~true_t, 0 * one_t
        t_cur, best_t = one_t, one_t
        best_norm = torch.full((), float('inf'), dtype=x.dtype, device=x.device)
        ls_stop = ~true_t

        for _ in range(max_evals):
            if phase == 0:   # a new damped solve, full step
                dx = solve_damped(JTJ, jtj_diag, mu, minus_JTf)
                solve_ok = torch.isfinite(dx).all()
                norm_dx = torch.dot(dx, dx)
                clip = norm_dx > max_norm_dx
                dx = dx * torch.where(
                    clip, torch.sqrt(max_norm_dx / torch.clamp(norm_dx, min=1e-300)),
                    one_t)
                norm_dx = torch.dot(dx, dx)
                t = one_t
            else:            # the line search's next backtracked step
                t = t_cur

            trial_f = lsvec_fn(x + t * dx)
            trial_norm = torch.dot(trial_f, trial_f)

            xtol_conv = norm_dx < (rel_xtol ** 2) * norm_x
            do_ls = clip | (norm_dx > (ls_kappa ** 2) * norm_x) \
                | ~torch.isfinite(trial_norm)
            start_ls = do_ls if phase == 0 else ~true_t

            better = torch.isfinite(trial_norm) & (trial_norm < best_norm) & ~ls_stop
            nbest_t = torch.where(better, t, best_t)
            nbest_norm = torch.where(better, trial_norm, best_norm)
            nbest_f = torch.where(better, trial_f, bf)
            nls_stop = ls_stop | ~better
            ls_done = nls_stop | (t <= (ls_beta ** ls_max_evals) * 1.0001)
            conclude = ~do_ls if phase == 0 else ls_done

            if phase == 0:
                att_t, att_f, att_norm = one_t, trial_f, trial_norm
            else:
                att_t, att_f, att_norm = nbest_t, nbest_f, nbest_norm
            shrunk = att_t < 1.0
            dx2 = dx * att_t
            new_x = x + dx2
            norm_dx2 = torch.dot(dx2, dx2)
            dL = torch.dot(dx2, mu * dx2 + minus_JTf)
            dF = norm_f - att_norm
            ftol_conv = (dL / norm_f < rel_ftol) & (dF >= 0) \
                & (dF / norm_f < rel_ftol) & (dF / torch.clamp(dL, min=1e-300) < 2.0)
            accept = solve_ok & torch.isfinite(att_norm) & (dL > 0) & (dF > 0) \
                & ~xtol_conv & ~ftol_conv
            if do_oob_k:
                # the candidate out of bounds is rejected (oob_action "reject")
                accept = accept & ~oob_fn(new_x)

            t_gain = 1.0 - (2 * dF / torch.clamp(dL, min=1e-300) - 1.0) ** 3
            mu_factor = torch.where(norm_dx2 > 1e-8,
                                    torch.clamp(t_gain, min=1.0 / 3.0), 0.3 * one_t)
            mu_factor = torch.where(shrunk, torch.clamp(mu_factor, min=1.0), mu_factor)
            overflow = nu > half_max_nu
            zero_i = torch.zeros_like(code)
            code_att = torch.where(
                xtol_conv, zero_i + 3, torch.where(
                    ftol_conv, zero_i + 4, torch.where(
                        accept, zero_i, torch.where(
                            overflow, zero_i + 6, torch.where(
                                ~torch.isfinite(att_norm) & ~solve_ok,
                                zero_i + 8, zero_i)))))
            done_att = accept | xtol_conv | ftol_conv | overflow
            mu_att = torch.where(accept, mu * mu_factor,
                                 torch.where(done_att, mu, mu * nu))
            nu_att = torch.where(accept, 2 * one_t, torch.where(done_att, nu, 2 * nu))

            init_norm = torch.where(torch.isfinite(trial_norm), trial_norm,
                                    torch.full_like(trial_norm, float('inf')))
            phase_n = torch.where(conclude, 0, torch.where(start_ls, 1, phase))
            t_cur = torch.where(start_ls, ls_beta * one_t, t * ls_beta)
            best_t = torch.where(start_ls, one_t, nbest_t)
            best_norm = torch.where(start_ls, init_norm, nbest_norm)
            best_f_n = torch.where(start_ls, trial_f, nbest_f)
            ls_stop = torch.where(start_ls, ~true_t, nls_stop)

            mu = torch.where(conclude, mu_att, mu)
            nu = torch.where(conclude, nu_att, nu)
            done = conclude & done_att
            take = conclude & accept
            accepted = take
            code = torch.where(conclude, code_att, zero_i)
            bx = torch.where(take, new_x, bx)
            bf = torch.where(take, att_f, best_f_n)
            bnf = torch.where(take, att_norm, bnf)

            phase, done_h = (int(a) for a in torch.stack([phase_n, done.long()]).tolist())
            if done_h:
                break

        x1 = torch.where(accepted, bx, x)
        f1 = torch.where(accepted, bf, f)
        norm_f1 = torch.where(accepted, bnf, norm_f)
        improved = accepted & (norm_f1 < st.best_norm_f)
        if oob_fn is not None and interval > 0 and not do_oob_k:
            # the best point is one known in bounds
            improved = improved & ~oob_fn(x1)
        best_x = torch.where(improved, x1, st.best_x)
        best_norm_f = torch.where(improved, norm_f1, st.best_norm_f)
        best_f = torch.where(improved, f1, st.best_f)
        best_mu = torch.where(improved, mu, st.best_mu)
        best_nu = torch.where(improved, nu, st.best_nu)
        exit_code = torch.where(norm_f < f_norm2_tol, 1, torch.where(
            norm_JTf < jac_norm_tol, 2, torch.where(~finite_jtj, 8, code)))
        if interval > 1 and 1 <= int(exit_code) <= 4:
            # a convergence exit with unchecked iterates: back to the best
            # point known in bounds, checking every iteration from now on
            return _LMState(st.k + 1, best_x, best_f, best_norm_f, best_mu, best_nu,
                            best_x, best_norm_f, best_f, best_mu, best_nu,
                            torch.zeros_like(exit_code), 1)
        return _LMState(st.k + 1, x1, f1, norm_f1, mu, nu, best_x, best_norm_f, best_f,
                        best_mu, best_nu, exit_code, interval)

    def lm_run(state, max_iter, tols):
        """Iterate until an exit code is set or `max_iter` iterations."""
        while state.k < max_iter and int(state.exit_code) == 0:
            with span('lm.iteration'):
                state = iteration(state, tols)
        return state

    def lm_finalize(final, max_iter):
        """(x, f, norm_f, mu, nu, exit_code, k) at the best point found, as
        host numpy and Python numbers."""
        exit_code = int(final.exit_code)
        if exit_code == 0 and final.k >= int(max_iter):
            exit_code = 5
        norm_f, best_norm_f = float(final.norm_f), float(final.best_norm_f)
        if best_norm_f <= norm_f:
            x_out, f_out, norm_out = final.best_x, final.best_f, best_norm_f
        else:
            x_out, f_out, norm_out = final.x, final.f, norm_f
        return (x_out.cpu().numpy(), f_out.cpu().numpy(), norm_out,
                float(final.mu), float(final.nu), exit_code, final.k)

    return lm_init, lm_run, lm_finalize


EXIT_MESSAGES = {
    1: "Sum of squares is at most tolerance",
    2: "norm(J'f) is at most tolerance",
    3: "Relative change, |dx|/|x|, is at most rel_xtol",
    4: "Both actual and predicted relative reductions are at most rel_ftol",
    5: "Maximum iterations exceeded (treated as converged)",
    6: "Stopping after nu overflow",
    7: "(near-)singular linear system",
    8: "Non-finite values encountered",
}
