"""Levenberg-Marquardt with its state on the device (counterpart of
pygsti_tpu/optimize/device_lm.py: make_device_lm).

The update semantics are the JAX package's (and the reference's
simplish_leastsq): identity damping on the JTJ diagonal, the (mu, nu)
schedule with gain-ratio factor 1-(2 dF/dL-1)^3, a guarded backtracking line
search folded into one residual evaluation per inner iteration, and the same
convergence tests.  Every state tensor stays on the device; the host reads a
scalar only where a loop decides whether (and how) to go on: the outer exit
code, and the inner loop's (phase, done) pair.  The out-of-bounds protocol
and the conjugate-gradient solver are not ported.

Exit codes: 0 = running, 1 = f_norm2_tol, 2 = jac_norm_tol, 3 = rel_xtol,
4 = rel_ftol, 5 = max_iter, 6 = nu overflow, 7 = singular, 8 = non-finite.
"""

from __future__ import annotations

from typing import NamedTuple, Any

import torch


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
    exit_code: Any


def _solve_damped(JTJ, jtj_diag, mu, minus_JTf):
    """Solve (JTJ + mu*I) dx = -JTf via Cholesky; NaNs signal failure."""
    A = JTJ.clone()
    A.diagonal().copy_(jtj_diag + mu)
    L, info = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, minus_JTf[:, None], upper=False)
    dx = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    return torch.where(info == 0, dx, torch.full_like(dx, float('nan')))


def make_device_lm(jtj_jtf_fn, lsvec_fn, ls_beta=0.25, ls_max_evals=6,
                   ls_kappa=1.0, max_inner=16):
    """Build the LM driver from jtj_jtf_fn(x) -> (f, JTJ, JTf) and
    lsvec_fn(x) -> f.  Returns (lm_init, lm_run, lm_finalize); lm_run takes
    the iteration cap and tols = (f_norm2_tol, jac_norm_tol, rel_ftol,
    rel_xtol, max_norm_dx)."""
    tau = 1e-3
    half_max_nu = 2.0 ** 62
    max_evals = 3 * max_inner

    def lm_init(x0):
        f0 = lsvec_fn(x0)
        norm_f0 = torch.dot(f0, f0)
        one = torch.ones((), dtype=x0.dtype, device=x0.device)
        return _LMState(0, x0, f0, norm_f0, one, 2 * one, x0, norm_f0, f0,
                        torch.zeros((), dtype=torch.int64, device=x0.device))

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
                dx = _solve_damped(JTJ, jtj_diag, mu, minus_JTf)
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
        exit_code = torch.where(norm_f < f_norm2_tol, 1, torch.where(
            norm_JTf < jac_norm_tol, 2, torch.where(~finite_jtj, 8, code)))
        return _LMState(st.k + 1, x1, f1, norm_f1, mu, nu,
                        torch.where(improved, x1, st.best_x),
                        torch.where(improved, norm_f1, st.best_norm_f),
                        torch.where(improved, f1, st.best_f), exit_code)

    def lm_run(state, max_iter, tols):
        """Iterate until an exit code is set or `max_iter` iterations."""
        while state.k < max_iter and int(state.exit_code) == 0:
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
