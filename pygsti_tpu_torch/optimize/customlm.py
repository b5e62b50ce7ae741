"""custom_leastsq (counterpart of pygsti_tpu/optimize/customlm.py): the host
LM loop of simplerlm.py with the reference's knob surface, from a
residual function and its Jacobian."""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.optimize.simplerlm import (CustomLMOptimizer, Optimizer,  # noqa: F401
                                                 OptimizerResult, SimplerLMOptimizer,
                                                 simplish_leastsq)


def custom_leastsq(obj_fn, jac_fn, x0, f_norm2_tol=1e-6, jac_norm_tol=1e-6, rel_ftol=1e-6,
                   rel_xtol=1e-6, max_iter=100, num_fd_iters=0, max_dx_scale=1.0,
                   damping_mode="identity", damping_basis="diagonal_values",
                   damping_clip=None, use_acceleration=False, uphill_step_threshold=0.0,
                   init_munu="auto", oob_check_interval=0, oob_action="reject",
                   oob_check_mode=0, resource_alloc=None, arrays_interface=None,
                   serial_solve_proc_threshold=100, x_limits=None, verbosity=0,
                   profiler=None):
    """Levenberg-Marquardt least squares of obj_fn with Jacobian jac_fn:
    simplish_leastsq on J^T J and J^T f formed on the host.  'adaptive'
    damping, damping_basis='singular_values' and use_acceleration raise
    NotImplementedError; num_fd_iters and the MPI arguments are accepted
    and not used, as in the JAX package."""
    if damping_basis != "diagonal_values":
        raise NotImplementedError("damping_basis=%r is not implemented (only "
                                  "'diagonal_values')" % damping_basis)
    if use_acceleration:
        raise NotImplementedError("use_acceleration=True (geodesic acceleration) is not "
                                  "implemented")

    def jtj_jtf_fn(x):
        f = np.asarray(obj_fn(x))
        J = np.asarray(jac_fn(x))
        return f, J.T @ J, J.T @ f

    return simplish_leastsq(obj_fn, jtj_jtf_fn, x0, f_norm2_tol=f_norm2_tol,
                            jac_norm_tol=jac_norm_tol, rel_ftol=rel_ftol, rel_xtol=rel_xtol,
                            max_iter=max_iter, max_dx_scale=max_dx_scale, init_munu=init_munu,
                            oob_check_interval=oob_check_interval, oob_action=oob_action,
                            oob_check_mode=oob_check_mode,
                            x_limits=None if x_limits is None
                            else np.asarray(x_limits, dtype=float),
                            damping_mode=damping_mode, damping_clip=damping_clip,
                            uphill_step_threshold=uphill_step_threshold, verbosity=verbosity)
