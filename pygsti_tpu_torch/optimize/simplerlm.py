"""Levenberg-Marquardt optimizer for GST (counterpart of
pygsti_tpu/optimize/simplerlm.py: SimplerLMOptimizer's device branch; the
host loop, finite-difference iterations and out-of-bounds modes are not
ported)."""

from __future__ import annotations

import time

import numpy as np


class OptimizerResult(object):
    """Result of one optimization."""

    def __init__(self, objective, opt_x, opt_f=None, opt_unpenalized_f=None,
                 chi2_k_distributed_qty=None, optimizer_specific_qtys=None):
        self.objective = objective
        self.x = opt_x
        self.f = opt_f
        self.f_no_penalties = opt_unpenalized_f
        self.chi2_k_distributed_qty = chi2_k_distributed_qty
        self.optimizer_specific_qtys = optimizer_specific_qtys


class SimplerLMOptimizer(object):
    """LM optimizer whose loop runs on the objective's device."""

    @classmethod
    def cast(cls, obj):
        if isinstance(obj, cls):
            return obj
        if obj is None:
            return cls()
        if isinstance(obj, dict):
            return cls(**obj)
        raise ValueError("Cannot cast %r to SimplerLMOptimizer" % (obj,))

    def __init__(self, maxiter=100, tol=1e-6, linesearch=None):
        if isinstance(tol, (float, int)):
            tol = {'relx': 1e-8, 'relf': float(tol), 'f': 1.0, 'jac': float(tol),
                   'maxdx': 1.0}
        else:
            tol = {'relx': 1e-8, 'relf': 1e-6, 'f': 1.0, 'jac': 1e-6, 'maxdx': 1.0,
                   **tol}
        self.maxiter = maxiter
        self.tol = tol
        self.linesearch = {'beta': 0.25, 'max_evals': 6, 'kappa': 1.0,
                           **(linesearch or {})}

    def run(self, objective):
        """Minimize `objective`; the model takes the optimum.  Raises if the
        loop ends without converging."""
        x0 = objective.model.to_vector()
        t0 = time.time()
        x, converged, msg, mu, nu, norm_f, f, iters = objective.run_device_lm(
            x0, maxiter=self.maxiter, tol=self.tol, linesearch=self.linesearch)
        wall = time.time() - t0
        if not converged:
            raise RuntimeError("Failed to converge: %s" % msg)
        objective.model.from_vector(x)
        unpenalized_normf = float(np.sum(f[:objective.num_elements] ** 2))
        return OptimizerResult(
            objective, x, norm_f, unpenalized_normf,
            objective.chi2k_distributed_qty(unpenalized_normf),
            {'msg': msg, 'mu': mu, 'nu': nu, 'fvec': f, 'iterations': iters,
             'wall_s': wall})
