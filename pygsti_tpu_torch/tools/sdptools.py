"""The diamond norm (counterpart of pygsti_tpu/tools/sdptools.py).

||L||_diamond = max over |psi> in C^d x C^d of ||(L x I)(|psi><psi|)||_1,
maximized with L-BFGS-B from seeded random starts, as in the JAX package:
no SDP solver is needed for the GST regime (d <= 16).  The CVXPY model
builders of the JAX package need cvxpy, which neither package requires:
here they raise ImportError when cvxpy is absent (CVXPY_ENABLED).
"""

from __future__ import annotations

import importlib.util

import numpy as np
import scipy.optimize as spo

from pygsti_tpu_torch.tools.basistools import change_basis

CVXPY_ENABLED = importlib.util.find_spec("cvxpy") is not None


def _apply_channel_ext(std_superop, psi, d):
    """(L x I)(|psi><psi|) for |psi> in C^(d*d); L acts on the first
    factor's density-matrix indices."""
    rho4 = np.outer(psi, psi.conj()).reshape(d, d, d, d)
    S = std_superop.reshape(d, d, d, d)
    return np.einsum('klab,axby->kxly', S, rho4).reshape(d * d, d * d)


def diamond_norm(superop, mx_basis='pp', num_restarts=6, seed=0):
    """Diamond norm of a superoperator (usually a difference of channels)."""
    std = change_basis(np.asarray(superop), mx_basis, 'std')
    d = int(round(np.sqrt(std.shape[0])))
    D = d * d
    rng = np.random.default_rng(seed)

    def objective(x):
        psi = x[:D] + 1j * x[D:]
        nrm = np.linalg.norm(psi)
        if nrm < 1e-12:
            return 0.0
        m = _apply_channel_ext(std, psi / nrm, d)
        return -float(np.sum(np.linalg.svd(m, compute_uv=False)))

    best = 0.0
    for _ in range(num_restarts):
        res = spo.minimize(objective, rng.normal(size=2 * D), method='L-BFGS-B',
                           options={'maxiter': 300, 'ftol': 1e-12})
        best = max(best, -res.fun)
    return best


def diamond_norm_distance(a, b, mx_basis='pp', num_restarts=6, seed=0):
    """||a - b||_diamond (no factor 1/2)."""
    return diamond_norm(np.asarray(a) - np.asarray(b), mx_basis, num_restarts, seed)


def _needs_cvxpy(*args, **kwargs):
    raise ImportError("this SDP model needs cvxpy, which is not installed")


# the JAX package's CVXPY model builders: they need cvxpy
solve_sdp = diamond_norm_model_jamiolkowski = diamond_norm_canon = _needs_cvxpy
cptp_superop_variable = root_fidelity_canon = _needs_cvxpy


def diamond_distance_projection_model(superop, basis, leakfree=False, seepfree=False,
                                      cptp=True, subspace_diamond=False):
    assert CVXPY_ENABLED, "cvxpy is required for SDP projection models"
    _needs_cvxpy()
