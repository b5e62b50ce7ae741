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


def diamond_norm(superop, mx_basis='pp', num_restarts=6, seed=0, return_x=False):
    """Diamond norm of a superoperator (usually a difference of channels),
    the best of L-BFGS-B from seeded starts, as in the JAX package.

    With `return_x`, (norm, psi): psi in C^(d*d) is the input of the best
    start, polished with the analytic gradient where the map preserves
    Hermiticity (a difference of channels).  The starts stop where their
    finite-difference gradient is about 1e-5, which leaves psi off the
    maximizer by about as much and the norm up to 1e-4 relative short of
    the maximum at d 16; a linearization at psi (trace_norm_at_input) needs
    the maximizer.  The norm returned is the starts' either way."""
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

    best, best_x = 0.0, None
    for _ in range(num_restarts):
        res = spo.minimize(objective, rng.normal(size=2 * D), method='L-BFGS-B',
                           options={'maxiter': 300, 'ftol': 1e-12})
        if best_x is None or -res.fun > best:
            best_x = res.x
        best = max(best, -res.fun)
    if not return_x:
        return best
    S4 = std.reshape(d, d, d, d)
    if np.allclose(S4, S4.transpose(1, 0, 3, 2).conj(), atol=1e-12, rtol=0):
        res = spo.minimize(lambda x: _neg_trace_norm_and_grad(std, x, d), best_x, jac=True,
                           method='L-BFGS-B', options={'maxiter': 500, 'ftol': 1e-15,
                                                       'gtol': 1e-13})
        if -objective(res.x) > best:
            best_x = res.x
    psi = best_x[:D] + 1j * best_x[D:]
    return best, psi / np.linalg.norm(psi)


def _neg_trace_norm_and_grad(std, x, d):
    """-||(L x I)(|phi><phi|)||_1, phi = psi/|psi| with psi = x[:D] + i x[D:],
    and its gradient in x, for a Hermiticity-preserving L: with S the sign
    of the output and K = (L x I)^dag(S), the norm is phi^dag K phi and its
    gradient in psi is (2/|psi|) (K phi - norm phi)."""
    D = d * d
    psi = x[:D] + 1j * x[D:]
    n = np.linalg.norm(psi)
    phi = psi / n
    M = _apply_channel_ext(std, phi, d)
    evals, U = np.linalg.eigh((M + M.conj().T) / 2)
    S = (U * np.sign(evals)) @ U.conj().T
    K = np.einsum('klab,kxly->axby', std.reshape(d, d, d, d).conj(),
                  S.reshape(d, d, d, d)).reshape(D, D)
    f = float(np.sum(np.abs(evals)))
    g = (2.0 / n) * (K @ phi - f * phi)
    return -f, -np.concatenate([g.real, g.imag])


def trace_norm_at_input(superop, psi, mx_basis='pp'):
    """||(L x I)(|psi><psi|)||_1 at a fixed unit input psi in C^(d*d): the
    diamond norm's objective, whose maximum over psi is the norm.  At the
    maximizer its first derivative in L is the norm's (Danskin's theorem),
    so it linearizes the norm about a point where the maximizer is known."""
    std = change_basis(np.asarray(superop), mx_basis, 'std')
    d = int(round(np.sqrt(std.shape[0])))
    return float(np.sum(np.linalg.svd(_apply_channel_ext(std, psi, d), compute_uv=False)))


def diamond_norm_distance(a, b, mx_basis='pp', num_restarts=6, seed=0, return_x=False):
    """||a - b||_diamond (no factor 1/2); with `return_x`, (distance, psi)
    as diamond_norm gives them."""
    return diamond_norm(np.asarray(a) - np.asarray(b), mx_basis, num_restarts, seed, return_x)


def _needs_cvxpy(*args, **kwargs):
    raise ImportError("this SDP model needs cvxpy, which is not installed")


# the JAX package's CVXPY model builders: they need cvxpy
solve_sdp = diamond_norm_model_jamiolkowski = diamond_norm_canon = _needs_cvxpy
cptp_superop_variable = root_fidelity_canon = _needs_cvxpy


def diamond_distance_projection_model(superop, basis, leakfree=False, seepfree=False,
                                      cptp=True, subspace_diamond=False):
    assert CVXPY_ENABLED, "cvxpy is required for SDP projection models"
    _needs_cvxpy()
