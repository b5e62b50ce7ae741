"""Log-likelihood functions of a model and a dataset (counterpart of
pygsti_tpu/tools/likelihoodfns.py): the totals, per circuit, their
gradient and Hessians, N_sigma, and the pointwise term.

``logl``, ``logl_max`` and ``two_delta_logl`` are the objective module's own
(objectivefns/objectivefns.py), re-exported here.  The gradient and the
Hessians are those of the objective (``gradient``, ``hessian``): the
Gauss-Newton Gram J^T diag(hterms) J through the blocked Jacobian's kernel
on a 'blocked' layout, and the exact Hessian's second-derivative term by
forward over reverse of the scan.  logL = logl_max - Delta logL, so each
derivative of logL is minus the objective's.
"""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.objectivefns.objectivefns import (  # noqa: F401 (re-exported)
    RawDeltaLogLFunction, RawPoissonPicDeltaLogLFunction, TimeIndependentMDCObjectiveFunction,
    logl, logl_max, two_delta_logl)


def _delta_logl_objective(model, dataset, circuits, min_prob_clip, radius, poisson_picture,
                          device):
    circuits = list(circuits) if circuits is not None else list(dataset.keys())
    if poisson_picture:
        raw = RawPoissonPicDeltaLogLFunction({'min_prob_clip': min_prob_clip, 'radius': radius})
    else:
        raw = RawDeltaLogLFunction({'min_prob_clip': min_prob_clip})
    return TimeIndependentMDCObjectiveFunction(raw, model, dataset, circuits, device=device)


def logl_jacobian(model, dataset, circuits=None, min_prob_clip=1e-4,
                  prob_clip_interval=(-1e6, 1e6), radius=1e-4, poisson_picture=True,
                  device="cuda", **_kwargs):
    """d logL / d params."""
    return -_delta_logl_objective(model, dataset, circuits, min_prob_clip, radius,
                                  poisson_picture, device).gradient()


def logl_hessian(model, dataset, circuits=None, min_prob_clip=1e-4,
                 prob_clip_interval=(-1e6, 1e6), radius=1e-4, poisson_picture=True,
                 device="cuda", **_kwargs):
    """d2 logL / d params2: minus the Hessian of Delta logL."""
    return -_delta_logl_objective(model, dataset, circuits, min_prob_clip, radius,
                                  poisson_picture, device).hessian()


def logl_approximate_hessian(model, dataset, circuits=None, min_prob_clip=1e-4,
                             prob_clip_interval=(-1e6, 1e6), radius=1e-4,
                             poisson_picture=True, device="cuda", **_kwargs):
    """The Gauss-Newton form of logl_hessian, -J^T diag(hterms) J (the
    Poisson picture, as in the JAX package, whatever `poisson_picture`)."""
    return -_delta_logl_objective(model, dataset, circuits, min_prob_clip, radius, True,
                                  device).hessian(approximate=True)


def logl_max_per_circuit(model, dataset, circuits=None, poisson_picture=True, **_kwargs):
    """Per circuit: sum of n log(n / N) over its outcomes, less N in the
    Poisson picture."""
    circuits = list(circuits) if circuits is not None else list(dataset.keys())
    return np.array([logl_max(model, dataset, [c], poisson_picture) for c in circuits])


def two_delta_logl_per_circuit(model, dataset, circuits=None, min_prob_clip=1e-6,
                               prob_clip_interval=(-1e6, 1e6), radius=1e-4,
                               poisson_picture=True, device="cuda", **_kwargs):
    """Per circuit 2 (logL_max - logL)."""
    return 2.0 * _delta_logl_objective(model, dataset, circuits, min_prob_clip, radius,
                                       poisson_picture, device).percircuit()


def logl_per_circuit(model, dataset, circuits=None, min_prob_clip=1e-6,
                     prob_clip_interval=(-1e6, 1e6), radius=1e-4, poisson_picture=True,
                     device="cuda", **_kwargs):
    """Per circuit logL."""
    return logl_max_per_circuit(model, dataset, circuits, poisson_picture) \
        - 0.5 * two_delta_logl_per_circuit(model, dataset, circuits, min_prob_clip,
                                           radius=radius, poisson_picture=poisson_picture,
                                           device=device)


def two_delta_logl_nsigma(model, dataset, circuits=None, min_prob_clip=1e-6,
                          prob_clip_interval=(-1e6, 1e6), radius=1e-4, poisson_picture=True,
                          dof_calc_method='modeltest', device="cuda", **_kwargs):
    """(2 Delta logL - k) / sqrt(2k): k is the data's degrees of freedom
    ('modeltest': the model is fixed) or that less the model's parameter
    count ('nongauge'), at least 1."""
    two_dlogl = two_delta_logl(model, dataset, circuits, min_prob_clip=min_prob_clip,
                               radius=radius, poisson_picture=poisson_picture, device=device)
    circuits = list(circuits) if circuits is not None else list(dataset.keys())
    k = dataset.degrees_of_freedom(circuits)
    if dof_calc_method == 'nongauge':
        k -= model.num_params
    elif dof_calc_method != 'modeltest':
        raise ValueError("Invalid `dof_calc_method`: %s" % dof_calc_method)
    k = max(k, 1)
    return (two_dlogl - k) / np.sqrt(2 * k)


def two_delta_logl_term(n, p, f, min_prob_clip=1e-6, poisson_picture=True):
    """The pointwise 2 Delta logL term of counts n = N f at probability p."""
    n = np.asarray(n, float)
    p = np.clip(np.asarray(p, float), min_prob_clip, None)
    f = np.asarray(f, float)
    N = np.where(f > 0, n / np.where(f > 0, f, 1.0), n)
    with np.errstate(divide='ignore', invalid='ignore'):
        term = 2 * np.where(n > 0, n * (np.log(np.where(f > 0, f, 1.0)) - np.log(p)), 0.0)
    if poisson_picture:
        term = term + 2 * (N * p - n)
    return term
