"""chi2 functions of a model and a dataset (counterpart of
pygsti_tpu/tools/chi2fns.py): the total (the objective module's ``chi2``,
re-exported), per circuit, the gradient and Hessians, chi-alpha, and the
pointwise terms.  The Hessians are the objective's (``hessian``,
``weighted_gram``): the Gram through the blocked Jacobian's kernel on a
'blocked' layout."""

from __future__ import annotations

import numpy as np
import torch

from pygsti_tpu_torch.objectivefns.objectivefns import (  # noqa: F401 (re-exported)
    RawChi2Function, RawChiAlphaFunction, TimeIndependentMDCObjectiveFunction, chi2)


def _chi2_objective(model, dataset, circuits, min_prob_clip_for_weighting, device):
    raw = RawChi2Function({'min_prob_clip_for_weighting': min_prob_clip_for_weighting})
    circuits = list(circuits) if circuits is not None else list(dataset.keys())
    return TimeIndependentMDCObjectiveFunction(raw, model, dataset, circuits, device=device)


def chi2_per_circuit(model, dataset, circuits=None, min_prob_clip_for_weighting=1e-4,
                     device="cuda", **_kwargs):
    return _chi2_objective(model, dataset, circuits, min_prob_clip_for_weighting,
                           device).percircuit()


def chi2_jacobian(model, dataset, circuits=None, min_prob_clip_for_weighting=1e-4,
                  device="cuda", **_kwargs):
    """d chi2 / d params."""
    return _chi2_objective(model, dataset, circuits, min_prob_clip_for_weighting,
                           device).gradient()


def chi2_hessian(model, dataset, circuits=None, min_prob_clip_for_weighting=1e-4,
                 device="cuda", **_kwargs):
    """d2 chi2 / d params2."""
    return _chi2_objective(model, dataset, circuits, min_prob_clip_for_weighting,
                           device).hessian()


def chi2_approximate_hessian(model, dataset, circuits=None, min_prob_clip_for_weighting=1e-4,
                             device="cuda", **_kwargs):
    """2 J^T J with J = d lsvec / d params (the Gauss-Newton form): the
    Gram of the probability Jacobian weighted by 2 dlsvec^2."""
    obj = _chi2_objective(model, dataset, circuits, min_prob_clip_for_weighting, device)
    data = obj._data
    with torch.no_grad():
        p = obj._fns['probs'](obj._v(None))
        w = 2 * obj.raw_objfn.dlsvec(p, *data) ** 2
    return obj.weighted_gram(w)


def chialpha_per_circuit(alpha, model, dataset, circuits=None, pfratio_stitchpt=1e-2,
                         pfratio_derivpt=1e-2, radius=None, device="cuda", **_kwargs):
    reg = {'pfratio_stitchpt': pfratio_stitchpt, 'pfratio_derivpt': pfratio_derivpt}
    if radius is not None:
        reg['radius'] = radius
    circuits = list(circuits) if circuits is not None else list(dataset.keys())
    return TimeIndependentMDCObjectiveFunction(RawChiAlphaFunction(reg, alpha=alpha), model,
                                               dataset, circuits, device=device).percircuit()


def chialpha(alpha, model, dataset, circuits=None, pfratio_stitchpt=1e-2, pfratio_derivpt=1e-2,
             radius=None, device="cuda", **_kwargs):
    return float(np.sum(chialpha_per_circuit(alpha, model, dataset, circuits, pfratio_stitchpt,
                                             pfratio_derivpt, radius, device)))


def chi2fn_2outcome(n, p, f, min_prob_clip_for_weighting=1e-4):
    """n (p - f)^2 / (cp (1 - cp)), cp = p clipped to [mpc, 1 - mpc]."""
    cp = np.clip(p, min_prob_clip_for_weighting, 1 - min_prob_clip_for_weighting)
    return n * (p - f) ** 2 / (cp * (1 - cp))


def chi2fn_2outcome_wfreqs(n, p, f):
    """n (p - f)^2 / (f1 (1 - f1)), f1 = (f n + 1) / (n + 2)."""
    f1 = (f * n + 1) / (n + 2)
    return n * (p - f) ** 2 / (f1 * (1 - f1))


def chi2fn(n, p, f, min_prob_clip_for_weighting=1e-4):
    """n (p - f)^2 / max(p, mpc)."""
    return n * (p - f) ** 2 / np.clip(p, min_prob_clip_for_weighting, None)


def chi2fn_wfreqs(n, p, f, min_freq_clip_for_weighting=1e-4):
    """n (p - f)^2 / max(f, mfc)."""
    return n * (p - f) ** 2 / np.clip(f, min_freq_clip_for_weighting, None)
