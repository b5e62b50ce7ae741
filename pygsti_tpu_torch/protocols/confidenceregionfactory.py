"""Confidence regions: Hessian-based error bars of an estimate (counterpart
of pygsti_tpu/protocols/confidenceregionfactory.py).

The Hessian is that of Delta logL at the estimate, on the factory's
`device`: the Gauss-Newton Gram J^T diag(hterms) J through the blocked
Jacobian's kernel, plus, for the exact Hessian, sum_e dterms_e d2 p_e by
forward over reverse of the scan in chunks of tangents
(objectivefns.TimeIndependentMDCObjectiveFunction.hessian).  It is
projected onto the non-gauge directions (models/nongauge.py) in one of four
ways and inverted there; the inverse gives profile-likelihood intervals of
the parameters and error bars of functions of the model.  Linear-response
error bars solve H x = g by conjugate gradients on the non-gauge subspace
instead of inverting.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize as spo
import scipy.sparse.linalg as spla
import scipy.stats as st
import torch

from pygsti_tpu_torch import DTYPE
from pygsti_tpu_torch.models.nongauge import nongauge_and_gauge_spaces
from pygsti_tpu_torch.objectivefns.objectivefns import (RawPoissonPicDeltaLogLFunction,
                                                        TimeIndependentMDCObjectiveFunction)


def _inverse_on_nongauge(projected, n_gauge):
    """Invert the symmetric `projected` with its n_gauge smallest-|eigenvalue|
    directions left out."""
    evals, U = torch.linalg.eigh((projected + projected.T) / 2)
    order = torch.argsort(torch.abs(evals))
    keep = torch.zeros_like(evals, dtype=torch.bool)
    keep[order[n_gauge:]] = True
    keep &= torch.abs(evals) > 1e-300
    inv_evals = torch.where(keep, 1.0 / torch.where(keep, evals, torch.ones_like(evals)),
                            torch.zeros_like(evals))
    return (U * inv_evals[None, :]) @ U.T


def _project_hessian_std(H, nongauge_space, gauge_space):
    """H in (nongauge, gauge) coordinates with the gauge and coupling blocks
    zeroed, transformed back."""
    invB = torch.cat([nongauge_space, gauge_space], dim=1)
    B = torch.linalg.inv(invB)
    Hp = invB.T @ H @ invB
    n = nongauge_space.shape[1]
    Hp[:n, n:] = 0.0
    Hp[n:, :n] = 0.0
    Hp[n:, n:] = 0.0
    return B.T @ Hp @ B


class ConfidenceRegionFactory(object):
    """The Hessian of an estimate's objective, its projections and their
    inverses.  `device` defaults to the parent estimate's."""

    def __init__(self, parent_estimate, model_lbl='final iteration estimate',
                 circuit_list_lbl='final', hessian=None, non_mark_radius=0, device=None):
        self.parent = parent_estimate
        self.model_lbl = model_lbl
        self.circuit_list_lbl = circuit_list_lbl
        self.hessian = hessian
        self.jacobian = None
        self.inv_hessian_projections = {}
        self.hessian_projection_parameters = {}
        self.nonMarkRadiusSq = non_mark_radius
        self.nNonGaugeParams = None
        self.nGaugeParams = None
        self.linresponse_mlgst_params = None
        self.device = torch.device(device if device is not None
                                   else getattr(parent_estimate, 'device', 'cuda'))
        self._obj = None
        self._exact = None

    @property
    def model(self):
        return self.parent.models[self.model_lbl]

    @property
    def inv_hessian_projected(self):
        """The most recent projection's inverse."""
        if not self.inv_hessian_projections:
            return None
        return self.inv_hessian_projections[list(self.inv_hessian_projections)[-1]]

    @inv_hessian_projected.setter
    def inv_hessian_projected(self, val):
        if val is not None:
            self.inv_hessian_projections['default'] = val

    def has_hessian(self):
        return self.hessian is not None

    def can_construct_views(self):
        return bool(self.inv_hessian_projections) or self.linresponse_mlgst_params is not None

    def objective(self):
        """The Poisson-picture Delta logL of the model on the circuit list,
        on the factory's device (made once)."""
        if self._obj is None:
            results = self.parent.parent
            circuits = list(results.circuit_lists[self.circuit_list_lbl])
            self._obj = TimeIndependentMDCObjectiveFunction(
                RawPoissonPicDeltaLogLFunction(), self.model, results.dataset, circuits,
                device=self.device)
        return self._obj

    def compute_hessian(self, comm=None, mem_limit=None, approximate=False):
        """The Hessian of Delta logL (minus that of logL) at the estimate;
        `approximate` keeps the Gauss-Newton Gram only.  Also sets
        ``jacobian``, the gradient there."""
        obj = self.objective()
        self.hessian = obj.hessian(approximate=approximate)
        if not approximate:
            self._exact = self.hessian
        self.jacobian = obj.gradient()
        return self.hessian

    def enable_linear_response_errorbars(self, resource_alloc=None):
        """Error bars by the response of the estimate to a forcing term:
        var f = g^T x with H x = g solved by conjugate gradients."""
        self.linresponse_mlgst_params = {'enabled': True}

    def _hvp_solve(self, g, tol=1e-8, maxiter=None):
        """x with Pg H Pg x = Pg g, by conjugate gradients on products with
        the exact Hessian (made once), Pg the projector onto the non-gauge
        space, where H is singular along the gauge.  `maxiter` defaults to
        max(500, 10 P)."""
        if self._exact is None:
            self._exact = self.objective().hessian()
        H = self._exact
        ng, _ = nongauge_and_gauge_spaces(self.model, device=self.device)
        Pg = (ng @ ng.T).cpu().numpy()
        n = H.shape[0]
        A = spla.LinearOperator((n, n), matvec=lambda x: Pg @ (H @ (Pg @ x)))
        maxiter = max(500, 10 * n) if maxiter is None else maxiter
        try:
            x, _ = spla.cg(A, Pg @ np.asarray(g), rtol=tol, maxiter=maxiter)
        except TypeError:      # scipy before 1.12 names it tol
            x, _ = spla.cg(A, Pg @ np.asarray(g), tol=tol, maxiter=maxiter)
        return Pg @ x

    def project_hessian(self, projection_type='std', label=None, tol=1e-7, maxiter=10000,
                        verbosity=0):
        """Project the Hessian onto the non-gauge directions and invert it
        there; the inverse is kept under `label` (default: the type).

        'std'              the gauge and coupling blocks of H in (nongauge,
                           gauge) coordinates zeroed;
        'none'             no projection;
        'intrinsic error'  H itself, its n_gauge smallest-|eigenvalue|
                           directions left out of the inverse;
        'optimal gate CIs' 'std' with the non-gauge directions mixed with
                           gauge ones by M, chosen by L-BFGS-B to minimize
                           the sum of the gates' interval half-widths."""
        assert self.hessian is not None, "Compute Hessian first"
        label = projection_type if label is None else label
        H = torch.as_tensor(self.hessian, dtype=DTYPE, device=self.device)
        H = (H + H.T) / 2
        P = H.shape[0]
        if projection_type == 'none':
            self.nNonGaugeParams, self.nGaugeParams = P, 0
        else:
            ng, g = nongauge_and_gauge_spaces(self.model, tol, self.device)
            self.nNonGaugeParams = ng.shape[1]
            self.nGaugeParams = P - self.nNonGaugeParams
        if projection_type in ('none', 'intrinsic error'):
            projected = H
        elif projection_type == 'std':
            projected = _project_hessian_std(H, ng, g)
        elif projection_type == 'optimal gate CIs':
            projected = self._opt_projection_for_operation_cis(H, ng, g,
                                                               maxiter=min(maxiter, 100))
        else:
            raise ValueError("Invalid projection_type: %r" % projection_type)
        inv = _inverse_on_nongauge(projected, self.nGaugeParams).cpu().numpy()
        self.inv_hessian_projections[label] = inv
        self.hessian_projection_parameters[label] = {
            'projection_type': projection_type, 'tol': tol, 'maxiter': maxiter}
        return inv

    def _opt_projection_for_operation_cis(self, H, ng, g, maxiter=100):
        """'std' projection along ng + g M^T, M [n_nongauge, n_gauge] by
        L-BFGS-B from 0.  With O = [ng, g] orthogonal, the projection is
        ng A ng^T, A = (ng + g M^T)^T H (ng + g M^T), whose inverse on the
        non-gauge space is ng A^-1 ng^T: the objective, the sum over the
        gates' parameters of sqrt(|diag|) of that, and its gradient come
        from one solve on the device, where the JAX package differences
        P x P eigendecompositions."""
        nNG, nG = ng.shape[1], g.shape[1]
        if nG == 0:
            return _project_hessian_std(H, ng, g)
        model = self.model
        gates = np.concatenate([np.arange(model.num_params)[op.gpindices]
                                for op in model.operations.values()]) \
            if len(model.operations) else np.arange(H.shape[0])
        ng_g = ng[torch.as_tensor(gates, device=self.device)]
        Hnn, Hng, Hgg = ng.T @ H @ ng, ng.T @ H @ g, g.T @ H @ g

        def ci_sum(x):
            M = torch.as_tensor(x, dtype=DTYPE, device=self.device).reshape(nNG, nG) \
                .requires_grad_(True)
            A = Hnn + Hng @ M.T + M @ Hng.T + M @ Hgg @ M.T
            diag = (ng_g * torch.linalg.solve(A, ng_g.T).T).sum(1)
            val = torch.sqrt(torch.abs(diag)).sum()
            val.backward()
            return float(val.detach()), M.grad.reshape(-1).cpu().numpy()

        res = spo.minimize(ci_sum, np.zeros(nNG * nG), jac=True, method='L-BFGS-B',
                           options={'maxiter': maxiter})
        M = torch.as_tensor(res.x, dtype=DTYPE, device=self.device).reshape(nNG, nG)
        return _project_hessian_std(H, ng + g @ M.T, g)

    def view(self, confidence_level=95, region_type='normal', hessian_projection=None):
        """A view at one confidence level; 'non-markovian radius' widens the
        intervals by the factory's non-Markovian radius."""
        if hessian_projection is None and not self.inv_hessian_projections \
                and self.hessian is not None:
            self.project_hessian('std')
        return ConfidenceRegionFactoryView(self, confidence_level, region_type,
                                           hessian_projection)


class ConfidenceRegionFactoryView(object):
    """Error bars at a fixed confidence level."""

    def __init__(self, factory, confidence_level=95, region_type='normal',
                 hessian_projection=None):
        self.factory = factory
        self.confidence_level = confidence_level
        self.region_type = region_type
        self.hessian_projection = hessian_projection
        # the one-degree-of-freedom chi2 quantile: the profile-likelihood scale
        C1 = st.chi2.ppf(confidence_level / 100.0, 1)
        if region_type == 'non-markovian radius':
            C1 = C1 * (1 + np.sqrt(max(factory.nonMarkRadiusSq, 0.0)))
        self._C1 = C1
        self._profile_lcis = None

    @property
    def errorbar_type(self):
        if self.factory.linresponse_mlgst_params is not None \
                and not self.factory.inv_hessian_projections:
            return 'linear response'
        return 'hessian'

    def _inv_hessian(self):
        f = self.factory
        if self.hessian_projection is not None:
            if self.hessian_projection not in f.inv_hessian_projections:
                f.project_hessian(self.hessian_projection, label=self.hessian_projection)
            return f.inv_hessian_projections[self.hessian_projection]
        if not f.inv_hessian_projections:
            f.project_hessian('std')
        return f.inv_hessian_projected

    def profile_likelihood_confidence_intervals(self):
        """Per parameter, the interval half-width sqrt(C1 |diag(H^-1)|)."""
        if self._profile_lcis is None:
            self._profile_lcis = np.sqrt(self._C1 * np.abs(np.diag(self._inv_hessian())))
        return self._profile_lcis

    def retrieve_profile_likelihood_confidence_intervals(self, label=None):
        """The intervals of one member's parameters (operation, prep or
        POVM label), or of all when `label` is None."""
        lcis = self.profile_likelihood_confidence_intervals()
        if label is None:
            return lcis
        model = self.factory.model
        for container in (model.operations, model.preps, model.povms):
            if label in container:
                return lcis[container[label].gpindices]
        raise KeyError("Label %r not found in model members" % (label,))

    def compute_uncertainty(self, fn_of_model, model=None, eps=1e-7):
        """The interval half-width of the scalar fn(model): sqrt(C1 g^T H^-1
        g) with g its forward-difference gradient over the parameters, or
        g^T x with H x = g solved (linear response).

        `fn_of_model` is a callable of a model, whose gradient is differenced
        over every parameter, or a report ModelFunction, evaluated by its
        ``evaluate_nearby`` and differenced over the parameters of the
        members it depends on only: the others leave it unchanged, so their
        entries of g are 0 either way."""
        factory = self.factory
        model = model if model is not None else factory.model
        v0 = model.to_vector()
        indices = range(len(v0))
        if hasattr(fn_of_model, 'evaluate_nearby'):
            found = fn_of_model.parameter_indices(model)
            indices = indices if found is None else found
            fn_of_model = fn_of_model.evaluate_nearby
        f0 = fn_of_model(model)
        grad = np.zeros(len(v0))
        work = model.copy()
        for i in indices:
            vp = v0.copy()
            vp[i] += eps
            work.from_vector(vp)
            grad[i] = (fn_of_model(work) - f0) / eps
        if self.errorbar_type == 'linear response':
            var = float(grad @ factory._hvp_solve(grad))
        else:
            var = float(grad @ self._inv_hessian() @ grad)
        return np.sqrt(self._C1 * max(var, 0.0))
