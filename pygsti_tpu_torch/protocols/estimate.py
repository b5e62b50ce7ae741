"""Estimate: one GST estimate with its gauge-optimized variants and
metadata, and the goodness of fit of a GST estimate (counterpart of
pygsti_tpu/protocols/estimate.py)."""

from __future__ import annotations

import collections

import numpy as np


def misfit_sigma(final_objfn_value, final_dof):
    """N_sigma = (2*DeltaLogL - k) / sqrt(2k), with k the data's degrees of
    freedom less the model's parameter count (at least 1), as the JAX
    package's GateSetTomography sets ``final_dof``."""
    k = max(final_dof, 1)
    return (final_objfn_value - k) / np.sqrt(2 * k)


class Estimate(object):
    """A GST estimate: models dict (target/seed/iteration/final + gauge-opt
    variants), fit parameters, and goodness-of-fit access.  ``device`` is
    where its statistics are computed: the fit's device for a GST estimate."""

    def __init__(self, parent=None, models=None, parameters=None, device="cuda"):
        self.parent = parent
        self.device = device
        self.models = collections.OrderedDict(models or {})
        self.parameters = dict(parameters or {})
        self.goparameters = collections.OrderedDict()
        self.confidence_region_factories = {}

    @classmethod
    def create_gst_estimate(cls, parent, target_model, seed_model, models_by_iter,
                            parameters):
        models = collections.OrderedDict()
        models['target'] = target_model
        models['seed'] = seed_model
        for i, m in enumerate(models_by_iter):
            models['iteration %d estimate' % i] = m
        models['final iteration estimate'] = models_by_iter[-1] if models_by_iter else seed_model
        return cls(parent, models, parameters)

    def add_gaugeoptimized(self, goparams, model=None, label=None, comm=None, verbosity=0,
                           device="cuda"):
        """Add a gauge-optimized version of the final model."""
        from pygsti_tpu_torch.algorithms.gaugeopt import gaugeopt_to_target
        if label is None:
            label = "go%d" % len(self.goparameters)
        if model is None:
            gop = dict(goparams)
            gop.pop('verbosity', None)
            target = gop.pop('target_model', self.models.get('target'))
            mdl = self.models['final iteration estimate']
            model = gaugeopt_to_target(mdl, target, device=device, **gop)
        self.models[label] = model
        self.goparameters[label] = goparams
        return model

    def misfit_sigma(self):
        """N_sigma of the final fit; the expected value uses the model's
        total parameter count.  None when the estimate holds no fit."""
        fit = self.parameters.get('final_objfn_value')
        k = self.parameters.get('final_dof')
        if fit is None or k is None:
            return None
        return misfit_sigma(fit, k)

    def create_confidence_region_factory(self, model_label='final iteration estimate',
                                         circuits_label='final', device=None):
        """A ConfidenceRegionFactory of the model and circuit list, on
        `device` (default: the estimate's), kept in
        ``confidence_region_factories[(model_label, circuits_label)]``."""
        from pygsti_tpu_torch.protocols.confidenceregionfactory import ConfidenceRegionFactory
        crf = ConfidenceRegionFactory(self, model_label, circuits_label, device=device)
        self.confidence_region_factories[CRFkey(model_label, circuits_label)] = crf
        return crf

    def __getitem__(self, key):
        return self.models[key]

    def __contains__(self, key):
        return key in self.models

    def keys(self):
        return self.models.keys()


# key type for confidence_region_factories; a namedtuple compares equal to
# the plain (model, circuit_list) tuples, so both forms interoperate.
CRFkey = collections.namedtuple('CRFkey', ['model', 'circuit_list'])
