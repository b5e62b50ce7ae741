"""Simple time-resolved models for DIY time-resolved tomography
(counterpart of pygsti_tpu/extras/drift/trmodel.py)."""

from __future__ import annotations

import copy as _copy

from pygsti_tpu_torch.extras.drift import probtrajectory as _ptraj


class TimeResolvedModel(object):
    """Container for a basic time-resolved model (e.g. time-resolved
    Ramsey spectroscopy).  Subclasses implement `probabilities(circuit,
    times)` returning {outcome: [p(t) for t in times]} (reference:
    trmodel.TimeResolvedModel:19)."""

    def __init__(self, hyperparameters, parameters):
        self.hyperparameters = hyperparameters
        self.parameters = parameters

    def set_parameters(self, parameters):
        self.parameters = _copy.deepcopy(parameters)

    def parameters_copy(self):
        return _copy.deepcopy(self.parameters)

    def probabilities(self, circuit, times):
        raise NotImplementedError("Derived classes need to implement this!")

    def copy(self):
        return _copy.deepcopy(self)


def negloglikelihood(trmodel, ds, minp=0, maxp=1):
    """-logL of a TimeResolvedModel given time-series data (reference:
    trmodel.negloglikelihood:97)."""
    negll = 0.0
    for circuit in ds.keys():
        times, clickstreams = ds[circuit].timeseries_for_outcomes
        probs = {o: _as_array(p) for o, p in
                 trmodel.probabilities(circuit, times).items()}
        negll += _ptraj.probsdict_negloglikelihood(probs, clickstreams,
                                                   minp, maxp)
    return negll


def _as_array(p):
    import numpy as np
    return np.asarray(p, dtype=float)


def maxlikelihood(trmodel, ds, minp=1e-4, maxp=1 - 1e-6, bounds=None,
                  returnoptout=False, optoptions=None, verbosity=1):
    """Maximum-likelihood TimeResolvedModel over its parameters via
    scipy.optimize.minimize (reference: trmodel.maxlikelihood:128)."""
    from scipy.optimize import minimize as _minimize
    optoptions = optoptions or {}
    maxlmodel = trmodel.copy()

    def objfunc(parameters):
        maxlmodel.set_parameters(parameters)
        return negloglikelihood(maxlmodel, ds, minp, maxp)

    if verbosity > 0:
        print("- Performing MLE over %d parameters..."
              % len(maxlmodel.parameters_copy()), end='')
    seed = maxlmodel.parameters_copy()
    optout = _minimize(objfunc, seed, options=optoptions, bounds=bounds)
    maxlmodel.set_parameters(optout.x)
    if verbosity > 0:
        print("complete.")
    if returnoptout:
        return maxlmodel, optout
    return maxlmodel
