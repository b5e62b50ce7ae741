"""Parameterized time-resolved probability trajectories (counterpart of
pygsti_tpu/extras/drift/probtrajectory.py).

A ProbTrajectory models the outcome distribution of a circuit as a function
of time: p_o(t) = sum_i a_{o,i} f_i(t) over basis functions f_i.  The
CosineProbTrajectory uses Type-II DCT basis functions (the same modes the
StabilityAnalyzer spectra detect).  Maximum-likelihood amplitudes come from
scipy's Nelder-Mead on the host, as in the JAX package: a trajectory has a
handful of amplitudes.
"""

from __future__ import annotations

import copy as _copy

import numpy as np


class ProbTrajectory(object):
    """A time-dependent outcome distribution as a sum of basis functions
    (reference: probtrajectory.ProbTrajectory:23).

    `parameters` maps each outcome EXCEPT the last to its basis-function
    amplitude list; the last outcome's trajectory is fixed by normalization.
    """

    def __init__(self, outcomes, hyperparameters, parameters):
        self.outcomes = list(outcomes)
        self.numoutcomes = len(self.outcomes)
        self.set_hyperparameters(hyperparameters, parameters)

    def copy(self):
        return _copy.deepcopy(self)

    def basisfunction(self, i, times):
        raise NotImplementedError("Defined in derived classes")

    def set_hyperparameters(self, hyperparameters, parameters):
        self.hyperparameters = list(hyperparameters)
        self.set_parameters(parameters)

    def set_parameters(self, parameters):
        assert set(parameters.keys()) == set(self.outcomes[:-1]), \
            "parameters must have a key for every outcome except the last"
        for v in parameters.values():
            assert len(v) == len(self.hyperparameters)
        self.parameters = {k: list(v) for k, v in parameters.items()}

    def parameters_as_vector(self):
        return np.concatenate([self.parameters[o] for o in self.outcomes[:-1]])

    def set_parameters_from_vector(self, v):
        k = len(self.hyperparameters)
        self.parameters = {o: list(v[i * k:(i + 1) * k])
                           for i, o in enumerate(self.outcomes[:-1])}

    def basis_matrix(self, times):
        """[n_times, n_hyperparams] matrix of basis-function values."""
        return np.stack([np.asarray(self.basisfunction(i, times))
                         for i in self.hyperparameters], axis=1)

    def probabilities(self, times, trim=True):
        """{outcome: [p(t) for t in times]}; the last outcome is one minus
        the rest (reference: ProbTrajectory.probabilities)."""
        B = self.basis_matrix(times)
        out = {}
        total = np.zeros(len(times))
        for o in self.outcomes[:-1]:
            p = B @ np.asarray(self.parameters[o])
            if trim:
                p = np.clip(p, 0, 1)
            out[o] = p
            total = total + p
        last = 1.0 - total
        if trim:
            last = np.clip(last, 0, 1)
        out[self.outcomes[-1]] = last
        return out


class ConstantProbTrajectory(ProbTrajectory):
    """Time-independent distribution (reference:
    probtrajectory.ConstantProbTrajectory:192)."""

    def __init__(self, outcomes, probabilities):
        super().__init__(outcomes, [0],
                         {o: [p] for o, p in probabilities.items()})

    def basisfunction(self, i, times):
        return np.ones(len(times))


class CosineProbTrajectory(ProbTrajectory):
    """Sum-of-DCT-basis-functions trajectory (reference:
    probtrajectory.CosineProbTrajectory:228).  `hyperparameters` are DCT
    mode indices (must start with 0 = the constant mode)."""

    def __init__(self, outcomes, hyperparameters, parameters, starttime,
                 timestep, numtimes):
        self.starttime = starttime
        self.timestep = timestep
        self.numtimes = numtimes
        super().__init__(outcomes, hyperparameters, parameters)

    def basisfunction(self, i, times):
        """Type-II DCT basis function for mode i, evaluated at arbitrary
        times via the time->index map defined by (starttime, timestep)."""
        times = np.asarray(times, float)
        t_idx = (times - self.starttime) / self.timestep
        T = self.numtimes
        if i == 0:
            return np.ones(len(times))
        return np.sqrt(2) * np.cos(np.pi * i * (t_idx + 0.5) / T)


def _xlogp_rectified(x, p, minp=1e-4, maxp=1 - 1e-6):
    """x*log(p) with quadratic continuation below minp / above maxp
    (reference: probtrajectory._xlogp_rectified:308)."""
    p = np.asarray(p, float)
    pos = np.clip(p, minp, maxp)
    out = x * np.log(pos)
    # quadratic extrapolation below minp (keeps the MLE well-defined when
    # trial trajectories go negative)
    # (the JAX package takes the slopes over all of x but the steps over
    # the points below only, which raises for a stream with some points
    # below and some not: ROADMAP.md section 3)
    below = p < minp
    if np.any(below):
        out = np.array(np.broadcast_to(out, np.broadcast(x, p).shape))
        xb = np.broadcast_to(x, out.shape)[below]
        dp = np.broadcast_to(p, out.shape)[below] - minp
        out[below] = xb * np.log(minp) + xb / minp * dp - 0.5 * xb / minp ** 2 * dp ** 2
    return out


def negloglikelihood(probtrajectory, clickstreams, times, minp=0., maxp=1.):
    """-logL of a trajectory given per-outcome clickstreams (reference:
    probtrajectory.negloglikelihood:338)."""
    probs = probtrajectory.probabilities(times, trim=False)
    return probsdict_negloglikelihood(probs, clickstreams,
                                      max(minp, 1e-10), min(maxp, 1 - 1e-10))


def probsdict_negloglikelihood(probs, clickstreams, minp=0., maxp=1.):
    """-logL from a {outcome: p(t) array} dict (reference:
    probtrajectory.probsdict_negloglikelihood:375)."""
    minp = max(minp, 1e-10)
    maxp = min(maxp, 1 - 1e-10)
    total = 0.0
    for o, clicks in clickstreams.items():
        total -= float(np.sum(_xlogp_rectified(np.asarray(clicks, float),
                                               probs[o], minp, maxp)))
    return total


def maxlikelihood(probtrajectory, clickstreams, times, minp=1e-4,
                  maxp=1 - 1e-6, method='Nelder-Mead', return_opt_output=False,
                  options=None, verbosity=1):
    """Maximum-likelihood fit of the trajectory amplitudes (reference:
    probtrajectory.maxlikelihood:404).  Returns a new trajectory of the same
    type with optimized parameters."""
    import scipy.optimize as spo
    pt = probtrajectory.copy()
    x0 = pt.parameters_as_vector()

    def objective(v):
        pt.set_parameters_from_vector(v)
        return negloglikelihood(pt, clickstreams, times, minp, maxp)

    res = spo.minimize(objective, x0, method=method,
                       options=options or {'maxiter': 5000, 'xatol': 1e-8})
    pt.set_parameters_from_vector(res.x)
    if return_opt_output:
        return pt, res
    return pt


def amplitude_compression(probtrajectory, times, epsilon=0., verbosity=1):
    """Compress the non-constant amplitudes so every probability stays in
    [epsilon, 1-epsilon] at all `times` (reference:
    probtrajectory.amplitude_compression:499).  Returns
    (compressed_trajectory, was_compressed)."""
    pt = probtrajectory.copy()
    probs = pt.probabilities(times, trim=False)
    all_p = np.concatenate([probs[o] for o in pt.outcomes])
    lo, hi = float(np.min(all_p)), float(np.max(all_p))
    if lo >= epsilon and hi <= 1 - epsilon:
        return pt, False
    # scale the oscillating (non-constant) components uniformly so the
    # worst excursion just touches the allowed band
    scale = 1.0
    for o in pt.outcomes[:-1]:
        const = pt.parameters[o][0]
        osc = probs[o] - const
        span_hi = float(np.max(osc))
        span_lo = float(np.min(osc))
        if span_hi > 0:
            scale = min(scale, max(0.0, (1 - epsilon - const) / span_hi))
        if span_lo < 0:
            scale = min(scale, max(0.0, (const - epsilon) / (-span_lo)))
    # the implicit last outcome also constrains the sum
    const_last = 1.0 - sum(pt.parameters[o][0] for o in pt.outcomes[:-1])
    osc_last = probs[pt.outcomes[-1]] - const_last
    span_hi = float(np.max(osc_last))
    span_lo = float(np.min(osc_last))
    if span_hi > 0:
        scale = min(scale, max(0.0, (1 - epsilon - const_last) / span_hi))
    if span_lo < 0:
        scale = min(scale, max(0.0, (const_last - epsilon) / (-span_lo)))
    for o in pt.outcomes[:-1]:
        params = list(pt.parameters[o])
        pt.parameters[o] = [params[0]] + [scale * a for a in params[1:]]
    return pt, True
