"""Op-less models: coarse models predicting circuit success probabilities
from per-gate error rates, with no per-op process matrices (counterpart of
pygsti_tpu/models/oplessmodel.py: OplessModel, SuccessFailModel,
ErrorRatesModel, TwirledLayersModel, TwirledGatesModel,
AnyErrorCausesFailureModel, AnyErrorCausesRandomOutputModel).

These models have O(n_gates) parameters and a cheap closed form per
circuit, so they evaluate on the host in numpy with analytic derivatives:
there is nothing here for the card.
"""

from __future__ import annotations

import collections

import numpy as np

from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.baseobjs.statespace import QubitSpace
from pygsti_tpu_torch.baseobjs.outcomelabeldict import OutcomeLabelDict


def _prod(x):
    return float(np.prod(x)) if len(x) else 1.0


class OplessModel(object):
    """Base class for models without independent component operations
    (reference: oplessmodel.py:25)."""

    def __init__(self, state_space):
        self.state_space = state_space
        self.basis = None

    @property
    def dim(self):
        return 0

    def circuit_outcomes(self, circuit):
        raise NotImplementedError

    def probabilities(self, circuit, outcomes=None, time=None):
        raise NotImplementedError

    def bulk_probabilities(self, circuits, clip_to=None):
        return {c: self.probabilities(c) for c in circuits}


class SuccessFailModel(OplessModel):
    """Op-less model with ('success',)/('fail',) outcomes per circuit
    (reference: oplessmodel.py:144)."""

    def __init__(self, state_space, use_cache=False):
        super().__init__(state_space)
        self.use_cache = use_cache
        self._cache = {} if use_cache else None
        from pygsti_tpu_torch.forwardsims.successfailsim import SuccessFailForwardSimulator
        self._sim = SuccessFailForwardSimulator(self)

    @property
    def sim(self):
        return self._sim

    def circuit_outcomes(self, circuit):
        return (('success',), ('fail',))

    def _success_prob(self, circuit, cache):
        raise NotImplementedError

    def _success_dprob(self, circuit, param_slice, cache):
        """Finite-difference default (reference: oplessmodel.py:199)."""
        eps = 1e-7
        orig = self.to_vector().copy()
        sp0 = self._success_prob(circuit, cache)
        deriv = np.empty(self.num_params)
        for i in range(self.num_params):
            v = orig.copy()
            v[i] += eps
            self.from_vector(v)
            deriv[i] = (self._success_prob(circuit, cache) - sp0) / eps
        self.from_vector(orig)
        return deriv

    def probabilities(self, circuit, outcomes=None, time=None):
        cache = None
        if self._cache is not None:
            cache = self._cache.get(circuit)
            if cache is None:
                cache = self._cache[circuit] = self._circuit_cache(circuit)
        sp = self._success_prob(circuit, cache)
        d = OutcomeLabelDict()
        d[('success',)] = sp
        d[('fail',)] = 1.0 - sp
        if outcomes is not None:
            d = OutcomeLabelDict([(o, d[o]) for o in outcomes])
        return d

    def _circuit_cache(self, circuit):
        return None


class ErrorRatesModel(SuccessFailModel):
    """Success/fail model parameterized by per-gate & per-qubit-readout error
    rates; paramvec holds sqrt(rates) so rates stay nonnegative
    (reference: oplessmodel.py:282)."""

    def __init__(self, error_rates, num_qubits, state_space_labels=None,
                 alias_dict=None, idle_name='Gi'):
        if state_space_labels is None:
            state_space_labels = ['Q%d' % i for i in range(num_qubits)]
        super().__init__(QubitSpace(num_qubits), use_cache=True)
        gate_keys = sorted(error_rates.get('gates', {}).keys(), key=str)
        readout_keys = sorted(error_rates.get('readout', {}).keys(), key=str)
        self._idlename = idle_name
        self._alias_dict = dict(alias_dict or {})
        self._gate_error_rate_indices = {k: i for i, k in enumerate(gate_keys)}
        self._readout_error_rate_indices = {
            k: i + len(gate_keys) for i, k in enumerate(readout_keys)}
        self._paramvec = np.concatenate([
            np.sqrt(np.array([error_rates['gates'][k] for k in gate_keys], 'd')),
            np.sqrt(np.array([error_rates['readout'][k] for k in readout_keys], 'd')),
        ])

    @property
    def num_params(self):
        return len(self._paramvec)

    @property
    def primitive_op_labels(self):
        return tuple(self._gate_error_rate_indices.keys())

    def to_vector(self):
        return self._paramvec

    def from_vector(self, v, close=False):
        self._paramvec = np.asarray(v, 'd')

    def to_dict(self):
        p2 = self._paramvec ** 2
        return {'error_rates': {
            'gates': {k: p2[i] for k, i in self._gate_error_rate_indices.items()},
            'readout': {k: p2[i] for k, i in self._readout_error_rate_indices.items()}},
            'alias_dict': dict(self._alias_dict)}

    def __str__(self):
        d = self.to_dict()['error_rates']
        return ("Error rates model with %d parameters\nGates: %s\nReadout: %s"
                % (self.num_params, d['gates'], d['readout']))

    def _indices_for_label(self, lbl):
        g = self._gate_error_rate_indices
        ad = self._alias_dict
        for key in (lbl, lbl.name, Label(lbl.name, lbl.sslbls)):
            k = ad.get(key, key)
            if k in g:
                return [g[k]]
        raise ValueError("Cannot find error rate for circuit layer %s" % str(lbl))

    def _circuit_cache(self, circuit):
        """(width, depth, alpha, 1/2^w, per-layer index lists + readout list)
        (reference: oplessmodel.py:368 _circuit_cache)."""
        width = circuit.num_lines
        depth = circuit.depth
        alpha = 4 ** width / (4 ** width - 1)
        one_over_2_width = 1.0 / 2 ** width
        g = self._gate_error_rate_indices
        r = self._readout_error_rate_indices

        inds_by_layer = []
        for i in range(depth):
            layer = circuit.layertup[i]
            comps = layer.components if not layer.is_simple else (layer,)
            inds = []
            acted = set()
            for comp in comps:
                inds.extend(self._indices_for_label(comp))
                acted.update(comp.sslbls or circuit.line_labels)
            if self._idlename is not None:
                for q in circuit.line_labels:
                    if q not in acted:
                        for key in (Label(self._idlename, (q,)),
                                    self._idlename):
                            k = self._alias_dict.get(key, key)
                            if k in g:
                                inds.append(g[k])
                                break
            inds_by_layer.append(np.array(inds, np.int64))
        readout_inds = [r[q] for q in circuit.line_labels if q in r]
        inds_by_layer.append(np.array(readout_inds, np.int64))
        return width, depth, alpha, one_over_2_width, inds_by_layer


class TwirledLayersModel(ErrorRatesModel):
    """success = prod_layers(1 - alpha*(1 - prod(1-rate))) * (readout - 1/2^w)
    + 1/2^w (reference: oplessmodel.py:431)."""

    def _success_prob(self, circuit, cache):
        pvec = self._paramvec ** 2
        if cache is None:
            cache = self._circuit_cache(circuit)
        width, depth, alpha, one_over_2w, inds_by_layer = cache
        sp = 1.0 - pvec
        lam = 1.0
        for inds in inds_by_layer[:-1]:
            lam *= 1 - alpha * (1 - _prod(sp[inds]))
        sp_readout = _prod(sp[inds_by_layer[-1]])
        return lam * (sp_readout - one_over_2w) + one_over_2w

    def _success_dprob(self, circuit, param_slice, cache):
        pvec = self._paramvec ** 2
        dpvec = 2 * self._paramvec
        if cache is None:
            cache = self._circuit_cache(circuit)
        width, depth, alpha, one_over_2w, inds_by_layer = cache
        sp = 1.0 - pvec
        deriv = np.zeros(len(pvec))
        n_layers = len(inds_by_layer)
        lam_per = np.empty(n_layers)
        for i, inds in enumerate(inds_by_layer[:-1]):
            lam_per[i] = 1 - alpha * (1 - _prod(sp[inds]))
        sp_readout = _prod(sp[inds_by_layer[-1]])
        lam_per[-1] = sp_readout - one_over_2w
        lam_all = _prod(lam_per)
        for i, inds in enumerate(inds_by_layer[:-1]):
            lam_rest = lam_all / lam_per[i] if lam_per[i] != 0 else 0.0
            for ind in inds:
                deriv[ind] += lam_rest * alpha * (_prod(sp[inds]) / sp[ind]) * -1.0
        lam_rest = lam_all / lam_per[-1] if lam_per[-1] != 0 else 0.0
        for ind in inds_by_layer[-1]:
            deriv[ind] += lam_rest * (sp_readout / sp[ind]) * -1.0
        return deriv * dpvec


class TwirledGatesModel(ErrorRatesModel):
    """Per-gate (not per-layer) twirled depolarization
    (reference: oplessmodel.py:537)."""

    def _gate_cache(self, circuit):
        width, depth, alpha, one_over_2w, inds_by_layer = \
            ErrorRatesModel._circuit_cache(self, circuit)
        all_inds = np.concatenate(inds_by_layer[:-1]) if depth else \
            np.empty(0, np.int64)
        cnt = np.zeros(self.num_params, np.int64)
        for i in all_inds:
            cnt[i] += 1
        return width, depth, alpha, one_over_2w, all_inds, inds_by_layer[-1], cnt

    def _circuit_cache(self, circuit):
        return self._gate_cache(circuit)

    def _success_prob(self, circuit, cache):
        pvec = self._paramvec ** 2
        if cache is None:
            cache = self._circuit_cache(circuit)
        width, depth, alpha, one_over_2w, all_inds, ro_inds, cnt = cache
        sp = 1.0 - pvec
        lam_ops = 1.0 - alpha * pvec
        lam_all = _prod(lam_ops[all_inds])
        sp_readout = _prod(sp[ro_inds])
        return lam_all * (sp_readout - one_over_2w) + one_over_2w

    def _success_dprob(self, circuit, param_slice, cache):
        pvec = self._paramvec ** 2
        dpvec = 2 * self._paramvec
        if cache is None:
            cache = self._circuit_cache(circuit)
        width, depth, alpha, one_over_2w, all_inds, ro_inds, cnt = cache
        sp = 1.0 - pvec
        lam_ops = 1.0 - alpha * pvec
        deriv = np.zeros(len(pvec))
        lam_all = _prod(lam_ops[all_inds])
        for i, n in enumerate(cnt):
            if n:
                deriv[i] = n * lam_all / lam_ops[i] * -alpha
        readout_deriv = np.zeros(len(pvec))
        sp_readout = _prod(sp[ro_inds])
        for ind in ro_inds:
            readout_deriv[ind] = (sp_readout / sp[ind]) * -1.0
        deriv = deriv * (sp_readout - one_over_2w) + lam_all * readout_deriv
        return deriv * dpvec


class AnyErrorCausesFailureModel(ErrorRatesModel):
    """success = prod(1 - rate) over every gate & readout
    (reference: oplessmodel.py:648)."""

    def _circuit_cache(self, circuit):
        width, depth, alpha, one_over_2w, inds_by_layer = \
            ErrorRatesModel._circuit_cache(self, circuit)
        all_inds = np.concatenate(inds_by_layer)
        cnt = np.zeros(self.num_params, np.int64)
        for i in all_inds:
            cnt[i] += 1
        return all_inds, cnt

    def _success_prob(self, circuit, cache):
        pvec = self._paramvec ** 2
        if cache is None:
            cache = self._circuit_cache(circuit)
        all_inds, cnt = cache
        return _prod((1.0 - pvec)[all_inds])

    def _success_dprob(self, circuit, param_slice, cache):
        pvec = self._paramvec ** 2
        dpvec = 2 * self._paramvec
        if cache is None:
            cache = self._circuit_cache(circuit)
        all_inds, cnt = cache
        sp = 1.0 - pvec
        sp_all = _prod(sp[all_inds])
        deriv = np.zeros(len(pvec))
        for i, n in enumerate(cnt):
            if n:
                deriv[i] = n * sp_all / sp[i] * -1.0
        return deriv * dpvec


class AnyErrorCausesRandomOutputModel(ErrorRatesModel):
    """success = sp_all + (1 - sp_all)/2^w: any error randomizes the output
    (reference: oplessmodel.py:731)."""

    def _circuit_cache(self, circuit):
        width, depth, alpha, one_over_2w, inds_by_layer = \
            ErrorRatesModel._circuit_cache(self, circuit)
        all_inds = np.concatenate(inds_by_layer)
        cnt = np.zeros(self.num_params, np.int64)
        for i in all_inds:
            cnt[i] += 1
        return one_over_2w, all_inds, cnt

    def _success_prob(self, circuit, cache):
        pvec = self._paramvec ** 2
        if cache is None:
            cache = self._circuit_cache(circuit)
        one_over_2w, all_inds, cnt = cache
        sp_all = _prod((1.0 - pvec)[all_inds])
        return sp_all + (1 - sp_all) * one_over_2w

    def _success_dprob(self, circuit, param_slice, cache):
        pvec = self._paramvec ** 2
        dpvec = 2 * self._paramvec
        if cache is None:
            cache = self._circuit_cache(circuit)
        one_over_2w, all_inds, cnt = cache
        sp = 1.0 - pvec
        sp_all = _prod(sp[all_inds])
        deriv = np.zeros(len(pvec))
        for i, n in enumerate(cnt):
            if n:
                deriv[i] = n * sp_all / sp[i] * -1.0
        deriv *= (1.0 - one_over_2w)
        return deriv * dpvec
