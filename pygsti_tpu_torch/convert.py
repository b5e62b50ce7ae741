"""Carry a JAX-package model's parameters into the port.

Both functions take plain numpy data -- what ``pygsti_tpu``'s
``model.to_vector()`` or its members' dense matrices give -- and never
import the JAX package.  Labels are given as strings ('Gxpi2:1', '[]',
'Gcnot:0:1', 'rho0', 'Mdefault').
"""

from __future__ import annotations

import collections

import numpy as np

from pygsti_tpu_torch.circuits.circuitparser import parse_label_str
from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel


def model_from_vector(template, theta):
    """A copy of the port's `template` model holding the parameter vector
    `theta`.  The port orders parameters as the JAX package does (preps,
    POVMs, operations; each member's entries row-major), so a vector from a
    JAX model of the same structure means the same model here."""
    theta = np.asarray(theta, dtype=float)
    if theta.shape != (template.num_params,):
        raise ValueError("theta has shape %s; the model has %d parameters"
                         % (theta.shape, template.num_params))
    m = template.copy()
    m.from_vector(theta)
    return m


def model_from_dense(ops, preps, povms, gate_type='full', basis='pp'):
    """An ExplicitOpModel from dense arrays keyed by label string.

    ops: {label: [d, d]}; preps: {label: [d]}; povms: {label: {outcome: [d]}}.
    `gate_type` ('full' or 'full TP') picks the members' parameterization;
    insertion order of each dict becomes the model's order."""
    dims = {np.asarray(a).shape[0] for a in list(ops.values()) + list(preps.values())}
    if len(dims) != 1:
        raise ValueError("members disagree on the dimension: %s" % sorted(dims))
    m = ExplicitOpModel(dims.pop(), basis, gate_type, gate_type, gate_type)
    for lbl, vec in preps.items():
        m.preps[parse_label_str(lbl)] = np.asarray(vec, dtype=float)
    for lbl, effects in povms.items():
        m.povms[parse_label_str(lbl)] = collections.OrderedDict(
            (str(k), np.asarray(v, dtype=float)) for k, v in effects.items())
    for lbl, mx in ops.items():
        m.operations[parse_label_str(lbl)] = np.asarray(mx, dtype=float)
    return m
