"""Carry a JAX-package model's parameters, its instruments, its composite
layers, its interpolated operations, an implicit model's registered layers
and its gauge-group elements into the port.

The functions take plain numpy data -- what ``pygsti_tpu``'s
``model.to_vector()``, its members' dense matrices or a gauge group's
parameter vector give -- and never import the JAX package.  Labels are given as strings ('Gxpi2:1', '[]',
'Gcnot:0:1', 'rho0', 'Mdefault').
"""

from __future__ import annotations

import collections

import numpy as np

from pygsti_tpu_torch.circuits.circuitparser import parse_label_str
from pygsti_tpu_torch.modelmembers.instruments import Instrument, TPInstrument
from pygsti_tpu_torch.modelmembers.operations import FullArbitraryOp
from pygsti_tpu_torch.models import gaugegroup as _gg
from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel
from pygsti_tpu_torch.models.modelconstruction import _make_op, _make_povm, _make_prep

_GAUGE_GROUPS = {cls.name: cls for cls in (
    _gg.TrivialGaugeGroup, _gg.FullGaugeGroup, _gg.TPGaugeGroup, _gg.DiagGaugeGroup,
    _gg.TPDiagGaugeGroup, _gg.UnitaryGaugeGroup, _gg.SpamGaugeGroup,
    _gg.TPSpamGaugeGroup)}


def model_from_vector(template, theta):
    """A copy of the port's `template` model holding the parameter vector
    `theta`.  The port orders parameters as the JAX package does (preps,
    POVMs, operations, instruments; each member's entries row-major; a
    TPInstrument's total map without its first row, then its members but
    the first), so a vector from a JAX model of the same structure means the
    same model here."""
    theta = np.asarray(theta, dtype=float)
    if theta.shape != (template.num_params,):
        raise ValueError("theta has shape %s; the model has %d parameters"
                         % (theta.shape, template.num_params))
    m = template.copy()
    m.from_vector(theta)
    return m


def instrument_from_dense(kind, members):
    """An instrument from its members' dense superoperators {label: [d, d]}:
    kind 'TP' gives a TPInstrument, 'full' an Instrument of fully
    parameterized members, 'static' one of fixed members."""
    members = collections.OrderedDict((str(k), np.asarray(v, dtype=float))
                                      for k, v in members.items())
    if kind == 'TP':
        return TPInstrument(members)
    if kind == 'full':
        return Instrument({k: FullArbitraryOp(v) for k, v in members.items()})
    if kind == 'static':
        return Instrument(members)
    raise ValueError("unknown instrument kind %r ('TP', 'full' or 'static')" % (kind,))


def interpolated_model(template, interpolated_ops):
    """A copy of the port's `template` model with each operation of
    `interpolated_ops` ({label string: (grid axes, samples, point)}, the
    numpy arrays of a JAX-package InterpolatedDenseOp: its ``grid_axes``,
    ``samples`` and ``to_vector()``) replaced by the port's
    InterpolatedDenseOp of the same arrays.  A replaced operation keeps its
    place, so the copy orders its parameters as a JAX model whose same
    operations were replaced."""
    from pygsti_tpu_torch.extras.interpygate.core import InterpolatedDenseOp
    m = template.copy()
    for lbl, (axes, samples, point) in interpolated_ops.items():
        key = parse_label_str(lbl)
        if key not in m.operations:
            raise KeyError("the template has no operation %s" % lbl)
        m.operations[key] = InterpolatedDenseOp([np.asarray(a, dtype=float) for a in axes],
                                                np.asarray(samples, dtype=float),
                                                np.asarray(point, dtype=float))
    return m


def register_composite_layers(model, layers):
    """Register the composite layers `layers` (label strings such as
    '[Gxpi2:0Gypi2:1]', in the order of the JAX model's
    ``_derived_layers``) with the port's `model`, so that both models have
    the same ``op_keys`` and one op stack means the same in both."""
    for lbl in layers:
        model._register_layer(parse_label_str(lbl))
    return model


def implicit_model_from_vector(template, theta, layers=()):
    """A copy of the port's implicit `template` (a LocalNoiseModel or
    CloudNoiseModel built by the same construction call as the JAX model)
    holding the JAX model's parameter vector `theta`, with the JAX model's
    registered layers `layers` (label strings of its ``op_keys``, in order)
    registered first, so that both op stacks are the same.  The packages
    order an implicit model's parameters alike: preps, POVMs, gates, the
    idle, then the cloud members."""
    m = model_from_vector(template, theta)
    for lbl in layers:
        m.register_layer(parse_label_str(lbl))
    if layers and [str(k) for k in m.op_keys[:len(layers)]] != [str(l) for l in layers]:
        raise ValueError("the template had registered other layers first: %s"
                         % [str(k) for k in m.op_keys])
    return m


def model_from_dense(ops, preps, povms, gate_type='full', basis='pp'):
    """An ExplicitOpModel from dense arrays keyed by label string.

    ops: {label: [d, d]}; preps: {label: [d]}; povms: {label: {outcome: [d]}}.
    `gate_type` ('full' or 'full TP') picks the members' parameterization;
    insertion order of each dict becomes the model's order.  Add
    instruments with instrument_from_dense, composite layers with
    register_composite_layers."""
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


def model_from_types(ops, preps, povms, theta, basis='pp'):
    """An ExplicitOpModel of members given by parameterization name, holding
    the JAX-package parameter vector `theta`.

    ops: {label: (gate type, ideal superoperator [d, d])};
    preps: {label: (prep type, ideal vector [d])};
    povms: {label: (povm type, {outcome: ideal effect [d]})};
    each type any name of models/modelconstruction.py ('CPTPLND', 'GLND',
    'H+S', 'full unitary', 'full TP', ...), read off the JAX model by the
    caller.  Insertion order of each dict becomes the model's order.  The
    members are built at their ideal values and then given `theta`, which
    means the same model in both packages: the model orders preps, POVMs,
    operations; a composed member its factors; a Lindblad error generator
    its blocks 'ham', 'other_diag', 'other'; a 'ham' or 'other_diag' block
    one real number per basis element; an 'other' block its real diagonal
    first, then (re, im) pairs of the strict lower triangle of the Cholesky
    factor row by row ('cholesky' mode) or of the upper triangle of the
    Hermitian matrix row by row ('elements' mode); a 'full unitary' its
    Hermitian generator like the latter."""
    (gate_type, first), (prep_type, _), (povm_type, _) = (
        next(iter(d.values())) for d in (ops, preps, povms))
    m = ExplicitOpModel(np.asarray(first).shape[0], basis, gate_type, prep_type, povm_type)
    nq = m.num_qubits
    for lbl, (typ, vec) in preps.items():
        m.preps[parse_label_str(lbl)] = _make_prep(np.asarray(vec, dtype=float), typ,
                                                   m.basis, nq)
    for lbl, (typ, effects) in povms.items():
        m.povms[parse_label_str(lbl)] = _make_povm(collections.OrderedDict(
            (str(k), np.asarray(v, dtype=float)) for k, v in effects.items()), typ, m.basis, nq)
    for lbl, (typ, mx) in ops.items():
        m.operations[parse_label_str(lbl)] = _make_op(np.asarray(mx, dtype=float), typ, m.basis)
    return model_from_vector(m, theta)


def gauge_group_from_name(group_name, dim, basis='pp'):
    """The port's gauge group for a JAX-package group's ``name`` ('Full',
    'TP', 'Diag', 'TP Diag', 'Unitary', 'Spam', 'TP Spam', 'Trivial') on a
    `dim`-dimensional superoperator space."""
    if group_name not in _GAUGE_GROUPS:
        raise ValueError("no gauge group named %r in the port (it has %s)"
                         % (group_name, sorted(_GAUGE_GROUPS)))
    cls = _GAUGE_GROUPS[group_name]
    return cls(dim, basis) if cls is _gg.UnitaryGaugeGroup else cls(dim)


def gauge_element_from_params(group_name, params, dim, basis='pp'):
    """The port's GaugeGroupElement for a JAX-package group's name and
    parameter vector: both packages parameterize each group alike, so one
    vector means one transformation in both."""
    params = np.asarray(params, dtype=float)
    group = gauge_group_from_name(group_name, dim, basis)
    if params.shape != (group.num_params,):
        raise ValueError("params has shape %s; the %s group on dimension %d has %d "
                         "parameters" % (params.shape, group_name, dim, group.num_params))
    return group.compute_element(params)
