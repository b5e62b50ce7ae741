"""Cloud-noise implicit models (counterpart of
pygsti_tpu/models/cloudnoisemodel.py).

Each gate's noise acts on a "cloud" of qubits within `maxhops` of its
targets, as exp(Lindblad error generator) restricted to low-weight terms.
Built on LocalNoiseModel's leaves and layer recipes: each (gate, targets)
gets a cloud leaf appended to the recipe of every layer that holds it, and
the empty layer gets the global idle's error generator.
"""

from __future__ import annotations

import collections

import numpy as np

from pygsti_tpu_torch.baseobjs.basis import Basis
from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.models.layerrules import LayerRules as _LayerRulesBase
from pygsti_tpu_torch.models.localnoisemodel import LocalNoiseModel
from pygsti_tpu_torch.modelmembers import operations as _op
from pygsti_tpu_torch.modelmembers import povms as _pv
from pygsti_tpu_torch.modelmembers import states as _st
from pygsti_tpu_torch.tools import optools as _ot


class CloudNoiseModel(LocalNoiseModel):
    """Implicit model with an exp(error generator) cloud factor per gate
    and targets."""

    def __init__(self, processor_spec, gate_members, prep_member, povm_member,
                 cloud_members_by_targets, cloud_members_blk, basis='pp', idle_member=None,
                 simulator='auto'):
        # {(gate leaf key, targets): (cloud leaf key, cloud qubits)}
        self._cloud_map_by_targets = dict(cloud_members_by_targets)
        self._cloud_blk = collections.OrderedDict(cloud_members_blk)
        super().__init__(processor_spec, gate_members, prep_member, povm_member, basis,
                         idle_member, simulator)
        self.operation_blks['cloudnoise'] = self._cloud_blk

    def _iter_parameterized_objs(self):
        yield from super()._iter_parameterized_objs()
        yield from self._cloud_blk.items()

    def _leaves(self):
        out = super()._leaves()
        for key, member in self._cloud_blk.items():
            out[('__cloud__', key)] = member
        return out

    def _recipe(self, layer_lbl):
        recipe = super()._recipe(layer_lbl)
        extra = []
        for comp in layer_lbl.components:
            tkey = (self._leaf_for(comp), tuple(comp.sslbls or ()))
            if tkey in self._cloud_map_by_targets:
                cloud_key, cloud_qubits = self._cloud_map_by_targets[tkey]
                extra.append((('__cloud__', cloud_key), cloud_qubits))
        return recipe + extra


def create_cloud_crosstalk_model_from_hops_and_weights(
        processor_spec, custom_gates=None, max_idle_weight=1, max_spam_weight=1,
        maxhops=0, extra_weight_1_hops=0, extra_gate_weight=0,
        simulator='auto', evotype=None, gate_type='H+s', spam_type='computational',
        implicit_idle_mode='none', errcomp_type='gates', independent_clouds=True,
        connected_highweight_errors=False, basis='pp', verbosity=0):
    """A cloud-noise model from hop and weight limits.

    Each gate gets an exp(Lindblad) noise factor on its cloud, the qubits
    within `maxhops` of its targets, with error terms of weight at most the
    gate's qubit count plus `extra_gate_weight`; the global idle gets terms
    of weight at most `max_idle_weight` on all qubits.  Each cloud has
    independent parameters.  `simulator` becomes the model's (a type name
    or a ForwardSimulator).  As in the JAX package,
    independent_clouds=False, connected_highweight_errors=True,
    extra_weight_1_hops != 0, an errcomp_type other than 'gates', an
    implicit_idle_mode other than 'none' and evotypes other than
    densitymx raise NotImplementedError.
    """
    if evotype not in (None, 'default', 'densitymx'):
        raise NotImplementedError(
            "evotype=%r: only dense superoperator (densitymx) semantics are "
            "implemented" % (evotype,))
    if errcomp_type != 'gates':
        raise NotImplementedError(
            "errcomp_type=%r is not implemented (only 'gates')"
            % (errcomp_type,))
    if implicit_idle_mode != 'none':
        raise NotImplementedError(
            "implicit_idle_mode=%r is not supported (only 'none')"
            % (implicit_idle_mode,))
    if not independent_clouds:
        raise NotImplementedError(
            "independent_clouds=False (shared cloud parameters) is not "
            "implemented")
    if connected_highweight_errors:
        raise NotImplementedError(
            "connected_highweight_errors=True (restrict high-weight error "
            "terms to connected qubit subsets) is not implemented; weight-"
            "limited terms span the whole cloud")
    if extra_weight_1_hops:
        raise NotImplementedError(
            "extra_weight_1_hops != 0 (longer-range weight-1 terms) is not "
            "implemented")
    pspec = processor_spec
    nq = pspec.num_qubits
    qlbls = tuple(pspec.qubit_labels)
    graph = pspec.qubit_graph
    gate_members = collections.OrderedDict()
    cloud_members_blk = collections.OrderedDict()
    cloud_map = {}
    for name in pspec.gate_names:
        if name in ('{idle}', '(idle)'):
            continue
        u = pspec.gate_unitaries[name]
        udim = u.shape[0]
        ideal = _op.StaticArbitraryOp(
            np.real(_ot.unitary_to_superop(u, Basis.cast(basis, udim * udim))))
        gate_members[Label(name)] = custom_gates.get(name, ideal) if custom_gates else ideal
        weight = (1 if udim == 2 else 2) + extra_gate_weight
        for targets in pspec.resolved_availability(name):
            targets = tuple(targets)
            cloud = tuple(sorted(graph.radius(list(targets), maxhops), key=qlbls.index))
            key = ('cloud', name, targets)
            eg = _op.build_lindblad_errorgen(Basis.cast(basis, 4 ** len(cloud)), gate_type,
                                             max_weight=weight)
            cloud_members_blk[key] = _op.ExpErrorgenOp(eg)
            cloud_map[(Label(name), targets)] = (key, cloud)
    idle_member = None
    if max_idle_weight > 0:
        idle_member = _op.ExpErrorgenOp(_op.build_lindblad_errorgen(
            Basis.cast(basis, 4 ** nq), gate_type, max_weight=max_idle_weight))
    prep_member = _st.ComputationalBasisState([0] * nq, basis)
    povm_member = _pv.ComputationalBasisPOVM(nq, basis)
    if spam_type not in ('computational', 'static') and max_spam_weight > 0:
        prep_member = _st.ComposedState(prep_member, _op.ExpErrorgenOp(
            _op.build_lindblad_errorgen(Basis.cast(basis, 4 ** nq), spam_type,
                                        max_weight=max_spam_weight)))
        povm_member = _pv.ComposedPOVM(_op.ExpErrorgenOp(
            _op.build_lindblad_errorgen(Basis.cast(basis, 4 ** nq), spam_type,
                                        max_weight=max_spam_weight)), povm_member)
    return CloudNoiseModel(pspec, gate_members, prep_member, povm_member, cloud_map,
                           cloud_members_blk, basis, idle_member, simulator)


class CloudNoiseLayerRules(_LayerRulesBase):
    """The layer rules of a cloud-noise model: the target layer composed
    with its clouds' error maps ('gates') or with their summed generators
    in one exponential ('errorgens').  CloudNoiseModel builds the 'gates'
    composition in its layer recipes; this records the configuration."""

    def __init__(self, errcomp_type='gates', qubit_labels=None,
                 implicit_idle_mode='none', singleq_idle_layer_labels=None,
                 implied_global_idle_label=None):
        self.errcomp_type = errcomp_type
        self.qubit_labels = qubit_labels
        self.implicit_idle_mode = implicit_idle_mode
        self.single_qubit_idle_layer_labels = singleq_idle_layer_labels
        self.implied_global_idle_label = implied_global_idle_label
