"""ExplicitOpModel: dict-style model with explicit operations, preps, POVMs
and instruments (counterpart of pygsti_tpu/models/explicitmodel.py).

``tensors_fn()`` returns a pure torch function ``v -> ModelTensors``
(stacked op matrices, prep vectors and effect rows) on ``v``'s device and
dtype.  The op stack holds the operations, then the composite layers that
circuits use (a parallel layer such as ``[Gxpi2:0Gypi2:1]``, registered by
the layout, is the product of its components' dense forms), then one slot
per instrument member, keyed ``('INSTRUMENT', label, member)`` in
``op_keys``.  The
parameter vector is laid out preps, POVMs, operations, instruments, each in
insertion order, exactly as in the JAX package, so one vector means one
model in both.  A model is gauge-transformed in place by a
GaugeGroupElement (host numpy) and serializes to the JAX package's state
layout, so either package's checkpoint reads here.
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple, Any

import numpy as np
import torch

from pygsti_tpu_torch.baseobjs.errorgenlabel import GlobalElementaryErrorgenLabel
from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
from pygsti_tpu_torch.models.model import OpModel
from pygsti_tpu_torch.modelmembers.modelmember import ModelMember
from pygsti_tpu_torch.modelmembers import operations as _op
from pygsti_tpu_torch.modelmembers import states as _st
from pygsti_tpu_torch.modelmembers import povms as _pv
from pygsti_tpu_torch.modelmembers.instruments import Instrument


class ModelTensors(NamedTuple):
    """Stacked dense representations produced by tensors_fn."""
    ops: Any        # [n_ops + n_composite_layers + n_instrument_members, dim, dim]
    preps: Any      # [n_preps, dim]
    effects: Any    # [n_effect_rows, dim]  (all POVMs' effects, concatenated)


_OP_TYPES = {'full': _op.FullArbitraryOp, 'full arbitrary': _op.FullArbitraryOp,
             'full TP': _op.FullTPOp, 'TP': _op.FullTPOp,
             'static': _op.StaticArbitraryOp}
_PREP_TYPES = {'full': _st.FullState, 'full arbitrary': _st.FullState,
               'full TP': _st.TPState, 'TP': _st.TPState,
               'static': _st.StaticState}
_POVM_TYPES = {'full': _pv.UnconstrainedPOVM, 'full arbitrary': _pv.UnconstrainedPOVM,
               'full TP': _pv.TPPOVM, 'TP': _pv.TPPOVM}


class _MemberDict(collections.OrderedDict):
    """Ordered member dict: keys become Labels, raw arrays are cast to the
    model's default member type, and any change invalidates the parent's
    parameter vector."""

    def __init__(self, parent, kind):
        super().__init__()
        self._parent = parent
        self._kind = kind

    def __setitem__(self, key, val):
        if isinstance(val, Instrument) != (self._kind == 'instrument'):
            raise TypeError("%s cannot be a member of a model's %s dict"
                            % (type(val).__name__, self._kind))
        if not isinstance(val, ModelMember):
            val = self._parent._cast_member(self._kind, val)
        super().__setitem__(Label(key), val)
        self._parent._mark_for_rebuild()

    def __getitem__(self, key):
        return super().__getitem__(Label(key))

    def __contains__(self, key):
        return super().__contains__(Label(key))

    def __reduce__(self):
        # OrderedDict's own reduce calls the class without arguments; the
        # items go in the state and are restored without a rebuild, since
        # the parent's own state comes back with them
        return (_MemberDict.__new__, (_MemberDict,),
                {'_parent': self._parent, '_kind': self._kind, '_items': list(self.items())})

    def __setstate__(self, state):
        state = dict(state)
        items = state.pop('_items')
        self.__dict__.update(state)
        for key, val in items:
            collections.OrderedDict.__setitem__(self, key, val)


def _rebuilt(member, D, what):
    """The member of the same dense family at D @ its dense value: a static
    one (a static unitary too) becomes static arbitrary, a full or full TP
    one keeps its type; any other member raises TypeError."""
    for static in (_op.StaticArbitraryOp, _st.StaticState):
        if isinstance(member, static):
            return static(D @ member.dense())
    if isinstance(member, (_op.FullArbitraryOp, _op.FullTPOp, _st.FullState, _st.TPState)):
        return type(member)(D @ member.dense())
    raise TypeError("%s cannot rebuild a %s from a dense value" % (what, type(member).__name__))


class ExplicitOpModel(OpModel):
    """Model with explicit .operations/.preps/.povms/.instruments dicts."""

    def __init__(self, dim, basis='pp', default_gate_type='full',
                 default_prep_type=None, default_povm_type=None):
        super().__init__(dim, basis)
        self.default_gate_type = default_gate_type
        self.default_prep_type = default_prep_type or default_gate_type
        self.default_povm_type = default_povm_type or default_gate_type
        self.preps = _MemberDict(self, 'prep')
        self.povms = _MemberDict(self, 'povm')
        self.operations = _MemberDict(self, 'op')
        self.instruments = _MemberDict(self, 'instrument')
        # composite layer -> its component operations' labels, in the order
        # the circuits first showed them
        self._derived_layers = collections.OrderedDict()

    def _cast_member(self, kind, val):
        table, t = {'op': (_OP_TYPES, self.default_gate_type),
                    'prep': (_PREP_TYPES, self.default_prep_type),
                    'povm': (_POVM_TYPES, self.default_povm_type)}[kind]
        if t not in table:
            raise ValueError("Cannot auto-cast %s for type %r" % (kind, t))
        return table[t](val)

    @property
    def num_qubits(self):
        """Number of qubits when the dimension is 4**n, else None."""
        n = int(round(math.log(self.dim, 4)))
        return n if 4 ** n == self.dim else None

    def _iter_parameterized_objs(self):
        for d in (self.preps, self.povms, self.operations, self.instruments):
            for lbl, obj in d.items():
                yield lbl, obj

    def __getitem__(self, label):
        label = Label(label)
        for d in (self.operations, self.preps, self.povms, self.instruments):
            if label in d:
                return d[label]
        raise KeyError(label)

    def register_circuit_layers(self, circuits):
        """Register each layer of `circuits` that is no operation but whose
        components all are (a parallel layer such as [Gxpi2:0Gypi2:1]) as a
        composite layer of the op stack: the product of its components."""
        for layer in dict.fromkeys(l for c in circuits for l in c.layertup):
            self._register_layer(layer)

    def _register_layer(self, layer):
        if layer in self.operations or layer in self._derived_layers:
            return
        comps = layer.components
        if len(comps) > 1 and all(comp in self.operations for comp in comps):
            self._derived_layers[layer] = [Label(comp) for comp in comps]

    @property
    def op_keys(self):
        """Keys of the op stack: the operations, the composite layers, then
        every instrument member as ('INSTRUMENT', instrument label, member
        label)."""
        return list(self.operations.keys()) + list(self._derived_layers.keys()) + [
            ('INSTRUMENT', ilbl, mlbl) for ilbl, inst in self.instruments.items()
            for mlbl in inst.member_labels]

    @property
    def prep_keys(self):
        return list(self.preps.keys())

    @property
    def povm_keys(self):
        return list(self.povms.keys())

    def povm_effect_rows(self):
        """povm label -> (row slice, outcome labels) into the effect stack."""
        out = {}
        off = 0
        for lbl, povm in self.povms.items():
            out[lbl] = (slice(off, off + povm.num_outcomes), povm.outcome_labels)
            off += povm.num_outcomes
        return out

    def _default_prep_label(self):
        if len(self.preps) != 1:
            raise ValueError("Model has %d preps; circuits must name one"
                             % len(self.preps))
        return self.prep_keys[0]

    def _default_povm_label(self):
        if len(self.povms) != 1:
            raise ValueError("Model has %d POVMs; circuits must name one"
                             % len(self.povms))
        return self.povm_keys[0]

    def copy(self):
        """Deep copy of the members; the composite layers are kept."""
        m = ExplicitOpModel(self.dim, self.basis, self.default_gate_type,
                            self.default_prep_type, self.default_povm_type)
        m._derived_layers = collections.OrderedDict(
            (k, list(v)) for k, v in self._derived_layers.items())
        for src, dst in ((self.preps, m.preps), (self.povms, m.povms),
                         (self.operations, m.operations),
                         (self.instruments, m.instruments)):
            for lbl, obj in src.items():
                dst[lbl] = obj.copy()
        return m

    def probabilities(self, circuit, outcomes=None, device="cuda"):
        """{outcome: probability} of one circuit, simulated on `device`."""
        from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
        return SimpleForwardSimulator(self, device).probs(circuit, outcomes=outcomes)

    def bulk_probabilities(self, circuits, device="cuda"):
        """{circuit: {outcome: probability}}, simulated on `device`."""
        from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
        return SimpleForwardSimulator(self, device).bulk_probs(circuits)

    def circuit_outcomes(self, circuit):
        """The outcome labels of a circuit: those of the default POVM."""
        return [(ol,) for ol in self.povms[self._default_povm_label()].outcome_labels]

    def tensors_fn(self, composite_layers=True):
        """A pure function v -> ModelTensors (safe under torch.func); with
        composite_layers=False the op stack leaves the composite layers out.

        Members whose dense form is ``post @ E @ pre`` around an error map E
        (ModelMember.error_map_form) are grouped by their error map's
        function: each group's maps are evaluated in one call, vmapped over
        the stacked parameter slices.  The 8 members of a two-qubit Lindblad
        model then cost one pass through the generator and the matrix
        exponential instead of 8; under forward-mode differentiation, where
        the host pays for every op it issues, that is most of the time."""
        self._rebuild_paramvec_if_needed()
        members = list(self.operations.values()) + list(self.instruments.values()) \
            + list(self.preps.values()) + list(self.povms.values())
        n_gates = len(self.operations)
        n_ops = n_gates + len(self.instruments)   # stack members
        n_preps = len(self.preps)
        gate_pos = {k: i for i, k in enumerate(self.operations.keys())}
        derived = [[gate_pos[k] for k in comps] for comps in self._derived_layers.values()] \
            if composite_layers else []
        groups = []      # [error map, [(member position, pre, post)], [param slices]]
        for pos, m in enumerate(members):
            form = m.error_map_form()
            if form is None:
                continue
            emap, pre, post = form
            for g in groups:
                if g[0].same_function_as(emap):
                    break
            else:
                g = [emap, [], []]
                groups.append(g)
            g[1].append((pos, pre, post))
            g[2].append(m.gpindices)
        groups = [g for g in groups if len(g[1]) > 1]
        grouped = {pos for g in groups for pos, _, _ in g[1]}
        gather = [np.stack([np.arange(sl.start, sl.stop) for sl in g[2]]) for g in groups]
        consts = {}

        def const(key, array, v, dtype=None):
            key = (key, str(v.device), v.dtype)
            if key not in consts:
                consts[key] = torch.as_tensor(array, dtype=dtype or v.dtype, device=v.device)
            return consts[key]

        def compute(v):
            dense = [None] * len(members)
            for gi, (emap, uses, _) in enumerate(groups):
                idx = const(('idx', gi), gather[gi], v, torch.int64)
                E = torch.vmap(emap.to_dense)(v[idx])              # [n, d, d]
                for k, (pos, pre, post) in enumerate(uses):
                    mx = E[k]
                    if pre is not None:
                        mx = mx @ const(('pre', pos), pre, v)
                    if post is not None:
                        mx = const(('post', pos), post, v) @ mx
                    dense[pos] = mx
            for pos, m in enumerate(members):
                if pos not in grouped:
                    dense[pos] = m.to_dense(v[m.gpindices])
            # an operation is one slot of the op stack, a composite layer
            # one (the product of its components, the first applied first),
            # an instrument one slot per member
            layers = []
            for comps in derived:
                m = dense[comps[0]]
                for i in comps[1:]:
                    m = dense[i] @ m
                layers.append(m)
            return ModelTensors(torch.cat([x if x.dim() == 3 else x[None]
                                           for x in dense[:n_gates] + layers
                                           + dense[n_gates:n_ops]]),
                                torch.stack(dense[n_ops:n_ops + n_preps]),
                                torch.cat(dense[n_ops + n_preps:], dim=0))

        return compute

    def statevec_tensors_fn(self):
        """A pure function v -> (unitaries [K, u, u], state vectors
        [n_preps, u], effect matrices [n_effects, u, u]), complex, for the
        state-vector simulator: each operation's unitary, then each
        composite layer's (the product of its components').  A member with
        no pure-state form raises ValueError, in the JAX package's words."""
        from pygsti_tpu_torch.tools.basistools import vec_to_stdmx
        self._rebuild_paramvec_if_needed()
        for lbl, o in self.operations.items():
            if not hasattr(o, 'to_unitary'):
                raise ValueError(
                    "Operation %s (%s) has no unitary (statevec) representation;"
                    " the statevec simulator requires unitary gates -- use the"
                    " density-matrix simulator for noisy models" % (lbl, type(o).__name__))
        for lbl, p in self.preps.items():
            if not hasattr(p, 'to_statevec'):
                raise ValueError("Prep %s (%s) has no pure-state representation"
                                 % (lbl, type(p).__name__))
        if len(self.instruments):
            raise ValueError("the statevec simulator takes no instruments")
        ops = list(self.operations.values())
        gate_pos = {k: i for i, k in enumerate(self.operations.keys())}
        derived = [[gate_pos[k] for k in comps] for comps in self._derived_layers.values()]
        preps = list(self.preps.values())
        effect_mxs = vec_to_stdmx(np.concatenate([povm.dense() for povm in self.povms.values()]),
                                  self.basis)

        def compute(v):
            us = [o.to_unitary(v[o.gpindices]) for o in ops]
            for comps in derived:
                m = us[comps[0]]
                for i in comps[1:]:
                    m = us[i] @ m
                us.append(m)
            psis = torch.stack([p.to_statevec(v[p.gpindices]) for p in preps])
            return torch.stack(us), psis, torch.as_tensor(effect_mxs, dtype=psis.dtype,
                                                          device=v.device)

        return compute

    def flat_tensors_fn(self, composite_layers=True):
        """A pure function v -> every tensor entry as one vector [NT]:
        the op stack, then preps, then effects, each row-major."""
        compute = self.tensors_fn(composite_layers)

        def flat(v):
            t = compute(v)
            return torch.cat([t.ops.reshape(-1), t.preps.reshape(-1), t.effects.reshape(-1)])

        return flat

    def flat_tensors_jacobian_fn(self):
        """A function v -> Tv = d flat tensors / d v, [NT, P].

        Tv is block-diagonal: a member's entries depend on its own
        parameters only.  So forward mode needs as many tangents as the
        largest member has parameters, not P: tangent k carries the k-th
        parameter of every member at once, each member's rows of the result
        hold its own derivative, and the blocks are put in place by one
        gather and one mask.  For a Lindblad model of 8 members that is 240
        tangents through the matrix exponentials instead of 1,920.  An
        instrument is one block over all its member slots: member 0 of a
        TPInstrument depends on every parameter of the instrument.

        A composite layer depends on the parameters of all its components,
        so it is left out of that pass; its rows follow from its
        components' rows by the product rule, d(G_b G_a) = dG_b G_a +
        G_b dG_a, and are put in place between the operations' rows and the
        instruments'."""
        self._rebuild_paramvec_if_needed()
        flat = self.flat_tensors_fn(composite_layers=False)
        P = len(self._paramvec)
        d = self.dim
        n_gate_rows = len(self.operations) * d * d
        gate_pos = {k: i for i, k in enumerate(self.operations.keys())}
        derived = [[gate_pos[k] for k in comps] for comps in self._derived_layers.values()]
        # members in the order of the flat vector, with their row counts
        members = [(o, o.dim * o.dim) for o in self.operations.values()] \
            + [(i, i.num_members * i.dim * i.dim) for i in self.instruments.values()] \
            + [(p, p.dim) for p in self.preps.values()] \
            + [(p, p.num_outcomes * p.dim) for p in self.povms.values()]
        C = max((m.num_params for m, _ in members), default=0)
        row_member = np.repeat(np.arange(len(members)), [n for _, n in members])
        param_member = np.full(P, -1)
        param_k = np.zeros(P, dtype=np.int64)
        for i, (m, _) in enumerate(members):
            param_member[m.gpindices] = i
            param_k[m.gpindices] = np.arange(m.num_params)
        seeds = np.zeros((C, P))
        seeds[param_k, np.arange(P)] = 1.0
        mask = row_member[:, None] == param_member[None, :]
        consts = {}

        def jacobian(v):
            if P == 0:
                return torch.zeros((len(row_member) + len(derived) * d * d, 0),
                                   dtype=v.dtype, device=v.device)
            key = (str(v.device), v.dtype)
            if key not in consts:
                consts[key] = (torch.as_tensor(seeds, dtype=v.dtype, device=v.device),
                               torch.as_tensor(param_k, device=v.device),
                               torch.as_tensor(mask, device=v.device))
            S, k_of_param, own = consts[key]
            # vmap of jvp over the C seed tangents: what jacfwd does over the
            # P unit vectors
            compressed = torch.vmap(
                lambda t: torch.func.jvp(flat, (v,), (t,))[1], out_dims=1)(S)    # [NT, C]
            T = compressed[:, k_of_param] * own
            if not derived:
                return T
            G = flat(v)[:n_gate_rows].reshape(-1, d, d)
            dG = T[:n_gate_rows].reshape(-1, d, d, P)
            rows = []
            for comps in derived:
                m, dm = G[comps[0]], dG[comps[0]]
                for i in comps[1:]:
                    dm = torch.einsum('ij,jkp->ikp', G[i], dm) \
                        + torch.einsum('ijp,jk->ikp', dG[i], m)
                    m = G[i] @ m
                rows.append(dm.reshape(d * d, P))
            return torch.cat([T[:n_gate_rows]] + rows + [T[n_gate_rows:]])

        return jacobian

    def set_all_parameterizations(self, gate_type, prep_type='auto', povm_type='auto'):
        """Convert every operation, prep and POVM in place to the given
        parameterization (the SPAM types follow `gate_type` when 'auto'),
        each built from the member's current dense value by the
        constructors of models/modelconstruction.py."""
        from pygsti_tpu_torch.models.modelconstruction import (_make_op, _make_prep,
                                                                _make_povm)
        nq = self.num_qubits
        ptype = prep_type if prep_type != 'auto' else gate_type
        etype = povm_type if povm_type != 'auto' else gate_type
        for lbl, op in list(self.operations.items()):
            self.operations[lbl] = _make_op(op.dense(), gate_type, self.basis)
        for lbl, p in list(self.preps.items()):
            self.preps[lbl] = _make_prep(p.dense(), ptype, self.basis, nq)
        for lbl, povm in list(self.povms.items()):
            self.povms[lbl] = _make_povm(collections.OrderedDict(povm.items()), etype,
                                         self.basis, nq)
        self.default_gate_type = gate_type

    def create_processor_spec(self, qudit_labels=None):
        """A QubitProcessorSpec whose gates are this model's operations, each
        as the unitary of its (unitary) superoperator, on `qudit_labels`
        (default 0..n-1: the port's models carry no state-space labels)."""
        from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec
        from pygsti_tpu_torch.tools.basistools import change_basis
        from pygsti_tpu_torch.tools.optools import std_process_mx_to_unitary
        nq = self.num_qubits
        names, nonstd, avail = [], {}, {}
        for lbl, op in self.operations.items():
            name = lbl.name
            if name in ('[]', '', 'COMPOUND'):
                continue
            nonstd[name] = std_process_mx_to_unitary(change_basis(op.dense(), self.basis, 'std'))
            names.append(name)
            if lbl.sslbls:
                avail[name] = [tuple(lbl.sslbls)]
        return QubitProcessorSpec(nq, names, nonstd_gate_unitaries=nonstd, availability=avail,
                                  qubit_labels=qudit_labels)

    def errorgen_coefficients(self, normalized_elem_gens=True):
        """{member label: {GlobalElementaryErrorgenLabel: coefficient}} over
        the operations, preps and POVMs that carry an error generator, the
        qubits named 0..n-1.  normalized_elem_gens=False divides the H
        coefficients by sqrt(Hilbert-space dimension)."""
        sslbls = tuple(range(self.num_qubits or 1))
        d = np.sqrt(np.sqrt(self.dim))
        out = {}
        for members in (self.operations, self.preps, self.povms):
            for lbl, member in members.items():
                if not hasattr(member, 'errorgen_coefficients'):
                    continue
                coeffs = {}
                for l, v in member.errorgen_coefficients().items():
                    g = GlobalElementaryErrorgenLabel.cast(l, sslbls)
                    coeffs[g] = v / d if (g.errorgen_type == 'H'
                                          and not normalized_elem_gens) else v
                out[lbl] = coeffs
        return out

    def depolarize(self, op_noise=None, spam_noise=None, max_op_noise=None,
                   max_spam_noise=None, seed=None):
        """A depolarized copy: each op's non-identity block scaled by
        1 - op_noise; with spam_noise only the preps are depolarized, the
        POVMs are left alone (as in the JAX package and the reference).
        With `max_op_noise` each op's noise (and with `max_spam_noise` each
        prep's) is drawn uniformly from [0, max) by numpy's
        default_rng(seed), the ops' draws first, in the JAX package's order.
        Only the dense families (static, full, full TP) can be rebuilt from
        the scaled dense value; any other member raises TypeError (the JAX
        package fails there too, on the member's constructor)."""
        m = self.copy()
        rng = np.random.default_rng(seed)
        d = self.dim
        if max_op_noise is not None:
            op_noises = rng.uniform(0, max_op_noise, len(m.operations))
        else:
            op_noises = None if op_noise is None else [op_noise] * len(m.operations)
        if op_noises is not None:
            for (lbl, op), noise in zip(list(m.operations.items()), op_noises):
                D = np.diag([1.0] + [1.0 - noise] * (d - 1))
                m.operations[lbl] = _rebuilt(op, D, 'depolarize')
        if max_spam_noise is not None:
            spam_noises = rng.uniform(0, max_spam_noise, len(m.preps))
        else:
            spam_noises = None if spam_noise is None else [spam_noise] * len(m.preps)
        if spam_noises is not None:
            for (lbl, p), noise in zip(list(m.preps.items()), spam_noises):
                D = np.diag([1.0] + [1.0 - noise] * (d - 1))
                m.preps[lbl] = _rebuilt(p, D, 'depolarize')
        return m

    def rotate(self, rotate=None, max_rotate=None, seed=None):
        """A copy of a 1-qubit model with every operation followed by the
        rotation exp(-i (rx X + ry Y + rz Z) / 2): `rotate` = (rx, ry, rz),
        or with `max_rotate` each op's angles drawn uniformly from
        [0, max_rotate) by numpy's default_rng(seed), in the JAX package's
        order.  Only the dense families can be rebuilt; any other member
        raises TypeError, as depolarize does."""
        import scipy.linalg
        from pygsti_tpu_torch.tools.internalgates import sigmaX, sigmaY, sigmaZ
        from pygsti_tpu_torch.tools.optools import unitary_to_superop
        if self.num_qubits != 1:
            raise ValueError("rotate() supports 1-qubit models only")
        m = self.copy()
        rng = np.random.default_rng(seed)
        for lbl, op in list(m.operations.items()):
            rx, ry, rz = rng.uniform(0, max_rotate, 3) if max_rotate is not None else rotate
            u = scipy.linalg.expm(-0.5j * (rx * sigmaX + ry * sigmaY + rz * sigmaZ))
            m.operations[lbl] = _rebuilt(op, np.real(unitary_to_superop(u, self.basis.name)),
                                         'rotate')
        return m

    def strdiff(self, other):
        """One line 'op <label>: <Frobenius distance>' per operation that
        both models have."""
        return "\n".join("op %s: %.6g" % (lbl, np.linalg.norm(
            op.dense() - other.operations[lbl].dense()))
            for lbl, op in self.operations.items() if lbl in other.operations)

    def transform_inplace(self, s):
        """Apply the gauge transformation of element `s` (has
        .transform_matrix and .transform_matrix_inverse): rho -> Sinv rho,
        E -> E S, G -> Sinv G S."""
        smx = s.transform_matrix if hasattr(s, 'transform_matrix') else np.asarray(s)
        sinv = s.transform_matrix_inverse if hasattr(s, 'transform_matrix_inverse') \
            else np.linalg.inv(smx)
        for _, obj in self._iter_parameterized_objs():
            obj.transform_inplace(smx, sinv)
        self._mark_for_rebuild()

    def frobeniusdist(self, other):
        """RMS Frobenius distance over corresponding members, instruments
        (their member stacks) included."""
        total, count = 0.0, 0
        for mine, theirs in ((self.operations, other.operations),
                             (self.preps, other.preps), (self.povms, other.povms),
                             (self.instruments, other.instruments)):
            for lbl in mine:
                diff = mine[lbl].dense() - theirs[lbl].dense()
                total += np.sum(diff ** 2)
                count += diff.size
        return np.sqrt(total / count) if count else 0.0

    # -- serialization --------------------------------------------------------
    def to_nice_serialization(self):
        """The JAX package's state layout, with the port's module names.
        The port's models carry a dimension and no state-space labels, so
        'dim' stands where the JAX package writes its state space.  The
        instruments are written too, which the JAX package leaves out (its
        checkpoints of an instrument model read back without them)."""
        def ser(obj):
            return obj.to_nice_serialization()
        return {
            'module': type(self).__module__, 'class': type(self).__name__,
            'dim': self.dim,
            'basis': self.basis.name,
            'default_gate_type': self.default_gate_type,
            'default_prep_type': self.default_prep_type,
            'default_povm_type': self.default_povm_type,
            'preps': [[str(lbl), ser(o)] for lbl, o in self.preps.items()],
            'povms': [[str(lbl), ser(o)] for lbl, o in self.povms.items()],
            'operations': [[list(lbl) if isinstance(lbl, tuple) else str(lbl), ser(o)]
                           for lbl, o in self.operations.items()],
            'instruments': [[list(lbl) if isinstance(lbl, tuple) else str(lbl), ser(o)]
                            for lbl, o in self.instruments.items()],
        }

    @classmethod
    def from_nice_serialization(cls, state):
        """Reads the port's states and the JAX package's (whose state space
        is given as per-factor Hilbert dimensions)."""
        if 'dim' in state:
            dim = state['dim']
        else:
            dim = int(np.prod(state['state_space_udims'])) ** 2
        m = cls(dim, state['basis'], state['default_gate_type'],
                state['default_prep_type'], state['default_povm_type'])
        for kind in ('preps', 'povms', 'operations', 'instruments'):
            members = getattr(m, kind)
            for lbl, s in state.get(kind, []):
                key = Label(tuple(lbl)) if isinstance(lbl, list) else Label(lbl)
                members[key] = NicelySerializable.from_nice_serialization(s)
        return m
