"""ExplicitOpModel: dict-style model with explicit operations, preps and
POVMs (counterpart of pygsti_tpu/models/explicitmodel.py).

``tensors_fn()`` returns a pure torch function ``v -> ModelTensors``
(stacked op matrices, prep vectors and effect rows) on ``v``'s device and
dtype.  The parameter vector is laid out preps, POVMs, operations, each in
insertion order, exactly as in the JAX package, so one vector means one
model in both.  A model is gauge-transformed in place by a
GaugeGroupElement (host numpy) and serializes to the JAX package's state
layout, so either package's checkpoint reads here.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Any

import numpy as np
import torch

from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
from pygsti_tpu_torch.models.model import OpModel
from pygsti_tpu_torch.modelmembers.modelmember import ModelMember
from pygsti_tpu_torch.modelmembers import operations as _op
from pygsti_tpu_torch.modelmembers import states as _st
from pygsti_tpu_torch.modelmembers import povms as _pv


class ModelTensors(NamedTuple):
    """Stacked dense representations produced by tensors_fn."""
    ops: Any        # [n_ops, dim, dim]
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
        if not isinstance(val, ModelMember):
            val = self._parent._cast_member(self._kind, val)
        super().__setitem__(Label(key), val)
        self._parent._mark_for_rebuild()

    def __getitem__(self, key):
        return super().__getitem__(Label(key))

    def __contains__(self, key):
        return super().__contains__(Label(key))


class ExplicitOpModel(OpModel):
    """Model with explicit .operations/.preps/.povms dicts."""

    def __init__(self, dim, basis='pp', default_gate_type='full',
                 default_prep_type=None, default_povm_type=None):
        super().__init__(dim, basis)
        self.default_gate_type = default_gate_type
        self.default_prep_type = default_prep_type or default_gate_type
        self.default_povm_type = default_povm_type or default_gate_type
        self.preps = _MemberDict(self, 'prep')
        self.povms = _MemberDict(self, 'povm')
        self.operations = _MemberDict(self, 'op')

    def _cast_member(self, kind, val):
        table, t = {'op': (_OP_TYPES, self.default_gate_type),
                    'prep': (_PREP_TYPES, self.default_prep_type),
                    'povm': (_POVM_TYPES, self.default_povm_type)}[kind]
        if t not in table:
            raise ValueError("Cannot auto-cast %s for type %r" % (kind, t))
        return table[t](val)

    def _iter_parameterized_objs(self):
        for d in (self.preps, self.povms, self.operations):
            for lbl, obj in d.items():
                yield lbl, obj

    @property
    def op_keys(self):
        return list(self.operations.keys())

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
        """Deep copy of the members."""
        m = ExplicitOpModel(self.dim, self.basis, self.default_gate_type,
                            self.default_prep_type, self.default_povm_type)
        for src, dst in ((self.preps, m.preps), (self.povms, m.povms),
                         (self.operations, m.operations)):
            for lbl, obj in src.items():
                dst[lbl] = obj.copy()
        return m

    def tensors_fn(self):
        """A pure function v -> ModelTensors (safe under torch.func)."""
        self._rebuild_paramvec_if_needed()
        op_items = [(o.gpindices, o) for o in self.operations.values()]
        prep_items = [(p.gpindices, p) for p in self.preps.values()]
        povm_items = [(p.gpindices, p) for p in self.povms.values()]

        def compute(v):
            ops = torch.stack([o.to_dense(v[sl]) for sl, o in op_items])
            preps = torch.stack([p.to_dense(v[sl]) for sl, p in prep_items])
            effects = torch.cat([p.to_dense(v[sl]) for sl, p in povm_items], dim=0)
            return ModelTensors(ops, preps, effects)

        return compute

    def depolarize(self, op_noise=None, spam_noise=None):
        """A depolarized copy: each op's non-identity block scaled by
        1 - op_noise; with spam_noise only the preps are depolarized, the
        POVMs are left alone (as in the JAX package and the reference)."""
        m = self.copy()
        d = self.dim
        if op_noise is not None:
            D = np.diag([1.0] + [1.0 - op_noise] * (d - 1))
            for lbl, op in list(m.operations.items()):
                m.operations[lbl] = type(op)(D @ op.dense()) \
                    if not isinstance(op, _op.StaticArbitraryOp) \
                    else _op.StaticArbitraryOp(D @ op.dense())
        if spam_noise is not None:
            D = np.diag([1.0] + [1.0 - spam_noise] * (d - 1))
            for lbl, p in list(m.preps.items()):
                m.preps[lbl] = type(p)(D @ p.dense())
        return m

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
        """RMS Frobenius distance over corresponding members."""
        total, count = 0.0, 0
        for mine, theirs in ((self.operations, other.operations),
                             (self.preps, other.preps), (self.povms, other.povms)):
            for lbl in mine:
                diff = mine[lbl].dense() - theirs[lbl].dense()
                total += np.sum(diff ** 2)
                count += diff.size
        return np.sqrt(total / count) if count else 0.0

    # -- serialization --------------------------------------------------------
    def to_nice_serialization(self):
        """The JAX package's state layout, with the port's module names.
        The port's models carry a dimension and no state-space labels, so
        'dim' stands where the JAX package writes its state space."""
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
        for kind in ('preps', 'povms', 'operations'):
            members = getattr(m, kind)
            for lbl, s in state[kind]:
                key = Label(tuple(lbl)) if isinstance(lbl, list) else Label(lbl)
                members[key] = NicelySerializable.from_nice_serialization(s)
        return m
