"""Implicit models with local (crosstalk-free) noise (counterpart of
pygsti_tpu/models/localnoisemodel.py).

The model keeps *leaf* members -- one per primitive gate, acting on that
gate's qubits, plus an optional idle -- and a registry of the circuit
layers the layouts have shown it.  ``tensors_fn`` computes every leaf's
small matrix from the parameter vector, then each registered layer's
full-space superoperator by embedding its factors and multiplying them, the
first applied first.  The op stack is the registered layers in the order of
registration; the empty layer ``[]`` (the global idle) is always the first.

Parameters are laid out as in the JAX package: preps, POVMs, gates, the
idle (then, in a cloud-noise model, the cloud members), so one vector means
one model in both packages.

``flat_tensors_jacobian_fn`` gives Tv = d flat tensors / d v for the blocked
Jacobian without differentiating the whole stack: the leaves' rows come
from one vmap of jvp over as many tangents as the largest leaf has
parameters, and each layer's rows from its factors' by the product rule,
d(F_m ... F_1) = sum_i F_m ... dF_i ... F_1, embedding being linear.
"""

from __future__ import annotations

import collections
import copy

import numpy as np
import torch

from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.baseobjs.statespace import QubitSpace
from pygsti_tpu_torch.models.explicitmodel import ModelTensors
from pygsti_tpu_torch.models.model import OpModel
from pygsti_tpu_torch.modelmembers.operations import Embedding


def _embed_info(state_space, target_labels):
    """(rest_dim, src_dims, axes) of the kron-embedding of an operation on
    `target_labels` into `state_space`: kron(mat, I_rest_dim), reshaped to
    src_dims + src_dims and transposed by axes."""
    e = Embedding(state_space, target_labels)
    return e.rest_dim, e.src_dims, e.axes


class LocalNoiseModel(OpModel):
    """Implicit model: each gate's noise acts only on its target qubits."""

    def __init__(self, processor_spec, gate_members, prep_member, povm_member,
                 basis='pp', idle_member=None, simulator='auto'):
        self.state_space = QubitSpace(processor_spec.qubit_labels)
        super().__init__(self.state_space.dim, basis, simulator)
        self.processor_spec = processor_spec
        # leaf members: {Label(gate name) or Label(gate name, targets): member
        # on the gate's qubits}
        self.operation_blks = {'gates': collections.OrderedDict(gate_members)}
        self.prep_blks = {'layers': collections.OrderedDict([(Label('rho0'), prep_member)])}
        self.povm_blks = {'layers': collections.OrderedDict([(Label('Mdefault'), povm_member)])}
        self.idle_member = idle_member
        # {gate name: OpFactory} for labels with arguments, such as Gzr;0.5:0
        self.factories = {'gates': collections.OrderedDict()}
        # an implicit model has no instruments; the layout asks
        self.instruments = collections.OrderedDict()
        self._layer_keys = []
        self._layer_recipes = []      # per layer: [(leaf key, target labels), ...]
        self._layer_index = {}
        self.register_layer(Label(()))

    # -- members ----------------------------------------------------------------
    def _iter_parameterized_objs(self):
        yield from self.prep_blks['layers'].items()
        yield from self.povm_blks['layers'].items()
        yield from self.operation_blks['gates'].items()
        if self.idle_member is not None:
            yield Label('{idle}'), self.idle_member

    def _leaves(self):
        """{leaf key: member} of every operation leaf a recipe may name."""
        out = collections.OrderedDict(self.operation_blks['gates'])
        if self.idle_member is not None:
            out['__idle__'] = self.idle_member
        return out

    @property
    def preps(self):
        return self.prep_blks['layers']

    @property
    def povms(self):
        return self.povm_blks['layers']

    @property
    def num_qubits(self):
        return self.state_space.num_qubits

    # -- the layer registry -----------------------------------------------------
    def _leaf_for(self, comp):
        """The leaf key of a simple layer component: the member keyed by the
        label with its qubits, else by the gate name; a label with
        arguments gets (and keeps) the static op its gate's factory makes."""
        gates = self.operation_blks['gates']
        args = getattr(comp, 'args', None)
        if args:
            if comp not in gates:
                factory = self.factories['gates'].get(comp.name)
                if factory is None:
                    raise KeyError("No op factory for the layer component %s" % str(comp))
                fargs = tuple(float(a) if isinstance(a, str) else a for a in args)
                gates[comp] = factory.create_op(fargs, comp.sslbls)
                self._mark_for_rebuild()
            return comp
        key = Label(comp.name, comp.sslbls) if comp.sslbls else Label(comp.name)
        if key in gates:
            return key
        if Label(comp.name) in gates:
            return Label(comp.name)
        raise KeyError("No gate member for the layer component %s" % str(comp))

    def _recipe(self, layer_lbl):
        comps = layer_lbl.components
        if len(comps) == 0:
            return [('__idle__', tuple(self.state_space.qubit_labels))] \
                if self.idle_member is not None else []
        return [(self._leaf_for(comp), tuple(comp.sslbls or ())) for comp in comps]

    def register_layer(self, layer_lbl):
        """The op-stack index of a circuit layer, registering it first."""
        layer_lbl = Label(layer_lbl)
        if layer_lbl in self._layer_index:
            return self._layer_index[layer_lbl]
        recipe = self._recipe(layer_lbl)
        idx = len(self._layer_keys)
        self._layer_keys.append(layer_lbl)
        self._layer_recipes.append(recipe)
        self._layer_index[layer_lbl] = idx
        return idx

    _register_layer = register_layer

    def register_circuit_layers(self, circuits):
        """Register every layer of `circuits` (the layout calls this)."""
        for layer in dict.fromkeys(l for c in circuits for l in c.layertup):
            self.register_layer(layer)

    # -- the layout interface -----------------------------------------------------
    @property
    def op_keys(self):
        return list(self._layer_keys)

    @property
    def prep_keys(self):
        return list(self.preps.keys())

    @property
    def povm_keys(self):
        return list(self.povms.keys())

    def povm_effect_rows(self):
        """povm label -> (row slice, outcome labels) into the effect stack."""
        out, off = {}, 0
        for lbl, povm in self.povms.items():
            out[lbl] = (slice(off, off + povm.num_outcomes), povm.outcome_labels)
            off += povm.num_outcomes
        return out

    def _default_prep_label(self):
        return self.prep_keys[0]

    def _default_povm_label(self):
        return self.povm_keys[0]

    def circuit_outcomes(self, circuit):
        return [(ol,) for ol in self.povms[self._default_povm_label()].outcome_labels]

    # -- pure compute functions ---------------------------------------------------
    def _plan(self):
        """(leaf keys, leaf members, layer recipes with Embedding objects,
        prep members, POVM members) at the current registry."""
        self._rebuild_paramvec_if_needed()
        leaves = self._leaves()
        embeds = {}
        recipes = []
        for recipe in self._layer_recipes:
            r = []
            for key, targets in recipe:
                if targets not in embeds:
                    embeds[targets] = Embedding(self.state_space, targets) if targets else None
                r.append((key, embeds[targets]))
            recipes.append(r)
        return leaves, recipes, list(self.preps.values()), list(self.povms.values())

    def tensors_fn(self):
        """A pure function v -> ModelTensors (safe under torch.func)."""
        leaves, recipes, preps, povms = self._plan()
        used = {key for r in recipes for key, _ in r}
        dim = self.dim

        def compute(v):
            mats = {k: m.to_dense(v[m.gpindices]) for k, m in leaves.items() if k in used}
            layers = []
            for recipe in recipes:
                m = None
                for key, emb in recipe:
                    g = mats[key] if emb is None else emb(mats[key])
                    m = g if m is None else g @ m
                layers.append(m if m is not None
                              else torch.eye(dim, dtype=v.dtype, device=v.device))
            return ModelTensors(torch.stack(layers),
                                torch.stack([p.to_dense(v[p.gpindices]) for p in preps]),
                                torch.cat([p.to_dense(v[p.gpindices]) for p in povms], dim=0))

        return compute

    def flat_tensors_fn(self):
        """A pure function v -> every tensor entry as one vector [NT]: the
        op stack, then preps, then effects, each row-major."""
        compute = self.tensors_fn()

        def flat(v):
            t = compute(v)
            return torch.cat([t.ops.reshape(-1), t.preps.reshape(-1), t.effects.reshape(-1)])

        return flat

    def flat_tensors_jacobian_fn(self):
        """A function v -> Tv = d flat tensors / d v, [NT, P] (module note).
        Nothing is evaluated until it is called."""
        leaves, recipes, preps, povms = self._plan()
        used = {key for r in recipes for key, _ in r}
        dim = self.dim
        P = len(self._paramvec)
        # the members whose rows come from the jvp pass, in order: the
        # parameterized leaves, then the preps and POVMs
        live = [(k, m) for k, m in leaves.items() if k in used and m.num_params > 0]
        spam = [(None, m) for m in preps + povms]
        members = live + spam
        sizes = [m.dim * m.dim for _, m in live] + [p.dim for p in preps] \
            + [p.num_outcomes * p.dim for p in povms]
        C = max((m.num_params for _, m in members), default=0)
        row_member = np.repeat(np.arange(len(members)), sizes)
        param_member = np.full(P, -1)
        param_k = np.zeros(P, dtype=np.int64)
        for i, (_, m) in enumerate(members):
            param_member[m.gpindices] = i
            param_k[m.gpindices] = np.arange(m.num_params)
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        live_rows = {k: (int(offsets[i]), int(offsets[i + 1]), m)
                     for i, (k, m) in enumerate(live)}
        n_spam_rows = int(offsets[-1] - offsets[len(live)])
        consts = {}

        def leaf_flat(v):
            return torch.cat([m.to_dense(v[m.gpindices]).reshape(-1) for _, m in members])

        def jacobian(v):
            key = (str(v.device), v.dtype)
            if key not in consts:
                seeds = np.zeros((C, P))
                seeds[param_k, np.arange(P)] = 1.0
                consts[key] = (torch.as_tensor(seeds, dtype=v.dtype, device=v.device),
                               torch.as_tensor(param_k, device=v.device),
                               torch.as_tensor(row_member[:, None] == param_member[None, :],
                                               device=v.device))
            S, k_of_param, own = consts[key]
            if C:
                compressed = torch.vmap(lambda t: torch.func.jvp(leaf_flat, (v,), (t,))[1],
                                        out_dims=1)(S)                         # [NT_leaf, C]
                T = compressed[:, k_of_param] * own                            # [NT_leaf, P]
            else:
                T = torch.zeros((int(offsets[-1]), P), dtype=v.dtype, device=v.device)
            mats = {k: m.to_dense(v[m.gpindices]) for k, m in leaves.items() if k in used}
            rows = []
            for recipe in recipes:
                F = [mats[k] if emb is None else emb(mats[k]) for k, emb in recipe]
                dM = torch.zeros((dim, dim, P), dtype=v.dtype, device=v.device)
                for i, (k, emb) in enumerate(recipe):
                    if k not in live_rows:
                        continue
                    lo, hi, m = live_rows[k]
                    sl = m.gpindices
                    dl = m.dim
                    dF = T[lo:hi, sl].reshape(dl, dl, -1).permute(2, 0, 1)     # [p_i, dl, dl]
                    if emb is not None:
                        dF = emb(dF)
                    for f in reversed(F[:i]):    # the factors applied before
                        dF = dF @ f
                    for f in F[i + 1:]:          # and after
                        dF = f @ dF
                    dM[:, :, sl] += dF.permute(1, 2, 0)
                rows.append(dM.reshape(dim * dim, P))
            rows.append(T[T.shape[0] - n_spam_rows:])
            return torch.cat(rows)

        return jacobian

    def op_param_indices(self):
        """Per op-stack slot, in op_keys order, the sorted parameter indices
        in whose columns that slot's rows of Tv (flat_tensors_jacobian_fn)
        can be nonzero: the union of the gpindices of its recipe's
        parameterized leaves, read from the structure, never from values.
        Every other column of the slot's rows is exactly 0."""
        leaves, recipes, _, _ = self._plan()
        every = np.arange(len(self._paramvec))
        out = []
        for recipe in recipes:
            idx = [every[leaves[k].gpindices] for k, _ in recipe if leaves[k].num_params > 0]
            out.append(np.unique(np.concatenate(idx)) if idx else np.empty(0, np.int64))
        return out

    # -- convenience --------------------------------------------------------------
    def probabilities(self, circuit, outcomes=None, device="cuda"):
        """{outcome: probability} of one circuit, simulated on `device`."""
        from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
        return SimpleForwardSimulator(self, device).probs(circuit, outcomes=outcomes)

    def bulk_probabilities(self, circuits, device="cuda"):
        """{circuit: {outcome: probability}}, simulated on `device`."""
        from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
        return SimpleForwardSimulator(self, device).bulk_probs(circuits)

    def copy(self):
        """A deep copy, the layer registry included, with a fresh simulator
        of this model's type and settings."""
        memo = {id(s): None for s in (self.user_sim, self._default_sim) if s is not None}
        m = copy.deepcopy(self, memo)
        m.user_sim = m._default_sim = None
        self._copy_simulator_to(m)
        return m
