"""Forward simulation: batched circuit evaluation in torch (counterpart of
pygsti_tpu/forwardsims/forwardsim.py): the ForwardSimulator base class with
the JAX package's bulk API (probabilities, their first derivatives and
their exact second derivatives), SimpleForwardSimulator with its two
probability kernels, the aliases, and create_forward_simulator.

The JAX package contracts every step with a one-hot over all ops, a choice
made for the TPU's matrix unit.  On the card a direct gather of each
circuit's op, ``G[idx]``, followed by a batched matvec does less work, so
the depth loop here is: gather, ``bmm``, next layer.  The gather writes
B d^2 numbers per layer, which at five qubits (d = 1,024) is 8 MB per
circuit: above GATHER_BYTES_MAX per layer the scan groups each layer's rows
by op instead, so every op present multiplies its rows once
(``grouped_plan``), reading each op once per layer.

``probs_kernel='fact'`` evaluates the germ-power product cache of
layouts/prodcache.py instead: the shared subproducts as a few levels of
batched matrix products, then short per-circuit contractions.  It is not
the default, as in the JAX package: its reassociated products are noisier
than the scan's (PARITY.md, "Jacobian-mode comparison").

With a mesh (``sim.mesh``, parallel/mesh.py) each rank simulates its shard
of the circuits and the probabilities are gathered, so every rank returns
all of them.
"""

from __future__ import annotations

import numpy as np
import torch

from pygsti_tpu_torch import DTYPE
from pygsti_tpu_torch.baseobjs.outcomelabeldict import OutcomeLabelDict
from pygsti_tpu_torch.baseobjs.profiler import span
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.layouts.layout import CircuitOutcomeProbabilityLayout

SIM_TYPES = ('auto', 'map', 'matrix', 'dense')
PROBS_KERNELS = ('scan', 'fact')


def layout_tensors(layout, device):
    """The layout's index arrays as int64 tensors on `device`, cached on the
    layout itself (one entry per device), so no cache can outlive or
    mistake its layout."""
    cache = layout.__dict__.setdefault('_device_tensors', {})
    key = str(torch.device(device))
    hit = cache.get(key)
    if hit is None:
        hit = {name: torch.as_tensor(getattr(layout, name), dtype=torch.int64,
                                     device=device)
               for name in ('op_indices', 'prep_index', 'elem_circuit',
                            'elem_effect')}
        cache[key] = hit
    return hit


#: the largest gather of ops per layer (bytes) the scan makes before it
#: groups rows by op instead: the 2-qubit fits (14k-20k circuits at d 16,
#: under 41 MB) keep the gather
GATHER_BYTES_MAX = 64 << 20


def grouped_plan(layout, device):
    """Per layer t, (gather index, [(op, start, stop), ...]): the states,
    kept sorted by the previous layer's ops, are gathered into the order of
    layer t's ops, whose rows then lie in one contiguous run per op; last,
    the index that puts them back in row order.  Built on the host from the
    layout's op indices, cached on the layout per device."""
    cache = layout.__dict__.setdefault('_grouped_plans', {})
    key = str(torch.device(device))
    if key in cache:
        return cache[key]
    op_idx = np.asarray(layout.op_indices)
    B, D = op_idx.shape
    inv = np.arange(B)                 # position of each row in the current order
    steps = []
    for t in range(D):
        order = np.argsort(op_idx[:, t], kind='stable')
        ops = op_idx[order, t]
        cuts = np.flatnonzero(np.diff(ops)) + 1
        starts = np.concatenate([[0], cuts])
        stops = np.concatenate([cuts, [B]])
        steps.append((torch.as_tensor(inv[order], dtype=torch.int64, device=device),
                      [(int(ops[a]), int(a), int(b)) for a, b in zip(starts, stops)]))
        inv = np.empty(B, dtype=np.int64)
        inv[order] = np.arange(B)
    cache[key] = (steps, torch.as_tensor(inv, dtype=torch.int64, device=device))
    return cache[key]


def propagate(G, rho, op_idx, plan=None):
    """Push states rho [B, d] through layers op_idx [B, D] of the op stack
    G [K1, d, d] (the last slot the identity); returns the final states
    [B, d].  With a grouped_plan the rows of each op are multiplied
    together: the same products, summed in another order."""
    with span('scan'):
        if plan is None:
            for t in range(op_idx.shape[1]):
                rho = torch.bmm(G[op_idx[:, t]], rho.unsqueeze(-1)).squeeze(-1)
            return rho
        steps, back = plan
        identity = G.shape[0] - 1
        for gather, segments in steps:
            s = rho[gather]
            rho = torch.cat([s[a:b] if k == identity else s[a:b] @ G[k].T
                             for k, a, b in segments])
        return rho[back]


def fact_tensors(layout, device):
    """The product-cache plan's index arrays (layouts/prodcache.py) as
    int64 tensors on `device`, cached on the layout per device."""
    cache = layout.__dict__.setdefault('_fact_tensors', {})
    key = str(torch.device(device))
    if key not in cache:
        fact = layout.factorization

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

        cache[key] = {'levels': [(t(l), t(r)) for l, r in fact.levels],
                      'a_pfx': t(fact.a_pfx_cache), 'e_sfx': t(fact.e_sfx_cache),
                      'pair_g': t(fact.pair_g), 'pair_a': t(fact.pair_a),
                      'elem_pair': t(fact.elem_pair), 'elem_erow': t(fact.elem_erow),
                      'n_preps': int(fact.n_preps), 'n_effects': int(fact.n_effects)}
    return cache[key]


def cache_products(G, levels):
    """The op stack G [K1, d, d] extended by the product cache's entries,
    level by level: entry i of a level is T[left_i] @ T[right_i]."""
    T = G
    for lefts, rights in levels:
        T = torch.cat([T, torch.matmul(T[lefts], T[rights])])
    return T


def factorized_probs(T, preps, effects, ft):
    """(p [E], a [n_pfx * n_preps, d], e [n_sfx * n_eff, d], X [Q, d]) from
    the extended table T of cache_products: every prefix applied to every
    prep (a), every effect pulled back through every suffix (e), the power
    block applied to its pair's state (X), and one dot per element."""
    d = T.shape[-1]
    a = torch.einsum('mij,rj->mri', T[ft['a_pfx']], preps[:ft['n_preps']]).reshape(-1, d)
    e = torch.einsum('oi,mij->moj', effects[:ft['n_effects']], T[ft['e_sfx']]).reshape(-1, d)
    X = torch.einsum('qij,qj->qi', T[ft['pair_g']], a[ft['pair_a']])
    return (e[ft['elem_erow']] * X[ft['elem_pair']]).sum(-1), a, e, X


def layout_shard(mesh, layout):
    """(this rank's sub-layout, element count of every rank's shard) for
    the circuit axis of `mesh`, cached on the layout per shard."""
    from pygsti_tpu_torch.parallel.mesh import circuit_shard
    c0, c1, bounds = circuit_shard(mesh, len(layout.circuits))
    cache = layout.__dict__.setdefault('_shards', {})
    if (c0, c1) not in cache:
        sizes = [layout.element_slices[b - 1].stop - layout.element_slices[a].start
                 if b > a else 0 for a, b in bounds]
        cache[c0, c1] = (layout.sub_layout(c0, c1), sizes)
    return cache[c0, c1]


def create_forward_simulator(sim_type, model, device="cuda"):
    """The simulator `sim_type` names for `model`: a SimpleForwardSimulator
    on `device` for 'auto', 'map', 'matrix' and 'dense'; a ForwardSimulator
    itself, given `model`."""
    if isinstance(sim_type, ForwardSimulator):
        sim_type.model = model
        return sim_type
    if sim_type in SIM_TYPES:
        return SimpleForwardSimulator(model, device)
    raise ValueError("Unknown simulator type %r" % (sim_type,))


def simulator_for(model, device):
    """The simulator an objective on `device` evaluates `model` with: the
    one its user set (``model.sim = ...`` or ``simulator=``), which must
    be on `device`, else a SimpleForwardSimulator on `device`."""
    device = torch.device(device)
    sim = getattr(model, 'user_sim', None)
    if sim is None:
        return SimpleForwardSimulator(model, device)
    sim_dev = getattr(sim, 'device', None)
    same = sim_dev is not None and sim_dev.type == device.type and \
        (sim_dev.index is None or device.index is None or sim_dev.index == device.index)
    if not same:
        raise ValueError("the model's simulator runs on %s, the objective on %s: set model.sim "
                         "to a simulator on %s" % (sim_dev, device, device))
    return sim


def _outcome_dicts(layout, values, make=OutcomeLabelDict, cast=float):
    """{circuit: {outcome: value}} over the layout's real circuits, values
    indexed by element."""
    out = {}
    for i, c in enumerate(layout.circuits[:layout.num_real_circuits]):
        start = layout.element_slices[i].start
        d = make()
        for k, outcome in enumerate(layout.outcomes[i]):
            d[outcome] = cast(values[start + k])
        out[c] = d
    return out


class ForwardSimulator(object):
    """Base class of the bulk API (the JAX package's ForwardSimulator).  A
    subclass gives ``local_probs_fn(layout)``, a function v -> the
    probabilities of the layout's elements on ``self.device``; the fills,
    the derivatives and the mesh follow from it."""

    def __init__(self, model=None, device="cuda", mesh=None):
        self.model = model
        self.device = torch.device(device)
        self.mesh = mesh

    def create_layout(self, circuits, dataset=None, resource_alloc=None, array_types=('e',),
                      derivative_dimensions=None, verbosity=0, observed_outcomes_only=None):
        """The layout of `circuits`.  observed_outcomes_only=None chooses as
        the JAX package does: with a dataset, only the observed outcomes
        when a POVM has more than 8 outcomes (more than 3 qubits), where
        the dense element count grows out of reach; else all outcomes."""
        if observed_outcomes_only is None:
            povms = self.model.povms
            observed_outcomes_only = dataset is not None and len(povms) > 0 and \
                max(p.num_outcomes for p in povms.values()) > 8
        return CircuitOutcomeProbabilityLayout(circuits, self.model, dataset,
                                               observed_outcomes_only=observed_outcomes_only)

    def local_probs_fn(self, layout):
        raise NotImplementedError()

    def _v(self):
        return torch.as_tensor(self.model.to_vector(), dtype=DTYPE, device=self.device)

    def _on_shards(self, layout, fn):
        """fn(layout) [n_elements, ...]; with a mesh, fn of this rank's
        shard, gathered over the circuit axis."""
        if self.mesh is None:
            return fn(layout)
        from pygsti_tpu_torch.parallel.mesh import gather_along
        sub, sizes = layout_shard(self.mesh, layout)
        return gather_along(self.mesh, 'circuits', fn(sub), sizes)

    def probs_fn(self, layout):
        """A pure function v -> probabilities [n_elements] for `layout`
        (with a mesh: gathered from every rank's shard)."""
        if self.mesh is None:
            return self.local_probs_fn(layout)
        from pygsti_tpu_torch.parallel.mesh import gather_along
        sub, sizes = layout_shard(self.mesh, layout)
        local = self.local_probs_fn(sub)
        return lambda v, *t: gather_along(self.mesh, 'circuits', local(v, *t), sizes)

    # -- fills -----------------------------------------------------------------
    def bulk_fill_probs(self, array_to_fill, layout):
        """The probabilities [n_elements] at the model's parameters, into
        `array_to_fill` when given; returns them."""
        v = self._v()
        with torch.no_grad():
            p = self._on_shards(layout, lambda L: self.local_probs_fn(L)(v)).cpu().numpy()
        if array_to_fill is not None:
            array_to_fill[:] = p
        return p

    def bulk_fill_dprobs(self, array_to_fill, layout, pr_array_to_fill=None):
        """d probabilities / d parameters [n_elements, P] at the model's
        parameters, by forward-mode differentiation of the whole
        simulation; the probabilities into `pr_array_to_fill`."""
        v = self._v()
        dp = self._on_shards(layout, lambda L: torch.func.jacfwd(self.local_probs_fn(L))(v))
        dp = dp.cpu().numpy()
        if pr_array_to_fill is not None:
            self.bulk_fill_probs(pr_array_to_fill, layout)
        if array_to_fill is not None:
            array_to_fill[:] = dp
        return dp

    def bulk_fill_hprobs(self, array_to_fill, layout, pr_array_to_fill=None,
                         deriv1_array_to_fill=None, deriv2_array_to_fill=None):
        """The exact Hessians [n_elements, P, P] of the probabilities (the
        forward derivative of their reverse-mode gradient), into
        `array_to_fill`; the probabilities and first derivatives into the
        other arrays given."""
        if pr_array_to_fill is not None:
            self.bulk_fill_probs(pr_array_to_fill, layout)
        if deriv1_array_to_fill is not None or deriv2_array_to_fill is not None:
            J = self.bulk_fill_dprobs(None, layout)
            for arr in (deriv1_array_to_fill, deriv2_array_to_fill):
                if arr is not None:
                    arr[:] = J
        v = self._v()
        H = self._on_shards(layout, lambda L: torch.func.jacfwd(
            torch.func.jacrev(self.local_probs_fn(L)))(v)).cpu().numpy()
        if array_to_fill is not None:
            array_to_fill[:] = H
        return H

    # -- one circuit -------------------------------------------------------------
    def probs(self, circuit, outcomes=None, time=None, clip_to=None):
        """OutcomeLabelDict(outcome -> probability) of one circuit;
        `outcomes` restricts it to those outcomes, `clip_to` (lo, hi) clips
        the values.  The simulator is time-independent, so a `time` other
        than None raises, as in the JAX package (the time-resolved
        objectives take their own times)."""
        if time is not None:
            raise NotImplementedError(
                "time-dependent probabilities are not supported by this simulator's probs(); "
                "use the time-dependent objectives (objectivefns/timedep.py) instead")
        layout = self.create_layout([circuit])
        p = self.bulk_fill_probs(None, layout)
        if clip_to is not None:
            p = np.clip(p, clip_to[0], clip_to[1])
        keep = None if outcomes is None else \
            {OutcomeLabelDict.to_outcome(o) for o in outcomes}
        out = OutcomeLabelDict()
        for outcome, val in zip(layout.outcomes[0], p):
            if keep is None or outcome in keep:
                out[outcome] = float(val)
        return out

    def dprobs(self, circuit):
        """{outcome: d probability / d parameters [P]} of one circuit."""
        layout = self.create_layout([circuit])
        return _outcome_dicts(layout, self.bulk_fill_dprobs(None, layout), dict,
                              lambda x: x)[layout.circuits[0]]

    def hprobs(self, circuit):
        """{outcome: exact Hessian [P, P]} of one circuit's probabilities."""
        layout = self.create_layout([circuit])
        return _outcome_dicts(layout, self.bulk_fill_hprobs(None, layout), dict,
                              lambda x: x)[layout.circuits[0]]

    # -- many circuits -----------------------------------------------------------
    def _layout_of(self, circuits):
        return self.create_layout([c if isinstance(c, Circuit) else Circuit(c)
                                   for c in circuits])

    def bulk_probs(self, circuits, clip_to=None, resource_alloc=None, smartc=None):
        """{circuit: OutcomeLabelDict(outcome -> probability)}."""
        layout = self._layout_of(circuits)
        p = self.bulk_fill_probs(None, layout)
        if clip_to is not None:
            p = np.clip(p, clip_to[0], clip_to[1])
        return _outcome_dicts(layout, p)

    def bulk_dprobs(self, circuits):
        """{circuit: {outcome: d probability / d parameters [P]}}."""
        layout = self._layout_of(circuits)
        return _outcome_dicts(layout, self.bulk_fill_dprobs(None, layout), dict, lambda x: x)

    def bulk_hprobs(self, circuits):
        """{circuit: {outcome: exact Hessian [P, P]}}, in one evaluation."""
        layout = self._layout_of(circuits)
        return _outcome_dicts(layout, self.bulk_fill_hprobs(None, layout), dict, lambda x: x)

    def fresh(self, model):
        """A simulator of this one's type and settings for `model` (a
        copied model's)."""
        sim = object.__new__(type(self))
        sim.__dict__.update(self.__dict__)
        sim.model = model
        return sim


class SimpleForwardSimulator(ForwardSimulator):
    """Dense state-propagation simulator on one device (or, with a mesh,
    on each rank's).  `probs_kernel` is 'scan' (the default: the depth
    loop of ``propagate``) or 'fact' (the germ-power product cache)."""

    def __init__(self, model=None, device="cuda", probs_kernel='scan', mesh=None):
        super().__init__(model, device, mesh)
        if probs_kernel not in PROBS_KERNELS:
            raise ValueError("unknown probs_kernel %r (the port has %s)"
                             % (probs_kernel, PROBS_KERNELS))
        self.probs_kernel = probs_kernel

    def local_probs_fn(self, layout):
        """A pure function v -> probabilities [n_elements] for `layout`, on
        this simulator's device.  It also takes a time, probs(v, t): the
        probabilities with the model's tensors at time t
        (ExplicitOpModel.tensors_fn)."""
        layout.check_op_stack(self.model)
        compute = self.model.tensors_fn()
        idx = layout_tensors(layout, self.device)
        dim = self.model.dim

        def stack(ten):
            eye = torch.eye(dim, dtype=ten.ops.dtype, device=ten.ops.device)[None]
            return torch.cat([ten.ops, eye], dim=0)          # [K+1, d, d]

        if self.probs_kernel == 'fact':
            ft = fact_tensors(layout, self.device)

            def probs(v, t=None):
                with span('model.tensors'):
                    ten = compute(v) if t is None else compute(v, t)
                T = cache_products(stack(ten), ft['levels'])
                return factorized_probs(T, ten.preps, ten.effects, ft)[0]

            return probs

        gathered = layout.num_rows * dim * dim * torch.finfo(DTYPE).bits // 8
        plan = grouped_plan(layout, self.device) if gathered > GATHER_BYTES_MAX else None

        def probs(v, t=None):
            with span('model.tensors'):
                ten = compute(v) if t is None else compute(v, t)
            rho = propagate(stack(ten), ten.preps[idx['prep_index']], idx['op_indices'], plan)
            E = ten.effects[idx['elem_effect']]           # [E, d]
            return (E * rho[idx['elem_circuit']]).sum(dim=1)

        return probs


class MatrixForwardSimulator(SimpleForwardSimulator):
    """The JAX package's alias: the matrix- and map-style simulators are
    one simulator here."""


class MapForwardSimulator(SimpleForwardSimulator):
    """The JAX package's alias.  `max_cache_size` and `num_atoms` are
    accepted and ignored (with one warning per process): there is no
    prefix cache or atom decomposition; a mesh distributes the work."""
    _tuning_warned = False

    def __init__(self, model=None, max_cache_size=None, num_atoms=None, param_blk_size=None,
                 device="cuda"):
        super().__init__(model, device)
        self.max_cache_size = max_cache_size
        self.num_atoms = num_atoms
        if (max_cache_size is not None or num_atoms is not None) \
                and not MapForwardSimulator._tuning_warned:
            import warnings
            warnings.warn("MapForwardSimulator accepts num_atoms/max_cache_size for API parity "
                          "only; the scan has no prefix cache or atom decomposition, so these "
                          "arguments are ignored (a mesh distributes the work: "
                          "parallel/mesh.py)")
            MapForwardSimulator._tuning_warned = True


class DistributableForwardSimulator(SimpleForwardSimulator):
    """The JAX package's alias: distribution is a mesh over the circuit
    axis (``sim.mesh``, parallel/mesh.py)."""

    def __init__(self, model=None, mesh=None, num_atoms=None, processor_grid=None,
                 param_blk_sizes=None, device="cuda"):
        super().__init__(model, device, mesh=mesh)


class CacheForwardSimulator(SimpleForwardSimulator):
    """A simulator whose layouts carry a per-circuit ``cache`` dict, the
    hook of the JAX package's class for derived simulators."""

    def create_layout(self, circuits, dataset=None, resource_alloc=None, array_types=(),
                      derivative_dimensions=None, verbosity=0, observed_outcomes_only=None):
        layout = super().create_layout(circuits, dataset, resource_alloc, array_types,
                                       derivative_dimensions, verbosity, observed_outcomes_only)
        layout.cache = {c: None for c in layout.circuits}
        return layout
