"""Forward simulation: batched circuit evaluation in torch (counterpart of
pygsti_tpu/forwardsims/forwardsim.py, SimpleForwardSimulator's scan path).

The JAX package contracts every step with a one-hot over all ops, a choice
made for the TPU's matrix unit.  On the card a direct gather of each
circuit's op, ``G[idx]``, followed by a batched matvec does less work, so
the depth loop here is: gather, ``bmm``, next layer.  The gather writes
B d^2 numbers per layer, which at five qubits (d = 1,024) is 8 MB per
circuit: above GATHER_BYTES_MAX per layer the scan groups each layer's rows
by op instead, so every op present multiplies its rows once
(``grouped_plan``), reading each op once per layer.
"""

from __future__ import annotations

import numpy as np
import torch

from pygsti_tpu_torch import DTYPE
from pygsti_tpu_torch.baseobjs.outcomelabeldict import OutcomeLabelDict
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.layouts.layout import CircuitOutcomeProbabilityLayout


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


class SimpleForwardSimulator(object):
    """Dense state-propagation simulator on one device."""

    def __init__(self, model, device="cuda"):
        self.model = model
        self.device = torch.device(device)

    def create_layout(self, circuits, dataset=None, observed_outcomes_only=None):
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

    def probs_fn(self, layout):
        """A pure function v -> probabilities [n_elements] for `layout`.
        It also takes a time, probs(v, t): the probabilities with the
        model's tensors at time t (ExplicitOpModel.tensors_fn)."""
        layout.check_op_stack(self.model)
        compute = self.model.tensors_fn()
        idx = layout_tensors(layout, self.device)
        dim = self.model.dim
        gathered = layout.num_rows * dim * dim * torch.finfo(DTYPE).bits // 8
        plan = grouped_plan(layout, self.device) if gathered > GATHER_BYTES_MAX else None

        def probs(v, t=None):
            ten = compute(v) if t is None else compute(v, t)
            eye = torch.eye(dim, dtype=ten.ops.dtype, device=ten.ops.device)[None]
            G = torch.cat([ten.ops, eye], dim=0)          # [K+1, d, d]
            rho = propagate(G, ten.preps[idx['prep_index']], idx['op_indices'], plan)
            E = ten.effects[idx['elem_effect']]           # [E, d]
            return (E * rho[idx['elem_circuit']]).sum(dim=1)

        return probs

    def bulk_fill_probs(self, layout):
        v = torch.as_tensor(self.model.to_vector(), dtype=DTYPE, device=self.device)
        with torch.no_grad():
            return self.probs_fn(layout)(v).cpu().numpy()

    def bulk_fill_dprobs(self, layout):
        """d probabilities / d parameters [n_elements, P] at the model's
        parameters, by forward-mode differentiation of the whole scan (for
        small models: the design construction's amplification analysis)."""
        v = torch.as_tensor(self.model.to_vector(), dtype=DTYPE, device=self.device)
        return torch.func.jacfwd(self.probs_fn(layout))(v).cpu().numpy()

    def probs(self, circuit, outcomes=None):
        """OutcomeLabelDict(outcome -> probability) of one circuit;
        `outcomes` restricts it to those outcomes."""
        layout = self.create_layout([circuit])
        p = self.bulk_fill_probs(layout)
        keep = None if outcomes is None else \
            {OutcomeLabelDict.to_outcome(o) for o in outcomes}
        out = OutcomeLabelDict()
        for outcome, val in zip(layout.outcomes[0], p):
            if keep is None or outcome in keep:
                out[outcome] = float(val)
        return out

    def bulk_probs(self, circuits):
        """{circuit: OutcomeLabelDict(outcome -> probability)}."""
        circuits = [c if isinstance(c, Circuit) else Circuit(c) for c in circuits]
        layout = self.create_layout(circuits)
        p = self.bulk_fill_probs(layout)
        out = {}
        for i, c in enumerate(layout.circuits):
            start = layout.element_slices[i].start
            d = OutcomeLabelDict()
            for k, outcome in enumerate(layout.outcomes[i]):
                d[outcome] = float(p[start + k])
            out[c] = d
        return out
