"""Plain PyTorch gate sets built from a parameter vector theta, following
pyGSTi's published constructions and parameter order.

A circuit layer is a list of components [gate name, qubit, ...]; the empty
list is the idle layer.  Each model gives, for a table of layers, the pp
superoperator of every layer, and the state and effect vectors.

Departures from pyGSTi, each also made by the program under test:
- 'full' models: only the explicit members of a GST model pack (one prep
  'rho0', one unconstrained POVM 'Mdefault', one dense op per layer), and
  the truth's depolarization applies to the ops and the prep only (the
  POVM is left alone, as `ExplicitOpModel.depolarize` does in the port and
  in the JAX package it follows).
- cloud-noise models: errcomp_type 'gates' and implicit_idle_mode 'none'
  only (each layer is its gates then its gates' clouds, the first applied
  first; the empty layer is the global idle), independent clouds, and a
  cloud's error terms span the whole cloud (connected_highweight_errors
  False).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gstbench.reference import pauli


def _layer_key(layer):
    return tuple(tuple(c) for c in layer)


class FullGateSet(object):
    """An explicit n-qubit gate set in pyGSTi's 'full' parameterization.

    theta = [rho0 (d), each effect of Mdefault (d each), each op (d^2 each,
    row-major)], the members in the order preps, POVMs, operations.
    `spec`: {"qubits": n, "operations": [layer, ...]} in the model's
    operation order; each op's target is the ideal unitary of its layer."""

    def __init__(self, spec):
        self.n = n = spec['qubits']
        self.dim = d = 4 ** n
        self.op_layers = [_layer_key(l) for l in spec['operations']]
        self.outcomes = pauli.outcome_labels(n)
        self.num_effects = len(self.outcomes)
        self.num_params = d + self.num_effects * d + len(self.op_layers) * d * d
        rho = torch.zeros((2 ** n, 2 ** n), dtype=torch.complex128)
        rho[0, 0] = 1
        self._rho0 = pauli.state_vector(rho, n)
        self._effects0 = pauli.computational_effects(n)
        self._ops0 = torch.stack([ideal_layer_superop(l, n) for l in self.op_layers])

    def layer_index(self, layers):
        """The op index of each layer of a layer table."""
        index = {k: i for i, k in enumerate(self.op_layers)}
        return [index[_layer_key(l)] for l in layers]

    def theta_target(self):
        return torch.cat([self._rho0, self._effects0.reshape(-1), self._ops0.reshape(-1)])

    def theta_depolarized(self, op_noise, spam_noise):
        """The target with each op's non-identity block and the prep's
        scaled by 1 - noise (pyGSTi's `depolarize`)."""
        d = self.dim
        D_op = torch.diag(torch.tensor([1.0] + [1.0 - op_noise] * (d - 1), dtype=torch.float64))
        D_sp = torch.diag(torch.tensor([1.0] + [1.0 - spam_noise] * (d - 1), dtype=torch.float64))
        return torch.cat([D_sp @ self._rho0, self._effects0.reshape(-1),
                          (D_op @ self._ops0).reshape(-1)])

    def constants(self, layers, dtype, device):
        """What `split` needs for a layer table, on `device`."""
        return {'index': torch.as_tensor(self.layer_index(layers), device=device)}

    def at_point(self, theta, const):
        """`const` for differentiating at theta (nothing to fix here)."""
        return const

    def split(self, theta, const):
        """(layer ops [K, d, d] in the table's order, rho [d], effects [M, d])."""
        d, M = self.dim, self.num_effects
        rho = theta[:d]
        effects = theta[d:d + M * d].reshape(M, d)
        ops = theta[d + M * d:].reshape(len(self.op_layers), d, d)
        return ops[const['index']], rho, effects


def ideal_layer_superop(layer, n):
    """The pp superoperator of a layer of ideal gates (the identity for the
    empty layer)."""
    u = torch.eye(2 ** n, dtype=torch.complex128)
    for comp in layer:
        name, targets = comp[0], list(comp[1:])
        u = pauli.embed_unitary(pauli.gate_unitary(name), targets, n) @ u
    return pauli.unitary_superop(u, n)


def expm(A, squarings):
    """exp(A) for a stack [..., m, m], by a degree-16 Taylor polynomial of
    A / 2^s, squared s times.  `squarings` (s per matrix) comes from the
    matrices' 1-norms (`expm_squarings`), outside any differentiation."""
    out = []
    for a, s in zip(A, squarings):
        a = a / (2.0 ** s)
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        t = eye
        for k in range(16, 0, -1):
            t = eye + (a @ t) / k
        for _ in range(s):
            t = t @ t
        out.append(t)
    return torch.stack(out)


def expm_squarings(A):
    """Squarings that bring each matrix's 1-norm to 1/4 or below."""
    with torch.no_grad():
        norms = A.detach().abs().sum(-2).amax(-1).double().cpu().numpy()
    return [max(0, int(math.ceil(math.log2(x / 0.25)))) if x > 0.25 else 0 for x in norms]


def pauli_labels_upto(n, max_weight):
    """pyGSTi's error-generator labels on n qubits: every non-identity
    Pauli product of weight <= max_weight, in basis order."""
    return [l for l in pauli.pauli_labels(n)[1:] if sum(ch != 'I' for ch in l) <= max_weight]


class CloudNoise(object):
    """pyGSTi's cloud-noise crosstalk model
    (`create_cloud_crosstalk_model_from_hops_and_weights`) with Lindblad
    'H+s' clouds: each (gate, targets) has an error map exp(L) on the qubits
    within `maxhops` of its targets, L = sum_j h_j H_j + sum_j s_j S_j over
    the Pauli products P_j of weight <= (gate qubits + extra_gate_weight) on
    that cloud, H_j and S_j the elementary generators of B_j = P_j /
    sqrt(2^|cloud|); the global idle is exp(L) with terms of weight <=
    max_idle_weight on all qubits.  With a Lindblad `spam_type` ('H+S' or
    'H+s') the prep is exp(L_prep) rho0 and the POVM's effects are the
    computational ones after exp(L_povm), each L with terms of weight <=
    max_spam_weight on all qubits; under 'H+S' an S coefficient is its
    parameter squared.  Parameters: the prep's, the POVM's, the idle's,
    then each cloud's in gate order and availability order; each member's H
    coefficients, then its S coefficients."""

    def __init__(self, spec):
        if spec['parameterization'] != 'H+s':
            raise ValueError("only the 'H+s' parameterization is built here")
        spam = spec.get('spam_type', 'computational')
        if spam not in ('computational', 'H+S', 'H+s'):
            raise ValueError("spam_type %r is not built here" % spam)
        self.n = n = spec['qubits']
        self.dim = 4 ** n
        self.outcomes = pauli.outcome_labels(n)
        self.num_effects = len(self.outcomes)
        edges = {tuple(sorted(e)) for e in spec['edges']}

        def radius(targets, hops):
            out = set(targets)
            for _ in range(hops):
                out |= {b for a in out for e in edges for b in e if a in e}
            return sorted(out)

        self.leaves = []            # (key, qubits, labels, S coefficient squared)
        if spam != 'computational' and spec['max_spam_weight'] > 0:
            labels = pauli_labels_upto(n, spec['max_spam_weight'])
            for key in ('prep', 'povm'):
                self.leaves.append((key, list(range(n)), labels, spam == 'H+S'))
        keys = [k for k, _, _, _ in self.leaves]
        self.prep_leaf = keys.index('prep') if 'prep' in keys else None
        self.povm_leaf = keys.index('povm') if 'povm' in keys else None
        self.idle_leaf = len(self.leaves)
        self.leaves.append(('idle', list(range(n)),
                            pauli_labels_upto(n, spec['max_idle_weight']), False))
        self.cloud_of = {}
        for name, avail in spec['gates']:
            for targets in avail:
                weight = len(targets) + spec['extra_gate_weight']
                cloud = radius(targets, spec['maxhops'])
                self.cloud_of[(name, tuple(targets))] = len(self.leaves)
                self.leaves.append(((name, tuple(targets)), cloud,
                                    pauli_labels_upto(len(cloud), weight), False))
        self.slices = []
        off = 0
        for _, _, labels, _ in self.leaves:
            self.slices.append(slice(off, off + 2 * len(labels)))
            off += 2 * len(labels)
        self.num_params = off
        # every leaf's generators as full-space superoperators [2 n_j, d, d]
        gens = []
        for _, cloud, labels, _ in self.leaves:
            scale = 1.0 / math.sqrt(2 ** len(cloud))
            full = [_on_qubits(l, cloud, n) for l in labels]
            gens.append(torch.stack(
                [pauli.hamiltonian_generator(l, scale, n) for l in full]
                + [pauli.stochastic_generator(l, scale, n) for l in full]))
        self._gens = gens
        rho = torch.zeros((2 ** n, 2 ** n), dtype=torch.complex128)
        rho[0, 0] = 1
        self._rho0 = pauli.state_vector(rho, n)
        self._effects0 = pauli.computational_effects(n)

    def param_index(self, leaf_key, block, label):
        """The parameter of one coefficient: leaf 'prep', 'povm', 'idle' or
        (gate, targets),
        block 'H' or 'S', label a Pauli product on the leaf's qubits."""
        i = [k for k, _, _, _ in self.leaves].index(leaf_key)
        labels = self.leaves[i][2]
        return self.slices[i].start + (0 if block == 'H' else len(labels)) + labels.index(label)

    def theta_target(self):
        return torch.zeros(self.num_params, dtype=torch.float64)

    def constants(self, layers, dtype, device):
        """What `split` needs for a layer table, on `device`: the ideal
        layers, and per layer the leaves applied after them."""
        ideal = torch.stack([ideal_layer_superop(l, self.n) for l in layers])
        after = []
        for l in layers:
            if len(l) == 0:
                after.append([self.idle_leaf])
            else:
                after.append([self.cloud_of[(c[0], tuple(c[1:]))] for c in l])
        return {'ideal': ideal.to(device, dtype), 'after': after,
                'gens': [g.to(device, dtype) for g in self._gens],
                'rho': self._rho0.to(device, dtype), 'effects': self._effects0.to(device, dtype)}

    def _generators(self, theta, const):
        out = []
        for (_, _, labels, squared), sl, g in zip(self.leaves, self.slices, const['gens']):
            c = theta[sl]
            if squared:
                c = torch.cat([c[:len(labels)], c[len(labels):] ** 2])
            out.append(torch.einsum('p,pij->ij', c, g))
        return torch.stack(out)

    def at_point(self, theta, const):
        """`const` for differentiating at theta: the exponentials'
        squarings fixed from theta, outside any differentiation."""
        with torch.no_grad():
            return dict(const, squarings=expm_squarings(self._generators(theta, const)))

    def leaf_maps(self, theta, const):
        """exp(L_j) of every leaf [n_leaves, d, d]."""
        L = self._generators(theta, const)
        return expm(L, const.get('squarings') or expm_squarings(L))

    def split(self, theta, const):
        maps = self.leaf_maps(theta, const)
        ops = []
        for ideal, after in zip(const['ideal'], const['after']):
            op = ideal
            for j in after:
                op = maps[j] @ op
            ops.append(op)
        rho, effects = const['rho'], const['effects']
        if self.prep_leaf is not None:
            rho = maps[self.prep_leaf] @ rho
        if self.povm_leaf is not None:
            effects = effects @ maps[self.povm_leaf]
        return torch.stack(ops), rho, effects


def _on_qubits(label, qubits, n):
    """A Pauli label on `qubits` padded with I to all n qubits."""
    out = ['I'] * n
    for ch, q in zip(label, qubits):
        out[q] = ch
    return ''.join(out)


def cloud_truth(model, spec):
    """The planted truth of a cloud-noise configuration: every parameter
    scale * |N(0, 1)| from numpy's RandomState(seed) (an 'H+S' S
    coefficient is its parameter squared), then the planted parameters
    set."""
    t = spec['truth']
    v = t['scale'] * np.abs(np.random.RandomState(t['seed']).randn(model.num_params))
    for leaf, block, label, value in t['planted']:
        key = leaf if isinstance(leaf, str) else (leaf[0], tuple(leaf[1:]))
        v[model.param_index(key, block, label)] = value
    return torch.as_tensor(v, dtype=torch.float64)
