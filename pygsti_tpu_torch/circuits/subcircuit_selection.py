"""Subcircuit sampling for subcircuit volumetric benchmarking (counterpart
of pygsti_tpu/circuits/subcircuit_selection.py).

A subcircuit is a (qubit subset) x (contiguous layer window) restriction of
a full circuit; gates crossing the qubit boundary are dropped.  Sampling
draws from a numpy RandomState: `rand_state`, or one seeded with `seed`."""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.baseobjs.label import Label, LabelTupTup
from pygsti_tpu_torch.circuits.circuit import Circuit


def _layer_components(layer):
    return (layer,) if layer.is_simple else tuple(layer.components)


def restrict_circuit(circ, qubits, layer_window=None):
    """The subcircuit on `qubits` within `layer_window` (start, stop);
    gates acting partially outside `qubits` are dropped."""
    keep = set(qubits)
    start, stop = layer_window if layer_window is not None \
        else (0, circ.depth)
    new_layers = []
    for layer in circ.layertup[start:stop]:
        comps = [c for c in _layer_components(layer)
                 if len(c) > 0 and c.sslbls is not None
                 and set(c.sslbls) <= keep]
        if len(comps) == 0:
            new_layers.append(Label(()))
        elif len(comps) == 1:
            new_layers.append(comps[0])
        else:
            new_layers.append(LabelTupTup.init(tuple(comps)))
    return Circuit(tuple(new_layers), tuple(qubits))


def random_connected_subset(graph_edges, all_qubits, width, rand_state=None):
    """A random connected qubit subset of the given width via random BFS
    growth (reference: subcircuit_selection.random_connected_subgraph)."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    adj = {q: set() for q in all_qubits}
    for a, b in graph_edges:
        if a in adj and b in adj:
            adj[a].add(b)
            adj[b].add(a)
    start = list(all_qubits)[rng.randint(len(all_qubits))]
    chosen = [start]
    frontier = set(adj[start])
    while len(chosen) < width:
        if not frontier:
            return None  # not enough connected qubits from this seed
        nxt = list(sorted(frontier, key=str))[rng.randint(len(frontier))]
        chosen.append(nxt)
        frontier |= adj[nxt]
        frontier -= set(chosen)
    return tuple(chosen)


def sample_subcircuits(full_circs, widths, depths, num_samples_per_shape=1,
                       graph_edges=None, seed=None, rand_state=None):
    """Sample subcircuits of each (width, depth) shape from full circuits
    (reference: subcircuit_selection.sample_subcircuits:58).  Returns
    {(width, depth): [Circuit, ...]}."""
    rng = rand_state if rand_state is not None else np.random.RandomState(seed)
    if isinstance(full_circs, Circuit):
        full_circs = [full_circs]
    out = {}
    for w in widths:
        for d in depths:
            samples = []
            attempts = 0
            while len(samples) < num_samples_per_shape and attempts < 50:
                attempts += 1
                circ = full_circs[rng.randint(len(full_circs))]
                if d > circ.depth or w > circ.num_lines:
                    break
                if graph_edges is not None:
                    qubits = random_connected_subset(
                        graph_edges, circ.line_labels, w, rng)
                    if qubits is None:
                        continue
                else:
                    idx = rng.choice(len(circ.line_labels), size=w,
                                     replace=False)
                    qubits = tuple(circ.line_labels[i] for i in sorted(idx))
                start = rng.randint(circ.depth - d + 1)
                samples.append(restrict_circuit(circ, qubits, (start, start + d)))
            out[(w, d)] = samples
    return out
