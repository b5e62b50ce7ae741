"""Qubit connectivity graphs, host Python (counterpart of
pygsti_tpu/baseobjs/qubitgraph.py, trimmed to what processor specs use:
the standard geometries and their edges)."""

from __future__ import annotations

import numpy as np


class QubitGraph(object):
    """An undirected (or directed) graph over qubit labels."""

    def __init__(self, qubit_labels, initial_edges=None, directed=False):
        self.nqubits = len(qubit_labels)
        self._nodes = tuple(qubit_labels)
        self._node_index = {q: i for i, q in enumerate(self._nodes)}
        self.directed = directed
        self._edges = set()
        for e in initial_edges or ():
            self.add_edge(e[0], e[1])

    @classmethod
    def common_graph(cls, num_qubits, geometry="line", directed=False, qubit_labels=None):
        """A standard graph: 'line' (or 'chain'), 'ring', 'grid' (rows of
        ceil(sqrt(n))) or 'fully_connected' (or 'all')."""
        q = tuple(qubit_labels) if qubit_labels is not None else tuple(range(num_qubits))
        n = num_qubits
        if geometry in ("line", "chain"):
            edges = [(q[i], q[i + 1]) for i in range(n - 1)]
        elif geometry == "ring":
            edges = [(q[i], q[(i + 1) % n]) for i in range(n)]
        elif geometry in ("fully_connected", "all"):
            edges = [(q[i], q[j]) for i in range(n) for j in range(i + 1, n)]
        elif geometry == "grid":
            ncols = int(np.ceil(np.sqrt(n)))
            edges = []
            for i in range(n):
                if (i % ncols) + 1 < ncols and i + 1 < n:
                    edges.append((q[i], q[i + 1]))
                if i + ncols < n:
                    edges.append((q[i], q[i + ncols]))
        else:
            raise ValueError("Unknown geometry %r" % geometry)
        return cls(q, edges, directed=directed)

    @property
    def node_names(self):
        return self._nodes

    def add_edge(self, q1, q2):
        i, j = self._node_index[q1], self._node_index[q2]
        self._edges.add((i, j))
        if not self.directed:
            self._edges.add((j, i))

    def edges(self, double_for_undirected=False):
        """The edges as (label, label) pairs, in node order; an undirected
        edge once unless `double_for_undirected`."""
        out, seen = [], set()
        for i, j in sorted(self._edges):
            if not self.directed and not double_for_undirected:
                key = (min(i, j), max(i, j))
                if key in seen:
                    continue
                seen.add(key)
            out.append((self._nodes[i], self._nodes[j]))
        return out
