"""PC-algorithm causal discovery for crosstalk detection (counterpart of
pygsti_tpu/extras/crosstalk/pcalg.py).

- :func:`g_square_dis` -- the discrete (multinomial) G^2 CI test,
- :func:`estimate_skeleton` -- PC-stable skeleton search,
- :func:`estimate_cpdag` -- v-structure orientation + Meek rules 1-3.

The graphs are this module's own small structures, :class:`Skeleton` and
:class:`PDAG`, with the parts of networkx's interface the search and the
crosstalk pipeline use (nodes, edges, neighbours, predecessors and
successors, in networkx's order: node order, then each node's neighbours in
the order they were added, which for a complete graph over 0..n-1 is
ascending).  In the CPDAG an undirected edge is a 2-cycle (both directions
present).  Host work only; networkx is not needed.
"""

from __future__ import annotations

import itertools

import numpy as np
from scipy import stats


class Skeleton(object):
    """An undirected graph over nodes 0..n-1 that starts complete."""

    def __init__(self, n):
        self._adj = {i: [j for j in range(n) if j != i] for i in range(n)}

    def nodes(self):
        return list(self._adj)

    def has_edge(self, i, j):
        return j in self._adj.get(i, ())

    def remove_edge(self, i, j):
        self._adj[i].remove(j)
        self._adj[j].remove(i)

    def neighbors(self, i):
        return iter(self._adj[i])

    def edges(self):
        """Each edge once, as (i, j) with i before j in node order."""
        return [(i, j) for i in self._adj for j in self._adj[i] if j > i]

    def to_directed(self):
        return PDAG({i: list(nb) for i, nb in self._adj.items()})


class PDAG(object):
    """A partially directed graph: (i, j) and (j, i) both present is an
    undirected edge."""

    def __init__(self, succ):
        self._succ = succ
        self._pred = {i: [] for i in succ}
        for i in succ:
            for j in succ[i]:
                self._pred[j].append(i)

    def nodes(self):
        return list(self._succ)

    def has_edge(self, i, j):
        return j in self._succ.get(i, ())

    def remove_edge(self, i, j):
        self._succ[i].remove(j)
        self._pred[j].remove(i)

    def successors(self, i):
        return iter(self._succ[i])

    def predecessors(self, i):
        return iter(self._pred[i])

    def edges(self):
        return [(i, j) for i in self._succ for j in self._succ[i]]


def g_square_dis(data, x, y, s, levels=None):
    """Discrete G^2 conditional-independence test: p-value for
    "column x independent of column y given the columns in s".

    data : int ndarray [n_samples, n_cols] with values 0..levels[c]-1.
    s : tuple of conditioning column indices.
    levels : per-column category counts (computed if None).

    Follows the ``gsq.ci_tests.ci_test_dis`` semantics, including the
    heuristic that returns p=1 (independence) when there are fewer than
    10 * dof samples, which keeps the PC search from over-rejecting on
    sparse strata.
    """
    data = np.asarray(data, dtype=int)
    if levels is None:
        levels = [int(data[:, c].max()) + 1 for c in range(data.shape[1])]
    lx, ly = levels[x], levels[y]
    dof = (lx - 1) * (ly - 1) * int(np.prod([levels[c] for c in s], initial=1))
    if dof == 0:
        return 1.0
    if data.shape[0] < 10 * dof:
        return 1.0  # insufficient data to test reliably

    # encode the conditioning configuration of each sample as one integer
    if len(s) > 0:
        key = np.zeros(data.shape[0], dtype=np.int64)
        for c in s:
            key = key * levels[c] + data[:, c]
        n_cfg = int(np.prod([levels[c] for c in s]))
    else:
        key = np.zeros(data.shape[0], dtype=np.int64)
        n_cfg = 1

    # joint counts n[cfg, x, y] via a single bincount
    joint = np.bincount((key * lx + data[:, x]) * ly + data[:, y],
                        minlength=n_cfg * lx * ly).reshape(n_cfg, lx, ly)
    nk = joint.sum(axis=(1, 2), keepdims=True).astype(float)     # [cfg,1,1]
    nik = joint.sum(axis=2, keepdims=True).astype(float)         # [cfg,lx,1]
    njk = joint.sum(axis=1, keepdims=True).astype(float)         # [cfg,1,ly]
    with np.errstate(divide='ignore', invalid='ignore'):
        expected = nik * njk / nk
        ratio = np.where((joint > 0) & (expected > 0),
                         joint / np.where(expected > 0, expected, 1.0), 1.0)
        g2 = 2.0 * float(np.sum(joint * np.log(ratio)))
    return float(stats.chi2.sf(max(g2, 0.0), dof))


def estimate_skeleton(indep_test_func, data_matrix, alpha, ignore_edges=None,
                      max_reach=None):
    """PC-stable skeleton estimation.

    Starts from the complete undirected graph over columns (minus
    ``ignore_edges``, which the crosstalk pipeline uses to declare the
    experiment's settings mutually independent by design) and removes the
    edge (i, j) whenever x_i is found conditionally independent of x_j
    given some subset of i's neighbours, recording that subset in
    ``sep_set[i][j]``.

    Returns (Skeleton, sep_set) where sep_set is an
    [n][n] nested list of sets (the pcalg return contract consumed by
    :func:`estimate_cpdag`).
    """
    data_matrix = np.asarray(data_matrix, dtype=int)
    n_cols = data_matrix.shape[1]
    levels = [int(data_matrix[:, c].max()) + 1 for c in range(n_cols)]
    g = Skeleton(n_cols)
    for (i, j) in (ignore_edges or []):
        if g.has_edge(i, j):
            g.remove_edge(i, j)
    sep_set = [[set() for _ in range(n_cols)] for _ in range(n_cols)]

    l = 0
    while True:
        cont = False
        # PC-stable: neighbourhoods frozen for this level
        adj = {i: set(g.neighbors(i)) for i in g.nodes()}
        removed = set()
        for (i, j) in list(g.edges()):
            for (a, b) in ((i, j), (j, i)):
                if (i, j) in removed or (j, i) in removed:
                    break
                others = adj[a] - {b}
                if len(others) < l:
                    continue
                cont = True
                for k_set in itertools.combinations(sorted(others), l):
                    p = indep_test_func(data_matrix, a, b, k_set, levels)
                    if p > alpha:
                        if g.has_edge(i, j):
                            g.remove_edge(i, j)
                        removed.add((i, j))
                        sep_set[a][b] |= set(k_set)
                        sep_set[b][a] |= set(k_set)
                        break
        l += 1
        if max_reach is not None and l > max_reach:
            break
        if not cont:
            break
    return g, sep_set


def estimate_cpdag(skel_graph, sep_set):
    """Orient the skeleton into a CPDAG: v-structure rule then Meek rules
    1-3 to closure.  Undirected edges remain as 2-cycles in the returned
    PDAG; every edge of the skeleton stays, in one direction at least."""
    dag = skel_graph.to_directed()
    node_ids = list(skel_graph.nodes())

    def _has_both(d, i, j):
        return d.has_edge(i, j) and d.has_edge(j, i)

    # v-structures: i - k - j with i,j non-adjacent and k not in sep_set[i][j]
    for (i, j) in itertools.combinations(node_ids, 2):
        if skel_graph.has_edge(i, j):
            continue
        common = set(skel_graph.neighbors(i)) & set(skel_graph.neighbors(j))
        for k in common:
            if k not in sep_set[i][j]:
                # orient i -> k <- j; an adjacency an earlier v-structure
                # oriented the other way stays as it is (the JAX package
                # deletes it, losing a dependence the skeleton found:
                # ROADMAP.md section 3)
                for a in (i, j):
                    if dag.has_edge(k, a) and dag.has_edge(a, k):
                        dag.remove_edge(k, a)

    # Meek rules to closure
    changed = True
    while changed:
        changed = False
        for (i, j) in list(dag.edges()):
            if not _has_both(dag, i, j):
                continue  # already oriented
            # Rule 1: k -> i, i - j, k and j non-adjacent  =>  i -> j
            for k in dag.predecessors(i):
                if dag.has_edge(i, k):
                    continue  # k-i undirected
                if not (dag.has_edge(k, j) or dag.has_edge(j, k)):
                    dag.remove_edge(j, i)
                    changed = True
                    break
            if not _has_both(dag, i, j):
                continue
            # Rule 2: i -> k -> j and i - j  =>  i -> j
            for k in dag.successors(i):
                if dag.has_edge(k, i):
                    continue
                if dag.has_edge(k, j) and not dag.has_edge(j, k):
                    dag.remove_edge(j, i)
                    changed = True
                    break
            if not _has_both(dag, i, j):
                continue
            # Rule 3: i - k -> j and i - l -> j with k,l non-adjacent, i-j
            und_nbrs = [k for k in dag.successors(i) if dag.has_edge(k, i)]
            directing = [k for k in und_nbrs
                         if dag.has_edge(k, j) and not dag.has_edge(j, k)]
            done = False
            for (k, l) in itertools.combinations(directing, 2):
                if not (dag.has_edge(k, l) or dag.has_edge(l, k)):
                    dag.remove_edge(j, i)
                    changed = True
                    done = True
                    break
            if done:
                continue
    return dag
