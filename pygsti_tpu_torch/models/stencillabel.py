"""Stencil labels: qubit placeholders resolved against a gate's target
qubits and the device graph (counterpart of
pygsti_tpu/models/stencillabel.py)."""


from __future__ import annotations

import itertools


class StencilLabel(object):
    """Base: compute_absolute_sslbls(graph, target_lbls) -> list of
    absolute-qubit tuples."""

    @classmethod
    def cast(cls, obj):
        if isinstance(obj, StencilLabel):
            return obj
        if isinstance(obj, (tuple, list)):
            return StencilLabelTuple(tuple(obj))
        raise ValueError("Cannot cast %r to StencilLabel" % (obj,))

    def compute_absolute_sslbls(self, qubit_graph, target_lbls):
        raise NotImplementedError()


def _resolve_one(lbl, qubit_graph, target_lbls):
    """'@i' -> i-th target; '@i+left'-style directions resolve via the
    graph's neighbors; absolute labels pass through."""
    if isinstance(lbl, str) and lbl.startswith('@'):
        body = lbl[1:]
        if '+' in body:
            idx_s, direction = body.split('+', 1)
            base = target_lbls[int(idx_s)]
            nbrs = sorted(qubit_graph.neighbors(base), key=str) \
                if qubit_graph is not None else []
            nbrs = [n for n in nbrs if n not in target_lbls]
            if not nbrs:
                return None
            k = {'left': 0, 'right': -1, 'up': 0, 'down': -1}.get(direction, 0)
            return nbrs[k]
        return target_lbls[int(body)]
    return lbl


class StencilLabelTuple(StencilLabel):
    """A fixed tuple of (possibly relative) labels."""

    def __init__(self, sslbls):
        self.sslbls = tuple(sslbls)

    def compute_absolute_sslbls(self, qubit_graph, target_lbls):
        out = tuple(_resolve_one(l, qubit_graph, target_lbls)
                    for l in self.sslbls)
        if any(o is None for o in out):
            return []
        return [out]


class StencilLabelSet(StencilLabel):
    """A set of stencil tuples."""

    def __init__(self, *stencil_tuples):
        self.members = [StencilLabel.cast(t) for t in stencil_tuples]

    def compute_absolute_sslbls(self, qubit_graph, target_lbls):
        out = []
        for m in self.members:
            out.extend(m.compute_absolute_sslbls(qubit_graph, target_lbls))
        return out


class StencilLabelRadiusCombos(StencilLabel):
    """All length-k combinations of qubits within `radius` hops of the base
    labels."""

    def __init__(self, base_sslbls, radius, num_to_choose):
        self.base_sslbls = tuple(base_sslbls)
        self.radius = radius
        self.num_to_choose = num_to_choose

    def compute_absolute_sslbls(self, qubit_graph, target_lbls):
        bases = [_resolve_one(l, qubit_graph, target_lbls)
                 for l in self.base_sslbls]
        region = sorted(qubit_graph.radius(bases, self.radius), key=str)
        return [tuple(c) for c in
                itertools.combinations(region, self.num_to_choose)]
