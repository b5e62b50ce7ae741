"""Dependency graph of model members, for structural model comparison
(counterpart of pygsti_tpu/modelmembers/modelmembergraph.py).

`ModelMemberGraph.is_similar` compares two models structurally (same
member classes, composition structure, and shapes); `is_equivalent`
additionally requires equal parameter values.  Built from a model with
`create_modelmember_graph()` (available on ExplicitOpModel and the
implicit-model families).
"""

from __future__ import annotations

import collections

import numpy as np


def _submembers(mm):
    """Child members of a model member (composition factors, error
    generators, embedded/base ops...)."""
    out = []
    for attr in ('factors', 'ops_to_compose'):
        val = getattr(mm, attr, None)
        if isinstance(val, (list, tuple)):
            out.extend(val)
    for attr in ('errorgen', 'base_op', 'embedded_op', 'op_to_embed',
                 'state_vec', 'pure_state', 'noise_op', 'base_povm',
                 'base_state'):
        val = getattr(mm, attr, None)
        if val is not None and hasattr(val, 'num_params'):
            out.append(val)
    return out


class MMGNode(object):
    """A node wrapping one model member."""

    def __init__(self, mm):
        self.mm = mm
        self.children = [MMGNode(sub) for sub in _submembers(mm)]

    def structure_key(self):
        return (type(self.mm).__name__, int(self.mm.num_params),
                tuple(self.mm.dense().shape))


class ModelMemberGraph(object):
    """DAG of model-member dependencies (reference:
    modelmembergraph.ModelMemberGraph:19)."""

    def __init__(self, mm_dicts):
        """`mm_dicts`: {category: {label: member}} e.g.
        {'operations': {...}, 'preps': {...}, 'povms': {...}}."""
        self.mm_nodes = collections.OrderedDict(
            (cat, collections.OrderedDict(
                (lbl, MMGNode(mm)) for lbl, mm in d.items()))
            for cat, d in mm_dicts.items())

    @classmethod
    def from_model(cls, model):
        cats = collections.OrderedDict()
        for attr in ('preps', 'povms', 'operations', 'instruments',
                     'factories'):
            d = getattr(model, attr, None)
            if d is not None and len(d):
                cats[attr] = collections.OrderedDict(d.items())
        blks = getattr(model, 'operation_blks', None)
        if blks:
            for bname, d in blks.items():
                cats['operation_blks/' + str(bname)] = \
                    collections.OrderedDict(d.items())
        return cls(cats)

    # -- comparison ---------------------------------------------------------
    def is_similar(self, other, rtol=1e-5, atol=1e-8):
        """True if the two graphs have the same structure (categories,
        labels, member classes, composition trees, shapes) ignoring
        parameter values (reference: modelmembergraph.is_similar:105)."""
        return self._compare(other, check_params=False, rtol=rtol, atol=atol)

    def is_equivalent(self, other, rtol=1e-5, atol=1e-8):
        """True if structurally similar AND all parameter values agree to
        tolerance (reference: modelmembergraph.is_equivalent:122)."""
        return self._compare(other, check_params=True, rtol=rtol, atol=atol)

    def _compare(self, other, check_params, rtol, atol):
        if not isinstance(other, ModelMemberGraph):
            return False
        if list(self.mm_nodes.keys()) != list(other.mm_nodes.keys()):
            return False

        def compare_nodes(n1, n2):
            if n1.structure_key() != n2.structure_key():
                return False
            if check_params:
                v1 = np.asarray(n1.mm.to_vector()) \
                    if hasattr(n1.mm, 'to_vector') else np.zeros(0)
                v2 = np.asarray(n2.mm.to_vector()) \
                    if hasattr(n2.mm, 'to_vector') else np.zeros(0)
                if v1.shape != v2.shape or \
                   not np.allclose(v1, v2, rtol=rtol, atol=atol):
                    return False
            if len(n1.children) != len(n2.children):
                return False
            return all(compare_nodes(c1, c2)
                       for c1, c2 in zip(n1.children, n2.children))

        for cat in self.mm_nodes:
            d1, d2 = self.mm_nodes[cat], other.mm_nodes[cat]
            if [str(k) for k in d1] != [str(k) for k in d2]:
                return False
            for k1, k2 in zip(d1, d2):
                if not compare_nodes(d1[k1], d2[k2]):
                    return False
        return True
