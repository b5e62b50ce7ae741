"""TreeNode: the base-class name of the nested design / data / results
trees (counterpart of pygsti_tpu/protocols/treenode.py).  ExperimentDesign,
ProtocolData and ProtocolResultsDir carry the tree behaviour themselves."""

from __future__ import annotations


class TreeNode(object):
    """A node with keyed children: keys(), items(), [key], `in`, and a
    walk over itself and every node below it."""

    def keys(self):
        return ()

    def items(self):
        return iter(())

    def __getitem__(self, key):
        raise KeyError(key)

    def __contains__(self, key):
        return key in list(self.keys())

    def iterate_over_nodes(self):
        yield self
        for _, child in self.items():
            if isinstance(child, TreeNode):
                yield from child.iterate_over_nodes()
            else:
                yield child
