"""CircuitList: a named list of circuits (counterpart of
pygsti_tpu/circuits/circuitlist.py)."""

from __future__ import annotations

from pygsti_tpu_torch.circuits.circuit import Circuit


class CircuitList(object):
    """A named, immutable list of circuits, optionally with op-label aliases."""

    def __init__(self, circuits, op_label_aliases=None, name=None):
        self._list = [c if isinstance(c, Circuit) else Circuit(c) for c in circuits]
        self.op_label_aliases = op_label_aliases
        self.name = name

    def __len__(self):
        return len(self._list)

    def __iter__(self):
        return iter(self._list)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return CircuitList(self._list[i], self.op_label_aliases, self.name)
        return self._list[i]

    def __contains__(self, c):
        return c in self._list

    def __eq__(self, other):
        if isinstance(other, CircuitList):
            return self._list == other._list
        return self._list == list(other)

    def __repr__(self):
        return "CircuitList(%d circuits)" % len(self._list)
