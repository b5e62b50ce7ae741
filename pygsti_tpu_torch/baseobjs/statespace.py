"""State spaces: tensor products of qubit and qudit factors, host Python
(counterpart of pygsti_tpu/baseobjs/statespace.py).

``dim`` is the superoperator (density-matrix vector) dimension, ``udim``
the unitary (state-vector) one; each factor has a label and a unitary
dimension.  Implicit models embed their members by these labels.
"""

from __future__ import annotations

import numpy as np


class StateSpace(object):
    """Base class. A state space is an ordered list of tensor-product components,
    each with a label and a (unitary-space) dimension."""

    @classmethod
    def cast(cls, obj):
        if isinstance(obj, StateSpace):
            return obj
        if isinstance(obj, int):
            return QubitSpace(obj)
        if isinstance(obj, (list, tuple)):
            if all(isinstance(x, int) or (isinstance(x, str) and x.startswith('Q')) for x in obj):
                return QubitSpace(obj)
            return ExplicitStateSpace(obj)
        raise ValueError("Cannot cast %r to StateSpace" % (obj,))

    @property
    def udim(self):
        """Unitary-space (state-vector) dimension, e.g. 2**n for n qubits."""
        raise NotImplementedError()

    @property
    def dim(self):
        """Superoperator-space dimension = udim**2 (density-matrix vec length)."""
        return self.udim ** 2

    @property
    def tensor_product_block_labels(self):
        raise NotImplementedError()

    @property
    def tensor_product_block_dims(self):
        """Unitary dims of each factor."""
        raise NotImplementedError()

    @property
    def num_qubits(self):
        if not self.is_entirely_qubits:
            raise ValueError("State space is not entirely qubits")
        return len(self.tensor_product_block_labels)

    @property
    def qubit_labels(self):
        return self.tensor_product_block_labels

    @property
    def is_entirely_qubits(self):
        return all(d == 2 for d in self.tensor_product_block_dims)

    def label_dimension(self, label):
        try:
            i = self.tensor_product_block_labels.index(label)
        except ValueError:
            raise KeyError("No state-space label %r" % (label,))
        return self.tensor_product_block_dims[i]

    def label_index(self, label):
        return self.tensor_product_block_labels.index(label)

    @property
    def num_params(self):
        return 0

    def is_compatible_with(self, other):
        return (tuple(self.tensor_product_block_dims)
                == tuple(other.tensor_product_block_dims))

    def __eq__(self, other):
        if not isinstance(other, StateSpace):
            return NotImplemented
        return (tuple(self.tensor_product_block_labels) == tuple(other.tensor_product_block_labels)
                and tuple(self.tensor_product_block_dims) == tuple(other.tensor_product_block_dims))

    def __hash__(self):
        return hash((tuple(self.tensor_product_block_labels),
                     tuple(self.tensor_product_block_dims)))

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, list(self.tensor_product_block_labels))


class QubitSpace(StateSpace):
    """A state space composed entirely of qubits."""

    def __init__(self, nqubits_or_labels):
        if isinstance(nqubits_or_labels, int):
            self._labels = tuple(range(nqubits_or_labels))
        else:
            self._labels = tuple(nqubits_or_labels)

    @property
    def udim(self):
        return 2 ** len(self._labels)

    @property
    def tensor_product_block_labels(self):
        return self._labels

    @property
    def tensor_product_block_dims(self):
        return tuple(2 for _ in self._labels)

    @property
    def num_qubits(self):
        return len(self._labels)

    def __str__(self):
        return "QubitSpace(%d)" % len(self._labels)


class QuditSpace(StateSpace):
    """A state space of qudits with given unitary dims."""

    def __init__(self, labels, udims):
        self._labels = tuple(labels)
        self._udims = tuple(int(d) for d in udims)
        assert len(self._labels) == len(self._udims)

    @property
    def udim(self):
        return int(np.prod(self._udims)) if self._udims else 1

    @property
    def tensor_product_block_labels(self):
        return self._labels

    @property
    def tensor_product_block_dims(self):
        return self._udims


class ExplicitStateSpace(QuditSpace):
    """A state space given by explicit labels and dims.  Labels like 'Q0' imply
    qubits (dim 2); 'L0' implies a level (dim 1); otherwise dim must be given."""

    def __init__(self, labels, udims=None):
        if isinstance(labels, (int, str)):
            labels = (labels,)
        labels = tuple(labels)
        if len(labels) == 1 and isinstance(labels[0], (tuple, list)):
            # the nested form of a single tensor-product block, [('Q0', 'Q1')]
            labels = tuple(labels[0])
        if udims is None:
            udims = []
            for lbl in labels:
                if isinstance(lbl, int):
                    udims.append(2)
                elif isinstance(lbl, str) and lbl.startswith('Q'):
                    udims.append(2)
                elif isinstance(lbl, str) and lbl.startswith('T'):
                    udims.append(3)
                elif isinstance(lbl, str) and lbl.startswith('L'):
                    udims.append(1)
                else:
                    raise ValueError("Cannot infer dimension of state-space label %r" % (lbl,))
        elif isinstance(udims, int):
            udims = (udims,)
        super().__init__(labels, udims)


def default_space_for_dim(dim):
    """Build a state space whose superop dimension is `dim` (must be 4**k for qubits)."""
    udim = int(round(np.sqrt(dim)))
    assert udim * udim == dim, "dimension %d is not a perfect square" % dim
    nq = int(round(np.log2(udim)))
    if 2 ** nq == udim:
        return QubitSpace(nq)
    return ExplicitStateSpace(("D%d" % udim,), (udim,))


def default_space_for_udim(udim):
    """State space for a unitary-operator dimension: a QubitSpace when udim
    is a power of 2, else a single explicit qudit."""
    nqubits = int(round(np.log2(udim)))
    if 2 ** nqubits == udim:
        return QubitSpace(nqubits)
    return ExplicitStateSpace(('all',), udims=(udim,))


def default_space_for_num_qubits(num_qubits):
    """QubitSpace of the given size."""
    return QubitSpace(num_qubits)
