"""Operator bases, host numpy (counterpart of pygsti_tpu/baseobjs/basis.py):
the builtin bases ('std', 'pp', 'PP', 'gm', 'qt', 'l2p1'), bases given by
explicit elements, tensor-product and direct-sum bases, and lazily built
ones.  The builtin elements come from basisconstructors.py.

A vector in basis B has components x_i = Tr(B_i^dag rho); the 'std' basis
vectorization is the row-major flattening of rho.  A superoperator in basis
B is S[i,j] = Tr(B_i^dag Lambda(B_j)).
"""

from __future__ import annotations

import itertools
import re

import numpy as np

from pygsti_tpu_torch.baseobjs import basisconstructors as _bc


def _superop_dim(dim_or_space):
    """A superoperator dimension given as an int or as anything with a
    ``dim`` (a state space, a model)."""
    return int(getattr(dim_or_space, 'dim', dim_or_space))


# name -> (matrices of d, labels of d)
_BUILTIN = {
    'std': (_bc.std_matrices, _bc.std_labels),
    'pp': (lambda d: _bc.pp_matrices(d, normalize=True), _bc.pp_labels),
    'PP': (lambda d: _bc.pp_matrices(d, normalize=False), _bc.pp_labels),
    'gm': (lambda d: _bc.gm_matrices(d, normalize=True), _bc.gm_labels),
    'qt': (_bc.qt_matrices, _bc.qt_labels),
    'l2p1': (_bc.lf_matrices, _bc.lf_labels),
}


class Basis(object):
    """A basis of d x d matrices spanning (a subspace of) matrix space.
    ``Basis(name, dim)`` itself gives the builtin basis, as Basis.cast
    does."""

    def __new__(cls, *args, **kwargs):
        if cls is Basis:
            return BuiltinBasis(*args, **kwargs)
        return super().__new__(cls)

    def implies_leakage_modeling(self):
        """True when this basis designates a proper computational subspace
        (labels use the C[...]/L[...] leakage convention; reference:
        basis.implies_leakage_modeling:374)."""
        labels = [str(l) for l in self.labels]
        has_eye = any(re.match(r'^(?:I|C\[I+\])+$', l) for l in labels)
        has_leak = any(l.startswith('L[') for l in labels)
        return bool(has_eye and has_leak)

    @classmethod
    def cast(cls, name_or_basis, dim=None):
        """`name_or_basis` as a Basis: a Basis is returned as it is, a name
        becomes the builtin basis of superoperator dimension `dim` (d**2,
        or anything with a ``dim``)."""
        if isinstance(name_or_basis, Basis):
            return name_or_basis
        return BuiltinBasis(name_or_basis, _superop_dim(dim))

    # -- subclass responsibilities ------------------------------------------
    @property
    def elements(self):
        """ndarray [size, d, d] of basis elements."""
        raise NotImplementedError()

    @property
    def labels(self):
        raise NotImplementedError()

    @property
    def name(self):
        raise NotImplementedError()

    @property
    def dim(self):
        """Dimension of the spanned vector space (d**2 for a complete basis)."""
        raise NotImplementedError()

    # -- common -------------------------------------------------------------
    @property
    def size(self):
        return self.elements.shape[0]

    @property
    def elshape(self):
        return self.elements.shape[1:]

    @property
    def matrix_dim(self):
        return self.elements.shape[1]

    @property
    def real(self):
        """Whether vectors expanded in this basis of Hermitian-matrix
        combinations have real coefficients for Hermitian matrices."""
        els = self.elements
        return bool(np.allclose(els, els.conj().transpose(0, 2, 1)))

    @property
    def first_element_is_identity(self):
        el0 = self.elements[0]
        d = el0.shape[0]
        return np.allclose(el0, el0[0, 0] * np.identity(d))

    def is_normalized(self):
        els = self.elements
        g = np.einsum('aij,bij->ab', els.conj(), els)
        return np.allclose(g, np.identity(els.shape[0]))

    def to_elementstd_transform_matrix(self):
        """Matrix T with columns vec_std(B_i): x_std = T @ x_thisbasis."""
        els = self.elements
        n, d, _ = els.shape
        return els.reshape(n, d * d).T.copy()

    def create_transform_matrix(self, to_basis):
        """Matrix M such that x_to = M @ x_from(this basis)."""
        to_basis = Basis.cast(to_basis, self.dim)
        fro = self.to_elementstd_transform_matrix()       # std <- self
        to_els = to_basis.elements
        n, d, _ = to_els.shape
        # x_to[i] = Tr(Bto_i^dag rho) = vec(Bto_i)^dag vec_std(rho)
        to_dual = to_els.reshape(n, d * d).conj()
        return to_dual @ fro

    def is_equivalent(self, other):
        other = Basis.cast(other, self.dim)
        return np.allclose(self.elements, other.elements)

    def __eq__(self, other):
        if isinstance(other, str):
            return self.name == other
        if isinstance(other, Basis):
            return (self.name == other.name and self.dim == other.dim
                    and np.array_equal(self.elements, other.elements))
        return NotImplemented

    def __hash__(self):
        return hash((self.name, self.dim))

    def __str__(self):
        return "%s basis (dim=%d)" % (self.name, self.dim)

    __repr__ = __str__


class BuiltinBasis(Basis):
    """One of the builtin bases: 'std', 'pp', 'PP', 'gm', 'qt'."""

    def __init__(self, name, dim):
        if name not in _BUILTIN:
            raise ValueError("Unknown builtin basis %r (known: %s)" % (name, list(_BUILTIN)))
        dim = _superop_dim(dim)
        d = int(round(np.sqrt(dim)))
        if d * d != dim:
            raise ValueError("Basis dim must be a perfect square (superop dim), got %d" % dim)
        self._name = name
        self._dim = dim
        self._matrix_dim = d

    @property
    def name(self):
        return self._name

    @property
    def dim(self):
        return self._dim

    @property
    def elements(self):
        return _BUILTIN[self._name][0](self._matrix_dim)

    @property
    def labels(self):
        return _BUILTIN[self._name][1](self._matrix_dim)

    def __reduce__(self):
        return (BuiltinBasis, (self._name, self._dim))


class ExplicitBasis(Basis):
    """A basis given by explicit element matrices."""

    def __init__(self, elements, labels=None, name="ExplicitBasis"):
        self._elements = np.asarray(elements, dtype=complex)
        self._labels = list(labels) if labels is not None else \
            ["E%d" % i for i in range(self._elements.shape[0])]
        self._name = name

    @property
    def name(self):
        return self._name

    @property
    def dim(self):
        d = self._elements.shape[1]
        return d * d

    @property
    def elements(self):
        return self._elements

    @property
    def labels(self):
        return self._labels


class TensorProdBasis(Basis):
    """Tensor product of component bases: elements are kron products, with the
    first component's index varying slowest (reference: basis.py:1673)."""

    def __init__(self, component_bases):
        self.component_bases = [b for b in component_bases]
        self._elements = None

    @property
    def name(self):
        return "*".join(b.name for b in self.component_bases)

    @property
    def dim(self):
        return int(np.prod([b.dim for b in self.component_bases]))

    @property
    def elements(self):
        if self._elements is None:
            comps = [b.elements for b in self.component_bases]
            shapes = [c.shape[1] for c in comps]
            total = int(np.prod([c.shape[0] for c in comps]))
            d = int(np.prod(shapes))
            out = np.empty((total, d, d), dtype=complex)
            for k, idx in enumerate(itertools.product(*[range(c.shape[0]) for c in comps])):
                m = np.ones((1, 1), dtype=complex)
                for c, i in zip(comps, idx):
                    m = np.kron(m, c[i])
                out[k] = m
            out.flags.writeable = False
            self._elements = out
        return self._elements

    @property
    def labels(self):
        return ["".join(t) for t in
                itertools.product(*[b.labels for b in self.component_bases])]


class DirectSumBasis(Basis):
    """Direct sum of component bases: block-diagonal embedding of components."""

    def __init__(self, component_bases):
        self.component_bases = list(component_bases)
        self._elements = None

    @property
    def name(self):
        return "+".join(b.name for b in self.component_bases)

    @property
    def dim(self):
        return sum(b.dim for b in self.component_bases)

    @property
    def elements(self):
        if self._elements is None:
            comps = [b.elements for b in self.component_bases]
            block_dims = [c.shape[1] for c in comps]
            D = sum(block_dims)
            total = sum(c.shape[0] for c in comps)
            out = np.zeros((total, D, D), dtype=complex)
            k = 0
            off = 0
            for c, bd in zip(comps, block_dims):
                for e in c:
                    out[k, off:off + bd, off:off + bd] = e
                    k += 1
                off += bd
            out.flags.writeable = False
            self._elements = out
        return self._elements

    @property
    def labels(self):
        lbls = []
        for b in self.component_bases:
            lbls.extend(b.labels)
        return lbls


class LazyBasis(Basis):
    """Basis whose labels and elements are constructed only on first access
    (reference: basis.LazyBasis:845).  Subclasses implement
    _lazy_build_labels / _lazy_build_elements; here deferral is provided by
    wrapping builder callables."""

    def __init__(self, name, labels_builder=None, elements_builder=None):
        self._name = name
        self._labels_builder = labels_builder
        self._elements_builder = elements_builder
        self._lazy_labels = None
        self._lazy_elements = None

    def _lazy_build_labels(self):
        return list(self._labels_builder())

    def _lazy_build_elements(self):
        return np.asarray(self._elements_builder())

    @property
    def name(self):
        return self._name

    @property
    def labels(self):
        if self._lazy_labels is None:
            self._lazy_labels = self._lazy_build_labels()
        return self._lazy_labels

    @property
    def elements(self):
        if self._lazy_elements is None:
            self._lazy_elements = self._lazy_build_elements()
        return self._lazy_elements

    @property
    def dim(self):
        e = self.elements
        return e.shape[1] * e.shape[2] if e.ndim == 3 else e.shape[1]


def default_basis_for_udims(udims):
    """Default basis spec for per-qudit Hilbert dimensions `udims`: 'pp'
    for qubits, 'gm' otherwise; a TensorProdBasis only for genuinely
    mixed-dimension systems (reference:
    basis.default_basis_for_udims:61)."""
    udim_to_name = {2: 'pp'}
    if all(u == udims[0] for u in udims):
        return udim_to_name.get(udims[0], 'gm')
    return TensorProdBasis([Basis.cast(udim_to_name.get(u, 'gm'), u * u)
                            for u in udims])
