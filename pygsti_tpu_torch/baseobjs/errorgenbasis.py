"""Bases of elementary error generators, host numpy (counterpart of
pygsti_tpu/baseobjs/errorgenbasis.py): a basis is a list of elementary
error-generator labels, and gives their superoperators and duals."""

from __future__ import annotations

import itertools

import numpy as np

from pygsti_tpu_torch.baseobjs.errorgenlabel import (GlobalElementaryErrorgenLabel,
                                               LocalElementaryErrorgenLabel)


class ElementaryErrorgenBasis(object):
    """Base: a list of elementary errorgen labels spanning an errorgen
    subspace (reference: errorgenbasis.ElementaryErrorgenBasis)."""

    @property
    def labels(self):
        raise NotImplementedError()

    def __len__(self):
        return len(self.labels)

    def label_index(self, label, ok_if_missing=False):
        try:
            return self._index[label]
        except KeyError:
            if ok_if_missing:
                return None
            raise

    def label_indices(self, labels, ok_if_missing=False):
        """Indices of several labels at once (reference:
        errorgenbasis.ElementaryErrorgenBasis.label_indices)."""
        return [self.label_index(l, ok_if_missing) for l in labels]


class ExplicitElementaryErrorgenBasis(ElementaryErrorgenBasis):
    """A basis given by an explicit list of labels (reference:
    errorgenbasis.ExplicitElementaryErrorgenBasis)."""

    def __init__(self, state_space, labels, basis_1q=None):
        self.state_space = state_space
        self._labels = tuple(labels)
        self._index = {l: i for i, l in enumerate(self._labels)}
        self.basis_1q = basis_1q

    @property
    def labels(self):
        return self._labels


class CompleteElementaryErrorgenBasis(ElementaryErrorgenBasis):
    """ALL elementary error generators of the given types up to a maximum
    Pauli weight over an n-qubit space (reference:
    errorgenbasis.CompleteElementaryErrorgenBasis)."""

    def __init__(self, basis_1q='PP', state_space=None, elementary_errorgen_types=('H', 'S', 'C', 'A'),
                 max_ham_weight=None, max_other_weight=None, num_qubits=None,
                 sslbls=None):
        if num_qubits is None:
            if state_space is not None:
                num_qubits = getattr(state_space, 'num_qubits', None)
                if num_qubits is None:
                    import math
                    num_qubits = int(round(math.log(state_space.udim, 2)))
            else:
                raise ValueError("Need state_space or num_qubits")
        self.num_qubits = num_qubits
        self.state_space = state_space
        self.sslbls = tuple(sslbls) if sslbls is not None \
            else tuple(range(num_qubits))
        self.elementary_errorgen_types = tuple(elementary_errorgen_types)
        self._max_w = {'H': max_ham_weight, 'S': max_other_weight,
                       'C': max_other_weight, 'A': max_other_weight}
        self._labels = tuple(self._enumerate())
        self._index = {l: i for i, l in enumerate(self._labels)}

    def _paulis(self, max_weight):
        n = self.num_qubits
        out = []
        for combo in itertools.product('IXYZ', repeat=n):
            s = ''.join(combo)
            w = sum(1 for ch in s if ch != 'I')
            if w == 0 or (max_weight is not None and w > max_weight):
                continue
            out.append(s)
        return out

    def _enumerate(self):
        labels = []
        for typ in self.elementary_errorgen_types:
            ps = self._paulis(self._max_w[typ])
            if typ in ('H', 'S'):
                labels.extend(LocalElementaryErrorgenLabel(typ, (p,))
                              for p in ps)
            else:
                for i, p in enumerate(ps):
                    for q in ps[i + 1:]:
                        labels.append(LocalElementaryErrorgenLabel(typ, (p, q)))
        return labels

    @property
    def labels(self):
        return self._labels

    def global_labels(self):
        return [GlobalElementaryErrorgenLabel.cast(l, self.sslbls)
                for l in self._labels]

    @staticmethod
    def _pauli_mat(s, normalized=True):
        sigma = {'I': np.eye(2), 'X': np.array([[0, 1], [1, 0]], complex),
                 'Y': np.array([[0, -1j], [1j, 0]]), 'Z': np.diag([1, -1.0])}
        m = np.array([[1.0]], complex)
        for ch in s:
            m = np.kron(m, sigma[ch])
        if normalized:  # Frobenius-normalized, matching Basis.cast('pp', .)
            m = m / np.sqrt(2.0 ** len(s))
        return m

    def elemgen_matrices(self, mx_basis='pp'):
        """Dense superoperator for each label, in `mx_basis`; built from
        NORMALIZED Pauli products, matching the reference's
        CompleteElementaryErrorgenBasis / op errorgen-coefficient
        convention (std-basis generators from lindbladtools, converted)."""
        from pygsti_tpu_torch.tools import lindbladtools as _lt
        from pygsti_tpu_torch.tools.basistools import change_basis
        out = []
        for lbl in self._labels:
            bels = [self._pauli_mat(b) for b in lbl.basis_element_labels]
            g = _lt.create_elementary_errorgen(lbl.errorgen_type, *bels)
            out.append(np.real_if_close(change_basis(g, 'std', mx_basis)))
        return out

    def elemgen_dual_matrices(self, mx_basis='pp'):
        """Dual superoperators <dual_i, gen_j> = delta_ij, in `mx_basis`."""
        from pygsti_tpu_torch.tools import lindbladtools as _lt
        from pygsti_tpu_torch.tools.basistools import change_basis
        out = []
        for lbl in self._labels:
            bels = [self._pauli_mat(b) for b in lbl.basis_element_labels]
            g = _lt.create_elementary_errorgen_dual(lbl.errorgen_type, *bels)
            out.append(change_basis(g, 'std', mx_basis))
        return out

    def create_subbasis(self, sslbl_overlap):
        """Sub-basis of labels whose support overlaps `sslbl_overlap`."""
        keep = []
        want = set(self.sslbls.index(s) if s in self.sslbls else s
                   for s in sslbl_overlap)
        for l in self._labels:
            if set(l.support_indices()) & want:
                keep.append(l)
        return ExplicitElementaryErrorgenBasis(self.state_space, keep)


def union_basis(basis_a, basis_b):
    """Union of two elementary-errorgen bases, preserving basis_a's label
    order (reference: errorgenbasis .union methods)."""
    labels = list(basis_a.labels)
    seen = set(labels)
    labels.extend(l for l in basis_b.labels if l not in seen)
    return ExplicitElementaryErrorgenBasis(
        getattr(basis_a, 'state_space', None), labels)


def intersection_basis(basis_a, basis_b):
    """Labels common to both bases, in basis_a's order."""
    other = set(basis_b.labels)
    return ExplicitElementaryErrorgenBasis(
        getattr(basis_a, 'state_space', None),
        [l for l in basis_a.labels if l in other])


def difference_basis(basis_a, basis_b):
    """Labels of basis_a not in basis_b, in basis_a's order."""
    other = set(basis_b.labels)
    return ExplicitElementaryErrorgenBasis(
        getattr(basis_a, 'state_space', None),
        [l for l in basis_a.labels if l not in other])
