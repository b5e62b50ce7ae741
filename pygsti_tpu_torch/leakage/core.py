"""Computational-subspace machinery for leakage modeling, host numpy
(counterpart of pygsti_tpu/leakage/core.py).

A basis "implies leakage modeling" when its labels distinguish computational
('C[...]') from leakage ('L[...]') subspace elements.  The functions here
extract the computational effect/projector from such a basis, build an
orthonormal superket basis for the computational operator subspace M[C],
and augment an ordinary basis into a leakage-aware one.
"""

from __future__ import annotations

import re

import numpy as np
import scipy.linalg as la

from pygsti_tpu_torch.baseobjs.basis import Basis, ExplicitBasis
from pygsti_tpu_torch.tools import basistools as bt
from pygsti_tpu_torch.tools import matrixtools as mt

_EYE_LABEL_REGEX = re.compile(r'^(?:I|C\[I+\])+$')


def _eye_label(basis):
    """The label of the (computational-)identity element of `basis`: the
    all-'I' or 'C[I..I]' label with the most I's (reference:
    basis._eye_label:92)."""
    candidates = [ell for ell in basis.labels
                  if _EYE_LABEL_REGEX.match(str(ell))]
    if not candidates:
        return ''
    return max(candidates, key=lambda ell: (ell.count('I'), len(ell)))


def computational_effect(basis):
    """The computational effect of `basis`: the orthogonal projector onto
    the computational subspace C, recovered from the basis element carrying
    the identity-like label (reference: leakage.core.computational_effect:
    97)."""
    basis = Basis.cast(basis) if isinstance(basis, str) else basis
    label = _eye_label(basis)
    labels = list(basis.labels)
    if label not in labels:
        raise ValueError("basis %s has no identity-like element" % basis)
    E = np.array(basis.elements[labels.index(label)])
    try:
        E = mt.induced_projector(E, tol=1e-10, require_real=True)
    except ValueError as e:
        raise ValueError("basis %s does not support leakage modeling"
                         % basis) from e
    return E


def computational_superkets(basis):
    """Matrix U whose columns are an orthonormal superket basis for M[C],
    the operators supported on the computational subspace: project every
    basis element by E . E, vectorize, and orthonormalize the frame by
    pivoted QR (reference: leakage.core.computational_superkets:124).
    Identity when `basis` does not imply leakage modeling."""
    basis = Basis.cast(basis) if isinstance(basis, str) else basis
    if not basis.implies_leakage_modeling():
        return np.eye(basis.dim)
    E = computational_effect(basis)
    k = int(np.linalg.matrix_rank(E))
    if not mt.is_projector(E):
        raise ValueError("The computational effect of basis %s is not an "
                         "orthogonal projector" % basis)
    proj_elements = [E @ np.asarray(B) @ E for B in basis.elements]
    frame = np.column_stack([np.asarray(bt.stdmx_to_vec(pB, basis)).reshape(-1)
                             for pB in proj_elements]).real
    U_full = la.qr(frame, pivoting=True)[0]
    return U_full[:, :k ** 2]


def computational_projector(basis):
    """The superoperator P = U U^T orthogonally projecting M[H] onto M[C]
    (reference: leakage.core.computational_projector:162)."""
    U = computational_superkets(basis)
    return U @ U.T


def augment_for_leakage_modeling(b_in, E):
    """A leakage-aware version of `b_in` whose first rank(E)^2 elements span
    M[C] (labels 'C[...]', first is E) and whose remaining elements span the
    complement (labels 'L[...]', last is the complement projector)
    (reference: leakage.core.augment_for_leakage_modeling:171)."""
    b_in = Basis.cast(b_in) if isinstance(b_in, str) else b_in
    E = np.asarray(E)
    if la.norm(np.imag(E)) > 1e-10:
        raise ValueError("E must be real")
    mt.assert_hermitian(E, tol=1e-10)
    E = np.real(E)
    E = (E + E.T) / 2
    k = int(np.linalg.matrix_rank(E))
    E = E * (k / np.trace(E))
    if not mt.is_projector(E):
        raise ValueError("E must be (proportional to) a projector")

    num_I = max(_eye_label(b_in).count('I'), 1)
    I_lbl = 'C[' + 'I' * num_I + ']'
    L_lbl = 'L[' + 'I' * num_I + ']'
    b_labels = list(b_in.labels)

    # computational-subspace elements: E B E, then pivoted-QR select the
    # k^2 - 1 most E-supported ones after deflating E itself
    cs_elements = [(E @ np.asarray(B) @ E) for B in b_in.elements]
    cs_elements = [(B + B.T.conj()) / 2 for B in cs_elements]
    p = mt.pivot_indices_after_deflation(
        E.ravel().reshape(-1, 1),
        np.column_stack([B.ravel() for B in cs_elements]))[:k ** 2 - 1]
    cs_sel = [E] + [cs_elements[i] for i in p]
    cs_lbl = [I_lbl] + ['C[%s]' % b_labels[i] for i in p]

    # complement elements: B - E B E, select dim - k^2 - 1 after deflating
    # the complement projector
    E_comp = np.eye(E.shape[0]) - E
    oc_elements = [np.asarray(B) - E @ np.asarray(B) @ E
                   for B in b_in.elements]
    oc_elements = [(B + B.T.conj()) / 2 for B in oc_elements]
    p = mt.pivot_indices_after_deflation(
        E_comp.ravel().reshape(-1, 1),
        np.column_stack([B.ravel() for B in oc_elements]))[
            :b_in.dim - k ** 2 - 1]
    oc_sel = [oc_elements[i] for i in p] + [E_comp]
    oc_lbl = ['L[%s]' % b_labels[i] for i in p] + [L_lbl]

    elements = np.array(cs_sel + oc_sel)
    for element in elements:
        element /= la.norm(element)
        element[:] = element.round(decimals=16)
    out = ExplicitBasis(elements, cs_lbl + oc_lbl,
                        name='Leakage augmented ' + b_in.name)
    assert out.implies_leakage_modeling()
    return out
