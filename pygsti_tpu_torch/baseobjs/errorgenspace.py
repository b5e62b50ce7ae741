"""Error-generator subspaces, host numpy (counterpart of
pygsti_tpu/baseobjs/errorgenspace.py).

An ErrorgenSpace is a linear subspace of error-generator space: a matrix of
column vectors expressed in an elementary-errorgen basis.
"""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.tools import matrixtools as _mt


class ErrorgenSpace(object):
    """A subspace of errorgen space: `vectors` [dim_of_basis, n_vectors]
    over `basis` (an ElementaryErrorgenBasis) (reference:
    errorgenspace.ErrorgenSpace)."""

    def __init__(self, vectors, basis):
        self.vectors = np.asarray(vectors)
        self.elemgen_basis = basis

    def intersection(self, other_space, free_on_unspecified_space=False,
                     use_nice_nullspace=False):
        """Intersection of this space with another (reference:
        errorgenspace.ErrorgenSpace.intersection).

        free_on_unspecified_space: treat each space as unconstrained
        (identity) on elementary generators absent from its basis -- used
        when intersecting per-op gauge spaces whose bases may differ.
        """
        from pygsti_tpu_torch.baseobjs.errorgenbasis import union_basis, \
            difference_basis, intersection_basis
        dtype = self.vectors.dtype

        if free_on_unspecified_space:
            common_basis = union_basis(self.elemgen_basis,
                                       other_space.elemgen_basis)
            diff_self = difference_basis(common_basis, self.elemgen_basis)
            diff_other = difference_basis(common_basis,
                                          other_space.elemgen_basis)
            Vl, Vli = self.vectors.shape[1], len(diff_self)
            Wl, Wli = other_space.vectors.shape[1], len(diff_other)
            # [ V I | W I ]: identity fill-in on rows each basis is missing
            i = 0
            VIWI = np.zeros((len(common_basis), Vl + Vli + Wl + Wli), dtype)
            VIWI[common_basis.label_indices(self.elemgen_basis.labels),
                 0:Vl] = self.vectors[:, :]
            i += Vl
            VIWI[common_basis.label_indices(diff_self.labels),
                 i:i + Vli] = np.identity(Vli, dtype)
            i += Vli
            VIWI[common_basis.label_indices(other_space.elemgen_basis.labels),
                 i:i + Wl] = other_space.vectors[:, :]
            i += Wl
            VIWI[common_basis.label_indices(diff_other.labels),
                 i:i + Wli] = np.identity(Wli, dtype)
            ns = _mt.nice_nullspace(VIWI) if use_nice_nullspace \
                else _mt.nullspace(VIWI)
            intersection_vecs = VIWI[:, 0:(Vl + Vli)] @ ns[0:(Vl + Vli), :]
        else:
            common_basis = intersection_basis(self.elemgen_basis,
                                              other_space.elemgen_basis)
            Vl, Wl = self.vectors.shape[1], other_space.vectors.shape[1]
            VW = np.zeros((len(common_basis), Vl + Wl), dtype)
            VW[:, 0:Vl] = self.vectors[
                self.elemgen_basis.label_indices(common_basis.labels), :]
            VW[:, Vl:] = other_space.vectors[
                other_space.elemgen_basis.label_indices(common_basis.labels), :]
            ns = _mt.nullspace(VW)
            intersection_vecs = VW[:, 0:Vl] @ ns[0:Vl, :]

        return ErrorgenSpace(intersection_vecs, common_basis)

    def union(self, other_space):
        """The span of the union of the two spaces (same basis required)."""
        if tuple(self.elemgen_basis.labels) != tuple(other_space.elemgen_basis.labels):
            raise ValueError("union needs two spaces over the same basis")
        stacked = np.concatenate([self.vectors, other_space.vectors], axis=1)
        return ErrorgenSpace(stacked[:, _mt.independent_columns(stacked)],
                             self.elemgen_basis)

    def normalize(self, norm_order=2):
        """Normalize spanning vectors in place, sign-fixed so the largest
        element is positive (reference: ErrorgenSpace.normalize)."""
        for j in range(self.vectors.shape[1]):
            sign = +1 if max(self.vectors[:, j]) >= -min(self.vectors[:, j]) \
                else -1
            self.vectors[:, j] /= sign * np.linalg.norm(self.vectors[:, j],
                                                        ord=norm_order)
        return self

    def __eq__(self, other):
        if not isinstance(other, ErrorgenSpace):
            return False
        return (np.allclose(self.vectors, other.vectors)
                and tuple(self.elemgen_basis.labels)
                == tuple(other.elemgen_basis.labels))
