"""Gauge groups: parameterized families of gauge transformations
(counterpart of pygsti_tpu/models/gaugegroup.py; the operator-parameterized,
U(1) and direct-sum groups wait for the leakage modules).

A gauge transformation S acts as: rho -> Sinv rho,  E -> E S,  G -> Sinv G S.
Each group provides a pure torch map ``element_matrix(v)``: params -> S on
``v``'s device and dtype (so gauge optimization differentiates through it),
plus element construction on the host.  A group is built from the model's
superoperator dimension (an int, or anything with a ``dim``).
"""

from __future__ import annotations

import numpy as np
import torch

from pygsti_tpu_torch.baseobjs.basis import Basis


class GaugeGroupElement(object):
    """A concrete gauge transformation (host numpy matrices)."""

    def __init__(self, matrix, inverse=None):
        self._mx = np.asarray(matrix)
        self._inv = np.asarray(inverse) if inverse is not None else np.linalg.inv(self._mx)

    @property
    def transform_matrix(self):
        return self._mx

    @property
    def transform_matrix_inverse(self):
        return self._inv

    def inverse(self):
        """An element representing this element's inverse action."""
        return InverseGaugeGroupElement(self)


class InverseGaugeGroupElement(GaugeGroupElement):
    """The inverse action of another gauge group element."""

    def __init__(self, gauge_group_el):
        self.inverse_element = gauge_group_el

    @property
    def transform_matrix(self):
        return self.inverse_element.transform_matrix_inverse

    @property
    def transform_matrix_inverse(self):
        return self.inverse_element.transform_matrix

    def inverse(self):
        return self.inverse_element


class TrivialGaugeGroupElement(GaugeGroupElement):
    """Identity gauge transformation of the given dimension."""

    def __init__(self, dim):
        eye = np.identity(dim, 'd')
        super().__init__(eye, eye)


class FullGaugeGroupElement(GaugeGroupElement):
    pass


class TPGaugeGroupElement(GaugeGroupElement):
    pass


class DiagGaugeGroupElement(GaugeGroupElement):
    pass


class TPDiagGaugeGroupElement(GaugeGroupElement):
    pass


class UnitaryGaugeGroupElement(GaugeGroupElement):
    """Superoperator of a unitary; keeps the Hilbert-space unitary."""

    def __init__(self, matrix, inverse=None, unitary=None, basis=None):
        super().__init__(matrix, inverse)
        self.unitary = None if unitary is None else np.asarray(unitary)
        self.basis = basis


class SpamGaugeGroupElement(GaugeGroupElement):
    pass


class TPSpamGaugeGroupElement(GaugeGroupElement):
    pass


class GaugeGroup(object):
    """Base gauge group."""

    name = "Base"
    element_cls = GaugeGroupElement

    def __init__(self, state_space):
        self.dim = int(getattr(state_space, 'dim', state_space))

    @property
    def num_params(self):
        raise NotImplementedError()

    def initial_params(self):
        raise NotImplementedError()

    def element_matrix(self, v):
        """Pure torch: params tensor -> transform matrix S on v's device."""
        raise NotImplementedError()

    def compute_element(self, v):
        v = torch.as_tensor(np.asarray(v, dtype=float))
        return self.element_cls(self.element_matrix(v).numpy())


class TrivialGaugeGroup(GaugeGroup):
    name = "Trivial"

    @property
    def num_params(self):
        return 0

    def initial_params(self):
        return np.empty(0)

    def element_matrix(self, v):
        return torch.eye(self.dim, dtype=v.dtype, device=v.device)

    def compute_element(self, v):
        return TrivialGaugeGroupElement(self.dim)


class FullGaugeGroup(GaugeGroup):
    """All invertible matrices (d^2 params)."""

    name = "Full"
    element_cls = FullGaugeGroupElement

    @property
    def num_params(self):
        return self.dim ** 2

    def initial_params(self):
        return np.eye(self.dim).reshape(-1)

    def element_matrix(self, v):
        return v.reshape(self.dim, self.dim)


class TPGaugeGroup(GaugeGroup):
    """TP-preserving transforms: first row fixed to e0."""

    name = "TP"
    element_cls = TPGaugeGroupElement

    @property
    def num_params(self):
        return self.dim * (self.dim - 1)

    def initial_params(self):
        return np.eye(self.dim)[1:, :].reshape(-1)

    def element_matrix(self, v):
        d = self.dim
        first = torch.zeros((1, d), dtype=v.dtype, device=v.device)
        first[0, 0] = 1.0
        return torch.cat([first, v.reshape(d - 1, d)], dim=0)


class DiagGaugeGroup(GaugeGroup):
    """Diagonal transforms (d params)."""

    name = "Diag"
    element_cls = DiagGaugeGroupElement

    @property
    def num_params(self):
        return self.dim

    def initial_params(self):
        return np.ones(self.dim)

    def element_matrix(self, v):
        return torch.diag(v)


class TPDiagGaugeGroup(GaugeGroup):
    """Diagonal TP transforms: first diag element fixed at 1."""

    name = "TP Diag"
    element_cls = TPDiagGaugeGroupElement

    @property
    def num_params(self):
        return self.dim - 1

    def initial_params(self):
        return np.ones(self.dim - 1)

    def element_matrix(self, v):
        return torch.diag(torch.cat([torch.ones(1, dtype=v.dtype, device=v.device), v]))


class UnitaryGaugeGroup(GaugeGroup):
    """Superoperators of unitaries: S = superop(U(H)), H Hermitian on the
    udim-dimensional Hilbert space, U the Cayley transform of H."""

    name = "Unitary"

    def __init__(self, state_space, basis='pp'):
        super().__init__(state_space)
        self.basis = Basis.cast(basis, self.dim)
        self.udim = self.basis.matrix_dim
        M = self.basis.create_transform_matrix('std')
        self._std2basis = np.linalg.inv(M)
        self._basis2std = np.asarray(M)
        self._consts = {}     # (device, complex dtype) -> the two as tensors

    @property
    def num_params(self):
        return self.udim ** 2

    def initial_params(self):
        return np.zeros(self.udim ** 2)

    def _unitary_and_matrix(self, v):
        from pygsti_tpu_torch.modelmembers.operations import _real_params_to_hermitian
        h = _real_params_to_hermitian(v, self.udim)
        key = (str(h.device), h.dtype)
        if key not in self._consts:
            self._consts[key] = tuple(torch.as_tensor(a, dtype=h.dtype, device=h.device)
                                      for a in (self._std2basis, self._basis2std))
        std2basis, basis2std = self._consts[key]
        # Cayley transform U = (I + iH/2)^{-1} (I - iH/2): exactly unitary,
        # equal to expm(-iH) + O(H^3), and covers the group near the
        # identity -- the JAX package's parameterization, kept so that one
        # parameter vector means one element in both packages.
        eye = torch.eye(self.udim, dtype=h.dtype, device=h.device)
        u = torch.linalg.solve(eye + 0.5j * h, eye - 0.5j * h)
        s_std = torch.kron(u, u.conj())
        return u, torch.real(std2basis @ s_std @ basis2std)

    def element_matrix(self, v):
        return self._unitary_and_matrix(v)[1]

    def compute_element(self, v):
        v = torch.as_tensor(np.asarray(v, dtype=float))
        u, mx = self._unitary_and_matrix(v)
        return UnitaryGaugeGroupElement(mx.numpy(), unitary=u.numpy(), basis=self.basis)


class SpamGaugeGroup(GaugeGroup):
    """2-parameter group scaling the identity component and the rest of the
    space separately: S = diag(a, b, b, ..., b)."""

    name = "Spam"
    element_cls = SpamGaugeGroupElement

    @property
    def num_params(self):
        return 2

    def initial_params(self):
        return np.ones(2)

    def element_matrix(self, v):
        return torch.diag(torch.cat([v[0:1], v[1].expand(self.dim - 1)]))


class TPSpamGaugeGroup(GaugeGroup):
    """1-parameter TP version of SpamGaugeGroup: S = diag(1, b, ..., b)."""

    name = "TP Spam"
    element_cls = TPSpamGaugeGroupElement

    @property
    def num_params(self):
        return 1

    def initial_params(self):
        return np.ones(1)

    def element_matrix(self, v):
        one = torch.ones(1, dtype=v.dtype, device=v.device)
        return torch.diag(torch.cat([one, v[0].expand(self.dim - 1)]))


def default_gauge_group_for_model(model):
    """The natural gauge group for a model's parameterization."""
    t = getattr(model, 'default_gate_type', 'full')
    if t in ('full', 'full arbitrary'):
        return FullGaugeGroup(model.dim)
    if t in ('full TP', 'TP'):
        return TPGaugeGroup(model.dim)
    if t in ('static',):
        return TrivialGaugeGroup(model.dim)
    if t in ('CPTP', 'CPTPLND', 'GLND', 'H+S', 'H+s', 'H'):
        return UnitaryGaugeGroup(model.dim, model.basis)
    return FullGaugeGroup(model.dim)
