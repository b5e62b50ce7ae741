"""Gauge groups: parameterized families of gauge transformations
(counterpart of pygsti_tpu/models/gaugegroup.py), the operator-parameterized,
U(1) and direct-sum unitary groups included.

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

    def unitary(self, v):
        """The Hilbert-space unitary of parameters v (torch, complex)."""
        return self._unitary_and_matrix(v)[0]

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


class OpGaugeGroupElement(GaugeGroupElement):
    """An element whose transform matrix is an operation's dense matrix."""

    def __init__(self, operation):
        self.operation = operation
        super().__init__(operation.dense())

    def to_vector(self):
        return self.operation.to_vector()

    @property
    def num_params(self):
        return self.operation.num_params


class OpGaugeGroup(GaugeGroup):
    """The gauge group parameterized as an operation is: S = the
    operation's dense matrix at parameters v."""

    def __init__(self, operation, elementcls=OpGaugeGroupElement, name="Op gauge group"):
        self._operation = operation
        self._element_cls = elementcls
        self.name = name
        super().__init__(operation.dim)

    @property
    def num_params(self):
        return self._operation.num_params

    def initial_params(self):
        return self._operation.to_vector()

    def element_matrix(self, v):
        return self._operation.to_dense(v)

    def compute_element(self, v):
        op = self._operation.copy()
        op.from_vector(np.asarray(v, dtype=float))
        return self._element_cls(op)


class OpGaugeGroupWithBasis(OpGaugeGroup):
    """An OpGaugeGroup that carries its operation's matrix basis."""

    def __init__(self, operation, elementcls=OpGaugeGroupElement, name="Op gauge group",
                 basis='pp'):
        self.basis = basis
        super().__init__(operation, elementcls, name)


class U1GroupElement(GaugeGroupElement):
    """An element of U(1): the 1 x 1 matrix e^{i angle}."""

    def __init__(self, angle=0.0):
        self._angle = float(angle) % (2 * np.pi)

    @property
    def num_params(self):
        return 1

    @property
    def transform_matrix(self):
        return np.array([[np.exp(1j * self._angle)]])

    @property
    def transform_matrix_inverse(self):
        return self.transform_matrix.conj()

    @property
    def unitary(self):
        return self.transform_matrix

    def from_vector(self, v):
        self._angle = float(np.asarray(v).item()) % (2 * np.pi)

    def to_vector(self):
        return np.array([self._angle])


class U1Group(GaugeGroup):
    """The complex unit circle as a 1-parameter group on a 1-dimensional
    Hilbert space (a summand of a DirectSumUnitaryGroup)."""

    name = "U(1); the complex unit circle"

    def __init__(self):
        super().__init__(1)

    @property
    def num_params(self):
        return 1

    def initial_params(self):
        return np.zeros(1)

    def unitary(self, v):
        return torch.exp(1j * v[:1])[None, :]

    def element_matrix(self, v):
        """The 1 x 1 complex matrix e^{i v}."""
        return self.unitary(v)

    def compute_element(self, v):
        return U1GroupElement(np.asarray(v).item())


def _udim(group):
    """Hilbert dimension of a summand group: sqrt of its superoperator
    dimension (1 for U(1))."""
    return int(round(np.sqrt(group.dim)))


def _normalize_level_partition(level_partition, expected_block_sizes, udim):
    """A direct sum's level partition checked and made tuples: one tuple of
    standard-basis levels per summand, together a permutation of
    range(udim).  None is the contiguous block-diagonal layout."""
    if level_partition is None:
        return None
    blocks = tuple(tuple(int(x) for x in block) for block in level_partition)
    if len(blocks) != len(expected_block_sizes):
        raise ValueError("level_partition has %d blocks but there are %d summands"
                         % (len(blocks), len(expected_block_sizes)))
    if any(len(blk) != sz for blk, sz in zip(blocks, expected_block_sizes)):
        raise ValueError("level_partition block sizes disagree with the summand dimensions")
    if sorted(x for blk in blocks for x in blk) != list(range(udim)):
        raise ValueError("level_partition levels must be a permutation of range(%d)" % udim)
    return blocks


def _level_permutation(level_partition, udim):
    """P with P[level, i] = 1 for the i-th level of the partition's blocks in
    order: the block-diagonal unitary u goes to P u P^T."""
    perm = np.zeros((udim, udim))
    for i, lvl in enumerate(lvl for blk in level_partition for lvl in blk):
        perm[lvl, i] = 1.0
    return perm


class DirectSumUnitaryGroupElement(GaugeGroupElement):
    """A block-diagonal unitary (up to a permutation of the levels) on a
    direct-sum Hilbert space, as a superoperator in `basis`."""

    def __init__(self, subelements, basis, level_partition=None):
        import scipy.linalg
        from pygsti_tpu_torch.tools.optools import unitary_to_superop
        self.subelements = tuple(subelements)
        self.basis = basis
        blocks = []
        for se in self.subelements:
            u = getattr(se, 'unitary', None)
            if u is not None:
                blocks.append(np.asarray(u))
            else:   # a trivial element: its superoperator dim is udim**2
                blocks.append(np.eye(int(round(np.sqrt(se.transform_matrix.shape[0])))))
        u = scipy.linalg.block_diag(*blocks)
        udim = u.shape[0]
        self.level_partition = _normalize_level_partition(
            level_partition, [b.shape[0] for b in blocks], udim)
        if self.level_partition is not None:
            perm = _level_permutation(self.level_partition, udim)
            u = perm @ u @ perm.T
        m = unitary_to_superop(u, Basis.cast(basis, udim ** 2))
        if np.linalg.norm(m.imag) < 1e-12:
            m = m.real
        self._unitary_total = u
        super().__init__(np.asarray(m))

    @property
    def num_params(self):
        return int(sum(getattr(se, 'num_params', 0) for se in self.subelements))


class DirectSumUnitaryGroup(GaugeGroup):
    """Unitaries that keep a direct-sum structure of the Hilbert space:
    block-diagonal in the summands (U(1), unitary or trivial groups),
    optionally on interleaved levels (`level_partition`).  The summands'
    parameters follow one another."""

    name = "Direct sum gauge group"

    def __init__(self, subgroups, basis, level_partition=None, name="Direct sum gauge group"):
        self.subgroups = tuple(subgroups)
        udims = [_udim(sg) for sg in self.subgroups]
        udim = sum(udims)
        self.basis = Basis.cast(basis, udim ** 2)
        if self.basis.dim != udim ** 2:
            raise ValueError("basis.dim inconsistent with the direct-sum Hilbert space dimension")
        self.name = name
        self.level_partition = _normalize_level_partition(level_partition, udims, udim)
        self._param_dims = [sg.num_params for sg in self.subgroups]
        super().__init__(udim ** 2)
        self._udims = udims
        perm = np.eye(udim) if self.level_partition is None \
            else _level_permutation(self.level_partition, udim)
        M = np.asarray(self.basis.create_transform_matrix('std'))
        self._host = (perm, np.linalg.inv(M), M)
        self._consts = {}

    @property
    def num_params(self):
        return int(sum(self._param_dims))

    def initial_params(self):
        return np.concatenate([np.asarray(sg.initial_params(), dtype=float)
                               for sg in self.subgroups]) if self.subgroups else np.empty(0)

    def element_matrix(self, v):
        """Re(std2basis kron(u, u*) basis2std), u = P blockdiag(u_k) P^T with
        each summand's unitary u_k of its slice of v (the identity for a
        trivial summand)."""
        cdt = torch.complex128 if v.dtype == torch.float64 else torch.complex64
        key = (str(v.device), cdt)
        if key not in self._consts:
            self._consts[key] = tuple(torch.as_tensor(a, dtype=cdt, device=v.device)
                                      for a in self._host)
        perm, std2basis, basis2std = self._consts[key]
        blocks, off = [], 0
        for pd, ud, sg in zip(self._param_dims, self._udims, self.subgroups):
            if hasattr(sg, 'unitary'):
                blocks.append(sg.unitary(v[off:off + pd]).to(cdt))
            else:
                blocks.append(torch.eye(ud, dtype=cdt, device=v.device))
            off += pd
        u = perm @ torch.block_diag(*blocks) @ perm.T
        return torch.real(std2basis @ torch.kron(u, u.conj()) @ basis2std)

    def compute_element(self, v):
        v = np.asarray(v, dtype=float)
        if v.size != self.num_params:
            raise ValueError("%d parameters given, the group has %d" % (v.size, self.num_params))
        subelements, offset = [], 0
        for pd, sg in zip(self._param_dims, self.subgroups):
            subelements.append(sg.compute_element(v[offset:offset + pd]))
            offset += pd
        return DirectSumUnitaryGroupElement(subelements, self.basis, self.level_partition)


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
