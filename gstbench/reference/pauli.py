"""The Pauli-product ('pp') basis and superoperators on n qubits, in plain
PyTorch.

A density matrix rho on n qubits is the real vector v_k = Tr(B_k rho) over
the basis B_k = P_k / sqrt(2^n), P_k the Pauli products in the order
itertools.product('IXYZ', repeat=n), qubit 0 the leftmost letter and the
most significant tensor factor (pyGSTi's 'pp' basis).  A map Phi on density
matrices is the real matrix S[k, l] = Tr(B_k Phi(B_l)).
"""

from __future__ import annotations

import functools
import itertools
import math

import torch

_PAULI = {'I': ((1, 0), (0, 1)), 'X': ((0, 1), (1, 0)),
          'Y': ((0, -1j), (1j, 0)), 'Z': ((1, 0), (0, -1))}


def pauli_labels(n):
    """Every Pauli-product label on n qubits, identity first."""
    return [''.join(t) for t in itertools.product('IXYZ', repeat=n)]


def pauli_matrix(label):
    """The 2^n x 2^n complex matrix of a Pauli-product label."""
    out = torch.ones((1, 1), dtype=torch.complex128)
    for ch in label:
        out = torch.kron(out, torch.tensor(_PAULI[ch], dtype=torch.complex128))
    return out


@functools.lru_cache(maxsize=None)
def _pp_basis(n):
    return torch.stack([pauli_matrix(l) for l in pauli_labels(n)]) / math.sqrt(2 ** n)


def pp_basis(n):
    """[4^n, 2^n, 2^n] complex: the normalized basis B_k = P_k / sqrt(2^n)."""
    return _pp_basis(n).clone()


def superop(phi, n):
    """Real [4^n, 4^n] matrix of the linear map `phi` (which takes a stack
    [m, 2^n, 2^n] of matrices to their images) in the pp basis."""
    B = pp_basis(n)
    images = phi(B)
    return torch.einsum('kab,lba->kl', B, images).real.contiguous()


def state_vector(rho, n):
    """Real [4^n] pp vector of a density (or effect) matrix."""
    return torch.einsum('kab,ba->k', pp_basis(n), rho).real.contiguous()


def embed_unitary(u, targets, n):
    """The 2^n x 2^n unitary acting as `u` on the qubits `targets` (in the
    order u's tensor factors take them) and as the identity elsewhere."""
    k = len(targets)
    rest = [q for q in range(n) if q not in targets]
    full = torch.kron(u, torch.eye(2 ** (n - k), dtype=u.dtype)).reshape([2] * (2 * n))
    order = list(targets) + rest            # the qubit of each tensor axis
    inv = [order.index(q) for q in range(n)]
    return full.permute(inv + [n + i for i in inv]).reshape(2 ** n, 2 ** n)


def unitary_superop(u, n):
    """pp superoperator of rho -> u rho u^dag."""
    return superop(lambda B: u @ B @ u.conj().T, n)


def hamiltonian_generator(label, scale, n):
    """pp superoperator of rho -> -i scale [P, rho] (pyGSTi's elementary
    'H' error generator of the basis element scale * P)."""
    P = pauli_matrix(label)
    return superop(lambda B: -1j * scale * (P @ B - B @ P), n)


def stochastic_generator(label, scale, n):
    """pp superoperator of rho -> scale^2 (P rho P - rho) (pyGSTi's
    elementary 'S' error generator of the basis element scale * P)."""
    P = pauli_matrix(label)
    return superop(lambda B: scale ** 2 * (P @ B @ P - B), n)


# the standard gates' unitaries (pyGSTi's internal gate names)
def gate_unitary(name):
    c, s = math.cos(math.pi / 4), math.sin(math.pi / 4)
    if name == 'Gxpi2':
        return torch.tensor([[c, -1j * s], [-1j * s, c]], dtype=torch.complex128)
    if name == 'Gypi2':
        return torch.tensor([[c, -s], [s, c]], dtype=torch.complex128)
    if name == 'Gcnot':
        return torch.tensor([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
                            dtype=torch.complex128)
    raise KeyError("no unitary for gate %r" % name)


def computational_effects(n):
    """[2^n, 4^n] pp vectors of the projectors |x><x|, x in binary order
    with qubit 0 the leftmost bit."""
    out = []
    for x in range(2 ** n):
        e = torch.zeros((2 ** n, 2 ** n), dtype=torch.complex128)
        e[x, x] = 1
        out.append(state_vector(e, n))
    return torch.stack(out)


def outcome_labels(n):
    return [format(x, '0%db' % n) for x in range(2 ** n)]
