"""Hamiltonian-parameterized gate construction (counterpart of
pygsti_tpu/tools/gatetools.py)."""

from __future__ import annotations

import numpy as np
import scipy.linalg as spl

from pygsti_tpu_torch.tools.optools import unitary_to_pauligate

_SX = np.array([[0, 1], [1, 0]], dtype=complex)
_SY = np.array([[0, -1j], [1j, 0]], dtype=complex)
_SZ = np.diag([1, -1.0]).astype(complex)
_SI = np.eye(2, dtype=complex)


def single_qubit_gate(hx, hy, hz, noise=0):
    """PTM of exp(-i (hx X + hy Y + hz Z)) with optional uniform
    depolarization (reference: gatetools.single_qubit_gate)."""
    ex = -1j * (hx * _SX + hy * _SY + hz * _SZ)
    D = np.diag([1] + [1 - noise] * 3)
    return D @ np.real(unitary_to_pauligate(spl.expm(ex)))


def two_qubit_gate(ix=0, iy=0, iz=0, xi=0, xx=0, xy=0, xz=0, yi=0, yx=0,
                   yy=0, yz=0, zi=0, zx=0, zy=0, zz=0, ii=0):
    """PTM of exp(-i sum h_{ab} sigma_a (x) sigma_b) (counterpart of
    gatetools.two_qubit_gate)."""
    paulis = {'i': _SI, 'x': _SX, 'y': _SY, 'z': _SZ}
    coeffs = dict(ix=ix, iy=iy, iz=iz, xi=xi, xx=xx, xy=xy, xz=xz, yi=yi,
                  yx=yx, yy=yy, yz=yz, zi=zi, zx=zx, zy=zy, zz=zz, ii=ii)
    H = np.zeros((4, 4), dtype=complex)
    for name, c in coeffs.items():
        if c:
            H = H + c * np.kron(paulis[name[0]], paulis[name[1]])
    return np.real(unitary_to_pauligate(spl.expm(-1j * H)))
