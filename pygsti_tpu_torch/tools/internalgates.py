"""Unitaries of the standard gates the port's model packs use (counterpart of
pygsti_tpu/tools/internalgates.py: standard_gatename_unitaries)."""

from __future__ import annotations

import functools

import numpy as np
import scipy.linalg as spl

sigmaX = np.array([[0, 1], [1, 0]], dtype=complex)
sigmaY = np.array([[0, -1j], [1j, 0]], dtype=complex)


def _rot(generator, theta):
    """exp(-i * theta/2 * generator)."""
    return spl.expm(-1j * (theta / 2.0) * generator)


@functools.lru_cache(maxsize=1)
def standard_gatename_unitaries():
    """Dict of gate name -> unitary for Gi, Gxpi2, Gypi2 and Gcnot."""
    return {
        'Gi': np.eye(2, dtype=complex),
        'Gxpi2': _rot(sigmaX, np.pi / 2),
        'Gypi2': _rot(sigmaY, np.pi / 2),
        'Gcnot': np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                           [0, 0, 0, 1], [0, 0, 1, 0]], dtype=complex),
    }
