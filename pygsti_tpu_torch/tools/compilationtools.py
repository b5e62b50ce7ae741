"""ZXZXZ angle helpers of the random-circuit samplers (reference:
pygsti/tools/compilationtools.py)."""

import numpy as _np


def mod_2pi(theta):
    """Map angle into (-pi, pi] (reference: random_compilation.py:465)."""
    while theta > _np.pi:
        theta -= 2 * _np.pi
    while theta <= -_np.pi:
        theta += 2 * _np.pi
    return theta


def pauli_frame_randomize_unitary(theta1, theta2, theta3, net_pauli,
                                  recomp_pauli):
    """ZXZXZ angles for the Pauli-frame-randomized version of the unitary
    with ZXZXZ angles (theta1, theta2, theta3): conjugate away `net_pauli`
    (0=I,1=X,2=Y,3=Z) and recompile `recomp_pauli` into the Z rotations
    (reference: compilationtools.py:26)."""
    if net_pauli in (1, 3):     # X or Z commuting through flips theta2
        theta2 = -theta2
    if net_pauli in (1, 2):     # X or Y flips the outer Z rotations
        theta1, theta3 = -theta1, -theta3
    if recomp_pauli in (1, 2):  # absorb an X (or the X part of Y)
        theta1 = -theta1 + _np.pi
        theta2 = theta2 + _np.pi
    if recomp_pauli in (2, 3):  # absorb a Z (or the Z part of Y)
        theta1 = theta1 + _np.pi
    return (mod_2pi(theta1), mod_2pi(theta2), mod_2pi(theta3))


def inv_recompile_unitary(theta1, theta2, theta3):
    """ZXZXZ angles of the inverse of the unitary with ZXZXZ angles
    (theta1, theta2, theta3), recompiled so the X(-pi/2) pulses of the naive
    inverse become X(+pi/2) (reference: compilationtools.py:51)."""
    return (mod_2pi(_np.pi - theta1), mod_2pi(-theta2),
            mod_2pi(-theta3 + _np.pi))
