"""Unitaries of the standard gate names (counterpart of
pygsti_tpu/tools/internalgates.py: standard_gatename_unitaries).

Pauli rotations exp(-i theta sigma / 2), the 24 one-qubit Cliffords
Gc0-Gc23 from H/P/X words, and the two-qubit gates the model packs use, with
the JAX package's global-phase conventions, so that every unitary is the same
matrix in both packages.  The continuously parameterized gates Gzr, Gczr
and Gu3 are UnitaryGateFunction instances (callables of their arguments).
Beside the table: the reverse lookup unitary_to_standard_gatename and the
gate-name tables for OpenQASM, qiskit, quil and CHP; the cirq and stim
tables import those packages and raise ImportError without them.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.linalg as spl

from pygsti_tpu_torch.baseobjs.unitarygatefunction import UnitaryGateFunction

sigmaI = np.eye(2, dtype=complex)
sigmaX = np.array([[0, 1], [1, 0]], dtype=complex)
sigmaY = np.array([[0, -1j], [1j, 0]], dtype=complex)
sigmaZ = np.array([[1, 0], [0, -1]], dtype=complex)


def _rot(generator, theta):
    """exp(-i * theta/2 * generator)."""
    return spl.expm(-1j * (theta / 2.0) * generator)


def _phase_canonical(u):
    """u with its global phase fixed: the largest entry of its first row
    made real and positive."""
    row = u[0]
    idx = int(np.argmax(np.abs(row)))
    ph = row[idx] / abs(row[idx]) if abs(row[idx]) > 1e-12 else 1.0
    return u / ph


@functools.lru_cache(maxsize=1)
def standard_gatename_unitaries():
    """Dict of standard gate name -> unitary (complex ndarray)."""
    H = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
    P = np.array([[1, 0], [0, 1j]], dtype=complex)
    Pdag = P.conj().T
    X, Y, Z, I2 = sigmaX, sigmaY, sigmaZ, sigmaI

    u = {'Gi': I2.copy(),
         'Gxpi2': _rot(X, np.pi / 2), 'Gypi2': _rot(Y, np.pi / 2), 'Gzpi2': _rot(Z, np.pi / 2),
         'Gxpi': X.copy(), 'Gypi': Y.copy(), 'Gzpi': Z.copy(),
         'Gxmpi2': _rot(X, -np.pi / 2), 'Gympi2': _rot(Y, -np.pi / 2),
         'Gzmpi2': _rot(Z, -np.pi / 2),
         'Gxpi4': _rot(X, np.pi / 4), 'Gypi4': _rot(Y, np.pi / 4), 'Gzpi4': _rot(Z, np.pi / 4),
         'Gh': H.copy(), 'Gp': P.copy(), 'Gpdag': Pdag.copy(),
         'Gt': np.array([[1, 0], [0, np.exp(1j * np.pi / 4)]], dtype=complex),
         'Gtdag': np.array([[1, 0], [0, np.exp(-1j * np.pi / 4)]], dtype=complex),
         # pi/2 about the (sqrt(3)/2, 0, -1/2) axis
         'Gn': spl.expm(-1j * (np.pi / 4) * ((np.sqrt(3) / 2) * X - 0.5 * Z))}

    # the one-qubit Cliffords, indexed as in the JAX package (up to phase)
    cliff_words = {
        0: [], 1: [H, Pdag], 2: [P, H], 3: [X], 4: [H, Pdag, X], 5: [Pdag, H],
        6: [Y], 7: [H, P, X], 8: [Pdag, X, H], 9: [Z], 10: [H, P],
        11: [P, X, H], 12: [H], 13: [_rot(X, -np.pi / 2)], 14: [P],
        15: [_rot(Y, -np.pi / 2)], 16: [_rot(X, np.pi / 2)], 17: [P, X],
        18: [Y, H], 19: [Pdag, H, P], 20: [Pdag, X], 21: [_rot(Y, np.pi / 2)],
        22: [P, H, Pdag], 23: [Pdag],
    }
    for idx, word in cliff_words.items():
        m = I2.copy()
        for factor in word:
            m = m @ factor
        u['Gc%d' % idx] = _phase_canonical(m)

    u['Gcphase'] = np.diag(np.array([1, 1, 1, -1], dtype=complex))
    u['Gcnot'] = np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                           [0, 0, 0, 1], [0, 0, 1, 0]], dtype=complex)
    u['Gswap'] = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                           [0, 1, 0, 0], [0, 0, 0, 1]], dtype=complex)
    u['Giswap'] = np.array([[1, 0, 0, 0], [0, 0, 1j, 0],
                            [0, 1j, 0, 0], [0, 0, 0, 1]], dtype=complex)
    s2 = 1 / np.sqrt(2)
    u['Gsqrtiswap'] = np.array([[1, 0, 0, 0], [0, s2, 1j * s2, 0],
                                [0, 1j * s2, s2, 0], [0, 0, 0, 1]], dtype=complex)
    u['Gzz'] = _rot(np.kron(Z, Z), np.pi / 2)
    u['Gxx'] = _rot(np.kron(X, X), np.pi / 2)
    u['Gcres'] = _rot(np.kron(X, Z), np.pi / 2)
    # echoed cross-resonance (IX - XY)/sqrt(2); 'Gecr' is its other name
    u['Gecres'] = (np.kron(I2, X) - np.kron(X, Y)) / np.sqrt(2)
    u['Gecr'] = u['Gecres']
    u['Gzr'], u['Gczr'], u['Gu3'] = Gzr(), Gczr(), Gu3()
    u['Gx'], u['Gy'], u['Gz'] = u['Gxpi2'], u['Gypi2'], u['Gzpi2']
    # two-qubit products of one-qubit pi/2 rotations (the condensed packs)
    for nm, (a, b) in {'Gxxpi2': ('Gxpi2', 'Gxpi2'), 'Gyypi2': ('Gypi2', 'Gypi2'),
                       'Gxypi2': ('Gxpi2', 'Gypi2'), 'Gyxpi2': ('Gypi2', 'Gxpi2')}.items():
        u[nm] = np.kron(u[a], u[b])
    return u


def standard_gatenames_unitary_conversions():
    """Alias matching the reference API name."""
    return standard_gatename_unitaries()


def is_gate_this_standard_unitary(gate_unitary, standard_gate_name):
    """True if `gate_unitary` equals the named standard gate up to global phase."""
    std = standard_gatename_unitaries().get(standard_gate_name)
    if std is None or np.shape(gate_unitary) != np.shape(std):
        return False
    inner = np.abs(np.trace(np.asarray(gate_unitary).conj().T @ std))
    return bool(np.isclose(inner, std.shape[0]))


def unitary_from_gatename(name, args=None):
    """Look up (or construct, for parameterized names like 'Gzr') a unitary.

    'Gzr;theta' : rotation exp(-i theta/2 Z);  'Gczr;theta' : controlled version.
    """
    if name == 'Gzr':
        (theta,) = args
        return _rot(sigmaZ, float(theta))
    if name == 'Gczr':
        (theta,) = args
        out = np.eye(4, dtype=complex)
        out[2:, 2:] = _rot(sigmaZ, float(theta))
        return out
    u = standard_gatename_unitaries().get(name)
    if u is None:
        raise KeyError("Unknown standard gate name: %r" % name)
    return u


def standard_gatenames_openqasm_conversions(version='u3'):
    """Map pyGSTi standard gate names to OpenQASM gate names (+ parameter
    formatters for the parameterized ones) (reference:
    internalgates.standard_gatenames_openqasm_conversions).

    Returns (names, param_fns): names maps each standard name to a list of
    QASM gate strings; param_fns maps parameterized names to functions
    emitting the QASM parameter clause."""
    if version == 'u3':
        def u3(theta, phi, lam):
            return ['u3(%.12g, %.12g, %.12g)' % (theta, phi, lam)]
        names = {
            'Gi': u3(0, 0, 0), 'Gxpi2': u3(np.pi / 2, -np.pi / 2, np.pi / 2),
            'Gxmpi2': u3(np.pi / 2, np.pi / 2, -np.pi / 2),
            'Gxpi': ['x'], 'Gypi2': u3(np.pi / 2, 0, 0),
            'Gympi2': u3(np.pi / 2, -np.pi, np.pi), 'Gypi': ['y'],
            'Gzpi2': ['s'], 'Gzmpi2': ['sdg'], 'Gzpi': ['z'],
            'Gh': ['h'], 'Gp': ['s'], 'Gpdag': ['sdg'],
            'Gt': ['t'], 'Gtdag': ['tdg'],
            'Gcnot': ['cx'], 'Gcphase': ['cz'], 'Gswap': ['swap'],
        }
        param_fns = {
            'Gzr': lambda args: 'rz(%.12g)' % float(args[0]),
            'Gczr': lambda args: 'crz(%.12g)' % float(args[0]),
        }
        return names, param_fns
    raise ValueError("Unknown version %r" % version)


def standard_gatenames_chp_conversions():
    """Map (Clifford) standard gate names to CHP program operations
    (reference: internalgates.standard_gatenames_chp_conversions).
    Values are lists of (op, qubit-index-tuple-pattern) CHP lines where
    'h q' / 'p q' / 'c q1 q2' / 'm q' are the CHP primitives."""
    # CHP has h (hadamard), p (phase=S), c (CNOT), m (measure)
    return {
        'Gi': [],
        'Gh': [('h', (0,))],
        'Gp': [('p', (0,))],
        'Gzpi2': [('p', (0,))],
        'Gzmpi2': [('p', (0,)), ('p', (0,)), ('p', (0,))],
        'Gzpi': [('p', (0,)), ('p', (0,))],
        'Gxpi': [('h', (0,)), ('p', (0,)), ('p', (0,)), ('h', (0,))],
        'Gxpi2': [('h', (0,)), ('p', (0,)), ('h', (0,))],
        'Gcnot': [('c', (0, 1))],
        'Gcphase': [('h', (1,)), ('c', (0, 1)), ('h', (1,))],
        'Gswap': [('c', (0, 1)), ('c', (1, 0)), ('c', (0, 1))],
    }


def standard_gatenames_cirq_conversions():
    """Map standard gate names to cirq gate objects (requires cirq;
    reference: internalgates.standard_gatenames_cirq_conversions)."""
    try:
        import cirq
    except ImportError as e:
        raise ImportError("cirq is required for cirq conversions") from e
    return {
        'Gi': None, 'Gxpi': cirq.X, 'Gypi': cirq.Y, 'Gzpi': cirq.Z,
        'Gxpi2': cirq.X ** 0.5, 'Gypi2': cirq.Y ** 0.5, 'Gzpi2': cirq.S,
        'Gxmpi2': cirq.X ** -0.5, 'Gympi2': cirq.Y ** -0.5,
        'Gzmpi2': cirq.S ** -1, 'Gh': cirq.H, 'Gp': cirq.S,
        'Gpdag': cirq.S ** -1, 'Gt': cirq.T, 'Gtdag': cirq.T ** -1,
        'Gcnot': cirq.CNOT, 'Gcphase': cirq.CZ, 'Gswap': cirq.SWAP,
    }


def standard_gatenames_qiskit_conversions():
    """Map standard gate names to qiskit gate-name strings (reference:
    internalgates.standard_gatenames_qiskit_conversions)."""
    return {
        'Gi': 'id', 'Gxpi': 'x', 'Gypi': 'y', 'Gzpi': 'z',
        'Gxpi2': 'sx', 'Gzpi2': 's', 'Gzmpi2': 'sdg', 'Gh': 'h',
        'Gp': 's', 'Gpdag': 'sdg', 'Gt': 't', 'Gtdag': 'tdg',
        'Gcnot': 'cx', 'Gcphase': 'cz', 'Gswap': 'swap', 'Gzr': 'rz',
    }


# =============================================================================
# Reference-surface parity: parameterized gate callables, reverse lookups,
# and external-framework conversion tables (reference: internalgates.py).
# =============================================================================

class Gzr(UnitaryGateFunction):
    """Parameterized Z rotation: diag(1, e^{i theta}) (reference:
    internalgates.Gzr:34; theta = pi gives Z)."""
    shape = (2, 2)

    def __call__(self, arg):
        return np.array([[1.0, 0.0],
                         [0.0, np.exp(1j * float(arg[0]))]], complex)


class Gczr(UnitaryGateFunction):
    """Controlled Gzr (reference: internalgates.Gczr:45)."""
    shape = (4, 4)

    def __call__(self, arg):
        u = np.eye(4, dtype=complex)
        u[3, 3] = np.exp(1j * float(arg[0]))
        return u


class Gu3(UnitaryGateFunction):
    """QASM u3(theta, phi, lambda) single-qubit gate (reference:
    internalgates.Gu3:58)."""
    shape = (2, 2)

    def __call__(self, arg):
        theta, phi, lamb = (float(arg[0]), float(arg[1]), float(arg[2]))
        return np.array(
            [[np.cos(theta / 2), -np.exp(1j * lamb) * np.sin(theta / 2)],
             [np.exp(1j * phi) * np.sin(theta / 2),
              np.exp(1j * (phi + lamb)) * np.cos(theta / 2)]], complex)


def qasm_u3(theta, phi, lamb, output='unitary'):
    """The QASM u3 gate as a unitary or pp-basis superoperator (reference:
    internalgates.qasm_u3:999)."""
    u = Gu3()([theta, phi, lamb])
    if output == 'unitary':
        return u
    if output == 'superoperator':
        from pygsti_tpu_torch.tools.optools import unitary_to_superop
        return np.real(unitary_to_superop(u, 'pp'))
    raise ValueError("Invalid `output`: %s" % output)


def internal_gate_unitaries():
    """The standard gate-name -> unitary dict, with the continuously
    parameterized gates included as callables (reference:
    internalgates.internal_gate_unitaries:70)."""
    u = {k: v for k, v in standard_gatename_unitaries().items()
         if v is not None}
    u['Gzr'] = Gzr()
    u['Gczr'] = Gczr()
    u['Gu3'] = Gu3()
    return u


def unitary_to_standard_gatename(unitary, up_to_phase=False,
                                 return_phase=False):
    """The standard gate name matching `unitary`, or None (reference:
    internalgates.unitary_to_standard_gatename:347)."""
    unitary = np.asarray(unitary)
    std = standard_gatename_unitaries()
    for name, U in std.items():
        if U is None or callable(U):
            continue
        U = np.asarray(U)
        if U.shape == unitary.shape and np.allclose(unitary, U):
            return (name, 1.0) if (up_to_phase and return_phase) else name
    if up_to_phase:
        for name, U in std.items():
            if U is None or callable(U):
                continue
            U = np.asarray(U)
            if U.shape != unitary.shape:
                continue
            # phase: ratio of the largest-magnitude entries
            idx = np.unravel_index(np.argmax(np.abs(U)), U.shape)
            if abs(unitary[idx]) < 1e-12:
                continue
            phase = U[idx] / unitary[idx]
            if np.allclose(unitary * phase, U):
                return (name, complex(phase)) if return_phase else name
    return (None, None) if (up_to_phase and return_phase) else None


def is_gate_pauli_equivalent_to_this_standard_unitary(gate_unitary,
                                                      standard_gate_name):
    """Whether `gate_unitary` equals the named standard (Clifford) gate up
    to pre/post Pauli multiplication and a phase (reference:
    internalgates.is_gate_pauli_equivalent_to_this_standard_unitary:172)."""
    from pygsti_tpu_torch.tools.symplectic import unitary_to_symplectic
    try:
        s1, _ = unitary_to_symplectic(np.asarray(gate_unitary))
        s2, _ = unitary_to_symplectic(
            np.asarray(standard_gatename_unitaries()[standard_gate_name]))
    except (ValueError, KeyError):
        return False
    return bool(np.array_equal(s1, s2))


def cirq_gatenames_standard_conversions():
    """cirq gate -> standard gate-name map (the reverse of
    standard_gatenames_cirq_conversions; reference:
    internalgates.cirq_gatenames_standard_conversions:565)."""
    fwd = standard_gatenames_cirq_conversions()
    return {v: k for k, v in fwd.items() if v is not None}


def qiskit_gatenames_standard_conversions():
    """qiskit gate-name -> standard gate-name map (reference:
    internalgates.qiskit_gatenames_standard_conversions)."""
    fwd = standard_gatenames_qiskit_conversions()
    out = {}
    for k, v in fwd.items():
        out.setdefault(v, k)
    return out


def standard_gatenames_quil_conversions():
    """Standard gate-name -> quil gate-name map (reference:
    internalgates.standard_gatenames_quil_conversions:598)."""
    return {
        'Gi': 'I', 'Gxpi': 'X', 'Gypi': 'Y', 'Gzpi': 'Z',
        'Gxpi2': 'RX(pi/2)', 'Gxmpi2': 'RX(-pi/2)',
        'Gypi2': 'RY(pi/2)', 'Gympi2': 'RY(-pi/2)',
        'Gzpi2': 'RZ(pi/2)', 'Gzmpi2': 'RZ(-pi/2)',
        'Gh': 'H', 'Gp': 'S', 'Gt': 'T',
        'Gcphase': 'CZ', 'Gcnot': 'CNOT', 'Gswap': 'SWAP',
    }


def standard_gatenames_stim_conversions():
    """Standard gate-name -> stim Tableau map (requires stim; reference:
    internalgates.standard_gatenames_stim_conversions:398)."""
    try:
        import stim
    except ImportError as e:
        raise ImportError("stim is required for this operation") from e
    names = {'Gi': 'I', 'Gxpi': 'X', 'Gypi': 'Y', 'Gzpi': 'Z',
             'Gxpi2': 'SQRT_X', 'Gypi2': 'SQRT_Y', 'Gzpi2': 'S',
             'Gxmpi2': 'SQRT_X_DAG', 'Gympi2': 'SQRT_Y_DAG',
             'Gzmpi2': 'S_DAG', 'Gh': 'H', 'Gp': 'S', 'Gpdag': 'S_DAG',
             'Gcnot': 'CNOT', 'Gcphase': 'CZ', 'Gswap': 'SWAP'}
    return {k: stim.Tableau.from_named_gate(v) for k, v in names.items()}
