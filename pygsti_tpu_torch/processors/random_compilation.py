"""Randomized compilation (Pauli twirling) for U3-CX-CZ circuits
(counterpart of pygsti_tpu/processors/random_compilation.py; arXiv:2204.07568
pauli_rc, Nature Physics s41567-021-01409-7 central_pauli).

Pauli frames use a length-2n vector convention: entries in {0, 2};
p[0:n] = Z-part, p[n:2n] = X-part.  U3 parameters are updated by
decomposing the conjugated unitary P_out @ U3 @ P_in back into
(theta, phi, lam) -- equal up to global phase, which probabilities never
see.  Host numpy: the random draws come from a numpy RandomState in the
JAX package's order, so one seed gives its circuits.
"""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.circuits.circuit import Circuit

_PAULIS = {
    (0, 0): np.eye(2, dtype=complex),
    (0, 2): np.array([[1, 0], [0, -1]], dtype=complex),       # Z
    (2, 0): np.array([[0, 1], [1, 0]], dtype=complex),        # X
    (2, 2): np.array([[0, -1j], [1j, 0]], dtype=complex),     # Y
}


def mod_2pi(theta):
    """Map angle into (-pi, pi] (reference: random_compilation.py:465)."""
    while theta > np.pi:
        theta -= 2 * np.pi
    while theta <= -np.pi:
        theta += 2 * np.pi
    return theta


def u3_unitary(theta, phi, lam):
    """U3 gate: [[cos(t/2), -e^{i lam} sin(t/2)],
                 [e^{i phi} sin(t/2), e^{i(phi+lam)} cos(t/2)]]."""
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -np.exp(1j * lam) * s],
                     [np.exp(1j * phi) * s, np.exp(1j * (phi + lam)) * c]])


def u3_angles_from_unitary(w):
    """(theta, phi, lam) with U3(...) == w up to global phase (ZYZ Euler)."""
    c = abs(w[0, 0])
    s = abs(w[1, 0])
    theta = 2 * np.arctan2(s, c)
    if c > 1e-12 and s > 1e-12:
        alpha = np.angle(w[0, 0])
        phi = np.angle(w[1, 0]) - alpha
        lam = np.angle(-w[0, 1]) - alpha
    elif s <= 1e-12:            # diagonal: only phi+lam defined
        phi = np.angle(w[1, 1]) - np.angle(w[0, 0])
        lam = 0.0
    else:                       # anti-diagonal: only phi-lam defined
        phi = np.angle(w[1, 0]) - np.angle(-w[0, 1])
        lam = 0.0
    return mod_2pi(theta), mod_2pi(phi), mod_2pi(lam)


def inverse_u3(args):
    """Angles of U3(args)^-1 (reference: random_compilation.py:639)."""
    theta, phi, lam = (float(a) for a in args)
    return (mod_2pi(-theta), mod_2pi(-lam), mod_2pi(-phi))


def pauli_vector_to_u3_layer(p, qubits):
    """Layer of Gu3 labels implementing the Pauli described by `p`
    (reference: random_compilation.py:488)."""
    n = len(qubits)
    layer = []
    for i, q in enumerate(qubits):
        w = _PAULIS[(int(p[n + i]), int(p[i]))]
        theta, phi, lam = u3_angles_from_unitary(w)
        layer.append(Label('Gu3', (q,), args=(theta, phi, lam)))
    return layer


def update_u3_parameters(layer, p, q, qubit_map):
    """New Gu3 layer implementing Q_pauli . U3 . P_pauli per qubit, with
    twirled idles inserted on qubits absent from the layer (reference:
    random_compilation.py:372)."""
    n = len(qubit_map)
    new_layer = []
    used = set()
    for g in layer:
        assert g.name == 'Gu3', "layer must contain only Gu3 gates"
        qubit = g.sslbls[0]
        i = qubit_map[qubit]
        u = u3_unitary(*(float(a) for a in g.args))
        p_in = _PAULIS[(int(p[n + i]), int(p[i]))]
        q_out = _PAULIS[(int(q[n + i]), int(q[i]))]
        w = q_out @ u @ p_in
        new_layer.append(Label('Gu3', (qubit,),
                               args=u3_angles_from_unitary(w)))
        used.add(qubit)
    for qubit, i in qubit_map.items():
        if qubit in used:
            continue
        p_in = _PAULIS[(int(p[n + i]), int(p[i]))]
        q_out = _PAULIS[(int(q[n + i]), int(q[i]))]
        new_layer.append(Label('Gu3', (qubit,),
                               args=u3_angles_from_unitary(q_out @ p_in)))
    return new_layer


def _propagate_pauli_through_2q_layer(layer, p, n, qubit_map):
    for g in layer:
        if g.name == 'Gcnot':
            c, t = qubit_map[g.sslbls[0]], qubit_map[g.sslbls[1]]
            p[c] = (p[c] + p[t]) % 4                   # Z_t -> Z_c Z_t
            p[n + t] = (p[n + c] + p[n + t]) % 4       # X_c -> X_c X_t
        elif g.name in ('Gcphase', 'Gcz'):
            c, t = qubit_map[g.sslbls[0]], qubit_map[g.sslbls[1]]
            p[c] = (p[c] + p[n + t]) % 4               # X_t -> Z_c X_t
            p[t] = (p[n + c] + p[t]) % 4               # X_c -> X_c Z_t
        else:
            raise ValueError("2Q layers may only contain Gcnot/Gcphase gates")


def _layer_components(circ, i):
    lbl = circ.layertup[i]
    return lbl.components if not lbl.is_simple else (lbl,)


def pauli_randomize_circuit(circ, rand_state=None, return_bs=False,
                            return_target_pauli=False, test_layers=None):
    """Insert fresh random Pauli frames around every U3 layer, absorbed into
    the U3 angles (reference: random_compilation.py:156)."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    n = circ.num_lines
    d = circ.depth
    qubit_map = {q: i for i, q in enumerate(circ.line_labels)}
    p = np.zeros(2 * n, int)
    test_layers = list(test_layers) if test_layers is not None else None

    layers = []
    for i in range(d):
        comps = _layer_components(circ, i)
        if comps and comps[0].name in ('Gi', 'Gdelay'):
            layers.append(list(comps))
        elif len(comps) == 0 or comps[0].name == 'Gu3':
            if test_layers is not None:
                q = np.asarray(test_layers.pop(0), int)
            else:
                q = 2 * rng.randint(0, 2, 2 * n)
            layers.append(update_u3_parameters(comps, p, q, qubit_map))
            p = q
        else:
            layers.append(list(comps))
            _propagate_pauli_through_2q_layer(comps, p, n, qubit_map)

    bs = ''.join(str(b // 2) for b in p[n:])
    rc_circ = Circuit(layers, circ.line_labels)
    out = [rc_circ]
    if return_bs:
        out.append(bs)
    if return_target_pauli:
        out.append(p)
    return out


def randomize_central_pauli(circ, rand_state=None, return_bs=False,
                            return_target_pauli=False, test_layer=None):
    """Prepend a random central Pauli (as a U3 layer) and propagate it
    through the (mirror-second-half) circuit, conjugating each U3 layer
    (reference: random_compilation.py:268)."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    n = circ.num_lines
    d = circ.depth
    qubit_map = {q: i for i, q in enumerate(circ.line_labels)}
    central = np.asarray(test_layer, int) if test_layer is not None \
        else 2 * rng.randint(0, 2, 2 * n)
    p = central.copy()

    layers = [pauli_vector_to_u3_layer(central, circ.line_labels)]
    for i in range(d):
        comps = _layer_components(circ, i)
        if comps and comps[0].name in ('Gi', 'Gdelay'):
            layers.append(list(comps))
        elif len(comps) == 0 or comps[0].name == 'Gu3':
            layers.append(update_u3_parameters(comps, p, p, qubit_map))
        else:
            layers.append(list(comps))
            _propagate_pauli_through_2q_layer(comps, p, n, qubit_map)

    bs = ''.join(str(b // 2) for b in p[n:])
    cp_circ = Circuit(layers, circ.line_labels)
    out = [cp_circ]
    if return_bs:
        out.append(bs)
    if return_target_pauli:
        out.append(p)
    return out


class RandomCompilation(object):
    """Randomized compilation of one circuit at a time by `rc_strategy`
    (reference: random_compilation.py:21)."""

    def __init__(self, rc_strategy=None, return_bs=False, testing=False,
                 rand_state=None):
        self.rc_strategy = rc_strategy or 'pauli_rc'
        self.return_bs = return_bs
        self.testing = testing
        self.rand_state = rand_state if rand_state is not None \
            else np.random.RandomState()

    def compile(self, circ, test_layers=None):
        if self.rc_strategy in ('pauli_rc', 'rc'):
            return pauli_randomize_circuit(
                circ, self.rand_state, return_bs=self.return_bs,
                test_layers=test_layers if self.testing else None)
        if self.rc_strategy in ('central_pauli', 'cp'):
            return randomize_central_pauli(
                circ, self.rand_state, return_bs=self.return_bs,
                test_layer=test_layers if self.testing else None)
        raise ValueError("Unknown rc_strategy %r" % self.rc_strategy)
