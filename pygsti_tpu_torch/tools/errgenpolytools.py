"""Outcome probabilities as polynomials in error-generator rates
(counterpart of pygsti_tpu/tools/errgenpolytools.py).

p(b) = <b| exp(sum_j r_j L_j) rho |b> for a stabilizer state rho and
elementary error generators L_j ('H', 'S', 'C', 'A' over Paulis), Taylor
expanded through order 2 into a ``Polynomial`` over the label indices j.

The JAX package builds each L_j as a dense 4^n x 4^n superoperator, which
stops at about 3 qubits.  Here each L_j is a short sum of sandwiches
c A rho B with A, B Pauli operators (with phases), so L_j L_k rho is again
a sum of sandwiches and <b| A rho B |b> = <b|A|psi> conj(<b|B^dag|psi>) is a
product of two stabilizer amplitudes.  An amplitude <b| i^e X^x Z^z |psi>
is a sign times psi(b XOR x), so the state's amplitudes are solved once per
distinct x and every pair of labels is numpy bit arithmetic: the expansion
runs at the width of bench.py's 10-qubit circuits.  Host numpy.
"""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.baseobjs.polynomial import Polynomial
from pygsti_tpu_torch.tools import symplectic as _sym
from pygsti_tpu_torch.tools.errgenproptools import StabilizerAmplitudes

#: coefficients of smaller magnitude are left out of the polynomial
COEFF_TOL = 1e-15


def errorgen_gate_contributors(errorgen_label, circuit, propagator=None):
    """Which circuit layers' error generators propagate onto the given
    end-of-circuit label.  Requires a propagator with per-layer label maps;
    returns layer indices."""
    assert propagator is not None, "Provide an ErrorGeneratorPropagator"
    per_layer = propagator.propagate_errorgens_per_layer(circuit) \
        if hasattr(propagator, 'propagate_errorgens_per_layer') else None
    if per_layer is None:
        return []
    return [t for t, layer in enumerate(per_layer) if errorgen_label in layer]


def _parity(v):
    """Parity of the set bits of each int64 entry."""
    v = np.asarray(v, np.int64).copy()
    for s in (32, 16, 8, 4, 2, 1):
        v ^= v >> s
    return v & 1


def _mul(a, b):
    """Products of Paulis (x, z, e): i^e X^x Z^z with bit-mask ints."""
    (x1, z1, e1), (x2, z2, e2) = a, b
    return x1 ^ x2, z1 ^ z2, (e1 + e2 + 2 * _parity(z1 & x2)) % 4


def _sandwiches(lbl):
    """The label's superoperator as [(c, A, B)]: L[rho] = sum c A rho B, with
    A, B Paulis (x, z, e) of Hermitian operands i^{x.z} X^x Z^z."""
    def herm(p):
        return p.x_bits, p.z_bits, bin(p.x_bits & p.z_bits).count('1') % 4
    eye = (0, 0, 0)
    typ = lbl.errorgen_type
    P = herm(lbl.basis_element_labels[0])
    if typ == 'H':
        return [(-1j, P, eye), (1j, eye, P)]
    if typ == 'S':
        return [(1.0, P, P), (-1.0, eye, eye)]
    Q = herm(lbl.basis_element_labels[1])
    PQ, QP = _mul(P, Q), _mul(Q, P)
    if typ == 'C':
        return [(1.0, P, Q), (1.0, Q, P), (-0.5, PQ, eye), (-0.5, QP, eye),
                (-0.5, eye, PQ), (-0.5, eye, QP)]
    if typ == 'A':
        return [(1j, P, Q), (-1j, Q, P), (0.5j, PQ, eye), (-0.5j, QP, eye),
                (0.5j, eye, PQ), (-0.5j, eye, QP)]
    raise ValueError("Unknown errorgen type %r" % typ)


def _term_arrays(labels):
    """[N, T] arrays c, A = (x, z, e), B = (x, z, e), padded with c = 0."""
    terms = [_sandwiches(l) for l in labels]
    T = max((len(t) for t in terms), default=0)
    c = np.zeros((len(terms), T), complex)
    A = np.zeros((3, len(terms), T), np.int64)
    B = np.zeros((3, len(terms), T), np.int64)
    for j, tl in enumerate(terms):
        for t, (ct, a, b) in enumerate(tl):
            c[j, t] = ct
            A[:, j, t] = a
            B[:, j, t] = b
    return c, tuple(A), tuple(B)


class _Expectations(object):
    """<b| A rho B |b> for rho = |psi><psi| of a stabilizer state and Pauli
    arrays A, B, with psi's amplitudes solved once per distinct index."""

    def __init__(self, state_s, state_p, bits):
        self.amps = StabilizerAmplitudes(state_s, state_p)
        self.n = len(state_p) // 2
        self.b = int(sum(int(v) << q for q, v in enumerate(bits)))
        self._psi = {}

    def psi(self, idx):
        idx = np.asarray(idx, np.int64)
        uniq, inv = np.unique(idx, return_inverse=True)
        for u in uniq:
            if int(u) not in self._psi:
                self._psi[int(u)] = self.amps.amplitude(
                    np.array([(int(u) >> q) & 1 for q in range(self.n)], np.int64))
        return np.array([self._psi[int(u)] for u in uniq], complex)[inv].reshape(idx.shape)

    def pauli_amplitude(self, P):
        """<b| i^e X^x Z^z |psi> = i^e (-1)^{z.(b^x)} psi(b^x)."""
        x, z, e = P
        c = self.b ^ x
        return (1j ** e) * (1 - 2 * _parity(z & c)) * self.psi(c)

    def sandwich(self, coeff, A, B):
        # <psi|B|b> = conj(<b|B^dag|psi>), B^dag = i^{-e} (-1)^{x.z} X^x Z^z
        bx, bz, be = B
        bdag = (bx, bz, (-be + 2 * _parity(bx & bz)) % 4)
        return coeff * self.pauli_amplitude(A) * np.conj(self.pauli_amplitude(bdag))


def stabilizer_probability_polynomial(errorgen_labels, state_s, state_p,
                                      bitstring, order=2):
    """p(bitstring) as a Polynomial in the rates of `errorgen_labels`:
    the exact Taylor expansion of <b| exp(sum_j r_j L_j) rho |b> through
    `order` (<= 2); variable j is errorgen_labels[j].  Coefficients below
    COEFF_TOL in magnitude are left out (the constant always stays)."""
    assert order <= 2, "polynomial construction implemented through order 2"
    bits = np.asarray(list(bitstring), np.int64)
    ex = _Expectations(state_s, state_p, bits)
    a_b = ex.psi(np.array([ex.b]))[0]
    coeffs = {(): float(abs(a_b) ** 2)}
    N = len(errorgen_labels)
    if order < 1 or N == 0:
        return Polynomial(coeffs, max_num_vars=N)
    c, A, B = _term_arrays(errorgen_labels)
    first = np.real(ex.sandwich(c, A, B).sum(axis=1))
    for j in np.flatnonzero(np.abs(first) > COEFF_TOL):
        coeffs[(int(j),)] = float(first[j])
    if order >= 2:
        # L_j L_k rho = sum_{t, u} c_jt c_ku (A_jt A_ku) rho (B_ku B_jt)
        jj, kk = np.triu_indices(N)
        T = c.shape[1]

        def composed(first_idx, second_idx):
            ct = c[first_idx][:, :, None] * c[second_idx][:, None, :]
            At = tuple(a[first_idx][:, :, None] for a in A)
            Au = tuple(a[second_idx][:, None, :] for a in A)
            Bt = tuple(b[first_idx][:, :, None] for b in B)
            Bu = tuple(b[second_idx][:, None, :] for b in B)
            bc = (np.broadcast_to(v, (len(first_idx), T, T)) for v in _mul(Bu, Bt))
            ac = (np.broadcast_to(v, (len(first_idx), T, T)) for v in _mul(At, Au))
            return np.real(ex.sandwich(ct, tuple(ac), tuple(bc)).sum(axis=(1, 2)))

        second = 0.5 * (composed(jj, kk) + composed(kk, jj))
        second[jj == kk] *= 0.5
        for i in np.flatnonzero(np.abs(second) > COEFF_TOL):
            coeffs[(int(jj[i]), int(kk[i]))] = float(second[i])
    return Polynomial(coeffs, max_num_vars=N)


def circuit_probability_polynomial(propagator, circuit, bitstring,
                                   pspec=None, order=2):
    """End-to-end: propagate the circuit's error generators and return
    p(bitstring) as a Polynomial in the propagated rates.  Returns
    (polynomial, labels) where labels[j] is variable j's errorgen label."""
    errorgens = propagator.propagate_errorgens(circuit, pspec=pspec)
    labels = list(errorgens.keys())
    n = propagator.num_qubits
    srep = _sym.symplectic_rep_of_clifford_circuit(circuit, pspec=pspec)
    st = _sym.prep_stabilizer_state(n)
    out_s, out_p = _sym.apply_clifford_to_stabilizer_state(srep[0], srep[1], *st)
    poly = stabilizer_probability_polynomial(labels, out_s, out_p, bitstring, order)
    return poly, labels
