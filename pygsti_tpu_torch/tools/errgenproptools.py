"""Analytic corrections for error-generator propagation (counterpart of
pygsti_tpu/tools/errgenproptools.py; reference:
pygsti/tools/errgenproptools.py: bch_approximation:100, alpha:7880,
slow_amplitude_of_state:7294, approximate_stabilizer_probability machinery).

Implements stabilizer-state amplitudes on the framework's symplectic
(s, p) tableau representation and the first-order sensitivities
("alpha" factors) of computational outcome probabilities to elementary
H/S/C/A error generators -- the analytic path for predicting noisy-Clifford
outcome probabilities at 10+ qubits without density matrices.
"""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.tools import symplectic as _sym
from pygsti_tpu_torch.tools import matrixmod2 as _mod2


# -- stabilizer amplitudes ---------------------------------------------------

def _greedy_reference_bitstring(state_s, state_p):
    """A bitstring in the state's support, with its (real, positive)
    amplitude magnitude sqrt(prod p_i)."""
    n = len(state_p) // 2
    s, p = state_s, state_p
    bits = []
    amp2 = 1.0
    for a in range(n):
        p0, st0, p1, st1 = _sym.pauli_z_measurement(s, p, a)
        if p0 >= p1:
            bits.append(0)
            amp2 *= p0
            s, p = st0
        else:
            bits.append(1)
            amp2 *= p1
            s, p = st1
    return np.array(bits, np.int64), np.sqrt(amp2)


def _stabilizer_group_solve(state_s, state_p, xdiff):
    """(x, z, e) of a stabilizer-group element whose X-part equals `xdiff`
    (plain i^e X^x Z^z convention), or None if outside the group's X-span."""
    n = len(state_p) // 2
    X = state_s[:n, :n] % 2            # X-parts of the n stabilizer gens
    c = _mod2.solve_mod2(X, np.asarray(xdiff, np.int64) % 2)
    if c is None:
        return None
    x = np.zeros(n, np.int64)
    z = np.zeros(n, np.int64)
    e = 0
    for j in range(n):
        if c[j]:
            gx = state_s[:n, j] % 2
            gz = state_s[n:, j] % 2
            ge = int(state_p[j]) % 4
            x, z, e = _sym._pauli_product_phase_exponent(x, z, e, gx, gz, ge)
    return x, z, e


class StabilizerAmplitudes(object):
    """Amplitude oracle for one stabilizer state: complex <b|psi> with a
    consistent global-phase convention (<b0|psi> real positive for the
    reference bitstring b0) (reference: errgenproptools.py:7294
    slow_amplitude_of_state)."""

    def __init__(self, state_s, state_p):
        self.s = state_s
        self.p = state_p
        self.n = len(state_p) // 2
        self.b0, self.a0 = _greedy_reference_bitstring(state_s, state_p)

    def amplitude(self, bits):
        bits = np.asarray(bits, np.int64)
        g = _stabilizer_group_solve(self.s, self.p, bits ^ self.b0)
        if g is None:
            return 0.0 + 0.0j
        x, z, e = g
        # a_b = i^e (-1)^{z . b0} a_{b0}   (from g |psi> = |psi>)
        return (1j ** e) * ((-1) ** int(np.dot(z, self.b0) % 2)) * self.a0

    def pauli_amplitude(self, bits, px, pz, pe):
        """<b| P |psi> for P = i^pe X^px Z^pz (plain convention)."""
        bits = np.asarray(bits, np.int64)
        b2 = bits ^ np.asarray(px, np.int64)
        phase = (1j ** (pe % 4)) * ((-1) ** int(np.dot(pz, b2) % 2))
        return phase * self.amplitude(b2)


def _hermitian_pauli(x_bits, z_bits, n):
    """(x, z, e) of the HERMITIAN Pauli W = prod_q w_q with w in
    {I, X, Y, Z}: plain-convention exponent e = (#Y) mod 4 since Y = i XZ
    gives W = i^{x.z} X^x Z^z."""
    x = np.array([(x_bits >> q) & 1 for q in range(n)], np.int64)
    z = np.array([(z_bits >> q) & 1 for q in range(n)], np.int64)
    e = int(np.dot(x, z)) % 4
    return x, z, e


# -- alpha sensitivities -----------------------------------------------------

def alpha(errorgen, state_s, state_p, bitstring, amps=None):
    """First-order sensitivity d p(bitstring) / d rate for an elementary
    error generator acting on a stabilizer state (reference:
    errgenproptools.py:7880 alpha).

    `errorgen` is an ElementaryErrorgenLabel ('H'|'S'|'C'|'A' with
    PauliLabel operands); `bitstring` is a 0/1 sequence.
    """
    n = len(state_p) // 2
    if amps is None:
        amps = StabilizerAmplitudes(state_s, state_p)
    bits = np.asarray(list(bitstring), np.int64) if not isinstance(
        bitstring, np.ndarray) else bitstring
    typ = errorgen.errorgen_type
    paulis = errorgen.basis_element_labels

    def W(pl):
        return _hermitian_pauli(pl.x_bits, pl.z_bits, n)

    a_b = amps.amplitude(bits)
    if typ == 'S':
        px, pz, pe = W(paulis[0])
        u = amps.pauli_amplitude(bits, px, pz, pe)
        return float(abs(u) ** 2 - abs(a_b) ** 2)
    if typ == 'H':
        px, pz, pe = W(paulis[0])
        u = amps.pauli_amplitude(bits, px, pz, pe)
        return float(2.0 * np.imag(u * np.conj(a_b)))
    if typ in ('C', 'A'):
        (px1, pz1, pe1) = W(paulis[0])
        (px2, pz2, pe2) = W(paulis[1])
        uP = amps.pauli_amplitude(bits, px1, pz1, pe1)
        uQ = amps.pauli_amplitude(bits, px2, pz2, pe2)
        # products PQ and QP in plain convention
        xpq, zpq, epq = _sym._pauli_product_phase_exponent(
            px1, pz1, pe1, px2, pz2, pe2)
        xqp, zqp, eqp = _sym._pauli_product_phase_exponent(
            px2, pz2, pe2, px1, pz1, pe1)
        wPQ = amps.pauli_amplitude(bits, xpq, zpq, epq)
        wQP = amps.pauli_amplitude(bits, xqp, zqp, eqp)
        if typ == 'C':
            # L_C(rho) = P rho Q + Q rho P - (1/2){PQ + QP, rho}
            return float(2.0 * np.real(uP * np.conj(uQ))
                         - np.real((wPQ + wQP) * np.conj(a_b)))
        # L_A(rho) = i(P rho Q - Q rho P + (1/2){PQ - QP, rho})
        # <b|.|b> = -2 Im(uP conj(uQ)) - Im((wPQ - wQP) conj(a_b))
        return float(-2.0 * np.imag(uP * np.conj(uQ))
                     - np.imag((wPQ - wQP) * np.conj(a_b)))
    raise ValueError("Unknown errorgen type %r" % typ)


def approximate_stabilizer_probability(errorgen_dict, state_s, state_p,
                                       bitstring, order=1):
    """p_ideal(bitstring) + Taylor corrections of exp(L) through `order`
    (reference: errgenproptools.approximate_stabilizer_probability:8597;
    order 1 uses the amplitude-based alpha sensitivities, higher orders add
    dense (1/k!)<b|L^k rho|b> terms via stabilizer_probability_correction)."""
    bits = np.asarray(list(bitstring), np.int64)
    p_ideal = _sym.stabilizer_outcome_probability(state_s, state_p,
                                                  list(bits))
    if order == 0 or not errorgen_dict:
        return float(p_ideal)
    return float(p_ideal + stabilizer_probability_correction(
        errorgen_dict, state_s, state_p, bits, order))


def approximate_circuit_outcome_probability(propagator, circuit, bitstring,
                                            pspec=None, order=1):
    """End-to-end: propagate the circuit's error generators, evolve |0..0>
    through the ideal Clifford circuit, and apply first-order corrections."""
    errorgens = propagator.propagate_errorgens(circuit, pspec=pspec)
    n = propagator.num_qubits
    srep = _sym.symplectic_rep_of_clifford_circuit(circuit, pspec=pspec)
    st = _sym.prep_stabilizer_state(n)
    out_s, out_p = _sym.apply_clifford_to_stabilizer_state(srep[0], srep[1],
                                                           *st)
    # propagator coefficients: {ElementaryErrorgenLabel: rate}
    return approximate_stabilizer_probability(errorgens, out_s, out_p,
                                              bitstring, order)


# -- elementary errorgen algebra (commutators, BCH, Magnus) -------------------

def _all_pauli_labels(n):
    from pygsti_tpu_torch.errorgenpropagation.errorpropagator import PauliLabel
    out = []
    for x in range(2 ** n):
        for z in range(2 ** n):
            if x == 0 and z == 0:
                continue
            out.append(PauliLabel(x, z, n))
    return out


def elementary_errorgen_basis_labels(n, types=('H', 'S', 'C', 'A')):
    """All elementary errorgen labels on n qubits (reference:
    baseobjs/errorgenbasis.py ElementaryErrorgenBasis)."""
    from pygsti_tpu_torch.errorgenpropagation.errorpropagator import \
        ElementaryErrorgenLabel
    paulis = _all_pauli_labels(n)
    labels = []
    if 'H' in types:
        labels += [ElementaryErrorgenLabel('H', p) for p in paulis]
    if 'S' in types:
        labels += [ElementaryErrorgenLabel('S', p) for p in paulis]
    for typ in ('C', 'A'):
        if typ in types:
            for i, p in enumerate(paulis):
                for q in paulis[i + 1:]:
                    labels.append(ElementaryErrorgenLabel(typ, p, q))
    return labels


def errorgen_label_to_dense(lbl, n):
    """Dense std-basis superoperator of an elementary errorgen label
    (unnormalized Hermitian Paulis) (reference:
    errgenproptools.errorgen_layer_to_matrix:6578)."""
    from pygsti_tpu_torch.tools import lindbladtools as _lt
    mats = [p.to_dense() for p in lbl.basis_element_labels]
    if lbl.errorgen_type in ('H', 'S'):
        return _lt.create_elementary_errorgen(lbl.errorgen_type, mats[0])
    return _lt.create_elementary_errorgen(lbl.errorgen_type, mats[0], mats[1])


_PROJ_SCALE_CACHE = {}


def _projection_scale(typ, n):
    """Empirical dual<->errorgen pairing constant for each type, so the
    projection is exact in the unnormalized-Pauli convention regardless of
    the dual functions' internal normalization."""
    key = (typ, n)
    if key not in _PROJ_SCALE_CACHE:
        from pygsti_tpu_torch.errorgenpropagation.errorpropagator import (
            PauliLabel, ElementaryErrorgenLabel)
        X = PauliLabel(1, 0, n)
        Z = PauliLabel(1 << (n - 1), 1, n) if n > 1 else PauliLabel(0, 1, n)
        lbl = ElementaryErrorgenLabel(typ, X) if typ in ('H', 'S') else             ElementaryErrorgenLabel(typ, X, Z)
        dense = errorgen_label_to_dense(lbl, n)
        _PROJ_SCALE_CACHE[key] = float(np.real(
            np.vdot(_dual_for(lbl, n), dense)))
    return _PROJ_SCALE_CACHE[key]


def _dual_for(lbl, n):
    from pygsti_tpu_torch.tools import lindbladtools as _lt
    d = 2 ** n
    mats = [p.to_dense() / np.sqrt(d) for p in lbl.basis_element_labels]
    if lbl.errorgen_type in ('H', 'S'):
        return _lt.create_elementary_errorgen_dual(lbl.errorgen_type, mats[0])
    return _lt.create_elementary_errorgen_dual(lbl.errorgen_type, mats[0],
                                               mats[1])


def project_errorgen(dense_std, n, types=('H', 'S', 'C', 'A'), tol=1e-12):
    """Project a dense std-basis error generator onto elementary errorgen
    coefficients (unnormalized-Pauli convention) via the dual generators
    (reference: errgenproptools projections)."""
    out = {}
    for lbl in elementary_errorgen_basis_labels(n, types):
        coeff = np.real(np.vdot(_dual_for(lbl, n), dense_std))             / _projection_scale(lbl.errorgen_type, n)
        if abs(coeff) > tol:
            out[lbl] = float(coeff)
    return out


def error_generator_commutator_numerical(lbl1, lbl2, num_qubits,
                                         types=('H', 'S', 'C', 'A')):
    """[L1, L2] expanded in elementary errorgen coefficients (reference:
    errgenproptools.error_generator_commutator_numerical:6748).  Exact; cost
    grows as 16^n so intended for <= 3 qubits."""
    L1 = errorgen_label_to_dense(lbl1, num_qubits)
    L2 = errorgen_label_to_dense(lbl2, num_qubits)
    return project_errorgen(L1 @ L2 - L2 @ L1, num_qubits, types)


def error_generator_composition_numerical(lbl1, lbl2, num_qubits,
                                          types=('H', 'S', 'C', 'A')):
    """L1 @ L2 expanded in elementary errorgen coefficients (reference:
    errgenproptools.error_generator_composition_numerical:6802).  Note the
    composition generally has a part outside the elementary-errorgen span;
    only the projection is returned."""
    L1 = errorgen_label_to_dense(lbl1, num_qubits)
    L2 = errorgen_label_to_dense(lbl2, num_qubits)
    return project_errorgen(L1 @ L2, num_qubits, types)


def error_generator_commutator(lbl1, lbl2, num_qubits, weight=1.0,
                               truncation_threshold=1e-14):
    """[L1, L2] expanded in elementary errorgen coefficients -- ANALYTIC
    Pauli-bitmask algebra (tools/errgenalgebra.py), polynomial cost at any
    qubit count (reference: errgenproptools.error_generator_commutator:801
    implements the same expansion as hand-written case tables)."""
    from pygsti_tpu_torch.tools import errgenalgebra as _ega
    return _ega.error_generator_commutator(lbl1, lbl2, num_qubits, weight,
                                           tol=truncation_threshold)


def error_generator_composition(lbl1, lbl2, num_qubits, weight=1.0,
                                truncation_threshold=1e-14):
    """L1 o L2 projected onto elementary errorgen coefficients -- ANALYTIC
    (reference: errgenproptools.py:1340-6415 composition case tables)."""
    from pygsti_tpu_torch.tools import errgenalgebra as _ega
    return _ega.error_generator_composition(lbl1, lbl2, num_qubits, weight,
                                            tol=truncation_threshold)


def _layer_commutator(layer1, layer2, num_qubits, weight=1.0,
                      truncation_threshold=1e-14):
    """weight * [L(layer1), L(layer2)] as an errorgen dict (analytic; one
    sandwich-level composition of the full layers)."""
    from pygsti_tpu_torch.tools import errgenalgebra as _ega
    return _ega.layer_commutator_analytic(layer1, layer2, num_qubits, weight,
                                          truncation_threshold)


def _layer_sum(layers):
    out = {}
    for d in layers:
        for lbl, c in d.items():
            out[lbl] = out.get(lbl, 0.0) + c
    return out


def _layer_scale(layer, w):
    return {k: w * v for k, v in layer.items()}


def bch_approximation(errgen_layer_1, errgen_layer_2, num_qubits=None,
                      bch_order=1, truncation_threshold=1e-14):
    """log(e^X e^Y) to the given BCH order (1..5), as an errorgen dict
    (reference: errgenproptools.bch_approximation:100, orders 1-5).

    order 2: (1/2)[X,Y]
    order 3: (1/12)([X,[X,Y]] - [Y,[X,Y]])
    order 4: -(1/24)[Y,[X,[X,Y]]]
    order 5: -(1/720)([X,F]-[Y,E]) + (1/360)([Y,F]-[X,E]) + (1/120)([Y,G]-[X,D])
             with B=[X,[X,Y]], C=[Y,[X,Y]], D=[Y,B], E=[Y,C], F=[X,B], G=[X,C]
             (reference: errgenproptools.py:280 fifth-order grouping)
    All commutators are exact ANALYTIC elementary-errorgen commutators
    (Pauli-bitmask algebra, tools/errgenalgebra.py) -- polynomial cost at
    any qubit count.
    """
    if num_qubits is None:
        num_qubits = next(iter(errgen_layer_1 or errgen_layer_2)
                          ).basis_element_labels[0].num_qubits
    X, Y = errgen_layer_1, errgen_layer_2
    tt = truncation_threshold

    def comm(a, b, w=1.0):
        return _layer_commutator(a, b, num_qubits, weight=w,
                                 truncation_threshold=tt)

    out = _layer_sum([X, Y])
    if bch_order >= 2:
        XY = comm(X, Y)                       # [X,Y]
        out = _layer_sum([out, _layer_scale(XY, 0.5)])
    if bch_order >= 3:
        B = comm(X, XY)                       # [X,[X,Y]]
        C = comm(Y, XY)                       # [Y,[X,Y]]
        out = _layer_sum([out, _layer_scale(B, 1.0 / 12),
                          _layer_scale(C, -1.0 / 12)])
    if bch_order >= 4:
        D = comm(Y, B)                        # [Y,[X,[X,Y]]]
        out = _layer_sum([out, _layer_scale(D, -1.0 / 24)])
    if bch_order >= 5:
        E = comm(Y, C)
        F = comm(X, B)
        G = comm(X, C)
        out = _layer_sum([
            out,
            _layer_scale(comm(X, F), -1.0 / 720),
            _layer_scale(comm(Y, E), 1.0 / 720),
            _layer_scale(comm(Y, F), 1.0 / 360),
            _layer_scale(comm(X, E), -1.0 / 360),
            _layer_scale(comm(Y, G), 1.0 / 120),
            _layer_scale(comm(X, D), -1.0 / 120),
        ])
    if bch_order > 5:
        raise NotImplementedError("BCH orders > 5 are not implemented "
                                  "(reference supports 1-5)")
    return {k: v for k, v in out.items() if abs(v) > truncation_threshold}


def magnus_expansion(errorgen_layers, num_qubits=None, magnus_order=1,
                     truncation_threshold=1e-14):
    """Magnus expansion of a time-ordered product of errorgen layers
    (reference: errgenproptools.magnus_expansion:468).

    Order 1: sum of layers.  Order 2 adds (1/2) sum_{t2 > t1} [L_t2, L_t1].
    Order 3 combines layers by an iterated order-3 BCH right-fold (exact to
    O(L^4); reference: errgenproptools.py:468 magnus_order=3).
    """
    layers = list(errorgen_layers)
    if num_qubits is None:
        for d in layers:
            if d:
                num_qubits = next(iter(d)).basis_element_labels[0].num_qubits
                break
    if magnus_order >= 3:
        if not layers:
            return {}
        # log(e^{A_n} ... e^{A_1}): fold from the right so each step computes
        # log(e^{A_t} e^{accumulated}) -- layer t is applied AFTER 1..t-1
        out = dict(layers[0])
        for t in range(1, len(layers)):
            out = bch_approximation(layers[t], out, num_qubits,
                                    bch_order=min(magnus_order, 5),
                                    truncation_threshold=truncation_threshold)
        return {k: v for k, v in out.items() if abs(v) > truncation_threshold}
    out = _layer_sum(layers)
    if magnus_order >= 2:
        for t2 in range(len(layers)):
            for t1 in range(t2):
                comm = _layer_commutator(layers[t2], layers[t1], num_qubits,
                                         weight=0.5,
                                         truncation_threshold=truncation_threshold)
                out = _layer_sum([out, comm])
    return {k: v for k, v in out.items() if abs(v) > truncation_threshold}


def zassenhaus_formula(errorgen_groups, num_qubits=None, zassenhaus_order=1,
                       truncation_threshold=1e-14):
    """Disentangle exp(X1+...+Xn) into exp(X1)...exp(Xn)exp(W2)... to the
    given order (reference: errgenproptools.zassenhaus_formula:725, orders
    1-2).  Returns a list of errorgen dicts, one per exponentiated factor.

    Order 1 returns `errorgen_groups` as-is; order 2 appends the Lie
    polynomial W2 = (1/2) sum_{i<j} [X_j, X_i] (identical to the
    second-order Magnus term).
    """
    groups = list(errorgen_groups)
    if zassenhaus_order == 1:
        return groups
    if zassenhaus_order > 2:
        raise NotImplementedError(
            "The Zassenhaus formula is only implemented up to second order "
            "(matching the reference)")
    if num_qubits is None:
        for d in groups:
            if d:
                num_qubits = next(iter(d)).basis_element_labels[0].num_qubits
                break
    w2 = {}
    for j in range(len(groups)):
        for i in range(j):
            comm = _layer_commutator(groups[j], groups[i], num_qubits,
                                     weight=0.5,
                                     truncation_threshold=truncation_threshold)
            w2 = _layer_sum([w2, comm])
    w2 = {k: v for k, v in w2.items() if abs(v) > truncation_threshold}
    return groups + [w2]


def iterative_error_generator_composition(errorgen_labels, rates,
                                          num_qubits=None,
                                          truncation_threshold=1e-14):
    """Compose a sequence of elementary error generators L1 @ L2 @ ... @ Lk
    and expand the result in elementary errorgen coefficients (reference:
    errgenproptools.iterative_error_generator_composition:6683 /
    iterative_error_generator_composition_numerical:7144).

    ANALYTIC: the exact sandwich-level product is formed first and projected
    once at the end (so no out-of-span parts are lost at intermediate
    steps), with polynomial cost at any qubit count
    (tools/errgenalgebra.iterative_composition_analytic).  Returns a list of
    (label, rate) tuples.
    """
    from pygsti_tpu_torch.tools import errgenalgebra as _ega
    labels = list(errorgen_labels)
    rates = list(rates)
    assert len(labels) == len(rates) and labels
    if num_qubits is None:
        num_qubits = labels[0].basis_element_labels[0].num_qubits
    if len(labels) == 1:
        return [(labels[0], rates[0])]
    proj = _ega.iterative_composition_analytic(labels, rates, num_qubits,
                                               truncation_threshold)
    return [(lbl, rate) for lbl, rate in proj.items()]


def iterative_error_generator_composition_numerical(errorgen_labels, rates,
                                                    num_qubits=None,
                                                    truncation_threshold=1e-14):
    """Dense-numerical oracle for iterative_error_generator_composition
    (16^n cost -- <= 3 qubits; used in tests)."""
    labels = list(errorgen_labels)
    rates = list(rates)
    assert len(labels) == len(rates) and labels
    if num_qubits is None:
        num_qubits = labels[0].basis_element_labels[0].num_qubits
    if len(labels) == 1:
        return [(labels[0], rates[0])]
    M = errorgen_label_to_dense(labels[0], num_qubits)
    w = rates[0]
    for lbl, r in zip(labels[1:], rates[1:]):
        M = M @ errorgen_label_to_dense(lbl, num_qubits)
        w = w * r
    proj = project_errorgen(w * M, num_qubits, tol=truncation_threshold)
    return [(lbl, rate) for lbl, rate in proj.items()]


def stabilizer_probability_correction(errorgen_dict, state_s, state_p,
                                      bitstring, order=1):
    """kth-order Taylor corrections to p(bitstring) for exp(L) acting on a
    stabilizer state, L = sum_j rate_j L_j (reference:
    errgenproptools.stabilizer_probability_correction:8374).

    ANALYTIC at every order: each (1/k!) <b| L^k(rho) |b> term is computed
    at the Pauli-sandwich level with the stabilizer amplitude oracle
    (tools/errgenalgebra.stabilizer_probability_correction_analytic) --
    polynomial in n, usable at 10+ qubits."""
    from pygsti_tpu_torch.tools import errgenalgebra as _ega
    return _ega.stabilizer_probability_correction_analytic(
        errorgen_dict, state_s, state_p, bitstring, order)


def stabilizer_probability_correction_numerical(errorgen_dict, state_s,
                                                state_p, bitstring, order=1):
    """Dense-numerical oracle for stabilizer_probability_correction (16^n
    cost -- <= 3 qubits; used in tests)."""
    bits = np.asarray(list(bitstring), np.int64)
    n = len(state_p) // 2
    amps = StabilizerAmplitudes(state_s, state_p)
    corr = 0.0
    for lbl, rate in errorgen_dict.items():
        corr += rate * alpha(lbl, state_s, state_p, bits, amps)
    if order >= 2:
        d = 2 ** n
        # dense |psi> from the amplitude cache, rho = |psi><psi|
        psi = np.array([amps.amplitude(np.array(
            [(k >> (n - 1 - q)) & 1 for q in range(n)], np.int64))
            for k in range(d)], complex)
        rho = np.outer(psi, np.conj(psi))
        L = np.zeros((d * d, d * d), complex)
        for lbl, rate in errorgen_dict.items():
            L = L + rate * errorgen_label_to_dense(lbl, n)
        b_idx = 0
        for q in range(n):
            b_idx = (b_idx << 1) | int(bits[q])
        vec = rho.reshape(-1)
        fact = 1.0
        for k in range(2, order + 1):
            fact *= k
            vec2 = vec
            for _ in range(k):
                vec2 = L @ vec2
            corr += np.real(vec2.reshape(d, d)[b_idx, b_idx]) / fact
    return float(corr)
