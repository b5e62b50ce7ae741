"""Symbolic propagation of Lindblad error generators through Clifford
circuits (counterpart of pygsti_tpu/errorgenpropagation/errorpropagator.py;
reference: pygsti/errorgenpropagation/errorpropagator.py:48 +
tools/errgenproptools.py, the scalable 10+ qubit noisy-Clifford path).

Elementary error generators (H/S/C/A, arXiv:2103.01928) are labeled by Pauli
operators; conjugating by a Clifford C maps them to generators labeled by the
conjugated Paulis with signs:

    C L_P C^dag = sign(s) * L_{C(P)}

so pushing every layer's error generator to the end of the circuit only
requires the circuit's symplectic action on Pauli bitstrings -- integer
bit-vector arithmetic on the host (XOR/AND popcounts), and the basis of the
reference's 20-1000x speedups (CHANGELOG #687).

The combined end-of-circuit error generator is the BCH combination of the
propagated layer generators (first order: plain sum; second order adds
half-commutators).
"""

from __future__ import annotations

import collections

import numpy as np

from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.tools import symplectic as _sym


class PauliLabel(tuple):
    """An n-qubit Pauli as (x_bits, z_bits) integer bit masks (qubit 0 =
    least significant bit).  Hermitian convention: P = i^{x.z} X^x Z^z."""

    def __new__(cls, x_bits, z_bits, n):
        return tuple.__new__(cls, (int(x_bits), int(z_bits), int(n)))

    @property
    def x_bits(self):
        return self[0]

    @property
    def z_bits(self):
        return self[1]

    @property
    def num_qubits(self):
        return self[2]

    @classmethod
    def from_str(cls, s):
        """'XIZ' -> PauliLabel (leftmost char = qubit 0)."""
        x = z = 0
        for i, ch in enumerate(s):
            if ch in 'XY':
                x |= (1 << i)
            if ch in 'ZY':
                z |= (1 << i)
        return cls(x, z, len(s))

    def __str__(self):
        out = []
        for i in range(self.num_qubits):
            xb = (self.x_bits >> i) & 1
            zb = (self.z_bits >> i) & 1
            out.append('IXZY'[xb + 2 * zb] if xb + 2 * zb != 3 else 'Y')
        return "".join(out)

    @property
    def weight(self):
        return bin(self.x_bits | self.z_bits).count('1')

    def commutes_with(self, other):
        """Paulis commute iff the symplectic product is even."""
        sp = bin((self.x_bits & other.z_bits) ^ 0).count('1') \
            + bin((self.z_bits & other.x_bits)).count('1')
        return sp % 2 == 0

    def to_dense(self):
        n = self.num_qubits
        x = np.array([(self.x_bits >> i) & 1 for i in range(n)], np.int64)
        z = np.array([(self.z_bits >> i) & 1 for i in range(n)], np.int64)
        return _sym._pauli_matrix_from_vec(x, z, plain=False)  # Hermitian W


class ElementaryErrorgenLabel(tuple):
    """(typ, P) or (typ, P, Q) with typ in 'HSCA' and PauliLabel operands."""

    def __new__(cls, typ, p, q=None):
        return tuple.__new__(cls, (typ, p, q) if q is not None else (typ, p))

    @property
    def errorgen_type(self):
        return self[0]

    @property
    def basis_element_labels(self):
        return self[1:]

    def __str__(self):
        return "%s(%s)" % (self[0], ",".join(str(p) for p in self[1:]))


def canonicalize_errorgen_label(lbl, sign=1):
    """Canonical (label, sign) for an ElementaryErrorgenLabel: two-operand
    C/A labels get their Pauli operands (x, z)-lexicographically sorted --
    the convention of tools/errgenalgebra -- with the sign flipped for A on
    a swap (C(P,Q) == C(Q,P); A(P,Q) == -A(Q,P)), so coefficient
    accumulation merges mathematically equal generators (the reference
    leaves these under distinct keys)."""
    if lbl.errorgen_type in ('C', 'A') and len(lbl) == 3:
        p, q = lbl[1], lbl[2]
        kp = (p.x_bits, p.z_bits)
        kq = (q.x_bits, q.z_bits)
        if kq < kp:
            if lbl.errorgen_type == 'A':
                sign = -sign
            return ElementaryErrorgenLabel(lbl.errorgen_type, q, p), sign
    return lbl, sign


def _conjugate_pauli(s, p_vec, pauli, n):
    """Conjugate Hermitian Pauli W by Clifford (s, p_vec): returns
    (PauliLabel, sign in {+1,-1}).

    W(a) with a = (x|z); the image has bit-vector s @ a (mod 2); the phase
    follows Hostens-De Moor: for the plain operator i^e X^x Z^z built by
    multiplying the generator images (each gen X_j / Z_j contributing its
    column and phase), then re-expressed as a Hermitian Pauli.
    """
    x = np.array([(pauli.x_bits >> i) & 1 for i in range(n)], np.int64)
    z = np.array([(pauli.z_bits >> i) & 1 for i in range(n)], np.int64)
    # product of images: prod_j (C X_j C^dag)^{x_j} * prod_j (C Z_j C^dag)^{z_j}
    # each image C G_j C^dag = i^{p_col} X^{s_x_col} Z^{s_z_col} (plain conv.)
    acc_x = np.zeros(n, np.int64)
    acc_z = np.zeros(n, np.int64)
    acc_e = 0
    for j in range(n):
        if x[j]:
            col = j
            cx, cz = s[0:n, col], s[n:2 * n, col]
            acc_x, acc_z, acc_e = _sym._pauli_product_phase_exponent(
                acc_x, acc_z, acc_e, cx, cz, int(p_vec[col]))
    for j in range(n):
        if z[j]:
            col = n + j
            cx, cz = s[0:n, col], s[n:2 * n, col]
            acc_x, acc_z, acc_e = _sym._pauli_product_phase_exponent(
                acc_x, acc_z, acc_e, cx, cz, int(p_vec[col]))
    # source W(a) = i^{x.z} X^x Z^z, so conj = i^{x.z} * (computed product).
    # Re-express computed (i^{acc_e} X^{acc_x} Z^{acc_z}) as sign * W(a'):
    # W(a') = i^{x'.z'} X^{x'} Z^{z'}  =>  sign = i^{x.z + acc_e - x'.z'}
    e_total = (int(np.dot(x, z)) + acc_e - int(np.dot(acc_x, acc_z))) % 4
    assert e_total in (0, 2), "Pauli conjugation produced non-real phase"
    sign = 1 if e_total == 0 else -1
    xb = int(sum(int(b) << i for i, b in enumerate(acc_x)))
    zb = int(sum(int(b) << i for i, b in enumerate(acc_z)))
    return PauliLabel(xb, zb, n), sign


def _pauli_product(p1, p2, n):
    """Product of Hermitian Paulis: W1 W2 = i^e W3; returns (W3, e mod 4)."""
    x1 = np.array([(p1.x_bits >> i) & 1 for i in range(n)], np.int64)
    z1 = np.array([(p1.z_bits >> i) & 1 for i in range(n)], np.int64)
    x2 = np.array([(p2.x_bits >> i) & 1 for i in range(n)], np.int64)
    z2 = np.array([(p2.z_bits >> i) & 1 for i in range(n)], np.int64)
    x, z, e = _sym._pauli_product_phase_exponent(
        x1, z1, int(np.dot(x1, z1)), x2, z2, int(np.dot(x2, z2)))
    e = (e - int(np.dot(x, z))) % 4
    xb = int(sum(int(b) << i for i, b in enumerate(x)))
    zb = int(sum(int(b) << i for i, b in enumerate(z)))
    return PauliLabel(xb, zb, n), e


class ErrorGeneratorPropagator(object):
    """Propagate per-layer Lindblad error generators to the circuit end.

    The model must provide per-layer error generator coefficients via
    ``layer_errorgen_coefficients(layer_label) -> {ElementaryErrorgenLabel:
    coeff}``; for crosstalk-free models built with
    ``create_crosstalk_free_model(..., lindblad_error_coeffs=...)`` use
    :meth:`from_crosstalk_free_spec`.
    """

    def __init__(self, model=None, layer_coeff_fn=None, num_qubits=None,
                 srep_dict=None):
        self.model = model
        self._layer_coeff_fn = layer_coeff_fn
        self.num_qubits = num_qubits
        self._srep_dict = srep_dict

    @classmethod
    def from_errorgen_dict(cls, gate_errorgens, num_qubits, qubit_labels=None):
        """gate_errorgens: {gate Label (or name): {('H'|'S', pauli_str): coeff}}
        with pauli strings on the gate's target qubits."""
        qubit_labels = tuple(qubit_labels) if qubit_labels is not None \
            else tuple(range(num_qubits))
        qindex = {q: i for i, q in enumerate(qubit_labels)}

        def layer_coeffs(layer):
            comps = layer.components if not layer.is_simple else (layer,)
            out = {}
            for comp in comps:
                spec = gate_errorgens.get(Label(comp))
                if spec is None:
                    spec = gate_errorgens.get(comp.name)
                if spec is None:
                    continue
                targets = [qindex[q] for q in (comp.sslbls or qubit_labels)]
                for (typ, *paulis), coeff in spec.items():
                    embedded = []
                    for pstr in paulis:
                        x = z = 0
                        for local_i, ch in enumerate(pstr):
                            gq = targets[local_i]
                            if ch in 'XY':
                                x |= (1 << gq)
                            if ch in 'ZY':
                                z |= (1 << gq)
                        embedded.append(PauliLabel(x, z, num_qubits))
                    lbl, csign = canonicalize_errorgen_label(
                        ElementaryErrorgenLabel(typ, *embedded))
                    # pyGSTi coefficients are w.r.t. gate-locally NORMALIZED
                    # Paulis (P / sqrt(2^k)); internally rates are stored in
                    # UNNORMALIZED-Pauli units: H scales 1/sqrt(2^k),
                    # S/C/A scale 1/2^k
                    k = len(paulis[0])
                    scale = (2.0 ** k) ** -0.5 if typ == 'H' else (2.0 ** k) ** -1
                    out[lbl] = out.get(lbl, 0.0) + csign * coeff * scale
            return out

        return cls(layer_coeff_fn=layer_coeffs, num_qubits=num_qubits)

    def _circuit_sreps(self, circuit, pspec=None):
        srep_dict = self._srep_dict or dict(
            _sym.compute_internal_gate_symplectic_representations())
        if pspec is not None:
            srep_dict.update(pspec.compute_clifford_symplectic_reps())
        return srep_dict

    def _suffix_cliffords(self, circuit, pspec=None):
        """Symplectic (s, p) pairs for the suffix Clifford after each layer:
        suffixes[t] = product of layers t+1..D-1 (identity for the last)."""
        n = self.num_qubits
        srep_dict = self._circuit_sreps(circuit, pspec)
        q_labels = list(circuit.line_labels) if circuit.line_labels != ('*',) \
            else list(range(n))
        layers = list(circuit.layertup)
        D = len(layers)
        s_cur = np.identity(2 * n, np.int64)
        p_cur = np.zeros(2 * n, np.int64)
        suffixes = [None] * D
        for t in range(D - 1, -1, -1):
            suffixes[t] = (s_cur.copy(), p_cur.copy())
            s_l, p_l = _sym.symplectic_rep_of_clifford_layer(
                layers[t], n, q_labels, srep_dict)
            s_cur, p_cur = _sym.compose_cliffords(s_l, p_l, s_cur, p_cur)
        return layers, suffixes

    def _propagate_label(self, lbl, s_suf, p_suf):
        """Push one elementary errorgen label through a Clifford (s, p):
        returns (new_label, phase) with phase in {+1, -1} (the reference's
        per-label rate under fixed_rate=1; errorpropagator.py:394-500).
        C/A operands are canonicalized ((x, z)-lexicographic, matching
        tools/errgenalgebra's label convention) so mathematically equal
        generators -- C(P,Q)==C(Q,P), A(P,Q)==-A(Q,P) -- accumulate under
        one dict key."""
        n = self.num_qubits
        new_paulis = []
        sign = 1
        for p in lbl.basis_element_labels:
            p2, s2 = _conjugate_pauli(s_suf, p_suf, p, n)
            new_paulis.append(p2)
            sign *= s2
        if lbl.errorgen_type == 'S':
            sign = 1  # S_P invariant under P -> -P
        return canonicalize_errorgen_label(
            ElementaryErrorgenLabel(lbl.errorgen_type, *new_paulis), sign)

    def errorgen_transform_maps(self, circuit, pspec=None,
                                input_labels_by_layer=None):
        """Per-input-layer maps {(input_label, layer_idx): (output_label,
        phase)} describing how each layer's error generators transform when
        propagated to the end of the circuit (reference:
        errorpropagator.errorgen_transform_maps:445, fixed_rate=1 semantics
        so the 'rate' is the accumulated +/-1 phase).

        input_labels_by_layer optionally supplies the labels to map for each
        layer; by default the model's own layer errorgen labels are used.

        NOTE: layer indices count only GATE layers -- unlike the reference's
        default (include_spam=True), no prep/measure errorgen layers are
        prepended/appended, so reference layer index i+1 corresponds to
        index i here.
        """
        layers, suffixes = self._suffix_cliffords(circuit, pspec)
        if input_labels_by_layer is not None:
            assert len(input_labels_by_layer) == len(layers), \
                ("input_labels_by_layer has %d entries but the circuit has "
                 "%d layers" % (len(input_labels_by_layer), len(layers)))
        maps = []
        for t, layer in enumerate(layers):
            if input_labels_by_layer is not None:
                labels = input_labels_by_layer[t]
            else:
                assert self._layer_coeff_fn is not None, \
                    "Need layer errorgen labels (use from_errorgen_dict) " \
                    "or pass input_labels_by_layer"
                labels = list(self._layer_coeff_fn(layer).keys())
            s_suf, p_suf = suffixes[t]
            m = {}
            for lbl in labels:
                new_lbl, phase = self._propagate_label(lbl, s_suf, p_suf)
                m[(lbl, t)] = (new_lbl, phase)
            maps.append(m)
        return maps

    def errorgen_transform_map(self, circuit, pspec=None,
                               input_labels_by_layer=None):
        """Flattened union of :meth:`errorgen_transform_maps` — one dict
        keyed on (input_label, layer_idx) (reference:
        errorpropagator.errorgen_transform_map:394)."""
        out = {}
        for m in self.errorgen_transform_maps(circuit, pspec,
                                              input_labels_by_layer):
            out.update(m)
        return out

    def propagate_errorgens(self, circuit, pspec=None, bch_order=1,
                            include_spam=False):
        """Propagate every layer's error generator through the rest of the
        circuit; returns the end-of-circuit combined generator as
        {ElementaryErrorgenLabel: coeff} (reference:
        errorpropagator.propagate_errorgens).

        include_spam=True (the reference's default) -- propagating prep and
        measurement errorgen layers as extra first/last layers -- is NOT
        implemented here (this propagator has no SPAM errorgen source);
        requesting it raises rather than silently dropping the SPAM layers.
        """
        if include_spam:
            raise NotImplementedError(
                "SPAM errorgen-layer propagation (reference "
                "errorpropagator.py include_spam=True) is not implemented; "
                "call with include_spam=False and handle SPAM layers "
                "separately.")
        assert self._layer_coeff_fn is not None, \
            "Need layer error-generator coefficients (use from_errorgen_dict)"
        layers, suffixes = self._suffix_cliffords(circuit, pspec)
        D = len(layers)

        propagated_by_layer = []
        for t, layer in enumerate(layers):
            coeffs = self._layer_coeff_fn(layer)
            if not coeffs:
                propagated_by_layer.append({})
                continue
            s_suf, p_suf = suffixes[t]
            out = {}
            for lbl, coeff in coeffs.items():
                new_lbl, sign = self._propagate_label(lbl, s_suf, p_suf)
                out[new_lbl] = out.get(new_lbl, 0.0) + sign * coeff
            propagated_by_layer.append(out)

        # BCH combination
        total = {}
        for d in propagated_by_layer:
            for lbl, c in d.items():
                total[lbl] = total.get(lbl, 0.0) + c
        if bch_order >= 2:
            # second-order Magnus/BCH: (1/2) sum_{t1 < t2} [L_t2, L_t1],
            # via the full ANALYTIC elementary-errorgen commutator (all
            # H/S/C/A type pairs; tools/errgenalgebra.py) -- polynomial
            # cost at any qubit count (reference:
            # errgenproptools.bch_approximation:100 order 2).
            from pygsti_tpu_torch.tools import errgenalgebra as _ega
            for t2 in range(D):
                if not propagated_by_layer[t2]:
                    continue
                for t1 in range(t2):
                    if not propagated_by_layer[t1]:
                        continue
                    comm = _ega.layer_commutator_analytic(
                        propagated_by_layer[t2], propagated_by_layer[t1],
                        self.num_qubits, weight=0.5)
                    for lbl, c in comm.items():
                        total[lbl] = total.get(lbl, 0.0) + c
        return {k: v for k, v in total.items() if abs(v) > 1e-15}

    def errorgen_to_dense(self, errorgen_dict, basis='pp'):
        """Dense superoperator of an errorgen dict (for <= ~5 qubits)."""
        from pygsti_tpu_torch.tools import lindbladtools as _lt
        from pygsti_tpu_torch.tools.basistools import change_basis
        n = self.num_qubits
        d2 = 4 ** n
        out = np.zeros((d2, d2))
        for lbl, coeff in errorgen_dict.items():
            paulis = [p.to_dense() for p in lbl.basis_element_labels]
            typ = lbl.errorgen_type
            if typ in ('H', 'S'):
                eg = _lt.create_elementary_errorgen(typ, paulis[0])
            else:
                eg = _lt.create_elementary_errorgen(typ, paulis[0], paulis[1])
            out += coeff * np.real(change_basis(eg, 'std', basis))
        return out

    def approximate_circuit_channel(self, circuit, pspec=None, bch_order=1,
                                    basis='pp'):
        """Dense end-of-circuit channel approx: exp(L_total) @ C_ideal
        (for verification at small qubit counts)."""
        import scipy.linalg as spl
        from pygsti_tpu_torch.tools import optools as _ot
        errs = self.propagate_errorgens(circuit, pspec, bch_order)
        L = self.errorgen_to_dense(errs, basis)
        # ideal circuit unitary superop
        srep_dict = self._circuit_sreps(circuit, pspec)
        from pygsti_tpu_torch.tools.internalgates import standard_gatename_unitaries
        std = standard_gatename_unitaries()
        n = self.num_qubits
        U = np.eye(2 ** n, dtype=complex)
        q_labels = list(circuit.line_labels) if circuit.line_labels != ('*',) \
            else list(range(n))
        qindex = {q: i for i, q in enumerate(q_labels)}
        for layer in circuit.layertup:
            comps = layer.components if not layer.is_simple else (layer,)
            layer_u = np.eye(2 ** n, dtype=complex)
            for comp in comps:
                u = std[comp.name]
                targets = [qindex[q] for q in (comp.sslbls or q_labels)]
                # embed at the unitary level via kron/permutation
                layer_u = _embed_unitary(u, targets, n) @ layer_u
            U = layer_u @ U
        ideal_super = np.real(_ot.unitary_to_superop(U, basis)) if basis == 'pp' \
            else _ot.unitary_to_superop(U, basis)
        return spl.expm(L) @ ideal_super


def _embed_unitary(u, targets, n):
    """Embed a k-qubit unitary on `targets` into n qubits."""
    k = int(round(np.log2(u.shape[0])))
    assert len(targets) == k
    other = [i for i in range(n) if i not in targets]
    full = np.kron(u, np.eye(2 ** len(other), dtype=complex))
    order = list(targets) + other
    inv = [0] * n
    for newpos, srcpos in enumerate(order):
        inv[srcpos] = newpos
    full = full.reshape([2] * n + [2] * n)
    full = np.transpose(full, inv + [p + n for p in inv])
    return full.reshape(2 ** n, 2 ** n)
