"""Lightweight n-qubit Pauli state / operator / outcome objects for idle
tomography (counterpart of pygsti_tpu/extras/idletomography/pauliobjs.py)."""

from __future__ import annotations

import numpy as np

_PAULI_CHARS = 'IXYZ'

# single-qubit Pauli products: _PROD[a][b] = (phase_exponent_of_i, c) with
# P_a P_b = i^k P_c
_PROD = {}
for _a in range(4):
    for _b in range(4):
        if _a == 0:
            _PROD[(_a, _b)] = (0, _b)
        elif _b == 0:
            _PROD[(_a, _b)] = (0, _a)
        elif _a == _b:
            _PROD[(_a, _b)] = (0, 0)
        else:
            _c = 6 - _a - _b  # {1,2,3} \ {a,b}
            # XY=iZ, YZ=iX, ZX=iY (cyclic); anticyclic gives -i
            _cyclic = (_a, _b) in ((1, 2), (2, 3), (3, 1))
            _PROD[(_a, _b)] = (1 if _cyclic else 3, _c)


class NQOutcome(object):
    """A string of 0s and 1s: an n-qubit measurement outcome (reference:
    pauliobjs.NQOutcome:25)."""

    @classmethod
    def weight_1_string(cls, n, i):
        """The outcome with a '1' in position i only."""
        bits = ['0'] * n
        bits[i] = '1'
        return cls(''.join(bits))

    @classmethod
    def weight_2_string(cls, n, i, j):
        bits = ['0'] * n
        bits[i] = '1'
        bits[j] = '1'
        return cls(''.join(bits))

    def __init__(self, string_rep):
        self.rep = str(string_rep)

    def __str__(self):
        return self.rep

    def __repr__(self):
        return "NQOutcome[%s]" % self.rep

    def __eq__(self, other):
        return self.rep == (other.rep if isinstance(other, NQOutcome)
                            else str(other))

    def __hash__(self):
        return hash(self.rep)

    def flip(self, *indices):
        """A copy with the given bit positions flipped (reference:
        NQOutcome.flip)."""
        bits = list(self.rep)
        for i in indices:
            bits[i] = '1' if bits[i] == '0' else '0'
        return NQOutcome(''.join(bits))


class NQPauliState(object):
    """An n-qubit product eigenstate of a Pauli string: a basis string like
    'XYZ' plus +-1 signs choosing which eigenstate per qubit (reference:
    pauliobjs.NQPauliState:86)."""

    def __init__(self, string_rep, signs=None):
        if isinstance(string_rep, NQPauliState):
            signs = string_rep.signs if signs is None else signs
            string_rep = string_rep.rep
        self.rep = str(string_rep).strip('+-')
        if signs is None:
            signs = (1,) * len(self.rep)
        self.signs = tuple(signs)
        assert len(self.signs) == len(self.rep)

    def __len__(self):
        return len(self.rep)

    def __str__(self):
        sign_chars = ''.join('+' if s >= 0 else '-' for s in self.signs)
        return "State[%s;%s]" % (self.rep, sign_chars)

    def __repr__(self):
        return str(self)

    def __eq__(self, other):
        return isinstance(other, NQPauliState) and self.rep == other.rep \
            and self.signs == other.signs

    def __hash__(self):
        return hash((self.rep, self.signs))

    def to_circuit(self, pauli_basis_dict):
        """Circuit preparing this state from |0...0> using the gate-name
        lists in `pauli_basis_dict` (keys '+X','-X','+Y',... -> tuple of
        gate names; reference: NQPauliState.to_circuit)."""
        from pygsti_tpu_torch.circuits import Circuit
        from pygsti_tpu_torch.baseobjs.label import Label
        layers = []
        max_len = 0
        per_qubit = []
        for i, (p, s) in enumerate(zip(self.rep, self.signs)):
            key = ('+' if s >= 0 else '-') + p
            gates = pauli_basis_dict.get(key, pauli_basis_dict.get(p, ()))
            per_qubit.append([Label(g, (i,)) for g in gates])
            max_len = max(max_len, len(per_qubit[-1]))
        for t in range(max_len):
            comp = [gq[t] for gq in per_qubit if t < len(gq)]
            layers.append(comp[0] if len(comp) == 1 else tuple(comp))
        return Circuit(layers, line_labels=tuple(range(len(self))))


class NQPauliOp(object):
    """A signed n-qubit Pauli operator, e.g. -'XIZ' (reference:
    pauliobjs.NQPauliOp:175)."""

    @classmethod
    def weight_1_pauli(cls, n, i, pauli):
        """Weight-1 Pauli: `pauli` ('X','Y','Z' or int 0='X', 1='Y', 2='Z' --
        the reference's indexing, pauliobjs.py:196) on qubit i."""
        p = 'XYZ'[pauli] if isinstance(pauli, int) else pauli
        chars = ['I'] * n
        chars[i] = p
        return cls(''.join(chars))

    @classmethod
    def weight_2_pauli(cls, n, i, j, pauli1, pauli2):
        p1 = 'XYZ'[pauli1] if isinstance(pauli1, int) else pauli1
        p2 = 'XYZ'[pauli2] if isinstance(pauli2, int) else pauli2
        chars = ['I'] * n
        chars[i] = p1
        chars[j] = p2
        return cls(''.join(chars))

    def __init__(self, string_rep, sign=1):
        if isinstance(string_rep, NQPauliOp):
            sign = string_rep.sign * sign
            string_rep = string_rep.rep
        self.rep = str(string_rep).lstrip('+-')
        self.sign = int(sign)

    def __len__(self):
        return len(self.rep)

    def __str__(self):
        return "%s%s" % ('-' if self.sign < 0 else '', self.rep)

    def __repr__(self):
        return str(self)

    def __eq__(self, other):
        if isinstance(other, str):
            return str(self) == other
        return isinstance(other, NQPauliOp) and self.rep == other.rep \
            and self.sign == other.sign

    def __hash__(self):
        return hash((self.rep, self.sign))

    def subpauli(self, indices):
        """A same-length operator keeping this op's letters at `indices` and
        'I' elsewhere (reference: pauliobjs.NQPauliOp.subpauli:270)."""
        keep = set(indices)
        return NQPauliOp(''.join(ch if i in keep else 'I'
                                 for i, ch in enumerate(self.rep)), self.sign)

    def dot(self, other):
        """Hilbert-Schmidt inner product <P, Q>/2^n: +-1 when equal up to
        sign, else 0 (reference: NQPauliOp.dot)."""
        other = NQPauliOp(other) if not isinstance(other, NQPauliOp) else other
        if self.rep == other.rep:
            return self.sign * other.sign
        return 0

    def statedot(self, state):
        """<P, rho_state-ish> sign bookkeeping: product over qubits of the
        per-qubit sign of Tr(P_i |s_i><s_i|) when P_i == basis_i, else 0
        (reference: NQPauliOp.statedot)."""
        assert isinstance(state, NQPauliState)
        total = 1
        for p, b, s in zip(self.rep, state.rep, state.signs):
            if p == 'I':
                continue
            if p != b:
                return 0
            total *= (1 if s >= 0 else -1)
        return self.sign * total

    def commuteswith(self, other):
        """Do the two Pauli strings commute? (reference:
        NQPauliOp.commuteswith)."""
        other = NQPauliOp(other) if not isinstance(other, NQPauliOp) else other
        anti = sum(1 for a, b in zip(self.rep, other.rep)
                   if a != 'I' and b != 'I' and a != b)
        return anti % 2 == 0

    def icommutator_over_2(self, other):
        """i[P, Q]/2 as an NQPauliOp, or None when they commute (reference:
        NQPauliOp.icommutator_over_2)."""
        other = NQPauliOp(other) if not isinstance(other, NQPauliOp) else other
        if self.commuteswith(other):
            return None
        # P Q = i^k R (per-qubit phases accumulate)
        k_total = 0
        chars = []
        for a, b in zip(self.rep, other.rep):
            k, c = _PROD[(_PAULI_CHARS.index(a), _PAULI_CHARS.index(b))]
            k_total = (k_total + k) % 4
            chars.append(_PAULI_CHARS[c])
        # i[P,Q]/2 = i P Q (when they anticommute) = i^(k+1) R
        k_total = (k_total + 1) % 4
        sign = {0: 1, 2: -1}[k_total]  # result must be Hermitian
        return NQPauliOp(''.join(chars), sign * self.sign * other.sign)
