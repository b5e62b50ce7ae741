"""Idle tomography (counterpart of pygsti_tpu/extras/idletomography/idtcore.py).

Characterizes the idle operation's error generator: prepare Pauli
eigenstates, idle N times, measure Pauli observables; the slopes of
<observable> vs N are linear in the idle's intrinsic error rates.  The
reference inverts a combinatorially-constructed Jacobian
(hamiltonian/stochastic/affine_jac_element, idtcore.py:39-290); here the
same Jacobian is built NUMERICALLY from elementary error-generator
superoperators (design matrix M[(prep,meas), (type,P)] = d<meas>/dN under
rate (type,P)) and least-squares inverted -- the same estimator, with the
Pauli combinatorics replaced by dense linear algebra.

Intrinsic rates extracted per qubit: hamiltonian H_P, stochastic S_P and
affine A_P for P in {X,Y,Z} (9 rates from the 9 (prep,meas) slope
observations).  With ``maxweight=2``, weight-2 correlated stochastic rates
S_{PQ} are extracted per qubit pair from joint-parity decay slopes with the
weight-1 contributions subtracted (reference: maxweight=2 fidpairs,
idtcore.py:294 idle_tomography_fidpairs).
"""

from __future__ import annotations

import collections
import itertools

import numpy as np

from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.protocols.protocol import ExperimentDesign, Protocol, ProtocolResults
from pygsti_tpu_torch.tools.lindbladtools import create_elementary_errorgen


# 1-qubit Pauli-basis preparation/measurement fiducials in terms of
# Gxpi2/Gypi2 words: prep maps |0> to the +1 eigenstate; meas rotates the
# observable's eigenbasis onto Z.
_PREP_WORDS = {
    'X': [('Gypi2',)],          # |+>  (Y(pi/2)|0> = (|0>+|1>)/sqrt2)
    'Y': [('Gxpi2',), ('Gxpi2',), ('Gxpi2',)],  # |+i> via X(-pi/2) = X(pi/2)^3
    'Z': [],
}
_MEAS_WORDS = {
    'X': [('Gypi2',), ('Gypi2',), ('Gypi2',)],  # rotate X -> Z
    'Y': [('Gxpi2',)],                          # rotate Y -> Z
    'Z': [],
}

_PAULIS = {
    'I': np.eye(2, dtype=complex),
    'X': np.array([[0, 1], [1, 0]], dtype=complex),
    'Y': np.array([[0, -1j], [1j, 0]], dtype=complex),
    'Z': np.array([[1, 0], [0, -1]], dtype=complex),
}
_EIGENSTATES = {  # +1 eigenstate density matrices
    'X': 0.5 * (np.eye(2) + _PAULIS['X']),
    'Y': 0.5 * (np.eye(2) + _PAULIS['Y']),
    'Z': 0.5 * (np.eye(2) + _PAULIS['Z']),
}


def _word_to_labels(word, qubit):
    return [Label(g[0], qubit) for g in word]


def _affine_gen(p):
    """Affine elementary generator: rho -> tr(rho) * P (std superop)."""
    d = p.shape[0]
    return np.outer(p.reshape(-1), np.eye(d, dtype=complex).reshape(-1))


def _kron_pauli(letters):
    m = _PAULIS[letters[0]]
    for c in letters[1:]:
        m = np.kron(m, _PAULIS[c])
    return m


def _slope(L, rho, obs):
    """d<obs>/dN for error generator superop L (std basis): tr(obs L(rho))."""
    d = rho.shape[0]
    out = (L @ rho.reshape(-1)).reshape(d, d)
    return float(np.real(np.trace(obs @ out)))


def _weight1_design_matrix():
    """[9 obs, 9 rates] matrix: rows (prep,meas) in XYZ x XYZ order; cols
    (typ,P) for typ in H,S,A and P in X,Y,Z."""
    rows = []
    cols = [(t, P) for t in ('H', 'S', 'A') for P in 'XYZ']
    gens = {}
    for t, P in cols:
        if t == 'A':
            gens[(t, P)] = _affine_gen(_PAULIS[P])
        else:
            gens[(t, P)] = create_elementary_errorgen(t, _PAULIS[P])
    M = np.zeros((9, 9))
    for i, (prep, meas) in enumerate(itertools.product('XYZ', 'XYZ')):
        rho = _EIGENSTATES[prep]
        obs = _PAULIS[meas]
        for j, key in enumerate(cols):
            M[i, j] = _slope(gens[key], rho, obs)
    return M, cols


def _pair_observation_rows():
    """The 27 (prep-pair, observable) rows used for weight-2 analysis: for
    each same-basis prep (P,Q), the joint parity <P(x)Q> plus the two
    marginals <P(x)I> and <I(x)Q> (a weight-2 S rate never damps its own
    joint observable -- they commute -- so marginals are needed for an
    identifiable design)."""
    rows = []
    for p1, p2 in itertools.product('XYZ', 'XYZ'):
        rho = np.kron(_EIGENSTATES[p1], _EIGENSTATES[p2])
        rows.append(((p1, p2), 'joint', rho, _kron_pauli((p1, p2))))
        rows.append(((p1, p2), 'marg1', rho, _kron_pauli((p1, 'I'))))
        rows.append(((p1, p2), 'marg2', rho, _kron_pauli(('I', p2))))
    return rows


def _weight2_s_design_matrix():
    """[27 obs, 9 weight-2 S rates] over the _pair_observation_rows."""
    combos = list(itertools.product('XYZ', 'XYZ'))
    gens = {c: create_elementary_errorgen('S', _kron_pauli(c)) for c in combos}
    rows = _pair_observation_rows()
    M = np.zeros((len(rows), 9))
    for i, (_, _, rho, obs) in enumerate(rows):
        for j, c in enumerate(combos):
            M[i, j] = _slope(gens[c], rho, obs)
    return M, combos


def _embed_1local_superop(S1, which):
    """Embed a 1-qubit std-basis superop as acting on qubit `which` (0/1) of
    a 2-qubit system (identity on the other)."""
    out = np.zeros((16, 16), complex)
    for a in range(2):
        for b in range(2):
            for ap in range(2):
                for bp in range(2):
                    col = (a * 2 + b) * 4 + (ap * 2 + bp)
                    for x in range(2):
                        for xp in range(2):
                            if which == 0:
                                amp = S1[x * 2 + xp, a * 2 + ap]
                                row = (x * 2 + b) * 4 + (xp * 2 + bp)
                            else:
                                amp = S1[x * 2 + xp, b * 2 + bp]
                                row = (a * 2 + x) * 4 + (ap * 2 + xp)
                            out[row, col] += amp
    return out


def _joint_pair_design():
    """Joint design for one qubit pair: 45 observation rows x 27 unknowns
    [w1 rates on a (9), w1 rates on b (9), weight-2 S rates (9)].

    Rows: the 9 single-qubit (prep,meas) slopes for each of the two qubits
    (with the OTHER qubit idling in |0>, so correlated errors contribute --
    fitting jointly untangles weight-1 from weight-2 contributions, as the
    reference's global Jacobian inversion does) + the 27 pair rows.
    Returns (M [45,27], col_keys, row_specs)."""
    w1_cols = [(t, P) for t in ('H', 'S', 'A') for P in 'XYZ']
    w2_cols = list(itertools.product('XYZ', 'XYZ'))
    gens_1q = {}
    for t, P in w1_cols:
        gens_1q[(t, P)] = _affine_gen(_PAULIS[P]) if t == 'A' \
            else create_elementary_errorgen(t, _PAULIS[P])
    emb = {0: {k: _embed_1local_superop(g, 0) for k, g in gens_1q.items()},
           1: {k: _embed_1local_superop(g, 1) for k, g in gens_1q.items()}}
    gens_2q = {c: create_elementary_errorgen('S', _kron_pauli(c))
               for c in w2_cols}

    rho0 = _EIGENSTATES['Z']  # |0><0|
    row_specs = []  # ('single', which, prep, meas) or ('pair', kind, (p1,p2))
    rows = []       # (rho, obs)
    for which in (0, 1):
        for prep, meas in itertools.product('XYZ', 'XYZ'):
            if which == 0:
                rho = np.kron(_EIGENSTATES[prep], rho0)
                obs = _kron_pauli((meas, 'I'))
            else:
                rho = np.kron(rho0, _EIGENSTATES[prep])
                obs = _kron_pauli(('I', meas))
            row_specs.append(('single', which, prep, meas))
            rows.append((rho, obs))
    for (p1, p2), kind, rho, obs in _pair_observation_rows():
        row_specs.append(('pair', kind, (p1, p2)))
        rows.append((rho, obs))

    col_keys = [('a',) + k for k in w1_cols] + [('b',) + k for k in w1_cols] \
        + [('S', c) for c in w2_cols]
    M = np.zeros((len(rows), len(col_keys)))
    for i, (rho, obs) in enumerate(rows):
        j = 0
        for k in w1_cols:
            M[i, j] = _slope(emb[0][k], rho, obs)
            j += 1
        for k in w1_cols:
            M[i, j] = _slope(emb[1][k], rho, obs)
            j += 1
        for c in w2_cols:
            M[i, j] = _slope(gens_2q[c], rho, obs)
            j += 1
    return M, col_keys, row_specs


class IdleTomographyDesign(ExperimentDesign):
    """Pauli prep + idle^N + Pauli meas circuits, per qubit and (for
    maxweight=2) per qubit pair (reference: make_idle_tomography_list,
    idtcore.py:660)."""

    def __init__(self, qubit_labels, max_lengths=(0, 1, 2, 4, 8), paulis=('X', 'Y', 'Z'),
                 idle_label=None, maxweight=1):
        self.qubit_labels_list = tuple(qubit_labels)
        self.max_lengths = list(max_lengths)
        self.paulis = list(paulis)
        self.maxweight = maxweight
        self.idle_label = idle_label if idle_label is not None else Label(())
        circuits = []
        self.circuit_table = {}   # (qubit, prep, meas, N) -> circuit
        self.pair_table = {}      # ((q1,q2), (P,Q), N) -> circuit
        lls = self.qubit_labels_list
        for q in self.qubit_labels_list:
            for prep_p in self.paulis:
                for meas_p in self.paulis:
                    for N in self.max_lengths:
                        layers = (_word_to_labels(_PREP_WORDS[prep_p], q)
                                  + [self.idle_label] * N
                                  + _word_to_labels(_MEAS_WORDS[meas_p], q))
                        c = Circuit(layers, lls)
                        self.circuit_table[(q, prep_p, meas_p, N)] = c
                        circuits.append(c)
        if maxweight >= 2 and len(self.qubit_labels_list) >= 2:
            for q1, q2 in itertools.combinations(self.qubit_labels_list, 2):
                for p1 in self.paulis:
                    for p2 in self.paulis:
                        for N in self.max_lengths:
                            layers = (_word_to_labels(_PREP_WORDS[p1], q1)
                                      + _word_to_labels(_PREP_WORDS[p2], q2)
                                      + [self.idle_label] * N
                                      + _word_to_labels(_MEAS_WORDS[p1], q1)
                                      + _word_to_labels(_MEAS_WORDS[p2], q2))
                            c = Circuit(layers, lls)
                            self.pair_table[((q1, q2), (p1, p2), N)] = c
                            circuits.append(c)
        # dedupe
        seen, uniq = set(), []
        for c in circuits:
            if c not in seen:
                seen.add(c)
                uniq.append(c)
        super().__init__(uniq, qubit_labels)


class IdleTomographyProtocolResults(ProtocolResults):
    def __init__(self, data, protocol_instance, intrinsic_rates, observed_slopes,
                 pair_rates=None):
        super().__init__(data, protocol_instance)
        self.intrinsic_rates = intrinsic_rates    # {qubit: {('H','X'):..}}
        self.observed_slopes = observed_slopes
        self.pair_rates = pair_rates or {}        # {(q1,q2): {('S',('X','X')):..}}

    def __str__(self):
        lines = ["Idle tomography intrinsic rates:"]
        for q, rates in self.intrinsic_rates.items():
            lines.append("  qubit %s: %s" % (q, {k: round(v, 5)
                                                 for k, v in rates.items()}))
        for pair, rates in self.pair_rates.items():
            big = {k: round(v, 5) for k, v in rates.items()
                   if abs(v) > 1e-4}
            lines.append("  pair %s correlated rates: %s" % (pair, big))
        return "\n".join(lines)


class IdleTomography(Protocol):
    """Fit intrinsic idle-error rates from IdleTomographyDesign data via
    least-squares inversion of the numerically-built rate->slope Jacobian
    (reference: do_idle_tomography, idtcore.py:1040)."""

    def __init__(self, name=None):
        super().__init__(name)

    def run(self, data, memlimit=None, comm=None):
        design = data.edesign
        ds = data.dataset
        qpos = {q: i for i, q in enumerate(design.qubit_labels_list)}
        Ns = np.array(design.max_lengths, dtype=float)

        def expectation(circ, qubits):
            """<Z...Z> parity over `qubits` after the meas rotations."""
            row = ds[circ]
            total = row.total
            idxs = [qpos[q] for q in qubits]
            exp = 0.0
            for outcome, cnt in row.counts.items():
                bits = outcome[0]
                par = sum(int(bits[i]) for i in idxs) % 2
                exp += (1 - 2 * par) * cnt
            return exp / total if total > 0 else 0.0

        def fit_slope(vals):
            return np.polyfit(Ns, vals, 1)[0] if len(Ns) > 1 else 0.0

        M1, cols1 = _weight1_design_matrix()
        observed_slopes = collections.OrderedDict()
        intrinsic = collections.OrderedDict()
        for q in design.qubit_labels_list:
            slopes = {}
            svec = np.zeros(9)
            for i, (prep_p, meas_p) in enumerate(
                    itertools.product('XYZ', 'XYZ')):
                vals = [expectation(design.circuit_table[(q, prep_p, meas_p, N)],
                                    (q,))
                        for N in design.max_lengths]
                slopes[(prep_p, meas_p)] = svec[i] = fit_slope(vals)
            observed_slopes[q] = slopes
            rates_vec, *_ = np.linalg.lstsq(M1, svec, rcond=None)
            rates = collections.OrderedDict(zip(cols1, rates_vec))
            # legacy convenience aliases
            for P in 'XYZ':
                rates['decay_%s' % P] = -slopes[(P, P)]
                rates['H_%s' % P] = rates[('H', P)]
                rates['S_%s' % P] = rates[('S', P)]
            intrinsic[q] = rates

        pair_rates = collections.OrderedDict()
        if getattr(design, 'pair_table', None):
            M2, col_keys, row_specs = _joint_pair_design()
            pairs = sorted({k[0] for k in design.pair_table})
            for pair in pairs:
                q1, q2 = pair
                svec = np.zeros(len(row_specs))
                for i, spec in enumerate(row_specs):
                    if spec[0] == 'single':
                        _, which, prep, meas = spec
                        q = pair[which]
                        vals = [expectation(
                            design.circuit_table[(q, prep, meas, N)], (q,))
                            for N in design.max_lengths]
                    else:
                        _, kind, (p1, p2) = spec
                        qubits = pair if kind == 'joint' else \
                            ((q1,) if kind == 'marg1' else (q2,))
                        vals = [expectation(
                            design.pair_table[(pair, (p1, p2), N)], qubits)
                            for N in design.max_lengths]
                    svec[i] = fit_slope(vals)
                rates_vec, *_ = np.linalg.lstsq(M2, svec, rcond=None)
                fitted = collections.OrderedDict(zip(col_keys, rates_vec))
                pair_rates[pair] = collections.OrderedDict(
                    (k, v) for k, v in fitted.items() if k[0] == 'S'
                    and isinstance(k[1], tuple))
        return IdleTomographyProtocolResults(data, self, intrinsic,
                                             observed_slopes, pair_rates)


def run_idle_tomography_protocol(nqubits, dataset, max_lengths, maxweight=2):
    """Protocol-object convenience wrapper: build the IdleTomographyDesign
    for `nqubits` / `max_lengths`, match it against `dataset`, and return an
    IdleTomographyProtocolResults with per-qubit H/S/A rates."""
    qubit_labels = list(range(nqubits)) if isinstance(nqubits, int) else list(nqubits)
    design = IdleTomographyDesign(qubit_labels, max_lengths,
                                  maxweight=maxweight)
    from pygsti_tpu_torch.protocols.protocol import ProtocolData
    data = ProtocolData(design, dataset)
    return IdleTomography().run(data)


# =============================================================================
# Reference-parity functional API: analytic Pauli-combinatoric Jacobian
# elements, fiducial-pair generation, experiment lists, observed-rate fits,
# and `do_idle_tomography` (reference: idtcore.py:39-1425).  Unlike the
# protocol classes above (which build the Jacobian numerically from dense
# error-generator superoperators), these compute each Jacobian element
# analytically from Pauli commutation relations -- polynomial cost at any
# qubit count.
# =============================================================================

from pygsti_tpu_torch.extras.idletomography import idttools as _idttools  # noqa: E402
from pygsti_tpu_torch.extras.idletomography import pauliobjs as _pobjs  # noqa: E402
from pygsti_tpu_torch.extras.idletomography.idtresults import (  # noqa: E402
    IdleTomographyResults)


def hamiltonian_jac_element(prep, error, observable):
    """d<observable>/d(rate of Hamiltonian `error`) in state `prep`:
    Tr(i[err, obs]/2 * rho_prep) (reference: idtcore.py:39)."""
    com = error.icommutator_over_2(observable)
    return 0 if (com is None) else com.statedot(prep)


def stochastic_outcome(prep, error, meas):
    """The outcome produced when stochastic `error` occurs between preparing
    `prep` and measuring in basis `meas` (same Pauli basis up to signs):
    per qubit, an error that anticommutes with the basis Pauli flips the
    expected bit (reference: idtcore.py:69)."""
    bits = []
    for s1, p1, s2, p2, err in zip(prep.signs, prep.rep, meas.signs,
                                   meas.rep, error.rep):
        assert p1 == p2, "Stochastic outcomes must prep & measure along same bases!"
        commutes = (err == 'I') or (err == p1)
        if commutes:
            bits.append('0' if s1 == s2 else '1')
        else:
            bits.append('1' if s1 == s2 else '0')
    return _pobjs.NQOutcome(''.join(bits))


def stochastic_jac_element(prep, error, meas, outcome):
    """dP(outcome)/d(rate of stochastic `error`): 1 when `error` maps the
    prep onto `outcome`, else 0 (reference: idtcore.py:128)."""
    return 1 if stochastic_outcome(prep, error, meas) == outcome else 0


def affine_jac_element(prep, error, meas, outcome):
    """dP(outcome)/d(rate of affine `error`) when prepping `prep` and
    measuring basis `meas` (reference: idtcore.py:155).  An affine error
    acts as the identity on 'I' letters and replaces the state with the
    error Pauli elsewhere."""
    def helper(prep_sign, prep_basis, error_pauli, meas_sign, meas_basis,
               outcome_bit):
        assert prep_basis in ('X', 'Y', 'Z') and meas_basis in ('X', 'Y', 'Z')
        outsign = 1 if outcome_bit == '0' else -1
        if error_pauli == 'I':
            if prep_basis == meas_basis:
                return 1 if (prep_sign * meas_sign * outsign == 1) else 0
            return 1
        if meas_basis != error_pauli:
            return 0
        return meas_sign if outcome_bit == '0' else -meas_sign

    return int(np.prod([helper(s1, p1, err, s2, p2, o)
                        for s1, p1, s2, p2, err, o
                        in zip(prep.signs, prep.rep, meas.signs, meas.rep,
                               error.rep, outcome.rep)]))


def affine_jac_obs_element(prep, error, observable):
    """d<observable>/d(rate of affine `error`) in state `prep`
    (reference: idtcore.py:234)."""
    def helper(prep_sign, prep_basis, error_pauli, obs_pauli):
        assert prep_basis in ('X', 'Y', 'Z')
        if obs_pauli == 'I':
            return 1 if error_pauli == 'I' else 0
        if error_pauli == 'I':
            return prep_sign if prep_basis == obs_pauli else 0
        return 2 if obs_pauli == error_pauli else 0

    return int(np.prod([helper(s1, p1, err, o) for s1, p1, err, o
                        in zip(prep.signs, prep.rep, error.rep,
                               observable.rep)]))


def idle_tomography_fidpairs(nqubits, maxweight=2, include_hamiltonian=True,
                             include_stochastic=True, include_affine=True,
                             ham_tmpl="auto",
                             preferred_prep_basis_signs=("+", "+", "+"),
                             preferred_meas_basis_signs=("+", "+", "+")):
    """The standard (prep, meas) NQPauliState fiducial pairs probing
    Hamiltonian / stochastic / affine idle errors (reference:
    idtcore.idle_tomography_fidpairs:294)."""
    fidpairs = []

    def conv(x):
        return 1 if x == "+" else -1
    base_prep_signs = {l: conv(s) for l, s in
                       zip(('X', 'Y', 'Z'), preferred_prep_basis_signs)}
    base_meas_signs = {l: conv(s) for l, s in
                       zip(('X', 'Y', 'Z'), preferred_meas_basis_signs)}

    if include_stochastic:
        if include_affine:
            if maxweight == 1:
                flips = [(1,), (-1,)]
            elif maxweight == 2:
                flips = [(1, 1), (1, -1), (-1, 1)]
            else:
                raise NotImplementedError(
                    "No implementation for affine errors and maxweight > 2!")
        else:
            flips = [(1,) * maxweight]

        sto_tmpl_pairs = []
        for fliptup in flips:
            for basis_lets in itertools.product(('X', 'Y', 'Z'),
                                                repeat=maxweight):
                prep_signs = [f * base_prep_signs[l]
                              for f, l in zip(fliptup, basis_lets)]
                meas_signs = [f * base_meas_signs[l]
                              for f, l in zip(fliptup, basis_lets)]
                sto_tmpl_pairs.append(
                    (_pobjs.NQPauliState(''.join(basis_lets), prep_signs),
                     _pobjs.NQPauliState(''.join(basis_lets), meas_signs)))
        fidpairs.extend(_idttools.tile_pauli_fidpairs(sto_tmpl_pairs, nqubits,
                                                      maxweight))
    elif include_affine:
        raise ValueError("Cannot include affine sequences without also "
                         "including stochastic ones!")

    if include_hamiltonian:
        next_pauli = {"X": "Y", "Y": "Z", "Z": "X"}
        prev_pauli = {"X": "Z", "Y": "X", "Z": "Y"}

        if ham_tmpl == "auto":
            if maxweight == 1:
                ham_tmpl = ("X", "Y", "Z")
            elif maxweight == 2:
                ham_tmpl = ("ZY", "ZX", "XZ", "YZ", "YX", "XY")
            else:
                raise ValueError("Must supply `ham_tmpl` when maxweight > 2!")
        ham_tmpl_pairs = []
        for tmpl_lets in ham_tmpl:
            assert len(tmpl_lets) == maxweight, \
                "Hamiltonian template strings must have length == maxweight"
            prep_lets = ''.join(prev_pauli[p] for p in tmpl_lets)
            meas_lets = ''.join(next_pauli[p] for p in tmpl_lets)
            prep_signs = [base_prep_signs[l] for l in prep_lets]
            meas_signs = [base_meas_signs[l] for l in meas_lets]
            ham_tmpl_pairs.append(
                (_pobjs.NQPauliState(prep_lets, prep_signs),
                 _pobjs.NQPauliState(meas_lets, meas_signs)))
        fidpairs.extend(_idttools.tile_pauli_fidpairs(ham_tmpl_pairs, nqubits,
                                                      maxweight))

    return fidpairs


def preferred_signs_from_paulidict(pauli_basis_dict):
    """Choose the preferred '+'/'-' sign per X/Y/Z axis: the one whose
    gate-name string in `pauli_basis_dict` is shorter (reference:
    idtcore.preferred_signs_from_paulidict:414)."""
    preferred_signs = ()
    for let in ('X', 'Y', 'Z'):
        if "+" + let in pauli_basis_dict:
            plus_key = "+" + let
        elif let in pauli_basis_dict:
            plus_key = let
        else:
            plus_key = None
        minus_key = '-' + let if ('-' + let) in pauli_basis_dict else None

        if minus_key and plus_key:
            preferred_sign = '+' if len(pauli_basis_dict[plus_key]) <= \
                len(pauli_basis_dict[minus_key]) else '-'
        elif plus_key:
            preferred_sign = '+'
        elif minus_key:
            preferred_sign = '-'
        else:
            raise ValueError("No entry for %s-basis!" % let)
        preferred_signs += (preferred_sign,)
    return preferred_signs


def fidpairs_to_pauli_fidpairs(fidpairs_list, pauli_basis_dicts, nqubits):
    """Translate Circuit-type fiducial pairs to NQPauliState pairs using
    `pauli_basis_dicts`; unconvertible pairs are skipped (reference:
    idtcore.fidpairs_to_pauli_fidpairs:459)."""
    prep_dict, meas_dict = pauli_basis_dicts
    rev_prep = {v: k for k, v in prep_dict.items()}
    rev_meas = {v: k for k, v in meas_dict.items()}

    def convert(opstr, rev_pauli_dict):
        gatenames_per_qubit = collections.defaultdict(list)
        for glbl in opstr.layertup:
            comps = glbl.components if not glbl.is_simple else (glbl,)
            for c in comps:
                assert c.sslbls is not None and len(c.sslbls) == 1
                gatenames_per_qubit[c.sslbls[0]].append(c.name)
        letters = ""
        signs = []
        qubit_keys = sorted(gatenames_per_qubit.keys()) if gatenames_per_qubit \
            else []
        index_map = {q: q for q in qubit_keys}
        for i in range(nqubits):
            key = index_map.get(i, i)
            basis = rev_pauli_dict.get(tuple(gatenames_per_qubit[key]), None)
            assert basis is not None
            letters += basis[-1]
            signs.append(-1 if basis[0] == '-' else 1)
        return _pobjs.NQPauliState(letters, signs)

    ret = []
    for prep_str, meas_str in fidpairs_list:
        try:
            prep_pauli = convert(prep_str, rev_prep)
            meas_pauli = convert(meas_str, rev_meas)
        except AssertionError:
            continue
        ret.append((prep_pauli, meas_pauli))
    return ret


def determine_paulidicts(model):
    """Infer `(prepDict, measDict)` Pauli basis dictionaries from a model by
    locating X(pi/2)/Y(pi/2)-equivalent single-qubit gates (reference:
    idtcore.determine_paulidicts:538).  Returns None when the model's prep
    isn't |0..0> or no suitable gates exist."""
    from pygsti_tpu_torch.modelmembers import states as _st
    from pygsti_tpu_torch.models.modelconstruction import create_operation
    from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel

    # prep must be (close to) |0...0>
    try:
        preps = model.preps
        prep = preps[list(preps.keys())[0]]
    except AttributeError:
        try:
            prep = model.prep_blks['layers'][
                list(model.prep_blks['layers'].keys())[0]]
        except (AttributeError, KeyError, IndexError):
            return None
    if isinstance(prep, _st.ComputationalBasisState):
        if any(b != 0 for b in getattr(prep, 'zvals',
                                       getattr(prep, '_zvals', ()))):
            return None
    else:
        try:
            nq = int(round(np.log2(model.dim) / 2))
            cmp = _st.ComputationalBasisState([0] * nq, 'pp').dense()
            if np.linalg.norm(np.asarray(prep.dense()).ravel()
                              - np.asarray(cmp).ravel()) > 1e-6:
                return None
        except ValueError:      # another dimension than qubits
            return None

    def _dense(x):
        return np.asarray(x.dense() if hasattr(x, 'dense') else x)
    gx = _dense(create_operation("X(pi/2,Q0)", [('Q0',)], basis='pp',
                                 parameterization="static"))
    gy = _dense(create_operation("Y(pi/2,Q0)", [('Q0',)], basis='pp',
                                 parameterization="static"))

    found = {}
    if isinstance(model, ExplicitOpModel):
        oplabels = list(model.operations.keys())
        def get_gate(gl):
            return model.operations[gl]
    else:
        try:
            oplabels = list(model.operation_blks['gates'].keys())
            def get_gate(gl):
                return model.operation_blks['gates'][gl]
        except (AttributeError, KeyError):
            return None

    for gl in oplabels:
        sslbls = getattr(gl, 'sslbls', None)
        name = getattr(gl, 'name', str(gl))
        try:
            gate = get_gate(gl)
            mx = np.asarray(gate.dense() if hasattr(gate, 'dense') else gate)
        except (NotImplementedError, TypeError):     # no dense form
            continue
        if mx.shape != (4, 4):
            continue
        if sslbls is not None and len(sslbls) != 1 and sslbls != ('*',):
            continue
        if np.linalg.norm(mx - gx) < 1e-6:
            found['Gx'] = name
        elif np.linalg.norm(mx - gy) < 1e-6:
            found['Gy'] = name

    if 'Gx' in found and 'Gy' in found:
        gxl, gyl = found['Gx'], found['Gy']
        prep_dict = {'X': (gyl,), 'Y': (gxl,) * 3, 'Z': (),
                     '-X': (gyl,) * 3, '-Y': (gxl,), '-Z': (gxl, gxl)}
        meas_dict = {'X': (gyl,) * 3, 'Y': (gxl,), 'Z': (),
                     '-X': (gyl,), '-Y': (gxl,) * 3, '-Z': (gxl, gxl)}
        return prep_dict, meas_dict
    return None


def _idle_circuit(idle_string, nqubits):
    if isinstance(idle_string, Circuit):
        return idle_string
    return Circuit(idle_string, line_labels=tuple(range(nqubits)))


def _fidpair_circuits(pauli_fidpairs, pauli_basis_dicts):
    prep_dict, meas_dict = pauli_basis_dicts
    return [(x.to_circuit(prep_dict), y.to_circuit(meas_dict))
            for x, y in pauli_fidpairs]


def make_idle_tomography_list(nqubits, max_lengths, pauli_basis_dicts,
                              maxweight=2, idle_string=((),),
                              include_hamiltonian=True,
                              include_stochastic=True, include_affine=True,
                              ham_tmpl="auto",
                              preferred_prep_basis_signs="auto",
                              preferred_meas_basis_signs="auto"):
    """All idle-tomography circuits: prepFid + idle^L + measFid per fiducial
    pair and max-length (reference: idtcore.make_idle_tomography_list:660)."""
    prep_dict, meas_dict = pauli_basis_dicts
    if preferred_prep_basis_signs == "auto":
        preferred_prep_basis_signs = preferred_signs_from_paulidict(prep_dict)
    if preferred_meas_basis_signs == "auto":
        preferred_meas_basis_signs = preferred_signs_from_paulidict(meas_dict)

    gi_str = _idle_circuit(idle_string, nqubits)
    pauli_fidpairs = idle_tomography_fidpairs(
        nqubits, maxweight, include_hamiltonian, include_stochastic,
        include_affine, ham_tmpl, preferred_prep_basis_signs,
        preferred_meas_basis_signs)
    fidpairs = _fidpair_circuits(pauli_fidpairs, pauli_basis_dicts)
    experiments = []
    for prep_fid, meas_fid in fidpairs:
        for L in max_lengths:
            experiments.append(prep_fid + gi_str * L + meas_fid)
    return experiments


def make_idle_tomography_lists(nqubits, max_lengths, pauli_basis_dicts,
                               maxweight=2, idle_string=((),),
                               include_hamiltonian=True,
                               include_stochastic=True, include_affine=True,
                               ham_tmpl="auto",
                               preferred_prep_basis_signs="auto",
                               preferred_meas_basis_signs="auto"):
    """Idle-tomography circuits as one list per max-length value (reference:
    idtcore.make_idle_tomography_lists:743)."""
    prep_dict, meas_dict = pauli_basis_dicts
    if preferred_prep_basis_signs == "auto":
        preferred_prep_basis_signs = preferred_signs_from_paulidict(prep_dict)
    if preferred_meas_basis_signs == "auto":
        preferred_meas_basis_signs = preferred_signs_from_paulidict(meas_dict)

    gi_str = _idle_circuit(idle_string, nqubits)
    pauli_fidpairs = idle_tomography_fidpairs(
        nqubits, maxweight, include_hamiltonian, include_stochastic,
        include_affine, ham_tmpl, preferred_prep_basis_signs,
        preferred_meas_basis_signs)
    fidpairs = _fidpair_circuits(pauli_fidpairs, pauli_basis_dicts)
    return [[prep_fid + gi_str * L + meas_fid
             for prep_fid, meas_fid in fidpairs] for L in max_lengths]


def _fit_slope(xs, ys, wts, fit_order):
    """Weighted polynomial fit -> initial slope (reference's polyfit use)."""
    coeffs = np.polyfit(xs, ys, fit_order, w=wts)
    if fit_order == 1:
        return coeffs[0], coeffs
    if fit_order == 2:
        det = coeffs[1] ** 2 - 4 * coeffs[2] * coeffs[0]
        slope = -np.sign(coeffs[0]) * np.sqrt(det) if det >= 0 else coeffs[1]
        return slope, coeffs
    raise NotImplementedError("Only fit_order <= 2 are supported!")


def compute_observed_samebasis_err_rate(dataset, pauli_fidpair,
                                        pauli_basis_dicts, idle_string,
                                        outcome, max_lengths, fit_order=1):
    """Observed error rate of `outcome` in a same-basis prep/meas series:
    weighted polynomial fit of outcome frequency vs idle length (reference:
    idtcore.compute_observed_samebasis_err_rate:834)."""
    pauli_prep, pauli_meas = pauli_fidpair
    prep_dict, meas_dict = pauli_basis_dicts
    prep_fid = pauli_prep.to_circuit(prep_dict)
    meas_fid = pauli_meas.to_circuit(meas_dict)

    def freq_and_weight(circuit):
        row = dataset[circuit]
        cnts = dict(row.counts)
        total = sum(cnts.values())
        cnt = cnts.get((outcome.rep,), 0)
        f = cnt / total
        fp = (cnt + 1) / (total + 2)  # never exactly 0 or 1
        wt = np.sqrt(total / abs(fp * (1.0 - fp)))
        err = np.sqrt(abs(f * (1.0 - f)) / total)
        return f, wt, err

    data_to_fit, wts, errbars = [], [], []
    for L in max_lengths:
        opstr = prep_fid + idle_string * L + meas_fid
        f, wt, err = freq_and_weight(opstr)
        data_to_fit.append(f)
        wts.append(wt)
        errbars.append(err)

    slope, coeffs = _fit_slope(max_lengths, data_to_fit, wts, fit_order)
    return {'rate': slope, 'fit_order': fit_order, 'fitCoeffs': coeffs,
            'data': data_to_fit, 'errbars': errbars, 'weights': wts}


def compute_observed_diffbasis_err_rate(dataset, pauli_fidpair,
                                        pauli_basis_dicts, idle_string,
                                        observable, max_lengths, fit_order=1):
    """Observed error rate of `observable`'s expectation in a diff-basis
    series (reference: idtcore.compute_observed_diffbasis_err_rate:922)."""
    pauli_prep, pauli_meas = pauli_fidpair
    prep_dict, meas_dict = pauli_basis_dicts
    prep_fid = pauli_prep.to_circuit(prep_dict)
    meas_fid = pauli_meas.to_circuit(meas_dict)

    obs_indices = [i for i, letter in enumerate(observable.rep)
                   if letter != 'I']
    minus_sign = np.prod([pauli_meas.signs[i] for i in obs_indices])

    def unsigned_exptn_and_weight(circuit):
        row = dataset[circuit]
        total = row.total
        if len(obs_indices) == 1:
            i = obs_indices[0]
            cnt0 = sum(cnt for out, cnt in row.counts.items()
                       if out[0][i] == '0')
            cnt1 = total - cnt0
            exptn = float(cnt0 - cnt1) / total
            fp = 0.5 + 0.5 * float(cnt0 - cnt1 + 1) / (total + 2)
        elif len(obs_indices) == 2:
            i, j = obs_indices
            cnt_even = sum(cnt for out, cnt in row.counts.items()
                           if out[0][i] == out[0][j])
            cnt_odd = total - cnt_even
            exptn = float(cnt_even - cnt_odd) / total
            fp = 0.5 + 0.5 * float(cnt_even - cnt_odd + 1) / (total + 2)
        else:
            raise NotImplementedError(
                "Expectation values of weight > 2 observables not implemented!")
        wt = np.sqrt(total) / np.sqrt(fp * (1.0 - fp))
        f = 0.5 + 0.5 * exptn
        err = 2 * np.sqrt(f * (1.0 - f) / total)
        return exptn, wt, err

    data_to_fit, wts, errbars = [], [], []
    for L in max_lengths:
        opstr = prep_fid + idle_string * L + meas_fid
        exptn, wt, err = unsigned_exptn_and_weight(opstr)
        data_to_fit.append(minus_sign * exptn)
        wts.append(wt)
        errbars.append(err)

    slope, coeffs = _fit_slope(max_lengths, data_to_fit, wts, fit_order)
    return {'rate': slope, 'fit_order': fit_order, 'fitCoeffs': coeffs,
            'data': data_to_fit, 'errbars': errbars, 'weights': wts}


def do_idle_tomography(nqubits, dataset, max_lengths, pauli_basis_dicts,
                       maxweight=2, idle_string=((),),
                       include_hamiltonian="auto", include_stochastic="auto",
                       include_affine="auto", advanced_options=None,
                       verbosity=0, comm=None):
    """Full idle-tomography analysis (reference:
    idtcore.do_idle_tomography:1040): fit observed same-/diff-basis error
    rates, assemble the analytic Jacobians, and pseudo-invert for intrinsic
    hamiltonian/stochastic/affine rates.  "auto" error types are dropped
    when their Jacobian is rank-deficient.  Supports the reference's
    'separate' and 'together' jacobian modes."""
    import warnings as _warnings

    if advanced_options is None:
        advanced_options = {}
    prep_dict, meas_dict = pauli_basis_dicts

    if nqubits == 1 and len(dataset) > 0:
        first_circuit = list(dataset.keys())[0]
        gi_str = Circuit(idle_string, line_labels=first_circuit.line_labels) \
            if not isinstance(idle_string, Circuit) else idle_string
    else:
        gi_str = _idle_circuit(idle_string, nqubits)

    jacmode = advanced_options.get("jacobian mode", "separate")
    sto_aff_jac = sto_aff_obs_err_rates = None
    ham_aff_jac = ham_aff_obs_err_rates = None

    preferred_prep_basis_signs = advanced_options.get(
        'preferred_prep_basis_signs', 'auto')
    preferred_meas_basis_signs = advanced_options.get(
        'preferred_meas_basis_signs', 'auto')
    if preferred_prep_basis_signs == "auto":
        preferred_prep_basis_signs = preferred_signs_from_paulidict(prep_dict)
    if preferred_meas_basis_signs == "auto":
        preferred_meas_basis_signs = preferred_signs_from_paulidict(meas_dict)

    if 'pauli_fidpairs' in advanced_options:
        same_basis_fidpairs = [fp for fp in advanced_options['pauli_fidpairs']
                               if fp[0].rep == fp[1].rep]
        diff_basis_fidpairs = [fp for fp in advanced_options['pauli_fidpairs']
                               if fp[0].rep != fp[1].rep]
    else:
        same_basis_fidpairs = diff_basis_fidpairs = None

    # user-supplied fidpairs may leave a section empty: skip it cleanly
    if same_basis_fidpairs is not None and len(same_basis_fidpairs) == 0:
        include_stochastic = False
        include_affine = False
    if diff_basis_fidpairs is not None and len(diff_basis_fidpairs) == 0:
        include_hamiltonian = False

    errors = _idttools.allerrors(nqubits, maxweight)
    fit_order = advanced_options.get('fit order', 1)
    intrinsic_rates = {}
    pauli_fidpair_dict = {}
    observed_rate_infos = {}

    if include_stochastic in (True, "auto"):
        if same_basis_fidpairs is not None:
            pauli_fidpairs = same_basis_fidpairs
        else:
            pauli_fidpairs = idle_tomography_fidpairs(
                nqubits, maxweight, False, include_stochastic, include_affine,
                advanced_options.get('ham_tmpl', "auto"),
                preferred_prep_basis_signs, preferred_meas_basis_signs)

        J_rows = []
        infos_by_fidpair = []
        for pauli_fidpair in pauli_fidpairs:
            all_outcomes = _idttools.alloutcomes(pauli_fidpair[0],
                                                 pauli_fidpair[1], maxweight)
            infos_for_this_fidpair = collections.OrderedDict()
            for out in all_outcomes:
                Jrow = [stochastic_jac_element(pauli_fidpair[0], err,
                                               pauli_fidpair[1], out)
                        for err in errors]
                if include_affine:
                    Jrow.extend([affine_jac_element(pauli_fidpair[0], err,
                                                    pauli_fidpair[1], out)
                                 for err in errors])
                J_rows.append(Jrow)
                info = compute_observed_samebasis_err_rate(
                    dataset, pauli_fidpair, pauli_basis_dicts, gi_str, out,
                    max_lengths, fit_order)
                info['jacobian row'] = np.array(Jrow)
                infos_for_this_fidpair[out] = info
            infos_by_fidpair.append(infos_for_this_fidpair)

        J = np.array(J_rows, 'd')
        obs_err_rates = np.array([info['rate']
                                  for fidpair_infos in infos_by_fidpair
                                  for info in fidpair_infos.values()])

        if jacmode == "separate":
            rank = np.linalg.matrix_rank(J)
            if rank < J.shape[1]:
                if include_affine == "auto":
                    J_sto = J[:, 0:len(errors)]
                    rank_sto = np.linalg.matrix_rank(J_sto)
                    if rank_sto < len(errors):
                        if include_stochastic == "auto":
                            include_stochastic = False
                        else:
                            _warnings.warn(
                                "Idle tomography: stochastic-jacobian rank "
                                "(%d) < #intrinsic rates (%d)"
                                % (rank_sto, J_sto.shape[1]))
                    else:
                        J = J_sto
                        include_affine = False
                else:
                    if include_affine and include_stochastic == "auto":
                        raise ValueError(
                            "Cannot set `include_stochastic` to 'auto' when "
                            "`include_affine` is True")
                    _warnings.warn(
                        "Idle tomography: samebasis-jacobian rank (%d) < "
                        "#intrinsic rates (%d)" % (rank, J.shape[1]))
            intrinsic_sto = np.dot(np.linalg.pinv(J), obs_err_rates)

        if include_stochastic:
            if jacmode == "separate":
                if include_affine:
                    n = len(intrinsic_sto)
                    intrinsic_rates['stochastic'] = intrinsic_sto[0:n // 2]
                    intrinsic_rates['affine'] = intrinsic_sto[n // 2:]
                else:
                    intrinsic_rates['stochastic'] = intrinsic_sto
            elif jacmode == "together":
                sto_aff_jac = J
                sto_aff_obs_err_rates = obs_err_rates
            else:
                raise ValueError("Invalid `jacmode` == %s" % str(jacmode))
            pauli_fidpair_dict['samebasis'] = pauli_fidpairs
            observed_rate_infos['samebasis'] = infos_by_fidpair
    elif include_affine:
        raise ValueError("Cannot extract affine error rates without also "
                         "extracting stochastic ones!")

    if include_hamiltonian in (True, "auto"):
        if diff_basis_fidpairs is not None:
            pauli_fidpairs = diff_basis_fidpairs
        else:
            pauli_fidpairs = idle_tomography_fidpairs(
                nqubits, maxweight, include_hamiltonian, False, False,
                advanced_options.get('ham_tmpl', "auto"),
                preferred_prep_basis_signs, preferred_meas_basis_signs)

        J_rows = []
        Jaff_rows = []
        infos_by_fidpair = []
        for pauli_fidpair in pauli_fidpairs:
            all_observables = _idttools.allobservables(pauli_fidpair[1],
                                                       maxweight)
            infos_for_this_fidpair = collections.OrderedDict()
            for obs in all_observables:
                Jrow = [hamiltonian_jac_element(pauli_fidpair[0], err, obs)
                        for err in errors]
                J_rows.append(Jrow)
                if include_affine:
                    Jaff_row = [affine_jac_obs_element(pauli_fidpair[0], err,
                                                       obs)
                                for err in errors]
                    Jaff_rows.append(Jaff_row)
                info = compute_observed_diffbasis_err_rate(
                    dataset, pauli_fidpair, pauli_basis_dicts, gi_str, obs,
                    max_lengths, fit_order)
                info['jacobian row'] = np.array(Jrow)
                if include_affine:
                    info['affine jacobian row'] = np.array(Jaff_row)
                infos_for_this_fidpair[obs] = info
            infos_by_fidpair.append(infos_for_this_fidpair)

        J = np.array(J_rows, 'd').reshape(len(J_rows), len(errors))
        obs_err_rates = np.array([info['rate']
                                  for fidpair_infos in infos_by_fidpair
                                  for info in fidpair_infos.values()])

        if jacmode == "separate":
            if include_affine and 'affine' in intrinsic_rates:
                # correct observed rates for known affine errors:
                # J_ham * H = obs - J_aff * A  (skipped when the stochastic
                # section was auto-dropped before extracting affine rates)
                Jaff = np.array(Jaff_rows, 'd')
                obs_err_rates = obs_err_rates - np.dot(
                    Jaff, intrinsic_rates['affine'])
            rank = np.linalg.matrix_rank(J)
            if rank < J.shape[1]:
                if include_hamiltonian == "auto":
                    include_hamiltonian = False
                else:
                    _warnings.warn(
                        "Idle tomography: hamiltonian-jacobian rank (%d) < "
                        "#intrinsic rates (%d)" % (rank, J.shape[1]))
            if include_hamiltonian:
                intrinsic_rates['hamiltonian'] = np.dot(np.linalg.pinv(J),
                                                        obs_err_rates)
        elif jacmode == "together":
            if include_affine:
                Jaff = np.array(Jaff_rows, 'd')
                ham_aff_jac = np.concatenate((J, Jaff), axis=1)
            else:
                ham_aff_jac = J
            ham_aff_obs_err_rates = obs_err_rates

        pauli_fidpair_dict['diffbasis'] = pauli_fidpairs
        observed_rate_infos['diffbasis'] = infos_by_fidpair

    if jacmode == "together":
        ne = len(errors)
        if include_hamiltonian:
            sto_col, sto_row = ne, ham_aff_jac.shape[0]
        else:
            sto_col = sto_row = 0
        nrows = (ham_aff_jac.shape[0] if include_hamiltonian else 0) + \
            (sto_aff_jac.shape[0] if include_stochastic else 0)
        ncols = ne * (int(bool(include_hamiltonian))
                      + int(bool(include_stochastic))
                      + int(bool(include_affine)))
        Jbig = np.zeros((nrows, ncols), 'd')
        obs_to_concat = []
        if include_hamiltonian:
            Jbig[0:sto_row, 0:ne] = ham_aff_jac[:, 0:ne]
            obs_to_concat.append(ham_aff_obs_err_rates)
            if include_affine:
                Jbig[0:sto_row, 2 * ne:3 * ne] = ham_aff_jac[:, ne:]
        if include_stochastic:
            Jbig[sto_row:, sto_col:] = sto_aff_jac
            obs_to_concat.append(sto_aff_obs_err_rates)

        while np.linalg.matrix_rank(Jbig) < Jbig.shape[1]:
            if include_affine == "auto":
                include_affine = False
                Jbig = Jbig[:, 0:sto_col + ne]
            elif include_hamiltonian == "auto":
                include_hamiltonian = False
                Jbig = Jbig[:, ne:]
                sto_col = 0
            elif include_stochastic == "auto":
                include_stochastic = False
                Jbig = Jbig[:, 0:sto_col]
            else:
                if include_hamiltonian or include_stochastic or include_affine:
                    _warnings.warn(
                        "Idle tomography: whole-jacobian rank (%d) < "
                        "#intrinsic rates (%d)"
                        % (np.linalg.matrix_rank(Jbig), Jbig.shape[1]))
                break
            if Jbig.shape[1] == 0:
                break

        if Jbig.shape[1] > 0:
            all_intrinsic = np.dot(np.linalg.pinv(Jbig),
                                   np.concatenate(obs_to_concat))
            off = 0
            if include_hamiltonian:
                intrinsic_rates['hamiltonian'] = all_intrinsic[off:off + ne]
                off += ne
            if include_stochastic:
                intrinsic_rates['stochastic'] = all_intrinsic[off:off + ne]
                off += ne
            if include_affine:
                intrinsic_rates['affine'] = all_intrinsic[off:off + ne]

    return IdleTomographyResults(
        dataset, max_lengths, maxweight, fit_order, pauli_basis_dicts, gi_str,
        errors, intrinsic_rates, pauli_fidpair_dict, observed_rate_infos)
