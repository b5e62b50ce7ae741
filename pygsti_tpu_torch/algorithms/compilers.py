"""Clifford compilation: symplectic (s, p) -> native-gate circuits
(reference: pygsti/algorithms/compilers.py, 3119 LoC).

Strategy here: synthesize the symplectic matrix over the generator set
{H, P, CNOT} by symplectic Gaussian elimination, map those generators to
native-gate words found by BFS over the device's 1-qubit Clifford group,
then fix the phase vector with a final Pauli layer.  This produces exact
(s AND p) implementations, as required for computing ideal RB outcomes.
"""

from __future__ import annotations

import collections
import functools

import numpy as np

from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.tools import symplectic as sym
from pygsti_tpu_torch.tools import matrixmod2 as mod2


# ---------------------------------------------------------------------------
# Elementary-generator symplectic action (1-2 qubit, embedded on the fly)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _gen_sreps():
    from pygsti_tpu_torch.tools.internalgates import standard_gatename_unitaries
    std = standard_gatename_unitaries()
    return {
        'H': sym.unitary_to_symplectic(std['Gh']),
        'P': sym.unitary_to_symplectic(std['Gp']),
        'CNOT': sym.unitary_to_symplectic(std['Gcnot']),
        'X': sym.unitary_to_symplectic(std['Gxpi']),
        'Z': sym.unitary_to_symplectic(std['Gzpi']),
        'Y': sym.unitary_to_symplectic(std['Gypi']),
    }


def _apply_gen(s, p, gen, qubits, n):
    gs, gp = _gen_sreps()[gen]
    es, ep = sym.embed_clifford(gs, gp, qubits, n)
    return sym.compose_cliffords(s, p, es, ep)


def synthesize_symplectic(s_target, elimination_order=None):
    """Return a list of ('H'|'P'|'CNOT', qubits) generators whose product
    (first element acts first) has symplectic matrix `s_target` (phases
    unconstrained).

    Column-elimination algorithm: left-multiply r by generator symplectics
    until r = I, reducing the X_j / Z_j image columns of each qubit j in
    `elimination_order` (default 0..n-1).  Symplectic orthogonality with
    already-reduced columns guarantees each step only involves
    not-yet-eliminated qubits (standard tableau reduction; cf. the
    reference's ordered global Gaussian elimination, compilers.py:608, and
    Aaronson-Gottesman PRA 70, 052328).  The recorded left-factors
    L_k...L_1 r = I give the circuit as the reversed inverses.

    Randomizing `elimination_order` is the reference's ROGGE algorithm
    (compilers.py:494): different orders produce different gate counts, and
    the caller picks the cheapest.
    """
    s_target = np.asarray(s_target) % 2
    n = s_target.shape[0] // 2
    order = list(range(n)) if elimination_order is None \
        else [int(q) for q in elimination_order]
    assert sorted(order) == list(range(n)), \
        "elimination_order must be a permutation of range(n)"
    r = s_target.copy()
    gates = []

    def lmul(gen, qubits):
        nonlocal r
        gs, _ = _gen_sreps()[gen]
        es, _ = sym.embed_clifford(gs, np.zeros(gs.shape[0], np.int64), qubits, n)
        r = mod2.dot_mod2(es, r)
        gates.append((gen, tuple(qubits)))

    def cz(j, k):
        lmul('H', (k,))
        lmul('CNOT', (j, k))
        lmul('H', (k,))

    remaining = set(order)
    for j in order:
        remaining.discard(j)
        cand = [j] + sorted(remaining)     # qubits that can still have support
        colx, colz = j, n + j
        # ---- reduce column colx (the X_j image) to e_j --------------------
        x = r[0:n, colx]
        z = r[n:2 * n, colx]
        if not any(x[k] for k in cand):
            k = next(k for k in cand if z[k])
            lmul('H', (k,))
        x = r[0:n, colx]
        if not x[j]:
            k = next(k for k in sorted(remaining) if x[k])
            lmul('CNOT', (j, k))
            lmul('CNOT', (k, j))
            lmul('CNOT', (j, k))
        for k in cand:
            if k != j and r[k, colx]:
                lmul('CNOT', (j, k))       # x_k += x_j : clears x[k]
        if r[n + j, colx]:
            lmul('P', (j,))                # z_j += x_j : clears z[j]
        for k in cand:
            if k != j and r[n + k, colx]:
                cz(j, k)                   # z_k += x_j : clears z[k]
        # ---- reduce column colz (the Z_j image) to e_{n+j} ----------------
        # invariants now: colz has z[j] = 1 (symplectic product with e_j)
        for k in sorted(remaining):
            if r[k, colz] and r[n + k, colz]:
                lmul('CNOT', (k, j))       # z_k += z_j : clears z[k]
            if r[k, colz]:
                lmul('H', (k,))            # swap x_k/z_k : x[k] -> z[k]
            if r[n + k, colz]:
                lmul('CNOT', (k, j))
        if r[j, colz]:
            # colz is Y_j-like; sqrt(X) = H P H fixes X_j, maps Y_j -> Z-type
            lmul('H', (j,))
            lmul('P', (j,))
            lmul('H', (j,))
        assert r[n + j, colz] == 1 and not r[j, colz]

    assert np.array_equal(r, np.identity(2 * n, np.int64)), \
        "Symplectic synthesis failed to reduce to identity"
    circuit_gates = []
    for gen, qubits in reversed(gates):
        if gen == 'P':
            circuit_gates.extend([('P', qubits)] * 3)  # P^-1 = P^3
        else:  # H, CNOT self-inverse
            circuit_gates.append((gen, qubits))
    return circuit_gates


# ---------------------------------------------------------------------------
# Native-gate word search
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _native_1q_words(native_gates):
    """BFS: map every 1-qubit Clifford (s,p) -> shortest word over the given
    native 1q gate names.  Returns dict[bytes_key] -> tuple of names."""
    from pygsti_tpu_torch.tools.internalgates import standard_gatename_unitaries
    std = standard_gatename_unitaries()
    sreps = {g: sym.unitary_to_symplectic(std[g]) for g in native_gates}

    def key(s, p):
        return s.tobytes() + bytes(p % 4)

    ident = (np.identity(2, np.int64), np.zeros(2, np.int64))
    words = {key(*ident): ()}
    frontier = [ident]
    while frontier:
        new_frontier = []
        for (s, p) in frontier:
            w = words[key(s, p)]
            for g, (gs, gp) in sreps.items():
                s2, p2 = sym.compose_cliffords(s, p, gs, gp)
                k2 = key(s2, p2)
                if k2 not in words:
                    words[k2] = w + (g,)
                    new_frontier.append((s2, p2))
        frontier = new_frontier
    return words


def compile_1q_clifford(s, p, native_gates=('Gxpi2', 'Gypi2'), qubit_label=0):
    """Shortest native word implementing the 1-qubit Clifford (s, p) exactly."""
    words = _native_1q_words(tuple(native_gates))
    k = s.astype(np.int64).tobytes() + bytes(np.asarray(p, np.int64) % 4)
    if k not in words:
        raise ValueError("Clifford not reachable with native gates %s" % (native_gates,))
    return [Label(g, qubit_label) for g in words[k]]


class CompilationRules(object):
    """Maps abstract generators (H, P, CNOT, Paulis) to native-gate circuits
    for a processor spec (minimal analogue of the reference's
    processors/compilationrules.py + modelpacks' clifford compilations)."""

    def __init__(self, pspec, one_q_gate_names=None):
        self.pspec = pspec
        names_1q = one_q_gate_names
        if names_1q is None:
            names_1q = [g for g in pspec.gate_names
                        if g not in ('{idle}', '(idle)') and pspec.gate_num_qubits(g) == 1]
        self.native_1q = tuple(names_1q)
        self.has_cnot = 'Gcnot' in pspec.gate_names
        self.has_cphase = 'Gcphase' in pspec.gate_names or 'Gcz' in pspec.gate_names

    def word_for_1q(self, gen_name, qubit):
        gs, gp = _gen_sreps()[gen_name]
        return compile_1q_clifford(gs, gp, self.native_1q, qubit)

    def word_for_cnot(self, control, target):
        if self.has_cnot:
            return [Label('Gcnot', (control, target))]
        if self.has_cphase:
            h = self.word_for_1q('H', target)
            return h + [Label('Gcphase', (control, target))] + h
        raise ValueError("Processor has no 2-qubit gate for CNOT compilation")


def _validate_aargs(aargs):
    """The reference threads per-algorithm extra args (`aargs`) into its
    compilation routines; the algorithms implemented here take none, so
    anything but the reference's defaults raises instead of being silently
    dropped."""
    if aargs is None or aargs == 'default':
        return
    if isinstance(aargs, (list, tuple)) \
            and all(a == 'default' for a in aargs):
        return
    raise NotImplementedError(
        "per-algorithm aargs are not supported by the implemented "
        "BGGE/ROGGE/BGE/ROCAGE algorithms (got %r)" % (aargs,))


def compile_clifford(s, p, pspec=None, qubit_labels=None, compilation_rules=None,
                     absolute_compilation=None, paulieq_compilation=None,
                     iterations=20, algorithm='ROGGE', aargs=None,
                     costfunction='2QGC:10:depth:1', prefixpaulis=False,
                     paulirandomize=False, rand_state=None):
    """Compile (s, p) into a Circuit of the processor's native gates
    implementing the Clifford exactly (reference:
    compilers.compile_clifford:73).

    The symplectic part is compiled by :func:`compile_symplectic` using
    `algorithm` ('ROGGE' default: `iterations` randomized elimination
    orders, lowest `costfunction` wins; 'BGGE': deterministic), then the
    phase vector is fixed with a single Pauli layer, appended by default or
    prepended when `prefixpaulis` (reference's post-/pre-multiplied Pauli,
    symplectic.find_postmultipled_pauli).  `paulirandomize` Pauli-frame
    randomizes the interior layers before the phase fix, so the overall
    Clifford is unchanged."""
    _validate_aargs(aargs)
    s = np.asarray(s) % 2
    n = s.shape[0] // 2
    if rand_state is None:
        rand_state = np.random.RandomState()
    if qubit_labels is None:
        qubit_labels = tuple(pspec.qubit_labels) if pspec is not None else tuple(range(n))
    if pspec is None and compilation_rules is None:
        # no processor: compile over the internal H/P/CNOT gate set
        from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec
        pspec = QubitProcessorSpec(n, ['Gh', 'Gp', 'Gcnot'],
                                   geometry='fully_connected',
                                   qubit_labels=qubit_labels)
    rules = compilation_rules \
        or (absolute_compilation
            if isinstance(absolute_compilation, CompilationRules) else None) \
        or CompilationRules(pspec)

    # the INTERIOR may be compiled with pauli-equivalent rules (the final
    # phase-fix layer absorbs any Pauli difference -- reference
    # compile_clifford:73 uses the paulieq library for the symplectic
    # stage); the phase-fix layer itself must use absolute rules
    circ = compile_symplectic(s, pspec=pspec, absolute_compilation=rules,
                              paulieq_compilation=paulieq_compilation,
                              qubit_labels=qubit_labels,
                              iterations=iterations, algorithms=[algorithm],
                              costfunction=costfunction,
                              paulirandomize=paulirandomize,
                              check=False, rand_state=rand_state)
    s_c, p_c = sym.symplectic_rep_of_clifford_circuit(circ)
    assert np.array_equal(s_c, s), "Symplectic synthesis bug"
    # phase correction: one Pauli layer appended (or prepended) so the
    # implemented phase vector becomes p
    finder = sym.find_premultipled_pauli if prefixpaulis \
        else sym.find_postmultipled_pauli
    pauli_labels = []
    for pl, q in finder(s, p_c, p, qubit_labels=qubit_labels):
        if pl != 'I':
            pauli_labels.extend(_pauli_word(rules, pl, q))
    if pauli_labels:
        layers = list(circ.layertup)
        layers = (pauli_labels + layers) if prefixpaulis \
            else (layers + pauli_labels)
        circ = Circuit(layers, qubit_labels)
        s_c, p_c = sym.symplectic_rep_of_clifford_circuit(circ)
    assert np.array_equal(s_c, s)
    assert np.array_equal(p_c % 4, np.asarray(p) % 4), \
        "Phase correction failed: %s vs %s" % (p_c, p)
    return circ


def _pauli_word(rules, pauli, qubit):
    gs, gp = _gen_sreps()[pauli]
    return compile_1q_clifford(gs, gp, rules.native_1q, qubit)


# =============================================================================
# Reference-named compilation entry points (reference: compilers.py).
# =============================================================================

def _gates_to_circuit(gen_gates, pspec, qubit_labels, rules=None, n=None):
    """Generator-name gate list -> Circuit (native gates when a pspec /
    rules is given, internal Gh/Gp/Gcnot labels otherwise).  `n` fixes the
    qubit count (an identity synthesis has NO gates, so the gate list alone
    cannot determine the width)."""
    from pygsti_tpu_torch.baseobjs.label import Label
    if n is None:
        n = 1 + max((max(q) for _, q in gen_gates), default=0)
    if qubit_labels is None:
        qubit_labels = tuple(pspec.qubit_labels) if pspec is not None \
            else tuple(range(n))
    if pspec is not None or rules is not None:
        rules = rules or CompilationRules(pspec)
        labels = []
        for gen, qubits in gen_gates:
            qlbls = tuple(qubit_labels[q] for q in qubits)
            if gen == 'CNOT':
                labels.extend(rules.word_for_cnot(qlbls[0], qlbls[1]))
            else:
                labels.extend(rules.word_for_1q(gen, qlbls[0]))
    else:
        name_map = {'H': 'Gh', 'P': 'Gp', 'CNOT': 'Gcnot'}
        labels = [Label(name_map[gen], tuple(qubit_labels[q] for q in qubits))
                  for gen, qubits in gen_gates]
    return Circuit(labels, qubit_labels)


def create_standard_costfunction(name):
    """Circuit-cost function from a standard name (reference:
    compilers._create_standard_costfunction:27): '2QGC' (two-qubit gate
    count), 'depth', or '2QGC:x:depth:y' (x * 2QGC + y * depth)."""
    if name == '2QGC':
        return lambda circuit, pspec=None: circuit.two_q_gate_count()
    if name == 'depth':
        return lambda circuit, pspec=None: circuit.depth
    if name.startswith('2QGC'):
        parts = name.split(':')
        try:
            two_q_factor = int(parts[1])
            assert parts[2] == 'depth'
            depth_factor = int(parts[3])
        except (IndexError, ValueError, AssertionError):
            raise ValueError("Invalid costfunction string %r" % (name,))
        return lambda circuit, pspec=None: (
            two_q_factor * circuit.two_q_gate_count()
            + depth_factor * circuit.depth)
    raise ValueError("Invalid costfunction string %r" % (name,))


def _random_pauli_layers(circ, qubit_labels, rules, rand_state):
    """Interleave independent uniformly random Pauli layers between every
    layer of `circ` (and at both ends) -- Pauli-frame randomization
    (reference: compile_symplectic's paulirandomize, compilers.py:463-489).
    Paulis are emitted as native words when `rules` is given, else as
    internal X/Y/Z labels."""
    pauli_names = ('I', 'X', 'Y', 'Z')

    def pauli_layers():
        labels = []
        for q in qubit_labels:
            pl = pauli_names[rand_state.randint(4)]
            if pl == 'I':
                continue
            if rules is not None:
                labels.extend(_pauli_word(rules, pl, q))
            else:
                labels.append(Label(pl, q))
        # native Pauli words can have different lengths per qubit; emit as
        # sequential simple layers (correct, if not depth-minimal)
        return [[l] for l in labels] if rules is not None \
            else ([labels] if labels else [])

    layers = pauli_layers()
    for layer in circ.layertup:
        layers.append([layer])
        layers.extend(pauli_layers())
    return Circuit(layers, qubit_labels)


def compile_symplectic(s, pspec=None, absolute_compilation=None,
                       paulieq_compilation=None, qubit_labels=None,
                       iterations=20, algorithms=('ROGGE',),
                       costfunction='2QGC:10:depth:1', paulirandomize=False,
                       aargs=None, check=True, rand_state=None):
    """A circuit implementing the Clifford with symplectic matrix `s`, up
    to Paulis (reference: compilers.compile_symplectic:253).

    Algorithm portfolio (every listed algorithm runs; the lowest-cost
    circuit under `costfunction` wins, matching the reference):

    * 'BGGE'  -- deterministic global Gaussian elimination (tableau
      column-elimination in qubit order 0..n-1).
    * 'ROGGE' -- the BGGE core with the qubit ELIMINATION ORDER randomized
      over `iterations` attempts, keeping the cheapest circuit (reference:
      _compile_symplectic_using_rogge_algorithm:494).  The default.

    The reference's remaining algorithm, 'iAGvGE' (3-stage CNOT
    decomposition via conditional-symplectic machinery), is not
    implemented; requesting it raises NotImplementedError rather than
    silently falling back.  `paulirandomize` inserts uniformly random Pauli
    layers between every circuit layer (native-compiled when `pspec` is
    given); it changes the implemented phase vector but not `s`."""
    _validate_aargs(aargs)
    s = np.asarray(s) % 2
    n = s.shape[0] // 2
    if rand_state is None:
        rand_state = np.random.RandomState()
    if isinstance(costfunction, str):
        costfunction = create_standard_costfunction(costfunction)
    # this function's output contract is 'implements s up to Paulis', so a
    # pauli-equivalent compilation library is preferred when provided (the
    # reference's paulieq libraries exist to cheapen exactly this stage);
    # the exact rules built from a pspec satisfy the same contract
    rules = None
    for cand in (paulieq_compilation, absolute_compilation):
        if isinstance(cand, CompilationRules):
            rules = cand
            break
    if rules is None and pspec is not None:
        rules = CompilationRules(pspec)

    known = {'BGGE', 'ROGGE', 'iAGvGE'}
    algorithms = list(algorithms)
    unknown = set(algorithms) - known
    if unknown:
        raise ValueError("Unknown compile_symplectic algorithm(s) %s; "
                         "choose from %s" % (sorted(unknown), sorted(known)))
    if 'iAGvGE' in algorithms:
        raise NotImplementedError(
            "The 'iAGvGE' algorithm (reference compilers.py:1004) is not "
            "implemented; use 'ROGGE' or 'BGGE'.")

    def attempt(order):
        gen_gates = synthesize_symplectic(s, elimination_order=order)
        return _gates_to_circuit(gen_gates, pspec, qubit_labels,
                                 rules=rules, n=n)

    best, best_cost = None, np.inf
    if 'BGGE' in algorithms:
        c = attempt(None)
        cost = costfunction(c, pspec)
        if cost < best_cost:
            best, best_cost = c, cost
    if 'ROGGE' in algorithms:
        # order randomization is vacuous at n == 1: a single deterministic
        # attempt suffices
        n_iters = 1 if n == 1 else int(iterations)
        for i in range(n_iters):
            order = list(rand_state.permutation(n)) if i > 0 else None
            c = attempt(order)
            cost = costfunction(c, pspec)
            if cost < best_cost:
                best, best_cost = c, cost
    circ = best

    if paulirandomize:
        ql = circ.line_labels
        circ = _random_pauli_layers(circ, ql, rules, rand_state)

    if check:
        s_c, _ = sym.symplectic_rep_of_clifford_circuit(circ)
        assert np.array_equal(s_c, s), \
            "compile_symplectic synthesis check failed"
    return circ


def _cnot_gauss_jordan_ops(M, pivot_order):
    """GF(2) Gauss-Jordan row reduction of invertible `M` with the given
    pivot (elimination) order; returns the applied ('CNOT', (ctrl, tgt))
    row operations (row t ^= row c)."""
    n = M.shape[0]
    A = M.copy()
    ops = []
    remaining = list(pivot_order)
    for idx, j in enumerate(pivot_order):
        remaining = pivot_order[idx + 1:]
        if not A[j, j]:
            pivots = [k for k in remaining if A[k, j]]
            if not pivots:
                raise AssertionError(
                    "CNOT-circuit matrix is not invertible over GF(2)")
            k = pivots[0]
            A[j, :] ^= A[k, :]
            ops.append(('CNOT', (k, j)))
        for k in range(n):
            if k != j and A[k, j]:
                A[k, :] ^= A[j, :]
                ops.append(('CNOT', (j, k)))
    assert np.array_equal(A, np.eye(n, dtype=A.dtype)), \
        "CNOT-circuit matrix is not invertible over GF(2)"
    return ops


def compile_cnot_circuit(s, pspec=None, compilation=None, qubit_labels=None,
                         algorithm='ROCAGE', compile_to_native=False,
                         check=True, aargs=None, rand_state=None,
                         iterations=10, costfunction='2QGC:10:depth:1'):
    """A CNOT circuit implementing the invertible GF(2) matrix encoded in
    `s` (reference: compilers.compile_cnot_circuit:1004).  `s` may be the
    [n, n] GF(2) matrix itself or the symplectic rep of a CNOT circuit
    (whose upper-left block is taken).

    Algorithms:

    * 'BGE'    -- deterministic Gauss-Jordan elimination in qubit order.
    * 'ROCAGE' -- Gauss-Jordan with the pivot (elimination) ORDER
      randomized over `iterations` attempts, keeping the circuit with the
      lowest `costfunction` (the reference's randomized-order
      connectivity-aware elimination, simplified to all-to-all
      connectivity).  The default.

    The reference's connectivity-ordered variants ('COCAGE', 'COiCAGE')
    are not implemented; requesting them raises NotImplementedError."""
    _validate_aargs(aargs)
    s = np.asarray(s) % 2
    n = s.shape[0] // 2 if s.shape[0] % 2 == 0 and s.shape[0] == s.shape[1] \
        and s.shape[0] > 2 and np.array_equal(
            s[:s.shape[0] // 2, s.shape[0] // 2:],
            np.zeros((s.shape[0] // 2,) * 2, s.dtype)) else None
    M = s[:n, :n].copy() if n is not None else s.copy()
    n = M.shape[0]
    if algorithm in ('COCAGE', 'COiCAGE'):
        raise NotImplementedError(
            "Connectivity-ordered CNOT compilation (%r; reference "
            "compilers.py:1004) is not implemented; use 'ROCAGE' or 'BGE'."
            % algorithm)
    if algorithm not in ('BGE', 'ROCAGE'):
        raise ValueError("Unknown compile_cnot_circuit algorithm %r"
                         % (algorithm,))
    if isinstance(costfunction, str):
        costfunction = create_standard_costfunction(costfunction)
    if rand_state is None:
        rand_state = np.random.RandomState()

    def attempt(order):
        # the recorded ops reduce M to I (left-multiplied row ops); the
        # circuit implementing M applies them reversed (CNOTs self-inverse)
        ops = _cnot_gauss_jordan_ops(M, order)
        return _gates_to_circuit(list(reversed(ops)),
                                 pspec if compile_to_native else None,
                                 qubit_labels, n=n)

    best, best_cost = attempt(list(range(n))), np.inf
    best_cost = costfunction(best, pspec)
    if algorithm == 'ROCAGE' and n > 1:
        for _ in range(int(iterations) - 1):
            c = attempt(list(rand_state.permutation(n)))
            cost = costfunction(c, pspec)
            if cost < best_cost:
                best, best_cost = c, cost
    circ = best
    if check:
        s_c, _ = sym.symplectic_rep_of_clifford_circuit(
            circ, srep_dict=sym.compute_internal_gate_symplectic_representations())
        assert np.array_equal(s_c[:n, :n] % 2, M), \
            "compile_cnot_circuit synthesis check failed"
    return circ


def compile_stabilizer_state(s, p, pspec=None, absolute_compilation=None,
                             paulieq_compilation=None, qubit_labels=None,
                             iterations=20, paulirandomize=False,
                             algorithm='ROGGE', aargs=None,
                             costfunction='2QGC:10:depth:1',
                             rand_state=None):
    """A circuit preparing the stabilizer state U|0...0> where U is the
    Clifford (s, p) (reference: compilers.compile_stabilizer_state:1303).
    Compiles the full Clifford -- correct though not depth-minimal (the
    reference exploits the state's stabilizer-group freedom via
    conditional-symplectic compilation), so `algorithm` here selects the
    SYMPLECTIC algorithm ('ROGGE'/'BGGE'), not the reference's internal
    CNOT-circuit algorithm."""
    return compile_clifford(np.asarray(s), np.asarray(p), pspec,
                            qubit_labels=qubit_labels,
                            compilation_rules=absolute_compilation
                            if isinstance(absolute_compilation,
                                          CompilationRules) else None,
                            iterations=iterations, algorithm=algorithm,
                            costfunction=costfunction,
                            paulirandomize=paulirandomize,
                            rand_state=rand_state)


def compile_stabilizer_measurement(s, p, pspec=None,
                                   absolute_compilation=None,
                                   paulieq_compilation=None,
                                   qubit_labels=None, iterations=20,
                                   paulirandomize=False, algorithm='ROGGE',
                                   aargs=None,
                                   costfunction='2QGC:10:depth:1',
                                   rand_state=None):
    """A circuit rotating the stabilizer state U|0...0> back to the
    computational basis -- i.e. implementing U^{-1} (reference:
    compilers.compile_stabilizer_measurement:1815).  See
    :func:`compile_stabilizer_state` for the `algorithm` semantics."""
    s_inv, p_inv = sym.inverse_clifford(np.asarray(s), np.asarray(p))
    return compile_clifford(s_inv, p_inv, pspec, qubit_labels=qubit_labels,
                            compilation_rules=absolute_compilation
                            if isinstance(absolute_compilation,
                                          CompilationRules) else None,
                            iterations=iterations, algorithm=algorithm,
                            costfunction=costfunction,
                            paulirandomize=paulirandomize,
                            rand_state=rand_state)


# ---------------------------------------------------------------------------
# Conditional-symplectic compilation (reference: compilers.py:2523-3119).
# Core of short-form stabilizer-state compilation: build a circuit whose
# symplectic rep matches the RIGHT half of a target s, which is all that
# matters when acting on |0..0>.
# ---------------------------------------------------------------------------

def _quad_origin(position, n):
    """(row_start, col_start) of an n x n quadrant of a 2n x 2n matrix."""
    return {'UL': (0, 0), 'UR': (0, n),
            'LL': (n, 0), 'LR': (n, n)}[position]


def _cnot_for_quadrant_add(src, dst, optype, position, n):
    """The CNOT (control, target) whose `optype` action on a 2n x 2n
    symplectic adds row/column `src` into `dst` WITHIN the given quadrant.

    Row-action CNOT(c,t): row t ^= row c (top half), row c+n ^= row t+n
    (bottom half).  Column-action CNOT(c,t): col c ^= col t (left half),
    col t+n ^= col c+n (right half)."""
    rs, cs = _quad_origin(position, n)
    if optype == 'row':
        return (src, dst) if rs == 0 else (dst, src)
    return (dst, src) if cs == 0 else (src, dst)


def _submatrix_gauss_jordan_cnots(s, optype, position, qubit_labels):
    """Map one quadrant of `s` to the identity using CNOT row/column
    operations (GF(2) Gauss-Jordan).  Returns (sout, instructions, success);
    instructions are Labels in the order the operations were applied to
    `s`, and None when the quadrant is singular (success False).

    The reference's equivalent (compilers.py:2523) returns its column-op
    lists pre-reversed into before-the-unitary circuit order; here applied
    order is always returned and callers do any reordering."""
    n = s.shape[0] // 2
    sout = s.copy()
    rs, cs = _quad_origin(position, n)
    quad = lambda: sout[rs:rs + n, cs:cs + n]
    instructions = []

    def add(src, dst):
        pair = _cnot_for_quadrant_add(src, dst, optype, position, n)
        sym.apply_internal_gate_to_symplectic(sout, 'CNOT', pair,
                                              optype=optype)
        instructions.append(Label('CNOT', (qubit_labels[pair[0]],
                                           qubit_labels[pair[1]])))

    for k in range(n):
        q = quad()
        if optype == 'row':
            if q[k, k] == 0:
                pivots = [m for m in range(k + 1, n) if q[m, k] == 1]
                if not pivots:
                    return sout, None, False
                add(pivots[0], k)
            q = quad()
            for m in range(n):
                if m != k and q[m, k] == 1:
                    add(k, m)
        else:
            if q[k, k] == 0:
                pivots = [m for m in range(k + 1, n) if q[k, m] == 1]
                if not pivots:
                    return sout, None, False
                add(pivots[0], k)
            q = quad()
            for m in range(n):
                if m != k and q[k, m] == 1:
                    add(k, m)
    return sout, instructions, True


def _make_submatrix_invertible_using_hadamards(s, optype, position,
                                               qubit_labels,
                                               rand_state=None):
    """Apply `optype`-action Hadamards on a subset of qubits until the
    given quadrant of `s` is invertible over GF(2) (reference:
    compilers.py:2619; randomized, as there).  Returns (sout, h_labels)."""
    n = s.shape[0] // 2
    rng = rand_state if rand_state is not None else np.random.RandomState()
    sout = s.copy()
    rs, cs = _quad_origin(position, n)
    h_set = set()
    for iteration in range(10 * n + 101):
        if mod2.rank_mod2(sout[rs:rs + n, cs:cs + n]) == n:
            return sout, [Label('H', qubit_labels[i]) for i in sorted(h_set)]
        hq = rng.randint(n)
        sym.apply_internal_gate_to_symplectic(sout, 'H', (hq,),
                                              optype=optype)
        h_set.symmetric_difference_update({hq})
    raise ValueError("Randomized Hadamard search failed -- the input is "
                     "likely not symplectic.")


def _make_submatrix_invertible_using_phases(s, optype, position,
                                            qubit_labels):
    """Apply `optype`-action phase gates to make the given quadrant of `s`
    invertible, exploiting that the adjacent quadrant (above for row ops,
    to the right for column ops) is the identity so that P on qubit i adds
    e_i into row/column i of the target quadrant (reference:
    compilers.py:2697).  Returns (sout, p_labels)."""
    n = s.shape[0] // 2
    sout = s.copy()
    rs, cs = _quad_origin(position, n)
    if optype == 'row':
        assert position in ('LL', 'LR'), \
            "Row-action phases require a lower quadrant"
    else:
        assert position in ('UL', 'LL'), \
            "Column-action phases require a left quadrant"
    work = sout[rs:rs + n, cs:cs + n].copy()
    instructions = []
    for i in range(n):
        if work[i, i] != 1:
            sym.apply_internal_gate_to_symplectic(sout, 'P', (i,),
                                                  optype=optype)
            instructions.append(Label('P', qubit_labels[i]))
            work[i, i] ^= 1
        # eliminate below/right of the pivot in the scratch copy only
        if optype == 'row':
            for j in range(i + 1, n):
                if work[j, i] == 1:
                    work[j, :] ^= work[i, :]
        else:
            for j in range(i + 1, n):
                if work[i, j] == 1:
                    work[:, j] ^= work[:, i]
    return sout, instructions


def find_albert_factorization_transform_using_cnots(s, optype, position,
                                                    qubit_labels,
                                                    rand_state=None):
    """Given a symmetric invertible quadrant D of `s`, find invertible M
    with D = M M^T (Albert factorization) and apply a CNOT circuit mapping
    that quadrant D -> M^T (row action) or D -> M (column action)
    (reference: compilers.py:2782).  Returns (sout, cnot_labels) with the
    labels in applied order; does not modify `s`."""
    n = s.shape[0] // 2
    rs, cs = _quad_origin(position, n)
    D = s[rs:rs + n, cs:cs + n].copy()
    assert np.array_equal(D, D.T), \
        "The quadrant to Albert-factorize must be symmetric!"
    M = mod2.albert_factor(D, rand_state=rand_state)
    sout = s.copy()
    # Substitute the factor so Gauss-Jordan drives it to I; the recorded
    # operations E then satisfy E . M = I (row) / M^T . E = I (column), so
    # the true quadrant D = M M^T maps to E . D = M^T (resp. D . E = M).
    sout[rs:rs + n, cs:cs + n] = M if optype == 'row' else M.T
    sout, instructions, success = _submatrix_gauss_jordan_cnots(
        sout, optype, position, qubit_labels)
    assert success, "Albert factor was not invertible -- internal error"
    sout[rs:rs + n, cs:cs + n] = M.T if optype == 'row' else M
    return sout, instructions


def compile_conditional_symplectic(s, pspec=None, qubit_labels=None,
                                   calg='ROCAGE', cargs=None, check=True,
                                   rand_state=None):
    """Find circuits (C2, C1) such that C1 is a CNOT circuit, C2 has the
    form 1Q-gates -- CNOTs -- 1Q-gates, and the symplectic rep of C1
    followed by C2 has the same RIGHT half as `s` -- so C2 alone prepares
    the same stabilizer state from |0..0> (up to Paulis) as any Clifford
    with rep (s, p) (reference: compilers.compile_conditional_symplectic:
    2951).  Returns (circuit, precircuit)."""
    n = s.shape[0] // 2
    if qubit_labels is not None:
        assert len(qubit_labels) == n, \
            "qubit_labels length inconsistent with the size of s"
        qubits = list(qubit_labels)
    else:
        assert pspec is not None and len(pspec.qubit_labels) == n, \
            "Need qubit_labels when s covers a subset of pspec's qubits"
        qubits = list(pspec.qubit_labels)
    rng = rand_state if rand_state is not None else np.random.RandomState()

    sout = np.asarray(s).copy()
    # 1. row Hadamards -> UR invertible
    sout, h_some = _make_submatrix_invertible_using_hadamards(
        sout, 'row', 'UR', qubits, rand_state=rng)
    # 2. column CNOTs -> UR = I
    cnots_rhs1 = []
    if n > 1:
        sout, cnots_rhs1, ok = _submatrix_gauss_jordan_cnots(
            sout, 'column', 'UR', qubits)
        assert ok, "UR Gaussian elimination failed -- input not symplectic?"
    # 3. row phases -> LR invertible (UR = I enables the e_i trick)
    sout, p_some = _make_submatrix_invertible_using_phases(
        sout, 'row', 'LR', qubits)
    # 4. row CNOTs via Albert factorization -> UR = LR = M
    cnots_row = []
    cnots_rhs2 = []
    if n > 1:
        sout, cnots_row = find_albert_factorization_transform_using_cnots(
            sout, 'row', 'LR', qubits, rand_state=rng)
        # 5. column CNOTs -> UR = LR = I
        sout, cnots_rhs2, ok = _submatrix_gauss_jordan_cnots(
            sout, 'column', 'UR', qubits)
        assert ok, "Final Gaussian elimination failed"
    # 6. row phases on every qubit -> LR = 0 (adds UR = I into LR = I)
    sout[n:, :] ^= sout[:n, :]
    p_all = [Label('P', q) for q in qubits]
    # 7. row Hadamards on every qubit -> swap halves (UR = 0, LR = I)
    sout = np.concatenate((sout[n:, :], sout[:n, :]), axis=0)
    h_all = [Label('H', q) for q in qubits]

    # The main circuit implements the INVERSE of the accumulated row
    # operations: time order Hall, Pall, reversed row CNOTs, Psome, Hsome
    # (H/P symplectic actions are involutions; each CNOT is self-inverse so
    # reversing the applied-order list inverts the product).
    layers = []
    layers.append(h_all)
    layers.append(p_all)
    mid_cnots = list(reversed(cnots_row))
    if mid_cnots and calg != 'BGE' and pspec is not None:
        # optionally recompile the CNOT block with a smarter CNOT compiler
        cnot_s, _ = sym.symplectic_rep_of_clifford_circuit(
            Circuit([[c] for c in mid_cnots], qubits))
        try:
            recompiled = compile_cnot_circuit(
                cnot_s, pspec, qubit_labels=qubits, algorithm=calg,
                compile_to_native=False, check=True,
                aargs=(cargs or []), rand_state=rng)
            mid_cnots = [lbl for layer in recompiled.layertup
                         for lbl in (layer.components
                                     if not layer.is_simple else (layer,))]
        except Exception:
            pass  # keep the Gaussian-elimination CNOT list
    layers.extend([[c] for c in mid_cnots])
    if p_some:
        layers.append(p_some)
    if h_some:
        layers.append(h_some)
    circuit = Circuit(layers, qubits)

    # The pre-circuit inverts the column operations: time order = applied
    # order (right-multiplication composes in reverse of circuit time).
    pre_layers = [[c] for c in cnots_rhs1 + cnots_rhs2]
    precircuit = Circuit(pre_layers, qubits)

    if check:
        both = Circuit(list(precircuit.layertup) + list(circuit.layertup),
                       qubits)
        scheck, _ = sym.symplectic_rep_of_clifford_circuit(both)
        assert np.array_equal(scheck[:, n:], np.asarray(s)[:, n:]), \
            "compile_conditional_symplectic failed its self-check!"
    return circuit, precircuit
