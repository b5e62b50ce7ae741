"""Random circuit sampling for benchmarking protocols
(reference: pygsti/algorithms/randomcircuit.py, 2463 LoC)."""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.baseobjs.label import Label, LabelTupTup
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.tools import symplectic as sym
from pygsti_tpu_torch.algorithms.compilers import compile_clifford, CompilationRules


def create_clifford_rb_circuit(pspec, clifford_compilations=None, length=1,
                               qubit_labels=None, randomizeout=False, citerations=20,
                               compilercache=None, seed=None, rand_state=None,
                               interleaved_circuit=None):
    """Sample one Clifford RB circuit of the given length (reference:
    randomcircuit.py:1132).

    Samples `length + 1` uniform Cliffords, compiles each to native gates,
    appends the compiled inverse of their composition, and returns
    (circuit, ideal_outcome_bits).  With randomizeout=True a uniformly random
    Pauli is absorbed into the inversion so the ideal outcome is a random
    bit string.
    """
    rng = rand_state if rand_state is not None else np.random.RandomState(seed)
    qubit_labels = tuple(qubit_labels) if qubit_labels is not None else tuple(pspec.qubit_labels)
    n = len(qubit_labels)
    rules = clifford_compilations if isinstance(clifford_compilations, CompilationRules) \
        else CompilationRules(pspec)

    def _compile(s_mx, p_vec):
        # compilercache: (s, p)-keyed reuse of compiled Cliffords across
        # calls (reference's citerations/compilercache pair) -- pass a dict
        # shared between calls to amortize the randomized compiler attempts
        if compilercache is not None:
            ckey = (s_mx.tobytes(), p_vec.tobytes())
            if ckey in compilercache:
                return compilercache[ckey]
        circ = compile_clifford(s_mx, p_vec, pspec, qubit_labels, rules,
                                iterations=citerations, rand_state=rng)
        if compilercache is not None:
            compilercache[ckey] = circ
        return circ

    s_comp = np.identity(2 * n, np.int64)
    p_comp = np.zeros(2 * n, np.int64)
    layers = []
    if interleaved_circuit is not None:
        s_int, p_int = sym.symplectic_rep_of_clifford_circuit(
            interleaved_circuit, pspec=pspec)
    for _ in range(length + 1):
        s, p = sym.random_clifford(n, rand_state=rng)
        circ = _compile(s, p)
        layers.extend(circ.layertup)
        s_comp, p_comp = sym.compose_cliffords(s_comp, p_comp, s, p)
        if interleaved_circuit is not None:
            # interleave the target gate after each random Clifford
            layers.extend(interleaved_circuit.layertup)
            s_comp, p_comp = sym.compose_cliffords(s_comp, p_comp, s_int, p_int)

    s_inv, p_inv = sym.inverse_clifford(s_comp, p_comp)
    if randomizeout:
        # compose a random Pauli before the inversion
        s_pauli = np.identity(2 * n, np.int64)
        p_pauli = 2 * rng.randint(0, 2, 2 * n)
        s_inv, p_inv = sym.compose_cliffords(s_pauli, p_pauli, s_inv, p_inv)
    inv_circ = _compile(s_inv, p_inv)
    layers.extend(inv_circ.layertup)

    full = Circuit(layers, qubit_labels)
    # ideal outcome via stabilizer propagation
    s_tot, p_tot = sym.symplectic_rep_of_clifford_circuit(full, pspec=pspec)
    state = sym.prep_stabilizer_state(n, [0] * n)
    state = sym.apply_clifford_to_stabilizer_state(s_tot, p_tot, *state)
    idealout = sym.measure_all_qubits_deterministic(*state)
    return full, idealout


def sample_circuit_layer_by_edgegrab(pspec, qubit_labels=None, two_q_gate_density=0.25,
                                     one_q_gate_names=None, gate_args_lists=None,
                                     rand_state=None):
    """'edgegrab' layer sampler (reference: randomcircuit.py:201): grab a
    random set of disjoint edges, place 2Q gates on a subset, 1Q gates
    elsewhere.  `gate_args_lists` maps a gate name to a list of args tuples
    one of which is sampled uniformly for each placed gate (e.g.
    ``{'Gczr': [('1.5707...',), ('-1.5707...',)]}``).  Passing
    ``one_q_gate_names=[]`` leaves non-2Q qubits idle."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    qubit_labels = tuple(qubit_labels) if qubit_labels is not None else tuple(pspec.qubit_labels)
    if one_q_gate_names is None:
        one_q_gate_names = [g for g in pspec.gate_names
                            if pspec.gate_num_qubits(g) == 1 and g not in ('{idle}', '(idle)')]
    twoq_names = [g for g in pspec.gate_names if pspec.gate_num_qubits(g) == 2]

    # random maximal set of disjoint edges
    edges = [e for e in pspec.qubit_graph.edges()
             if e[0] in qubit_labels and e[1] in qubit_labels]
    rng.shuffle(edges)
    chosen = []
    used = set()
    for e in edges:
        if e[0] not in used and e[1] not in used:
            chosen.append(e)
            used.update(e)
    # keep each edge w.p. mean_two_q_gates/len(chosen)
    n = len(qubit_labels)
    mean_two_q_gates = two_q_gate_density * n / 2
    prob = min(mean_two_q_gates / max(len(chosen), 1), 1.0)
    components = []
    occupied = set()
    gate_args_lists = gate_args_lists or {}

    def _with_args(name, sslbls):
        argl = gate_args_lists.get(name, None)
        args = argl[rng.randint(len(argl))] if argl else None
        return Label(name, sslbls, args=args)

    for e in chosen:
        if rng.rand() < prob and twoq_names:
            g2 = twoq_names[rng.randint(len(twoq_names))]
            components.append(_with_args(g2, e))
            occupied.update(e)
    if one_q_gate_names:
        for q in qubit_labels:
            if q not in occupied:
                g1 = one_q_gate_names[rng.randint(len(one_q_gate_names))]
                components.append(_with_args(g1, (q,)))
    return LabelTupTup.init(tuple(components))


def create_random_circuit(pspec, length, qubit_labels=None, sampler='edgegrab',
                          samplerargs=None, rand_state=None, seed=None):
    """Random circuit of `length` layers using the given layer sampler
    (reference: randomcircuit.py create_random_circuit)."""
    rng = rand_state if rand_state is not None else np.random.RandomState(seed)
    qubit_labels = tuple(qubit_labels) if qubit_labels is not None else tuple(pspec.qubit_labels)
    samplerargs = samplerargs or {}
    layers = []
    for _ in range(length):
        if callable(sampler):
            layers.append(sampler(pspec, qubit_labels, rand_state=rng,
                                  **samplerargs))
        elif sampler == 'edgegrab':
            layers.append(sample_circuit_layer_by_edgegrab(
                pspec, qubit_labels, rand_state=rng, **samplerargs))
        elif sampler == 'Qelimination':
            layers.append(sample_circuit_layer_by_q_elimination(
                pspec, qubit_labels, rand_state=rng, **samplerargs))
        elif sampler == 'co2Qgates':
            layers.append(sample_circuit_layer_by_co2_q_gates(
                pspec, qubit_labels, rand_state=rng, **samplerargs))
        elif sampler in ('local', '1Q'):
            layers.append(sample_circuit_layer_of_one_q_gates(
                pspec, qubit_labels, rand_state=rng, **samplerargs))
        else:
            raise ValueError("Unknown sampler %r" % sampler)
    return Circuit(layers, qubit_labels)


def _sample_one_layer(pspec, qubit_labels, sampler, samplerargs, rng):
    """One circuit layer from the named/callable layer sampler (the
    create_random_circuit dispatch, single-layer form)."""
    return create_random_circuit(pspec, 1, qubit_labels, sampler,
                                 samplerargs, rand_state=rng).layertup


def create_direct_rb_circuit(pspec, clifford_compilations=None, length=1,
                             qubit_labels=None, sampler='edgegrab', samplerargs=None,
                             addlocal=False, lsargs=None, randomizeout=False,
                             cliffordtwirl=True, conditionaltwirl=True,
                             citerations=20, seed=None, rand_state=None):
    """Sample one direct RB circuit (reference: randomcircuit.py:782).

    Structure: random stabilizer prep (here: a uniform Clifford; skipped
    when `cliffordtwirl` is False), `length` sampled layers of native gates
    (with a random 1Q-gate layer between each when `addlocal`, sampled with
    `lsargs`), then an inversion (compiled Clifford with `citerations`
    randomized compiler attempts) returning to a computational state.  The
    reference compiles stabilizer-state preparations when
    `conditionaltwirl` is True (a shorter circuit implementing the same
    conditional map); both settings here use the full Clifford compilation,
    which implements the benchmarking-equivalent exact map.
    """
    rng = rand_state if rand_state is not None else np.random.RandomState(seed)
    qubit_labels = tuple(qubit_labels) if qubit_labels is not None else tuple(pspec.qubit_labels)
    n = len(qubit_labels)
    rules = clifford_compilations if isinstance(clifford_compilations, CompilationRules) \
        else CompilationRules(pspec)

    layers = []
    # initial twirl
    if cliffordtwirl:
        s0, p0 = sym.random_clifford(n, rand_state=rng)
        layers.extend(compile_clifford(s0, p0, pspec, qubit_labels, rules,
                                       iterations=citerations,
                                       rand_state=rng).layertup)
    # random core layers; addlocal surrounds them with random 1Q-gate
    # layers -- one BEFORE each sampled layer and one after the last, the
    # reference's 2*length+1 structure (randomcircuit.py:782 addlocal)
    for k in range(length):
        if addlocal:
            layers.append(sample_circuit_layer_of_one_q_gates(
                pspec, qubit_labels, rand_state=rng, **(lsargs or {})))
        layers.extend(_sample_one_layer(pspec, qubit_labels, sampler,
                                        samplerargs, rng))
    if addlocal and length > 0:
        layers.append(sample_circuit_layer_of_one_q_gates(
            pspec, qubit_labels, rand_state=rng, **(lsargs or {})))
    # inversion
    partial = Circuit(layers, qubit_labels)
    s_par, p_par = sym.symplectic_rep_of_clifford_circuit(partial, pspec=pspec)
    s_inv, p_inv = sym.inverse_clifford(s_par, p_par)
    if randomizeout:
        s_pauli = np.identity(2 * n, np.int64)
        p_pauli = 2 * rng.randint(0, 2, 2 * n)
        s_inv, p_inv = sym.compose_cliffords(s_pauli, p_pauli, s_inv, p_inv)
    layers.extend(compile_clifford(s_inv, p_inv, pspec, qubit_labels, rules,
                                   iterations=citerations,
                                   rand_state=rng).layertup)

    full = Circuit(layers, qubit_labels)
    s_tot, p_tot = sym.symplectic_rep_of_clifford_circuit(full, pspec=pspec)
    state = sym.prep_stabilizer_state(n, [0] * n)
    state = sym.apply_clifford_to_stabilizer_state(s_tot, p_tot, *state)
    idealout = sym.measure_all_qubits_deterministic(*state)
    return full, idealout


def create_mirror_rb_circuit(pspec, absolute_compilation=None, length=0,
                             qubit_labels=None, sampler='edgegrab', samplerargs=None,
                             localclifford=True, paulirandomize=True, seed=None,
                             rand_state=None, fixed_layers=None):
    """Sample one mirror RB circuit (reference: randomcircuit.py:1447).

    Structure: random 1Q-Clifford layer; length/2 sampled layers; (Pauli
    layer); the inverses of the sampled layers in reverse; inverse 1Q layer.
    All gates must have self-contained inverses in the native set; we invert
    each layer via per-gate symplectic inversion + 1Q-word compilation.
    """
    assert length % 2 == 0, "Mirror RB length must be even"
    rng = rand_state if rand_state is not None else np.random.RandomState(seed)
    qubit_labels = tuple(qubit_labels) if qubit_labels is not None else tuple(pspec.qubit_labels)
    n = len(qubit_labels)
    rules = absolute_compilation \
        if isinstance(absolute_compilation, CompilationRules) \
        else CompilationRules(pspec)

    srep_dict = dict(sym.compute_internal_gate_symplectic_representations())
    srep_dict.update(pspec.compute_clifford_symplectic_reps())

    def invert_layer(layer):
        out = []
        for comp in (layer.components if not layer.is_simple else (layer,)):
            s_g, p_g = srep_dict[comp.name]
            s_i, p_i = sym.inverse_clifford(s_g, p_g)
            if len(comp.sslbls) == 1:
                out.extend(compile_1q_word(s_i, p_i, rules, comp.sslbls[0]))
            else:
                # self-inverse 2Q gates (CNOT/CZ/SWAP) invert to themselves
                assert np.array_equal(s_i, s_g) and np.array_equal(p_i % 4, p_g % 4), \
                    "2Q gate %s is not self-inverse" % comp.name
                out.append(comp)
        return out

    from pygsti_tpu_torch.algorithms.compilers import compile_1q_clifford

    def compile_1q_word(s, p, rules, q):
        return compile_1q_clifford(s, p, rules.native_1q, q)

    layers = []
    # initial random 1q-Clifford layer (omitted when localclifford=False)
    init_cliffs = []
    if localclifford:
        for q in qubit_labels:
            s, p = sym.random_clifford(1, rand_state=rng)
            init_cliffs.append((q, s, p))
            init_word = compile_1q_word(s, p, rules, q)
            layers.extend(init_word)

    core_layers = []
    for k in range(length // 2):
        if fixed_layers is not None:
            # periodic mirror circuits: cycle through the given germ layers
            layer = fixed_layers[k % len(fixed_layers)]
        else:
            sampled = _sample_one_layer(pspec, qubit_labels, sampler,
                                        samplerargs, rng)
            layer = sampled[0] if len(sampled) == 1 else sampled
        core_layers.append(layer)
        layers.append(layer)

    if paulirandomize:
        # central random Pauli layer (compiled into native 1Q words)
        for q in qubit_labels:
            xz = (rng.randint(2), rng.randint(2))
            name = {(1, 0): 'X', (0, 1): 'Z', (1, 1): 'Y'}.get(xz)
            if name is not None:
                from pygsti_tpu_torch.algorithms.compilers import _gen_sreps
                s_p, p_p = _gen_sreps()[name]
                layers.extend(compile_1q_word(s_p, p_p, rules, q))

    for layer in reversed(core_layers):
        layers.extend(invert_layer(layer))

    # final inverse 1q-Clifford layer
    for (q, s, p) in init_cliffs:
        s_i, p_i = sym.inverse_clifford(s, p)
        layers.extend(compile_1q_word(s_i, p_i, rules, q))

    full = Circuit(layers, qubit_labels)
    s_tot, p_tot = sym.symplectic_rep_of_clifford_circuit(full, pspec=pspec)
    state = sym.prep_stabilizer_state(n, [0] * n)
    state = sym.apply_clifford_to_stabilizer_state(s_tot, p_tot, *state)
    idealout = sym.measure_all_qubits_deterministic(*state)
    return full, idealout


def create_binary_rb_circuit(pspec, clifford_compilations=None, length=1,
                             qubit_labels=None, layer_sampling='mixed1q2q',
                             sampler='edgegrab', samplerargs=None,
                             addlocal=False, lsargs=None, seed=None):
    """Generate one binary RB (BiRB) circuit (reference:
    randomcircuit.create_binary_rb_circuit:2268).

    Structure: random stabilizer prep (an eigenstate of a random +/- Pauli P),
    `length` random layers U, then a single-qubit basis-change layer M mapping
    Q = U P U^-1 onto a Z-type Pauli.  Returns (circuit, meas, sign): `meas`
    is the 'I'/'Z' string of the measured Pauli and `sign` the ideal
    eigenvalue; the BiRB statistic is the measured Pauli expectation.
    """
    from pygsti_tpu_torch.tools import symplectic as sym
    from pygsti_tpu_torch.algorithms.compilers import compile_clifford, CompilationRules
    from pygsti_tpu_torch.circuits.circuit import Circuit

    rng = np.random.RandomState(seed)
    if qubit_labels is None:
        qubit_labels = tuple(pspec.qubit_labels)
    n = len(qubit_labels)
    rules = clifford_compilations if isinstance(clifford_compilations, CompilationRules) \
        else CompilationRules(pspec)

    # -- 1) random Clifford C -> prep circuit; P = C (+/-Z_0) C^-1 ----------
    s_C, p_C = sym.random_clifford(n, rng)
    rand_sign_bit = rng.randint(2)           # eigenstate sign of Z_0: |0> or |1>
    # the compiler's random elimination orders come from a generator of
    # their own, made from `seed`, so that one seed gives one circuit while
    # rng's draws stay those of the JAX package (which compiles unseeded)
    prep_circ = compile_clifford(
        s_C, p_C, pspec, qubit_labels, rules,
        rand_state=np.random.RandomState(None if seed is None else [seed, 1]))
    if rand_sign_bit:
        from pygsti_tpu_torch.baseobjs.label import Label
        xname = next((g for g in pspec.gate_names if g in ('Gxpi', 'Gx')), None)
        if xname is not None:
            prep_circ = Circuit([Label(xname, qubit_labels[0])],
                                qubit_labels) + prep_circ
        else:  # no pi-pulse available: stick to + eigenstates
            rand_sign_bit = 0

    # Pauli P as a single transformed stabilizer column: start with (-1)^b Z_0
    col = np.zeros((2 * n, 1), np.int64)
    col[n, 0] = 1
    ph = np.array([2 * rand_sign_bit], np.int64)
    P_s, P_p = sym.apply_clifford_to_stabilizer_state(s_C, p_C, col, ph)

    # -- 2) core random circuit U ------------------------------------------
    # layer_sampling 'mixed1q2q' (default): every layer from `sampler`;
    # 'alternating1q2q': pure 1Q-gate layers alternate with sampled layers
    # (reference create_binary_rb_circuit:2268).  `addlocal` interleaves a
    # random 1Q-gate layer (sampled with `lsargs`) after each core layer.
    if layer_sampling not in ('mixed1q2q', 'alternating1q2q'):
        raise ValueError("Unknown layer_sampling %r" % (layer_sampling,))
    samplerargs = samplerargs or {}
    core_layers = []
    for k in range(length):
        if addlocal:  # 2*length+1 structure: 1Q layer before each + after last
            core_layers.append(sample_circuit_layer_of_one_q_gates(
                pspec, qubit_labels, rand_state=rng, **(lsargs or {})))
        if layer_sampling == 'alternating1q2q' and k % 2 == 0:
            core_layers.append(sample_circuit_layer_of_one_q_gates(
                pspec, qubit_labels, rand_state=rng))
        else:
            core_layers.extend(create_random_circuit(
                pspec, 1, qubit_labels=qubit_labels, sampler=sampler,
                samplerargs=samplerargs, rand_state=rng).layertup)
    if addlocal and length > 0:
        core_layers.append(sample_circuit_layer_of_one_q_gates(
            pspec, qubit_labels, rand_state=rng, **(lsargs or {})))
    core = Circuit(core_layers, qubit_labels)
    s_U, p_U = sym.symplectic_rep_of_clifford_circuit(core, pspec=pspec)

    # Q = U P U^-1
    Q_s, Q_p = sym.apply_clifford_to_stabilizer_state(s_U, p_U, P_s, P_p)
    qx, qz = Q_s[:n, 0], Q_s[n:, 0]

    # -- 3) per-qubit basis change M: g X g^-1 = Z (H) / g Y g^-1 = Z ------
    from pygsti_tpu_torch.algorithms.compilers import compile_1q_clifford
    from pygsti_tpu_torch.tools.internalgates import standard_gatename_unitaries
    std = standard_gatename_unitaries()
    H_u = std['Gh']
    HSdg_u = H_u @ std['Gp'].conj().T          # S^dag then H
    meas_words = []
    for i, q in enumerate(qubit_labels):
        if qx[i] and not qz[i]:        # X -> Z
            s1, p1 = sym.unitary_to_symplectic(H_u)
            meas_words.append(compile_1q_clifford(s1, p1, rules.native_1q, q))
        elif qx[i] and qz[i]:          # Y -> Z
            s1, p1 = sym.unitary_to_symplectic(HSdg_u)
            meas_words.append(compile_1q_clifford(s1, p1, rules.native_1q, q))
    basis_circ_layers = []
    maxlen = max((len(w) for w in meas_words), default=0)
    for k in range(maxlen):
        basis_circ_layers.append([w[k] for w in meas_words if len(w) > k])
    basis_circ = Circuit(basis_circ_layers, qubit_labels)

    s_M, p_M = sym.symplectic_rep_of_clifford_circuit(basis_circ, pspec=pspec)
    Z_s, Z_p = sym.apply_clifford_to_stabilizer_state(s_M, p_M, Q_s, Q_p)
    zx, zz = Z_s[:n, 0], Z_s[n:, 0]
    assert not zx.any(), "basis change failed to map Pauli onto Z-type"
    meas = ''.join('Z' if zz[i] else 'I' for i in range(n))
    # phase exponent of i^p Z-type Pauli must be 0 or 2 -> sign
    sign = 1 if int(Z_p[0]) % 4 == 0 else -1

    full = prep_circ + core + basis_circ
    return full, meas, sign


# =============================================================================
# Additional reference layer samplers (reference: randomcircuit.py:292-520).
# =============================================================================

def _ops_on_qubits(pspec, qubit_labels):
    """{qubit-tuple: [Label, ...]} over 1Q and 2Q gates (the reference's
    pspec.compute_ops_on_qubits restricted to what the samplers need)."""
    out = {}
    for q in qubit_labels:
        out[(q,)] = []
    for q1 in qubit_labels:
        for q2 in qubit_labels:
            if q1 != q2:
                out[(q1, q2)] = []
    for name in pspec.gate_names:
        nq = pspec.gate_num_qubits(name)
        if nq not in (1, 2) or name in ('{idle}', '(idle)', '[]', ''):
            continue
        for targets in pspec.resolved_availability(name):
            if all(t in qubit_labels for t in targets) and targets in out:
                out[targets].append(Label(name, targets))
    return out


def sample_circuit_layer_by_q_elimination(pspec, qubit_labels=None,
                                          two_q_prob=0.5, rand_state=None):
    """'Qelimination' layer sampler: repeatedly pick a random unassigned
    qubit; with probability `two_q_prob` give it a random available 2Q gate
    to another unassigned qubit, else a random 1Q gate (reference:
    randomcircuit.py:292)."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    qubits = list(qubit_labels) if qubit_labels is not None \
        else list(pspec.qubit_labels)
    ops = _ops_on_qubits(pspec, tuple(qubits))
    layer = []
    remaining = list(qubits)
    while remaining:
        q = remaining.pop(rng.randint(len(remaining)))
        twoq = []
        for q2 in remaining:
            twoq += ops.get((q, q2), []) + ops.get((q2, q), [])
        if twoq and rng.rand() < two_q_prob:
            lbl = twoq[rng.randint(len(twoq))]
            layer.append(lbl)
            other = lbl.sslbls[0] if lbl.sslbls[0] != q else lbl.sslbls[1]
            remaining.remove(other)
        else:
            oneq = ops[(q,)]
            layer.append(oneq[rng.randint(len(oneq))])
    return LabelTupTup.init(tuple(layer))


def sample_circuit_layer_of_one_q_gates(pspec, qubit_labels=None,
                                        one_q_gate_names='all', pdist='uniform',
                                        modelname='clifford', rand_state=None):
    """A layer of independent random 1Q gates on every qubit (reference:
    randomcircuit.py:520)."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    qubits = tuple(qubit_labels) if qubit_labels is not None \
        else tuple(pspec.qubit_labels)
    if one_q_gate_names == 'all':
        names = [g for g in pspec.gate_names if pspec.gate_num_qubits(g) == 1
                 and g not in ('{idle}', '(idle)', '[]', '')]
    else:
        names = list(one_q_gate_names)
    if isinstance(pdist, str) and pdist == 'uniform':
        p = None
    else:
        p = np.asarray(pdist, float)
        p = p / p.sum()
    layer = [Label(names[rng.choice(len(names), p=p)], (q,)) for q in qubits]
    return LabelTupTup.init(tuple(layer))


def sample_circuit_layer_by_co2_q_gates(pspec, qubit_labels, co2_q_gates,
                                        co2_q_gates_prob='uniform',
                                        two_q_prob=1.0,
                                        one_q_gate_names='all',
                                        rand_state=None):
    """'co2Qgates' layer sampler: pick one user-supplied set of compatible
    2Q gates (possibly nested one level), keep each with probability
    `two_q_prob`, and fill the remaining qubits with random 1Q gates
    (reference: randomcircuit.py:394)."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    qubits = tuple(qubit_labels) if qubit_labels is not None \
        else tuple(pspec.qubit_labels)
    sets = list(co2_q_gates)
    if isinstance(co2_q_gates_prob, str) and co2_q_gates_prob == 'uniform':
        probs = None
    else:
        probs = np.asarray(co2_q_gates_prob, float)
        probs = probs / probs.sum()
    chosen = sets[rng.choice(len(sets), p=probs)]
    if len(chosen) > 0 and isinstance(chosen[0], (list, tuple)) \
       and not hasattr(chosen[0], 'sslbls'):  # Labels are tuple subclasses
        # nested one level: choose again uniformly within the sub-list
        chosen = chosen[rng.randint(len(chosen))]
    layer = []
    occupied = set()
    for lbl in chosen:
        if rng.rand() < two_q_prob:
            layer.append(lbl)
            occupied.update(lbl.sslbls)
    if one_q_gate_names == 'all':
        names = [g for g in pspec.gate_names if pspec.gate_num_qubits(g) == 1
                 and g not in ('{idle}', '(idle)', '[]', '')]
    else:
        names = list(one_q_gate_names)
    for q in qubits:
        if q not in occupied:
            layer.append(Label(names[rng.randint(len(names))], (q,)))
    return LabelTupTup.init(tuple(layer))


def create_random_germ(pspec, depths, interacting_qs_density, qubit_labels,
                       rand_state=None):
    """A random 'germ' circuit: per-qubit repeated random 1Q-gate subgerms
    (power-of-2 subgerm depths) with 2Q gates inserted at the requested
    density (reference: randomcircuit.create_random_germ:1651)."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    qubits = list(qubit_labels) if qubit_labels is not None \
        else list(pspec.qubit_labels)
    width = len(qubits)
    if width == 1:
        interacting_qs_density = 0

    r = rng.rand()
    max_subgerm_depth = 1 if r < 0.5 else (2 if r < 0.75 else
                                           (4 if r < 0.875 else 8))
    if interacting_qs_density > 0:
        required = max_subgerm_depth * width * interacting_qs_density
        R = int(np.ceil(2 / required))
    else:
        R = 1
    germ_depth = R * max_subgerm_depth

    oneq_names = [g for g in pspec.gate_names
                  if pspec.gate_num_qubits(g) == 1
                  and g not in ('{idle}', '(idle)', '[]', '')]
    twoq_names = [g for g in pspec.gate_names if pspec.gate_num_qubits(g) == 2]

    repeated_subgerm = {}
    for q in qubits:
        power = 0
        while rng.binomial(1, 0.5) == 1 and 2 ** power < max_subgerm_depth:
            power += 1
        sub_depth = 2 ** power
        sub = [Label(oneq_names[rng.randint(len(oneq_names))], (q,))
               for _ in range(sub_depth)]
        repeated_subgerm[q] = (germ_depth // sub_depth) * sub

    layers = []
    for l in range(germ_depth):
        layers.append(LabelTupTup.init(
            tuple(repeated_subgerm[q][l] for q in qubits)))

    if interacting_qs_density > 0 and twoq_names:
        num_2q = int(np.floor(germ_depth * width
                              * interacting_qs_density / 2))
        edges = [tuple(e) for e in pspec.qubit_graph.edges()
                 if e[0] in qubits and e[1] in qubits]
        for _ in range(max(num_2q, 1)):
            if not edges:
                break
            l = rng.randint(germ_depth)
            e = edges[rng.randint(len(edges))]
            g2 = Label(twoq_names[rng.randint(len(twoq_names))], e)
            comps = [c for c in (layers[l].components
                                 if not layers[l].is_simple
                                 else (layers[l],))
                     if not set(c.sslbls) & set(e)]
            layers[l] = LabelTupTup.init(tuple(comps) + (g2,))
    return Circuit(layers, qubits)


def create_random_germpower_circuits(pspec, depths, interacting_qs_density,
                                     qubit_labels, fixed_versus_depth=False,
                                     rand_state=None):
    """Random germ-power circuits: one (or per-depth) random germ repeated
    to reach each requested depth (reference:
    randomcircuit.create_random_germpower_circuits:1779).  Returns
    (circuits, auxinfo) with the germ(s) recorded."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    qubits = list(qubit_labels) if qubit_labels is not None \
        else list(pspec.qubit_labels)
    circuits = []
    aux = {'germs': []}
    germ = create_random_germ(pspec, depths, interacting_qs_density,
                              qubits, rng) if fixed_versus_depth else None
    for depth in depths:
        g = germ if fixed_versus_depth else create_random_germ(
            pspec, depths, interacting_qs_density, qubits, rng)
        glen = max(len(g.layertup), 1)
        reps = max(int(depth) // glen, 1)
        circuits.append(g * reps)
        aux['germs'].append(g)
    return circuits, aux


def create_random_germpower_mirror_circuits(pspec, absolute_compilation,
                                            depths, qubit_labels=None,
                                            localclifford=True,
                                            paulirandomize=True,
                                            interacting_qs_density=1 / 8,
                                            fixed_versus_depth=False,
                                            rand_state=None):
    """Mirror (circuit + inverse) versions of random germ-power circuits,
    returning (circuits, ideal_outcomes, auxinfo) (reference:
    randomcircuit.create_random_germpower_mirror_circuits:1847).  Built on
    create_mirror_rb_circuit's mirroring machinery."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    qubits = tuple(qubit_labels) if qubit_labels is not None \
        else tuple(pspec.qubit_labels)
    base_circuits, aux = create_random_germpower_circuits(
        pspec, depths, interacting_qs_density, list(qubits),
        fixed_versus_depth, rng)
    from pygsti_tpu_torch.algorithms.mirroring import create_mirror_circuit
    circuits, outcomes = [], []
    for c in base_circuits:
        # the mirror's random layers come from rng too, so that one seed
        # gives one set of circuits (the JAX package draws them unseeded)
        mc, out = create_mirror_circuit(c, pspec,
                                        circ_type='clifford+zxzxz'
                                        if paulirandomize else 'clifford',
                                        rand_state=rng)
        circuits.append(mc)
        outcomes.append(out)
    return circuits, outcomes, aux


def sample_haar_random_one_qubit_unitary_parameters(rand_state=None):
    """Sample a Haar-random 1Q unitary and return its ZXZXZ Euler angles
    (theta1, theta2, theta3) such that U ~ Z(theta3) X(pi/2) Z(theta2)
    X(pi/2) Z(theta1) up to global phase (reference: randomcircuit.py:31)."""
    from pygsti_tpu_torch.tools.compilationtools import mod_2pi
    rng = rand_state if rand_state is not None else np.random
    psi = 2 * np.pi * rng.rand() - np.pi
    chi = 2 * np.pi * rng.rand() - np.pi
    phi = np.arcsin(np.sqrt(rng.rand()))
    return (mod_2pi(psi - chi + np.pi), mod_2pi(np.pi - 2 * phi),
            mod_2pi(psi + chi))


def sample_random_clifford_one_qubit_unitary_parameters(rand_state=None):
    """Sample ZXZXZ Euler angles that are uniform multiples of pi/2, giving
    a (non-uniformly-distributed) random 1Q Clifford (reference:
    randomcircuit.py:48)."""
    from pygsti_tpu_torch.tools.compilationtools import mod_2pi
    rng = rand_state if rand_state is not None else np.random
    return tuple(mod_2pi(rng.randint(4) * np.pi / 2) for _ in range(3))


def _zxzxz_layers(qubits, angles, zname, xname):
    """Five circuit layers realizing Z(t1) X(pi/2) Z(t2) X(pi/2) Z(t3) on
    every qubit, with per-qubit angle triples `angles`."""
    xlayer = [Label(xname, (q,)) for q in qubits]
    layers = []
    for k in range(3):
        layers.append([Label(zname, (q,), args=(str(angles[i][k]),))
                       for i, q in enumerate(qubits)])
        if k < 2:
            layers.append(list(xlayer))
    return layers


def sample_compiled_haar_random_one_qubit_gates_zxzxz_circuit(
        pspec, zname='Gzr', xname='Gxpi2', qubit_labels=None, rand_state=None):
    """A 5-layer circuit applying an independent Haar-random 1Q unitary to
    each qubit, compiled into the ZXZXZ form (reference:
    randomcircuit.py:58)."""
    qubits = tuple(qubit_labels) if qubit_labels is not None \
        else tuple(pspec.qubit_labels)
    angles = [sample_haar_random_one_qubit_unitary_parameters(rand_state)
              for _ in qubits]
    return Circuit(_zxzxz_layers(qubits, angles, zname, xname),
                   line_labels=qubits)


def sample_compiled_random_clifford_one_qubit_gates_zxzxz_circuit(
        pspec, zname='Gzr', xname='Gxpi2', qubit_labels=None, rand_state=None):
    """Like the Haar variant but with random multiple-of-pi/2 Z angles
    (reference: randomcircuit.py:87)."""
    qubits = tuple(qubit_labels) if qubit_labels is not None \
        else tuple(pspec.qubit_labels)
    angles = [sample_random_clifford_one_qubit_unitary_parameters(rand_state)
              for _ in qubits]
    return Circuit(_zxzxz_layers(qubits, angles, zname, xname),
                   line_labels=qubits)


def sample_random_cz_zxzxz_circuit(pspec, length, qubit_labels=None,
                                   two_q_gate_density=0.25,
                                   one_q_gate_type='haar',
                                   two_q_gate_args_lists=None,
                                   rand_state=None):
    """Forward circuit for non-Clifford mirror RB: `length` alternating
    blocks of (ZXZXZ-compiled random 1Q unitary layer, edgegrab-sampled
    Gczr layer), capped by one final 1Q layer (reference:
    randomcircuit.py:116)."""
    if two_q_gate_args_lists is None:
        two_q_gate_args_lists = {'Gczr': [(str(np.pi / 2),), (str(-np.pi / 2),)]}
    if one_q_gate_type == 'haar':
        sample_1q = sample_compiled_haar_random_one_qubit_gates_zxzxz_circuit
    elif one_q_gate_type == 'clifford':
        sample_1q = sample_compiled_random_clifford_one_qubit_gates_zxzxz_circuit
    else:
        raise ValueError("Unknown value %r for `one_q_gate_type`!"
                         % one_q_gate_type)
    qubits = tuple(qubit_labels) if qubit_labels is not None \
        else tuple(pspec.qubit_labels)
    layers = []
    for _ in range(length):
        layers.extend(sample_1q(pspec, qubit_labels=qubits,
                                rand_state=rand_state).layertup)
        layers.append(sample_circuit_layer_by_edgegrab(
            pspec, qubit_labels=qubits, two_q_gate_density=two_q_gate_density,
            one_q_gate_names=[], gate_args_lists=two_q_gate_args_lists,
            rand_state=rand_state))
    layers.extend(sample_1q(pspec, qubit_labels=qubits,
                            rand_state=rand_state).layertup)
    return Circuit(layers, line_labels=qubits)


def find_all_sets_of_compatible_two_q_gates(edgelist, n, gatename='Gcnot',
                                            aslabel=False):
    """All size-`n` subsets of `edgelist` whose edges are pairwise disjoint,
    as Label lists or 'name:q0:q1' strings (reference:
    randomcircuit.py:160)."""
    import itertools
    out = []
    for pairs in itertools.combinations(edgelist, n):
        qs = [q for e in pairs for q in e]
        if len(qs) == len(set(qs)):
            if aslabel:
                out.append([Label(gatename, tuple(e)) for e in pairs])
            else:
                out.append(['%s:%s:%s' % (gatename, e[0], e[1])
                            for e in pairs])
    return out


def _compiled_1q_layer_circuit(pspec, sp_pairs, qubits, absolute_compilation):
    """Compile per-qubit 1Q Cliffords (symplectic (s,p) pairs) to native
    gates and pack the words into a parallelized circuit."""
    rules = absolute_compilation if isinstance(absolute_compilation,
                                               CompilationRules) \
        else CompilationRules(pspec)
    from pygsti_tpu_torch.algorithms.compilers import compile_1q_clifford
    words = [compile_1q_clifford(s, p, rules.native_1q, q)
             for (s, p), q in zip(sp_pairs, qubits)]
    depth = max((len(w) for w in words), default=0)
    layers = []
    for t in range(depth):
        comps = tuple(w[t] for w in words if t < len(w))
        layers.append(LabelTupTup.init(comps))
    if not layers:
        return Circuit(([],), line_labels=tuple(qubits))
    return Circuit(layers, line_labels=tuple(qubits))


def sample_pauli_layer_as_compiled_circuit(pspec, absolute_compilation=None,
                                           qubit_labels=None, keepidle=False,
                                           rand_state=None):
    """A uniformly random n-qubit Pauli compiled into the native gates of
    `pspec` (reference: randomcircuit.py:1339)."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    qubits = tuple(qubit_labels) if qubit_labels is not None \
        else tuple(pspec.qubit_labels)
    from pygsti_tpu_torch.algorithms.compilers import _gen_sreps
    sreps = _gen_sreps()
    paulis = ['I', 'X', 'Y', 'Z']
    r = rng.randint(0, 4, size=len(qubits))
    # the identity compiles to the empty word (the JAX package has no
    # representation of 'I' and raises KeyError where one is drawn)
    ident = (np.identity(2, np.int64), np.zeros(2, np.int64))
    sp_pairs = [sreps[paulis[k]] if k else ident for k in r]
    circ = _compiled_1q_layer_circuit(pspec, sp_pairs, qubits,
                                      absolute_compilation)
    if keepidle and circ.depth == 0:
        circ = Circuit([LabelTupTup.init(())], line_labels=qubits)
    return circ


def sample_one_q_clifford_layer_as_compiled_circuit(pspec,
                                                    absolute_compilation=None,
                                                    qubit_labels=None,
                                                    rand_state=None):
    """A layer of independent uniformly random 1Q Cliffords compiled into
    native gates (reference: randomcircuit.py:1393)."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    qubits = tuple(qubit_labels) if qubit_labels is not None \
        else tuple(pspec.qubit_labels)
    creps = sym.compute_internal_gate_symplectic_representations(
        ['Gc%d' % i for i in range(24)])
    r = rng.randint(0, 24, size=len(qubits))
    sp_pairs = [creps['Gc%d' % k] for k in r]
    return _compiled_1q_layer_circuit(pspec, sp_pairs, qubits,
                                      absolute_compilation)


def random_alternating_clifford_circ(pspec, depth, qubit_labels=None,
                                     two_q_gate_density=0.25,
                                     rand_state=None):
    """`depth` composite blocks of (edgegrab 2Q layer, random 1Q layer)
    (reference: randomcircuit.py:2418)."""
    qubits = tuple(qubit_labels) if qubit_labels is not None \
        else tuple(pspec.qubit_labels)
    layers = []
    for _ in range(depth):
        layers.append(sample_circuit_layer_by_edgegrab(
            pspec, qubit_labels=qubits, two_q_gate_density=two_q_gate_density,
            rand_state=rand_state))
        layers.append(sample_circuit_layer_of_one_q_gates(
            pspec, qubit_labels=qubits, rand_state=rand_state))
    return Circuit(layers, line_labels=qubits)
