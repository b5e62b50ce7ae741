"""Symplectic representation of Clifford operations (the RB backbone).

Follows the Hostens & De Moor formalism (PRA 71, 042315 (2005)) with the
same conventions as the reference (pygsti/tools/symplectic.py): an n-qubit
Clifford C is a pair (s, p) -- a 2n x 2n symplectic matrix over Z_2 and a
length-2n phase vector over Z_4 -- describing how C conjugates the
generators X_i, Z_i.  Basis-vector ordering is (X_1..X_n, Z_1..Z_n)
('standard' convention).  Stabilizer states are (s, p) pairs whose first n
columns are the stabilizer generators and last n the destabilizers.

All formulas verified numerically against unitary conjugation in tests.
"""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.tools import matrixmod2 as mod2


def symplectic_form(n, convention='standard'):
    """Omega = [[0, I], [-I, 0]] mod 2 ('standard') or the 'directsum' form."""
    ident = np.identity(n, np.int64)
    zeros = np.zeros((n, n), np.int64)
    if convention == 'standard':
        return np.block([[zeros, ident], [ident, zeros]]).astype(np.int64)
    # 'directsum': interleaved x/z pairs
    omega = np.zeros((2 * n, 2 * n), np.int64)
    for i in range(n):
        omega[2 * i, 2 * i + 1] = 1
        omega[2 * i + 1, 2 * i] = 1
    return omega


def check_symplectic(m, convention='standard'):
    n = m.shape[0] // 2
    omega = symplectic_form(n, convention)
    return np.array_equal(np.dot(np.dot(m.T, omega), m) % 2, omega)


def inverse_symplectic(s):
    """s^-1 = Omega s^T Omega (mod 2)."""
    n = s.shape[0] // 2
    omega = symplectic_form(n)
    return np.dot(np.dot(omega, s.T), omega) % 2


def check_valid_clifford(s, p):
    if not check_symplectic(s):
        return False
    # phase vector must make conjugated Paulis Hermitian:
    # p + diag(s^T U s) must be even (U = lower-left identity block)
    n = s.shape[0] // 2
    u = np.zeros((2 * n, 2 * n), np.int64)
    u[n:2 * n, 0:n] = np.identity(n, np.int64)
    vec = p + mod2.diagonal_as_vec(np.dot(np.dot(s.T, u), s))
    return bool(np.all(vec % 2 == 0))


def construct_valid_phase_vector(s, pseed):
    """Adjust the odd entries of pseed to make (s, p) a valid Clifford."""
    n = s.shape[0] // 2
    u = np.zeros((2 * n, 2 * n), np.int64)
    u[n:2 * n, 0:n] = np.identity(n, np.int64)
    d = mod2.diagonal_as_vec(np.dot(np.dot(s.T, u), s))
    p = np.array(pseed, np.int64) % 4
    for i in range(2 * n):
        if (p[i] + d[i]) % 2 != 0:
            p[i] = (p[i] + 1) % 4
    return p


def compose_cliffords(s1, p1, s2, p2, do_checks=False):
    """(s, p) of C2 C1 (C1 acts first); Hostens & De Moor Eq. for products
    (reference: symplectic.py:449)."""
    n = s1.shape[0] // 2
    s = mod2.dot_mod2(s2, s1)
    u = np.zeros((2 * n, 2 * n), np.int64)
    u[n:2 * n, 0:n] = np.identity(n, np.int64)
    vec1 = np.dot(s1.T, p2)
    inner = np.dot(np.dot(s2.T, u), s2)
    matrix = 2 * mod2.strictly_upper_triangle(inner) + mod2.diagonal_as_matrix(inner)
    vec2 = mod2.diagonal_as_vec(np.dot(np.dot(s1.T, matrix), s1))
    vec3 = np.dot(s1.T, mod2.diagonal_as_vec(inner))
    p = (p1 + vec1 + vec2 - vec3) % 4
    if do_checks:
        assert check_valid_clifford(s, p)
    return s, p


def inverse_clifford(s, p):
    """(s, p) of C^-1 (reference: symplectic.py:173)."""
    n = s.shape[0] // 2
    sinv = inverse_symplectic(s)
    u = np.zeros((2 * n, 2 * n), np.int64)
    u[n:2 * n, 0:n] = np.identity(n, np.int64)
    vec1 = -np.dot(sinv.T, p)
    inner = np.dot(np.dot(sinv.T, u), sinv)
    temp = 2 * mod2.strictly_upper_triangle(inner) + mod2.diagonal_as_matrix(inner)
    temp = mod2.diagonal_as_vec(np.dot(np.dot(s.T, temp), s))
    vec2 = -np.dot(sinv.T, temp)
    vec3 = mod2.diagonal_as_vec(inner)
    pinv = (vec1 + vec2 + vec3) % 4
    return sinv, pinv


# ---------------------------------------------------------------------------
# Stabilizer states
# ---------------------------------------------------------------------------

def prep_stabilizer_state(nqubits, zvals=None):
    """(s, p) of |z_1...z_n>: stabilizers (-1)^{z_i} Z_i in the first n
    columns, destabilizers X_i in the last n."""
    n = nqubits
    s = np.zeros((2 * n, 2 * n), np.int64)
    # column j (j<n): stabilizer Z_j -> z-part e_j
    for j in range(n):
        s[n + j, j] = 1      # Z_j
        s[j, n + j] = 1      # destabilizer X_j
    p = np.zeros(2 * n, np.int64)
    if zvals is not None:
        for j, z in enumerate(zvals):
            if int(z):
                p[j] = 2  # phase -1 on stabilizer Z_j
    return s, p


def apply_clifford_to_stabilizer_state(s, p, state_s, state_p):
    """Apply Clifford (s, p) to stabilizer state (reference: symplectic.py:587)."""
    n = s.shape[0] // 2
    out_s = mod2.dot_mod2(s, state_s)
    u = np.zeros((2 * n, 2 * n), np.int64)
    u[n:2 * n, 0:n] = np.identity(n, np.int64)
    inner = np.dot(np.dot(s.T, u), s)
    vec1 = np.dot(state_s.T, p - mod2.diagonal_as_vec(inner))
    matrix = 2 * mod2.strictly_upper_triangle(inner) + mod2.diagonal_as_matrix(inner)
    vec2 = mod2.diagonal_as_vec(np.dot(np.dot(state_s.T, matrix), state_s))
    out_p = (state_p + vec1 + vec2) % 4
    return out_s, out_p


def _pauli_product_phase_exponent(x1, z1, e1, x2, z2, e2):
    """Multiply P1 P2 where Pk = i^{ek} X^{xk} Z^{zk} (plain convention, the
    one used by the phase vectors); return (x, z, e) with e mod 4."""
    # Z^{z1} X^{x2} = (-1)^{z1.x2} X^{x2} Z^{z1}
    phase = (e1 + e2 + 2 * int(np.dot(z1, x2))) % 4
    x = (x1 + x2) % 2
    z = (z1 + z2) % 2
    return x, z, phase


def _column_pauli(state_s, state_p, col, n):
    """(x, z, e) of column `col`: the operator is i^{p_col} X^{x} Z^{z}
    (plain convention, matching the reference's phase vectors)."""
    x = state_s[0:n, col].copy()
    z = state_s[n:2 * n, col].copy()
    return x, z, int(state_p[col])


def pauli_z_measurement_probability(state_s, state_p, qubit_index):
    """P(outcome 0) of measuring Z on `qubit_index`; (prob0, deterministic).

    Deterministic iff every stabilizer generator commutes with Z_a (no X
    component on qubit a).  In that case the sign of Z_a as a product of
    stabilizer generators fixes the outcome; otherwise prob = 1/2.
    """
    two_n = len(state_p)
    n = two_n // 2
    a = qubit_index
    x_parts = state_s[a, 0:n]
    if np.any(x_parts == 1):
        return 0.5, False
    # solve sum_j c_j * stab_col_j = (0 | e_a) over GF(2)
    A = state_s[:, 0:n]
    b = np.zeros(two_n, np.int64)
    b[n + a] = 1
    c = mod2.solve_mod2(A, b)
    assert c is not None, "Invalid stabilizer state (Z_a not in group)"
    # accumulate the product of the selected generators
    x = np.zeros(n, np.int64)
    z = np.zeros(n, np.int64)
    e = 0
    for j in range(n):
        if c[j]:
            xj, zj, ej = _column_pauli(state_s, state_p, j, n)
            x, z, e = _pauli_product_phase_exponent(x, z, e, xj, zj, ej)
    # resulting operator should be +/- Z_a: i^e X^0 Z^{e_a}
    assert not np.any(x), "Pauli product is not Z-type"
    sign = (e % 4)
    assert sign in (0, 2), "Non-real phase for Z_a expectation (convention bug)"
    return (1.0, True) if sign == 0 else (0.0, True)


def measure_all_qubits_deterministic(state_s, state_p):
    """Assuming the state is a computational basis state, return its bit
    string (used for ideal RB outcomes)."""
    n = len(state_p) // 2
    bits = []
    for a in range(n):
        p0, det = pauli_z_measurement_probability(state_s, state_p, a)
        assert det, "State is not a computational basis state on qubit %d" % a
        bits.append(0 if p0 > 0.5 else 1)
    return tuple(bits)


# ---------------------------------------------------------------------------
# Gate representations
# ---------------------------------------------------------------------------

def _pauli_matrix_from_vec(x, z, plain=True):
    """X^{x} Z^{z} as a dense unitary (plain convention; set plain=False for
    the Hermitian W = i^{x.z} X^x Z^z)."""
    X = np.array([[0, 1], [1, 0]], complex)
    Z = np.array([[1, 0], [0, -1]], complex)
    n = len(x)
    out = np.ones((1, 1), complex)
    for k in range(n):
        m = np.eye(2, dtype=complex)
        if x[k]:
            m = m @ X
        if z[k]:
            m = m @ Z
        out = np.kron(out, m)
    if not plain:
        out = (1j) ** int(np.dot(x, z)) * out
    return out


def unitary_to_symplectic(u, flagnonclifford=True):
    """(s, p) of a Clifford unitary (1-4 qubits) via numeric conjugation
    (reference: symplectic.py:1445)."""
    u = np.asarray(u, dtype=complex)
    d = u.shape[0]
    n = int(round(np.log2(d)))
    s = np.zeros((2 * n, 2 * n), np.int64)
    p = np.zeros(2 * n, np.int64)
    # generators: X_j (cols j), Z_j (cols n+j)
    gens = []
    for j in range(n):
        x = np.zeros(n, np.int64)
        x[j] = 1
        gens.append((x, np.zeros(n, np.int64)))
    for j in range(n):
        z = np.zeros(n, np.int64)
        z[j] = 1
        gens.append((np.zeros(n, np.int64), z))
    # precompute all W(a) for matching
    for col, (gx, gz) in enumerate(gens):
        W = _pauli_matrix_from_vec(gx, gz)
        conj = u @ W @ u.conj().T
        # find (x', z', phase) with conj = i^q W(x', z')
        found = False
        for xz_int in range(4 ** n):
            bits = [(xz_int >> k) & 1 for k in range(2 * n)]
            xp = np.array(bits[:n], np.int64)
            zp = np.array(bits[n:], np.int64)
            Wp = _pauli_matrix_from_vec(xp, zp)
            ratio_mat = conj @ np.linalg.inv(Wp)
            val = ratio_mat[0, 0]
            if np.allclose(ratio_mat, val * np.identity(d), atol=1e-8) \
                    and np.isclose(abs(val), 1.0, atol=1e-8):
                q = int(round(np.angle(val) / (np.pi / 2))) % 4
                s[0:n, col] = xp
                s[n:2 * n, col] = zp
                p[col] = q
                found = True
                break
        if not found:
            if flagnonclifford:
                raise ValueError("Unitary is not a Clifford")
            return None, None
    if not check_valid_clifford(s, p):
        raise ValueError("Unitary is not a Clifford (invalid (s,p) extracted)")
    return s, p


_internal_srep_cache = {}


def compute_internal_gate_symplectic_representations(gllist=None):
    """(s, p) for the standard named Clifford gates (reference:
    symplectic.py:940)."""
    from pygsti_tpu_torch.tools.internalgates import standard_gatename_unitaries
    std = standard_gatename_unitaries()
    # short aliases the reference also exposes (symplectic.py:984-1049)
    short = {'I': 'Gi', 'H': 'Gh', 'P': 'Gp', 'PH': None, 'HP': None,
             'HPH': None, 'CNOT': 'Gcnot', 'SWAP': 'Gswap',
             'CPHASE': 'Gcphase',
             'X': 'Gxpi', 'Y': 'Gypi', 'Z': 'Gzpi'}
    if gllist is None:
        gllist = ['Gi', 'Gxpi', 'Gypi', 'Gzpi', 'Gxpi2', 'Gypi2', 'Gzpi2',
                  'Gxmpi2', 'Gympi2', 'Gzmpi2', 'Gh', 'Gp', 'Gpdag',
                  'Gcnot', 'Gcphase', 'Gswap'] \
            + ['Gc%d' % i for i in range(24)] \
            + [k for k, v in short.items() if v is not None]
    out = {}
    for name in gllist:
        if name in _internal_srep_cache:
            out[name] = _internal_srep_cache[name]
            continue
        u = std.get(short.get(name) or name, std.get(name))
        if u is None:
            continue
        try:
            srep = unitary_to_symplectic(u)
        except ValueError:
            continue
        _internal_srep_cache[name] = srep
        out[name] = srep
    return out


def symplectic_kronecker(sp_factors):
    """Tensor together per-factor (s, p) reps (reference: symplectic.py:512)."""
    nlist = [s.shape[0] // 2 for (s, p) in sp_factors]
    n = sum(nlist)
    s = np.zeros((2 * n, 2 * n), np.int64)
    p = np.zeros(2 * n, np.int64)
    off = 0
    for (sk, pk), nk in zip(sp_factors, nlist):
        s[off:off + nk, off:off + nk] = sk[0:nk, 0:nk]                 # XX
        s[off:off + nk, n + off:n + off + nk] = sk[0:nk, nk:2 * nk]    # XZ
        s[n + off:n + off + nk, off:off + nk] = sk[nk:2 * nk, 0:nk]    # ZX
        s[n + off:n + off + nk, n + off:n + off + nk] = sk[nk:2 * nk, nk:2 * nk]
        p[off:off + nk] = pk[0:nk]
        p[n + off:n + off + nk] = pk[nk:2 * nk]
        off += nk
    return s, p


def embed_clifford(s_small, p_small, target_qubits, n):
    """Embed a k-qubit Clifford acting on `target_qubits` into n qubits."""
    k = s_small.shape[0] // 2
    assert len(target_qubits) == k
    s = np.identity(2 * n, np.int64)
    p = np.zeros(2 * n, np.int64)
    for a, qa in enumerate(target_qubits):
        for b, qb in enumerate(target_qubits):
            s[qa, qb] = s_small[a, b]
            s[qa, n + qb] = s_small[a, k + b]
            s[n + qa, qb] = s_small[k + a, b]
            s[n + qa, n + qb] = s_small[k + a, k + b]
        # clear default identity if overwritten pattern doesn't include it
        if s_small[a, a] != 1 or np.sum(s_small[:, a]) != 1:
            pass
        p[qa] = p_small[a]
        p[n + qa] = p_small[k + a]
    # fix identity defaults for target columns: the loop above overwrote the
    # relevant entries; off-target entries of target columns must be zero
    for a, qa in enumerate(target_qubits):
        s[qa, qa] = s_small[a, a]
        s[n + qa, n + qa] = s_small[k + a, k + a]
    return s, p


def symplectic_rep_of_clifford_layer(layer, n, q_labels=None, srep_dict=None):
    """(s, p) of one circuit layer (reference: symplectic.py:1124)."""
    if q_labels is None:
        q_labels = list(range(n))
    qindex = {q: i for i, q in enumerate(q_labels)}
    srep_dict = srep_dict or compute_internal_gate_symplectic_representations()
    s = np.identity(2 * n, np.int64)
    p = np.zeros(2 * n, np.int64)
    components = layer.components if hasattr(layer, 'components') else [layer]
    for sub in components:
        name = sub.name
        if name not in srep_dict:
            raise ValueError("No symplectic rep for gate %r" % name)
        s_g, p_g = srep_dict[name]
        targets = [qindex[q] for q in (sub.sslbls or q_labels)]
        s_emb, p_emb = embed_clifford(s_g, p_g, targets, n)
        s, p = compose_cliffords(s, p, s_emb, p_emb)
    return s, p


def symplectic_rep_of_clifford_circuit(circuit, srep_dict=None, pspec=None):
    """(s, p) of a whole Clifford circuit (reference: symplectic.py:1061)."""
    if pspec is not None:
        q_labels = list(pspec.qubit_labels)
        srep_dict = dict(compute_internal_gate_symplectic_representations())
        srep_dict.update(pspec.compute_clifford_symplectic_reps())
    else:
        q_labels = list(circuit.line_labels) if circuit.line_labels != ('*',) else None
        if q_labels is None:
            raise ValueError("Need line labels or pspec to define qubits")
        srep_dict = srep_dict or compute_internal_gate_symplectic_representations()
    n = len(q_labels)
    s = np.identity(2 * n, np.int64)
    p = np.zeros(2 * n, np.int64)
    for layer in circuit:
        s_l, p_l = symplectic_rep_of_clifford_layer(layer, n, q_labels, srep_dict)
        s, p = compose_cliffords(s, p, s_l, p_l)
    return s, p


# ---------------------------------------------------------------------------
# Random symplectic/Clifford sampling (Koenig-Smolin, J. Math. Phys. 55, 122202)
# ---------------------------------------------------------------------------

def _symplectic_transvection(k, v):
    """Apply transvection Z_k: v -> v + <v, k> k (mod 2), standard form with
    interleaved (x1, z1, x2, z2, ...) ordering used internally here."""
    n2 = len(k)
    # symplectic inner product in interleaved ordering
    ip = 0
    for i in range(0, n2, 2):
        ip += k[i] * v[i + 1] + k[i + 1] * v[i]
    return (v + (ip % 2) * k) % 2


def _find_transvection(x, y):
    """Find h1, h2 with y = Z_h1 Z_h2 x (Koenig-Smolin Lemma 2)."""
    n2 = len(x)
    out = (np.zeros(n2, np.int64), np.zeros(n2, np.int64))
    if np.array_equal(x, y):
        return out

    def ip(a, b):
        tot = 0
        for i in range(0, n2, 2):
            tot += a[i] * b[i + 1] + a[i + 1] * b[i]
        return tot % 2

    if ip(x, y) == 1:
        h = (x + y) % 2
        return (h, np.zeros(n2, np.int64))
    # find z with <x,z> = <y,z> = 1
    z = np.zeros(n2, np.int64)
    # try pairs where both x and y have support
    done = False
    for i in range(0, n2, 2):
        if (x[i] or x[i + 1]) and (y[i] or y[i + 1]):
            z[i] = (x[i] + y[i]) % 2
            z[i + 1] = (x[i + 1] + y[i + 1]) % 2
            if z[i] == 0 and z[i + 1] == 0:
                z[i + 1] = 1
                if x[i] != x[i + 1]:
                    z[i] = 1
            done = True
            break
    if not done:
        # disjoint supports
        for i in range(0, n2, 2):
            if x[i] or x[i + 1]:
                if x[i] == x[i + 1]:
                    z[i + 1] = 1
                else:
                    z[i + 1] = x[i]
                    z[i] = x[i + 1]
                break
        for i in range(0, n2, 2):
            if (y[i] or y[i + 1]) and not (x[i] or x[i + 1]):
                if y[i] == y[i + 1]:
                    z[i + 1] = 1
                else:
                    z[i + 1] = y[i]
                    z[i] = y[i + 1]
                break
    return ((x + z) % 2, (z + y) % 2)


def random_symplectic_matrix(n, convention='standard', rand_state=None):
    """Uniformly random 2n x 2n symplectic matrix over GF(2)
    (Koenig & Smolin algorithm; reference: symplectic.py:1483)."""
    rng = rand_state if rand_state is not None else np.random.RandomState()

    def symplectic_ks(i, n_):
        """i-th symplectic matrix of Sp(2n) in KS enumeration (interleaved form)."""
        nn = 2 * n_
        s = int(i % (2 ** nn - 1)) + 1
        i = i // (2 ** nn - 1)
        f1 = np.array([(s >> j) & 1 for j in range(nn)], np.int64)
        e1 = np.zeros(nn, np.int64)
        e1[0] = 1
        t1, t2 = _find_transvection(e1, f1)
        bits = [(i >> j) & 1 for j in range(nn - 1)]
        eprime = e1.copy()
        for j in range(2, nn):
            eprime[j] = bits[j - 1]
        h0 = _symplectic_transvection(t1, eprime)
        h0 = _symplectic_transvection(t2, h0)
        if bits[0] == 1:
            f1 = f1 * 0
        id2 = np.identity(2, np.int64)
        if n_ == 1:
            g = id2.copy()
        else:
            g_small = symplectic_ks(i >> (nn - 1), n_ - 1)
            g = np.identity(nn, np.int64)
            g[2:, 2:] = g_small
        for j in range(nn):
            g[j] = _symplectic_transvection(t1, g[j])
            g[j] = _symplectic_transvection(t2, g[j])
            g[j] = _symplectic_transvection(h0, g[j])
            g[j] = _symplectic_transvection(f1, g[j])
        return g

    # number of symplectic matrices: prod (4^j - 1) 4^... ; sample index
    # uniformly by sampling each factor range
    nn = 2 * n
    index = 0
    mult = 1
    for j in range(1, n + 1):
        nj = 2 * j
        sz = (2 ** nj - 1) * (2 ** (nj - 1))
        index += mult * rng.randint(0, sz)
        mult *= sz
    g = symplectic_ks(index, n)
    # convert interleaved ordering -> standard (X1..Xn, Z1..Zn)
    perm = [2 * i for i in range(n)] + [2 * i + 1 for i in range(n)]
    g_std = g[np.ix_(perm, perm)]
    if convention == 'standard':
        return g_std
    return g


def random_clifford(n, rand_state=None):
    """Uniformly random n-qubit Clifford (s, p) (reference:
    symplectic.py random_clifford)."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    s = random_symplectic_matrix(n, 'standard', rng)
    pseed = 2 * rng.randint(0, 2, 2 * n)
    p = construct_valid_phase_vector(s, pseed)
    return s, p


# ---------------------------------------------------------------------------
# Measurement with state collapse (Aaronson-Gottesman PRA 70, 052328 update,
# in the Hostens column convention used here)
# ---------------------------------------------------------------------------

def _multiply_columns(state_s, state_p, dest_col, src_col, n):
    """col_dest <- col_src * col_dest (Pauli product with phase tracking)."""
    x1, z1, e1 = _column_pauli(state_s, state_p, src_col, n)
    x2, z2, e2 = _column_pauli(state_s, state_p, dest_col, n)
    x, z, e = _pauli_product_phase_exponent(x1, z1, e1, x2, z2, e2)
    state_s[0:n, dest_col] = x
    state_s[n:2 * n, dest_col] = z
    state_p[dest_col] = e % 4


def pauli_z_measurement(state_s, state_p, qubit_index):
    """Measure Z on `qubit_index`: returns
    (p0, (s0, p0vec), p1, (s1, p1vec)) -- outcome probabilities and the
    collapsed post-measurement states (None for zero-probability branches).
    """
    two_n = len(state_p)
    n = two_n // 2
    a = qubit_index
    prob0, det = pauli_z_measurement_probability(state_s, state_p, a)
    if det:
        if prob0 > 0.5:
            return 1.0, (state_s, state_p), 0.0, None
        return 0.0, None, 1.0, (state_s, state_p)

    def collapse(outcome_bit):
        s = state_s.copy()
        p = state_p.copy()
        pivot = next(c for c in range(n) if s[a, c] == 1)
        for c in range(2 * n):
            if c != pivot and s[a, c] == 1:
                _multiply_columns(s, p, c, pivot, n)
        # destabilizer of the pivot becomes the old stabilizer
        s[:, n + pivot] = s[:, pivot]
        p[n + pivot] = p[pivot]
        # new stabilizer = +/- Z_a
        s[:, pivot] = 0
        s[n + a, pivot] = 1
        p[pivot] = 0 if outcome_bit == 0 else 2
        return s, p

    return 0.5, collapse(0), 0.5, collapse(1)


def stabilizer_outcome_probability(state_s, state_p, outcome_bits):
    """Probability of a specific computational outcome bitstring for a
    stabilizer state (poly-time, any qubit count)."""
    prob = 1.0
    s, p = state_s, state_p
    for a, bit in enumerate(outcome_bits):
        p0, st0, p1, st1 = pauli_z_measurement(s, p, a)
        if bit == 0:
            if p0 == 0.0:
                return 0.0
            prob *= p0
            s, p = st0
        else:
            if p1 == 0.0:
                return 0.0
            prob *= p1
            s, p = st1
    return prob


# =============================================================================
# Reference-surface parity: public helpers the reference exposes from
# tools/symplectic.py.  The Koenig-Smolin enumeration functions implement the
# published algorithm ("How to efficiently select an arbitrary Clifford group
# element", J. Math. Phys. 55, 122202 (2014)); Pauli-layer bookkeeping follows
# the Hostens-De Moor phase conventions used throughout this module.
# =============================================================================

def change_symplectic_form_convention(s, outconvention='standard'):
    """Convert a symplectic matrix between the 'standard' (X1..Xn, Z1..Zn)
    and 'directsum' (X1, Z1, X2, Z2, ...) orderings (reference:
    symplectic.py:73)."""
    n = s.shape[0] // 2
    perm = np.array([2 * i for i in range(n)] + [2 * i + 1 for i in range(n)])
    if outconvention == 'standard':
        return s[np.ix_(perm, perm)]
    if outconvention == 'directsum':
        inv = np.argsort(perm)
        return s[np.ix_(inv, inv)]
    raise ValueError("Invalid `outconvention`: %s" % outconvention)


def symplectic_innerproduct(v, w):
    """The symplectic inner product <v, w> = v^T Omega w mod 2 over
    F_2^{2n} in the directsum convention (reference: symplectic.py:1774)."""
    nn = len(v)
    vw = 0
    for i in range(0, nn, 2):
        vw += v[i] * w[i + 1] + v[i + 1] * w[i]
    return int(vw % 2)


def symplectic_transvection(k, v):
    """Apply the transvection Z_k: v -> v + <v,k> k (mod 2) (reference:
    symplectic.py:1801)."""
    return _symplectic_transvection(k, v)


def find_symplectic_transvection(x, y):
    """Two transvections (h1, h2) with Z_h1 Z_h2 x = y, for nonzero x, y
    (Lemma 2 of Koenig-Smolin; reference: symplectic.py:1841)."""
    return _find_transvection(x, y)


def int_to_bitstring(i, n):
    """Little-endian length-`n` bit array of integer `i` (reference:
    symplectic.py:1823)."""
    return np.array([(int(i) >> j) & 1 for j in range(n)], np.int8)


def bitstring_to_int(b, n):
    """Integer of the little-endian length-`n` bit array `b` (reference:
    symplectic.py:1856)."""
    return int(sum((1 << j) for j in range(n) if int(b[j]) & 1))


def compute_num_symplectics(n):
    """|Sp(2n, F_2)| = prod_{j=1..n} 4^j - 1) * 2^(2j-1) ... computed via the
    Koenig-Smolin per-level factors (reference: symplectic.py:1731)."""
    num = 1
    for j in range(1, n + 1):
        num *= (2 ** (2 * j) - 1) * (2 ** (2 * j - 1))
    return num


def compute_num_cliffords(n):
    """The size of the n-qubit Clifford group (up to phases):
    4^n * |Sp(2n)| (reference: symplectic.py:1711)."""
    return (4 ** n) * compute_num_symplectics(n)


def compute_num_cosets(n):
    """|Sp(2n)| / |Sp(2n-2)|: the number of cosets at the outermost
    Koenig-Smolin level (reference: symplectic.py:1754)."""
    return (2 ** (2 * n) - 1) * (2 ** (2 * n - 1))


def compute_symplectic_matrix(i, n):
    """The `i`-th 2n x 2n symplectic matrix in the Koenig-Smolin canonical
    enumeration (directsum-ordered rows, as in the published algorithm;
    reference: symplectic.py:1956)."""
    nn = 2 * n
    ncosets = (2 ** nn - 1) * (2 ** (nn - 1))
    s_int = int(i % (2 ** nn - 1)) + 1
    rest = int(i) // (2 ** nn - 1)
    f1 = int_to_bitstring(s_int, nn).astype(np.int64)
    e1 = np.zeros(nn, np.int64)
    e1[0] = 1
    t1, t2 = _find_transvection(e1, f1)
    bits = [(rest >> j) & 1 for j in range(nn - 1)]
    eprime = e1.copy()
    for j in range(2, nn):
        eprime[j] = bits[j - 1]
    h0 = _symplectic_transvection(t1, eprime)
    h0 = _symplectic_transvection(t2, h0)
    if bits[0] == 1:
        f1 = f1 * 0
    if n == 1:
        g = np.identity(2, np.int64)
    else:
        g = np.identity(nn, np.int64)
        g[2:, 2:] = compute_symplectic_matrix(rest >> (nn - 1), n - 1)
    for j in range(nn):
        g[j] = _symplectic_transvection(t1, g[j])
        g[j] = _symplectic_transvection(t2, g[j])
        g[j] = _symplectic_transvection(h0, g[j])
        g[j] = _symplectic_transvection(f1, g[j])
    return g


def compute_symplectic_label(gn, n=None):
    """The Koenig-Smolin canonical index of symplectic matrix `gn`
    (directsum-ordered; inverse of compute_symplectic_matrix; reference:
    symplectic.py:2037)."""
    gn = np.asarray(gn, np.int64)
    if n is None:
        n = gn.shape[0] // 2
    nn = 2 * n
    v, w = gn[0], gn[1]
    e1 = np.zeros(nn, np.int64)
    e1[0] = 1
    # transvections mapping v back onto e1
    t1, t2 = _find_transvection(v, e1)
    tw = _symplectic_transvection(t2, _symplectic_transvection(t1, np.copy(w)))
    b = int(tw[0])
    h0 = np.zeros(nn, np.int64)
    h0[0] = 1
    h0[2:] = tw[2:]
    # the per-level coset index packs (nonzero first row, b, tw tail)
    bb = np.zeros(nn - 1, np.int64)
    bb[0] = b
    bb[1:] = tw[2:]
    zv = bitstring_to_int(v, nn) - 1
    zw = bitstring_to_int(bb, nn - 1)
    cvw = zw * (2 ** nn - 1) + zv
    if n == 1:
        return cvw
    gprime = np.copy(gn)
    for j in range(nn):
        gprime[j] = _symplectic_transvection(
            t2, _symplectic_transvection(t1, gn[j]))
        gprime[j] = _symplectic_transvection(h0, gprime[j])
        if b == 0:
            gprime[j] = _symplectic_transvection(e1, gprime[j])
    gnew = gprime[2:, 2:]
    return cvw + compute_num_cosets(n) * compute_symplectic_label(gnew, n - 1)


def random_symplectic_index(n, rand_state=None):
    """A uniformly random index into the Koenig-Smolin enumeration of
    Sp(2n, F_2) -- sampled per-level so arbitrarily large group orders never
    overflow (reference: symplectic.py:2116)."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    index = 0
    mult = 1
    for j in range(1, n + 1):
        sz = (2 ** (2 * j) - 1) * (2 ** (2 * j - 1))
        index += mult * int(rng.randint(0, sz))
        mult *= sz
    return index


def random_phase_vector(s, n, rand_state=None):
    """A uniformly random valid phase vector for the symplectic matrix `s`
    (reference: symplectic.py:1552)."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    pseed = 2 * rng.randint(0, 2, size=2 * n)
    return construct_valid_phase_vector(s, pseed)


def colsum(i, j, s, p, n):
    """Stabilizer-frame column update: generator[i] *= generator[j]
    (in place on `s` [2n, 2n] mod-2 and `p` [2n] mod-4; reference:
    symplectic.py:741)."""
    u = np.zeros((2 * n, 2 * n), np.int64)
    u[n:2 * n, 0:n] = np.identity(n, np.int64)
    p[i] += p[j] + 2 * int(np.dot(s[:, i].T, np.dot(u, s[:, j])))
    s[:, i] ^= s[:, j]


def colsum_acc(acc_s, acc_p, j, s, p, n):
    """colsum into a separate accumulator column `acc_s` [2n], `acc_p` [1]
    (reference: symplectic.py:791)."""
    u = np.zeros((2 * n, 2 * n), np.int64)
    u[n:2 * n, 0:n] = np.identity(n, np.int64)
    acc_p[0] += p[j] + 2 * int(np.dot(acc_s.T, np.dot(u, s[:, j])))
    acc_s ^= s[:, j]


def find_pauli_number(pvec):
    """Per-qubit Pauli indices (0=I, 1=X, 2=Y, 3=Z) of the Pauli encoded by
    phase vector `pvec` (reference: symplectic.py:440)."""
    n = len(pvec) // 2
    v = (np.asarray(pvec[0:n]) // 2) + 2 * (np.asarray(pvec[n:]) // 2)
    return [[0, 3, 1, 2][int(i)] for i in v]


def find_pauli_layer(pvec, qubit_labels, pauli_labels=None):
    """[(pauli_label, qubit_label), ...] for the Pauli encoded by phase
    vector `pvec` (reference: symplectic.py:429)."""
    if pauli_labels is None:
        pauli_labels = ['I', 'X', 'Y', 'Z']
    return [(pauli_labels[p], q)
            for p, q in zip(find_pauli_number(pvec), qubit_labels)]


def bitstring_for_pauli(p):
    """The computational-basis bitstring the Pauli with phase vector `p`
    creates from |0...0> (reference: symplectic.py:1615)."""
    n = len(p) // 2
    return [1 if int(b) > 0 else 0 for b in p[n:]]


def _pauli_layer_from_vec(vec, n, qubit_labels):
    labels = []
    for q in range(n):
        x, z = int(vec[q]) % 2, int(vec[q + n]) % 2
        labels.append((('I', 'Z', 'X', 'Y')[2 * x + z], qubit_labels[q]))
    return labels


def find_postmultipled_pauli(s, p_implemented, p_target, qubit_labels=None):
    """The Pauli layer to APPEND to a circuit implementing (s,
    p_implemented) so that it implements (s, p_target) (reference:
    symplectic.py:315)."""
    from pygsti_tpu_torch.tools import matrixmod2 as _m2
    n = s.shape[0] // 2
    omega = symplectic_form(n)
    vec = _m2.dot_mod2(s, np.dot(omega, (np.asarray(p_target)
                                         - np.asarray(p_implemented)) // 2))
    if qubit_labels is None:
        qubit_labels = list(range(n))
    return _pauli_layer_from_vec(vec, n, qubit_labels)


def find_premultipled_pauli(s, p_implemented, p_target, qubit_labels=None):
    """The Pauli layer to PREPEND to a circuit implementing (s,
    p_implemented) so that it implements (s, p_target) (reference:
    symplectic.py:372)."""
    from pygsti_tpu_torch.tools import matrixmod2 as _m2
    n = s.shape[0] // 2
    omega = symplectic_form(n)
    vec = _m2.dot_mod2(omega, (np.asarray(p_target)
                               - np.asarray(p_implemented)) // 2)
    if qubit_labels is None:
        qubit_labels = list(range(n))
    return _pauli_layer_from_vec(vec, n, qubit_labels)


def apply_internal_gate_to_symplectic(s, gate_name, qindex_list,
                                      optype='row'):
    """Apply H / P / CNOT / SWAP to the rows or columns of the symplectic
    matrix `s` in place (reference: symplectic.py:1638)."""
    n = s.shape[0] // 2
    if optype not in ('row', 'column'):
        raise ValueError("optype must be 'row' or 'column'!")
    if gate_name == 'H':
        i = qindex_list[0]
        if optype == 'row':
            s[[i + n, i], :] = s[[i, i + n], :]
        else:
            s[:, [i + n, i]] = s[:, [i, i + n]]
    elif gate_name == 'P':
        i = qindex_list[0]
        if optype == 'row':
            s[i + n, :] = s[i, :] ^ s[i + n, :]
        else:
            s[:, i] = s[:, i] ^ s[:, i + n]
    elif gate_name == 'CNOT':
        c, t = qindex_list[0], qindex_list[1]
        if optype == 'row':
            s[t, :] = s[t, :] ^ s[c, :]
            s[c + n, :] = s[t + n, :] ^ s[c + n, :]
        else:
            s[:, c] = s[:, c] ^ s[:, t]
            s[:, t + n] = s[:, t + n] ^ s[:, c + n]
    elif gate_name == 'SWAP':
        i, j = qindex_list[0], qindex_list[1]
        if optype == 'row':
            s[[i, j, i + n, j + n], :] = s[[j, i, j + n, i + n], :]
        else:
            s[:, [i, j, i + n, j + n]] = s[:, [j, i, j + n, i + n]]
    else:
        raise ValueError("Unsupported gate name: %s" % gate_name)


def one_q_clifford_symplectic_group_relations():
    """The up-to-Pauli composition table of the 1-qubit Clifford coset
    representatives 'I','H','P','HP','PH','HPH': table[(A, B)] = C when
    B.A = C x Pauli (reference: symplectic.py:1211).  Computed directly
    from the symplectic representations rather than hard-coded."""
    srep = compute_internal_gate_symplectic_representations()
    names = ('I', 'H', 'P', 'HP', 'PH', 'HPH')
    mats = {}
    for name in names:
        s = np.identity(2, np.int64)
        p = np.zeros(2, np.int64)
        for g in reversed(name if name != 'I' else ''):
            gs, gp = srep[g]
            s, p = compose_cliffords(s, p, gs, gp)
        mats[name] = s
    table = {}
    for a in names:
        for b in names:
            sba = np.dot(mats[b], mats[a]) % 2
            for c in names:
                if np.array_equal(sba, mats[c]):
                    table[(a, b)] = c
                    break
    return table


def unitary_is_clifford(unitary):
    """True when `unitary` (standard basis) is a Clifford gate (reference:
    symplectic.py:1276)."""
    try:
        s, p = unitary_to_symplectic(unitary, flagnonclifford=False)
    except Exception:
        return False
    return s is not None


def stabilizer_measurement_prob(state_sp_tuple, moutcomes, qubit_filter=None,
                                return_state=False):
    """Probability of computational-basis outcome `moutcomes` when measuring
    the qubits in `qubit_filter` (all qubits when None) of the stabilizer
    state `(s, p)` (reference: symplectic.py:846)."""
    s, p = state_sp_tuple
    s = np.array(s, np.int64)
    p = np.array(p, np.int64)
    n = s.shape[0] // 2
    qubits = list(range(n)) if qubit_filter is None else list(qubit_filter)
    prob = 1.0
    for q, out in zip(qubits, moutcomes):
        p0, st0, p1, st1 = pauli_z_measurement(s, p, q)
        branch_prob, branch_state = (p0, st0) if int(out) == 0 else (p1, st1)
        prob *= branch_prob
        if branch_state is None:  # deterministic opposite outcome
            prob = 0.0
            break
        s, p = branch_state
    if return_state:
        return prob, (s, p)
    return prob
