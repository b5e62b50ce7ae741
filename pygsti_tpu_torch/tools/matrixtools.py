"""Dense matrix helpers, host numpy/scipy in float64 (counterpart of
pygsti_tpu/tools/matrixtools.py).  The null spaces, intersections and
QR sign fixes here fix the FOGI directions, so they are the JAX package's
algorithms step for step: one input gives the same columns in both."""

from __future__ import annotations

import numpy as np
import scipy.linalg as spl


def is_hermitian(mx, tol=1e-9):
    m = np.asarray(mx)
    return m.shape[0] == m.shape[1] and np.allclose(m, m.conj().T, atol=tol)


def is_pos_def(mx, tol=1e-9):
    evals = np.linalg.eigvalsh(np.asarray(mx))
    return bool(np.all(evals > -tol))


def is_valid_density_mx(mx, tol=1e-9):
    m = np.asarray(mx)
    return is_hermitian(m, tol) and is_pos_def(m, tol) and abs(np.trace(m) - 1.0) < tol


def mx_to_string(m, width=9, prec=4):
    m = np.asarray(m)
    if np.iscomplexobj(m) and np.allclose(m.imag, 0, atol=1e-12):
        m = m.real
    return np.array2string(m, precision=prec, suppress_small=True)


def unitary_superoperator_matrix_log(m, mx_basis):
    """Log of a superoperator matrix that corresponds to a unitary map."""
    from pygsti_tpu_torch.tools.basistools import change_basis
    m_std = change_basis(np.asarray(m), mx_basis, 'std')
    ev, U = np.linalg.eig(m_std)
    log_ev = np.log(ev.astype(complex))
    # unitary superop evals lie on unit circle: log is purely imaginary
    log_m_std = U @ np.diag(log_ev) @ np.linalg.inv(U)
    return change_basis(log_m_std, 'std', mx_basis)


def real_matrix_log(m, action_if_imaginary="raise", tol=1e-8):
    """Real log of a real matrix, if it exists (reference: matrixtools.real_matrix_log)."""
    log_m = spl.logm(np.asarray(m))
    if np.linalg.norm(log_m.imag) > tol:
        if action_if_imaginary == "raise":
            raise ValueError("Matrix log has imaginary part")
        elif action_if_imaginary == "warn":
            import warnings
            warnings.warn("Matrix log has imaginary part; taking real part")
    return log_m.real


def approximate_matrix_log(m, target_logm, target_weight=10.0, tol=1e-6):
    """Real approximate log near a target (simplified version of the
    reference's iterative routine): project logm(m) onto real matrices."""
    log_m = spl.logm(np.asarray(m))
    return log_m.real


def nullspace(m, tol=1e-7):
    """SVD nullspace: columns span ker(m) (reference: matrixtools.nullspace,
    absolute singular-value tolerance)."""
    m = np.asarray(m)
    _, s, vh = np.linalg.svd(m)
    rank = int((s > tol).sum())
    return vh[rank:].T.conj()


def nice_nullspace(m, tol=1e-7, orthogonalize=False):
    """Nullspace with a 'nice' basis: project unit columns (chosen by pivoted
    QR) onto the nullspace, then scale each column so its largest-magnitude
    element is +1.0 (reference: matrixtools.nice_nullspace — conventions
    matter for FOGI direction reproducibility)."""
    nullsp = nullspace(m, tol)
    dim_ker = nullsp.shape[1]
    if dim_ker == 0:
        return nullsp
    _, _, p = spl.qr(nullsp.T.conj(), mode='raw', pivoting=True)
    ret = nullsp @ (nullsp.T[:, p[:dim_ker]]).conj()
    if orthogonalize:
        ret, _ = spl.qr(ret, mode='economic')
    for j in range(ret.shape[1]):  # normalize so largest element is +1.0
        imax = np.argmax(np.abs(ret[:, j]))
        if abs(ret[imax, j]) > 1e-6:
            ret[:, j] /= ret[imax, j]
    return ret


def column_basis_vector(i, dim):
    v = np.zeros((dim, 1))
    v[i] = 1.0
    return v


def safe_onenorm(m):
    return np.linalg.norm(np.asarray(m), 1)


def mx_rank(m, tol=1e-7):
    s = np.linalg.svd(np.asarray(m), compute_uv=False)
    return int(np.sum(s > tol))


def print_mx(m, width=9, prec=4):
    print(mx_to_string(m, width, prec))


def safe_expm(m):
    return spl.expm(np.asarray(m))


def random_hermitian(dim, seed=None):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    return (a + a.conj().T) / 2


def project_onto_antikite(m, kite):
    """Zero out the block-diagonal ('kite') part, keeping off-kite elements."""
    m = np.array(m)
    off = 0
    for blk in kite:
        m[off:off + blk, off:off + blk] = 0
        off += blk
    return m


def project_onto_kite(m, kite):
    """Keep only the block-diagonal ('kite') part."""
    m = np.asarray(m)
    out = np.zeros_like(m)
    off = 0
    for blk in kite:
        out[off:off + blk, off:off + blk] = m[off:off + blk, off:off + blk]
        off += blk
    return out


def gram_matrix(m, adjoint=False):
    """M^dag M (or M M^dag when adjoint) (reference:
    matrixtools.gram_matrix)."""
    m = np.asarray(m)
    return m @ m.conj().T if adjoint else m.conj().T @ m


def is_projector(m, tol=1e-9):
    """Is m a projector (m @ m == m)? (reference: matrixtools.is_projector)."""
    m = np.asarray(m)
    return bool(np.linalg.norm(m @ m - m) < tol)


def normalize_columns(m, return_norms=False, ord=None):
    """Column-normalized copy; `ord` may be an array of per-column norm
    orders.  Zero columns report norm 1.0 (reference:
    matrixtools.normalize_columns)."""
    norms = column_norms(m, ord)
    norms[norms == 0.0] = 1.0
    normalized_m = scale_columns(m, 1 / norms)
    return (normalized_m, norms) if return_norms else normalized_m


def column_norms(m, ord=None):
    """Per-column norms; `ord` may be a per-column array (reference:
    matrixtools.column_norms)."""
    m = np.asarray(m)
    if isinstance(ord, (list, np.ndarray)):
        if len(ord) != m.shape[1]:
            raise ValueError("one norm order per column is needed")
        return np.array([np.linalg.norm(m[:, j], ord=o)
                         for j, o in enumerate(ord)])
    return np.linalg.norm(m, axis=0, ord=ord)


def scale_columns(m, scale_values):
    """Scale each column by the given value (reference:
    matrixtools.scale_columns)."""
    return np.asarray(m) * np.asarray(scale_values)[None, :]


def sign_fix_qr(q, r, tol=1e-6):
    """Flip signs of Q columns / R rows so each Q column's (first) largest-
    magnitude element is positive — removes QR sign ambiguity (reference:
    matrixtools.sign_fix_qr)."""
    qq = q.copy()
    rr = r.copy()
    for i in range(q.shape[1]):
        max_abs = max(np.abs(q[:, i]))
        k = np.argmax(np.abs(q[:, i]) > (max_abs - tol))
        if q[k, i] < 0.0:
            qq[:, i] = -q[:, i]
            rr[i, :] = -r[i, :]
    return qq, rr


def columns_are_orthogonal(m, tol=1e-7):
    m = np.asarray(m)
    g = np.abs(m.conj().T @ m)
    np.fill_diagonal(g, 0)
    return bool(np.all(g < tol))


def columns_are_orthonormal(m, tol=1e-7):
    m = np.asarray(m)
    g = m.conj().T @ m
    return bool(np.allclose(g, np.eye(m.shape[1]), atol=tol))


def independent_columns(m, initial_independent_cols=None, tol=1e-7):
    """Indices of a maximal linearly independent column subset, optionally
    relative to a base of known-independent columns (reference:
    matrixtools.independent_columns: project out the base with QR, then
    rank + pivoted QR pick the columns)."""
    m = np.asarray(m)
    if initial_independent_cols is None or np.asarray(initial_independent_cols).shape[1] == 0:
        proj_m = m.copy()
    else:
        base = np.asarray(initial_independent_cols)
        if base.shape[0] != m.shape[0]:
            raise ValueError("the base's columns and m's differ in length")
        q = spl.qr(base, mode='economic')[0]
        proj_m = m - q @ (q.T.conj() @ m)
    if proj_m.shape[1] == 0:
        return []
    rank = np.linalg.matrix_rank(proj_m, tol=tol)
    pivots = spl.qr(proj_m, overwrite_a=True, mode='raw', pivoting=True)[2]
    return pivots[:rank].tolist()


def matrix_sign(m):
    """Matrix sign function via Schur/eigendecomposition (reference:
    matrixtools.matrix_sign)."""
    import scipy.linalg as spl
    m = np.asarray(m, dtype=complex)
    evals, V = np.linalg.eig(m)
    return np.real_if_close(V @ np.diag(np.sign(np.real(evals))) @
                            np.linalg.inv(V))


def eigenvalues(m):
    return np.linalg.eigvals(np.asarray(m))


def eigendecomposition(m):
    """(V, evals, V^-1) (reference: matrixtools.eigendecomposition returns
    (U, evals, invU))."""
    evals, V = np.linalg.eig(np.asarray(m))
    return V, evals, np.linalg.inv(V)


def vec(matrix_in):
    """Column-stacked vectorization (reference: matrixtools.vec)."""
    return np.asarray(matrix_in).flatten(order='F')[:, None]


def unvec(vector_in):
    d = int(round(np.sqrt(np.asarray(vector_in).size)))
    return np.asarray(vector_in).reshape(d, d, order='F')


def norm1(m):
    """Trace (Schatten-1) norm."""
    return float(np.sum(np.linalg.svd(np.asarray(m), compute_uv=False)))


def norm1to1(operator, num_samples=8, mx_basis="gm", return_list=False):
    """1-to-1 norm of a superoperator, estimated by sampling random
    Hermitian inputs (reference: matrixtools.norm1to1)."""
    from pygsti_tpu_torch.tools.basistools import change_basis, vec_to_stdmx, stdmx_to_vec
    op = np.asarray(operator)
    d2 = op.shape[0]
    d = int(round(np.sqrt(d2)))
    vals = []
    for k in range(num_samples):
        h = random_hermitian(d, seed=k)
        h = h / norm1(h)
        rho_out = vec_to_stdmx(op @ stdmx_to_vec(h, mx_basis), mx_basis)
        vals.append(norm1(rho_out))
    return vals if return_list else float(max(vals))


def to_unitary(scaled_unitary):
    """(scale, unitary) with scaled_unitary = scale * unitary (reference:
    matrixtools.to_unitary)."""
    m = np.asarray(scaled_unitary, dtype=complex)
    scale = np.sqrt(np.abs(np.trace(m.conj().T @ m)) / m.shape[0])
    u = m / scale
    return scale, u


def sorted_eig(m):
    """Eigenvalues/vectors sorted by (real, imag) (reference:
    matrixtools.sorted_eig)."""
    evals, V = np.linalg.eig(np.asarray(m))
    order = np.lexsort((evals.imag, evals.real))
    return evals[order], V[:, order]


def intersection_space(space1, space2, tol=1e-7, use_nice_nullspace=False):
    """Intersection of two column spaces (reference:
    matrixtools.intersection_space)."""
    VW = np.concatenate([np.asarray(space1), -np.asarray(space2)], axis=1)
    ns = nice_nullspace(VW, tol) if use_nice_nullspace else nullspace(VW, tol)
    return np.asarray(space1) @ ns[:np.asarray(space1).shape[1], :]


def union_space(space1, space2, tol=1e-7):
    """Span of the union of two column spaces: the independent columns of
    their concatenation (reference: matrixtools.union_space)."""
    VW = np.concatenate([np.asarray(space1), np.asarray(space2)], axis=1)
    indep_cols = independent_columns(VW, None, tol)
    return VW[:, indep_cols]


def zvals_to_dense(zvals, superket=True):
    """Computational-basis state |z0 z1 ...> as a dense (super)ket
    (reference: matrixtools.zvals_to_dense)."""
    n = len(zvals)
    idx = 0
    for z in zvals:
        idx = (idx << 1) | int(z)
    psi = np.zeros(2 ** n, dtype=complex)
    psi[idx] = 1.0
    if not superket:
        return psi
    from pygsti_tpu_torch.tools.basistools import stdmx_to_vec
    return np.real(stdmx_to_vec(np.outer(psi, psi.conj()), 'pp'))


# =============================================================================
# Reference-surface parity additions (reference: pygsti/tools/matrixtools.py).
# =============================================================================

def assert_hermitian(mat, tol):
    """Raise ValueError when `mat` is not Hermitian to tolerance `tol`
    (reference: matrixtools.assert_hermitian:94)."""
    err = np.abs(mat - mat.T.conj())
    if np.any(err > tol):
        raise ValueError("Input matrix is not Hermitian up to tolerance %g "
                         "(max |mat - mat^H| = %g)" % (tol, err.max()))


def assert_projector(mx, tol=1e-12):
    """Raise ValueError when `mx` is not an orthogonal projector
    (reference: matrixtools.assert_projector:134)."""
    if not is_projector(mx, tol):
        raise ValueError("Matrix is not an orthogonal projector to "
                         "tolerance %g" % tol)


def nullspace_qr(m, tol=1e-7):
    """Nullspace of `m` via the QR decomposition of m^T (columns of Q beyond
    rank(m) span null(m)); faster but less accurate than the SVD nullspace
    (reference: matrixtools.nullspace_qr:312)."""
    M, N = m.shape
    q, r = np.linalg.qr(np.asarray(m).T, mode='complete')  # q: [N, N]
    rank = int(np.sum(np.abs(np.diag(r)[:min(M, N)]) > tol))
    return q[:, rank:]


def prime_factors(n):
    """Prime factorization of `n` as a list with multiplicity (reference:
    matrixtools.prime_factors:1288)."""
    factors = []
    d = 2
    n = int(n)
    while d * d <= n:
        while n % d == 0:
            factors.append(d)
            n //= d
        d += 1
    if n > 1:
        factors.append(n)
    return factors


def safe_norm(a, part=None):
    """Frobenius norm of a dense array or scipy sparse matrix, optionally of
    its real/imag part only (reference: matrixtools.safe_norm:1666)."""
    import scipy.sparse as _sps
    if _sps.issparse(a):
        a = a.tocsr().data
    a = np.asarray(a)
    if part == 'real':
        a = a.real
    elif part == 'imag':
        a = a.imag
    return float(np.linalg.norm(a))


def sparse_equal(a, b, atol=1e-8):
    """Whether two scipy sparse matrices are (almost) equal (reference:
    matrixtools.sparse_equal:2122)."""
    import scipy.sparse as _sps
    if np.array_equal(a.shape, b.shape) is False:
        return False
    diff = (a - b).tocoo() if _sps.issparse(a) else np.asarray(a - b)
    if _sps.issparse(a):
        return bool(len(diff.data) == 0 or np.all(np.abs(diff.data) <= atol))
    return bool(np.all(np.abs(diff) <= atol))


def sparse_onenorm(a):
    """Induced 1-norm (max column abs sum) of a sparse or dense matrix
    (reference: matrixtools.sparse_onenorm:2150)."""
    import scipy.sparse as _sps
    if _sps.issparse(a):
        return float(np.max(np.abs(a).sum(axis=0)))
    return float(np.linalg.norm(np.asarray(a), 1))


def int64_parity(x):
    """Bit parity of an int64 (reference: matrixtools.int64_parity)."""
    x = int(x)
    return bin(x & 0xFFFFFFFFFFFFFFFF).count('1') % 2


def mx_to_string_complex(m, real_width=9, im_width=9, prec=4):
    """Pretty-format string for a complex matrix (reference:
    matrixtools.mx_to_string_complex:760)."""
    m = np.asarray(m)
    if m.ndim == 1:
        m = m[None, :]
    lines = []
    for row in m:
        lines.append(" ".join(
            "%*.*f%+*.*fj" % (real_width, prec, el.real, im_width, prec,
                              el.imag) for el in row))
    return "\n".join(lines) + "\n"


def near_identity_matrix_log(m, tol=1e-8):
    """Logarithm of a superoperator matrix near the identity; real when `m`
    is real (reference: matrixtools.near_identity_matrix_log:837).  Uses the
    principal matrix log, which lands on the branch nearest zero for
    near-identity inputs."""
    import scipy.linalg as _spl
    log_m = _spl.logm(np.asarray(m))
    if np.isrealobj(m):
        assert np.linalg.norm(log_m.imag) < tol, \
            "Near-identity matrix log has significant imaginary part!"
        return log_m.real
    return log_m


def minweight_match(a, b, metricfn=None, return_pairs=True,
                    pass_indices_to_metricfn=False):
    """Min-weight bipartite matching of the elements of `a` to `b`
    (linear-sum assignment; reference: matrixtools.minweight_match:1310).
    Returns the matched weights and (optionally) the index pairs."""
    from scipy.optimize import linear_sum_assignment
    if len(a) != len(b):
        raise ValueError("a and b differ in length")
    D = len(a)
    if metricfn is None:
        def metricfn(x, y):
            return abs(x - y)
    weight = np.empty((D, D), 'd')
    for i in range(D):
        for j in range(D):
            weight[i, j] = metricfn(i, j) if pass_indices_to_metricfn \
                else metricfn(a[i], b[j])
    rows, cols = linear_sum_assignment(weight)
    pairs = list(zip(rows, cols))
    if return_pairs:
        return weight[rows, cols], pairs
    return weight[rows, cols]


def minweight_match_realmxeigs(a, b, metricfn=None,
                               pass_indices_to_metricfn=False, eps=1e-9):
    """Match the eigenvalues of two real matrices so that conjugate pairs
    stay conjugate pairs (reference:
    matrixtools.minweight_match_realmxeigs:1378).  Returns (eigs_a, eigs_b)
    reordered so matched values align."""
    ev_a = np.linalg.eigvals(np.asarray(a))
    ev_b = np.linalg.eigvals(np.asarray(b))
    _, pairs = minweight_match(ev_a, ev_b, metricfn, True,
                               pass_indices_to_metricfn)
    # repair conjugacy: greedily enforce that if (i, j) matched then
    # (conj(i), conj(j)) are matched too
    pairs = dict(pairs)
    used_b = set(pairs.values())

    def conj_index(evals, i):
        if abs(evals[i].imag) < eps:
            return None
        target = np.conj(evals[i])
        cands = [k for k in range(len(evals))
                 if k != i and abs(evals[k] - target) < eps]
        return cands[0] if cands else None

    for i in list(pairs.keys()):
        ci = conj_index(ev_a, i)
        if ci is None or ci not in pairs:
            continue
        cj = conj_index(ev_b, pairs[i])
        if cj is not None and pairs[ci] != cj and cj in used_b:
            # swap to restore conjugate pairing
            other = next(k for k, v in pairs.items() if v == cj)
            pairs[other], pairs[ci] = pairs[ci], cj
    idx_a = sorted(pairs.keys())
    return ev_a[idx_a], ev_b[[pairs[i] for i in idx_a]]


def compute_kite(eigenvalues):
    """Block ("kite") structure of a sorted eigenvalue list: sizes of the
    degenerate blocks (reference: matrixtools.compute_kite)."""
    kite = []
    blk = 1
    for i in range(1, len(eigenvalues)):
        if np.isclose(eigenvalues[i], eigenvalues[i - 1]):
            blk += 1
        else:
            kite.append(blk)
            blk = 1
    kite.append(blk)
    return kite


# ---------------------------------------------------------------------------
# Additional reference-surface utilities (reference: tools/matrixtools.py).
# These support the sparse/Lindblad host-side code paths; the TPU compute
# path uses dense jax arrays, so these are plain numpy/scipy.
# ---------------------------------------------------------------------------

def complex_compare(a, b):
    """Three-way comparison of complex numbers by real part, then imaginary
    part (reference: matrixtools.complex_compare:1263)."""
    if a.real < b.real:
        return -1
    if a.real > b.real:
        return 1
    if a.imag < b.imag:
        return -1
    if a.imag > b.imag:
        return 1
    return 0


def induced_projector(mx, tol=1e-12, *, require_real=False):
    """The orthogonal projector onto range(mx), for `mx` proportional to a
    projector: eigendecompose, rescale the spectrum to {0, 1}, and rebuild
    (reference: matrixtools.induced_projector:158)."""
    mx = np.asarray(mx)
    if require_real and not np.allclose(mx, mx.conj(), atol=tol, rtol=tol):
        raise ValueError("Input matrix has a nonzero imaginary part but "
                         "require_real=True was passed.")
    if not is_hermitian(mx, tol):
        raise ValueError("Input matrix is not Hermitian (tol=%g)." % tol)
    evals, evecs = np.linalg.eigh(mx)
    c = np.max(np.abs(evals))
    if c <= tol:
        return np.zeros_like(mx)
    scaled = evals / c
    on = np.abs(scaled - 1.0) <= tol
    off = np.abs(scaled) <= tol
    if not np.all(on | off):
        raise ValueError("Input matrix is not proportional to an orthogonal "
                         "projector (tol=%g)." % tol)
    V = evecs[:, on]
    P = V @ V.conj().T
    return P.real if require_real or np.isrealobj(mx) else P


def pivot_indices_after_deflation(m_fixed, m):
    """Column-pivot indices of `m` chosen by QR-with-column-pivoting after
    projecting out the column space of `m_fixed` (reference:
    matrixtools.pivot_indices_after_deflation:274)."""
    import scipy.linalg as _spl
    Q = _spl.qr(m_fixed, mode='economic')[0]
    M = m - Q @ (Q.T.conj() @ m)
    return _spl.qr(M, mode='economic', pivoting=True)[2]


def pinv_of_matrix_with_orthogonal_columns(m):
    """Pseudo-inverse of a matrix with mutually orthogonal (not necessarily
    normalized) columns: scale each conjugated column by 1/||col||^2 and
    transpose (reference:
    matrixtools.pinv_of_matrix_with_orthogonal_columns:607)."""
    col_norms_sq = np.linalg.norm(m, axis=0) ** 2
    inv_scale = np.where(col_norms_sq > 0, 1.0 / np.where(
        col_norms_sq > 0, col_norms_sq, 1.0), 0.0)
    return (m.conj() * inv_scale[None, :]).T


def jamiolkowski_angle(hamiltonian_mx):
    """The "Jamiolkowski angle" arccos |<psi| I (x) e^{iH} |psi>| of a
    Hamiltonian error, where |psi> is maximally entangled (reference:
    matrixtools.jamiolkowski_angle:2441)."""
    import scipy.linalg as _spl
    H = np.asarray(hamiltonian_mx)
    d = H.shape[0]
    errmap = np.kron(np.identity(d), _spl.expm(1j * H))
    psi = np.zeros(d ** 2)
    for i in range(d):
        psi[i * d + i] = 1.0 / np.sqrt(d)
    cos_theta = abs(psi.conj() @ (errmap @ psi))
    return float(np.real_if_close(np.arccos(np.clip(cos_theta, -1, 1))))


def ndarray_base(a, verbosity=0):
    """The root memory object of numpy array `a`, found by following
    `.base` links (reference: matrixtools.ndarray_base:2181)."""
    while a.base is not None:
        a = a.base
    return a


def find_zero_communtant_connection(u, u_inv, u0, u0_inv, kite):
    """Find a real R with u_inv R u0 diagonal (block-diagonal on `kite`)
    and log(R) having zero projection onto the commutant of
    G0 = u0 diag u0_inv -- the gauge connection used by gauge-robust
    decompositions (reference:
    matrixtools.find_zero_communtant_connection:2288).  Iterates
    R <- R exp(-Proj_commutant[log R]) to convergence."""
    import scipy.linalg as _spl
    D = project_onto_kite(u_inv @ u0, kite)
    R = u @ D @ u0_inv
    assert np.linalg.norm(R.imag) < 1e-8

    def _onto_commutant(x):
        return u0 @ project_onto_kite(u0_inv @ x @ u0, kite) @ u0_inv

    last_R = R
    for it in range(100):
        assert np.linalg.norm(
            project_onto_antikite(u_inv @ R @ u0, kite)) < 1e-8
        r = real_matrix_log(R)
        r_comm = _onto_commutant(r)
        if np.linalg.norm(r_comm) < 1e-12 or \
           (it > 0 and np.linalg.norm(R - last_R) < 1e-8):
            break
        last_R = R
        R = R @ _spl.expm(-r_comm)
    assert np.linalg.norm(R.imag) < 1e-8, "R should always be real!"
    return R.real


def zvals_int64_to_dense(zvals_int, nqubits, outvec=None,
                         trust_outvec_sparsity=False, abs_elval=None):
    """Fill a dense length-4^n array with the Pauli-product super-ket of the
    computational basis state whose z-values are the bits of `zvals_int`
    (reference: matrixtools.zvals_int64_to_dense:2528).  Each qubit factor
    is (1,0,0,+/-1)/sqrt(2), so the nonzero entries sit at indices whose
    base-4 digits are 0 or 3, with sign = parity of (digit==3 AND z==1)."""
    n = nqubits
    if outvec is None:
        outvec = np.zeros(4 ** n, 'd')
    if abs_elval is None:
        abs_elval = 1.0 / (np.sqrt(2) ** n)
    if not trust_outvec_sparsity:
        outvec[:] = 0
    for finds in range(2 ** n):
        idx = sum(3 * (4 ** (n - 1 - k)) for k in range(n)
                  if finds & (1 << k))
        outvec[idx] = -abs_elval if int64_parity(finds & zvals_int) \
            else abs_elval
    return outvec


# -- CSR summation helpers (reference: matrixtools.py:1713-1930; the
#    reference accelerates these in Cython for its sparse Lindblad op path).

def csr_sum_indices(csr_matrices):
    """Precompute destination-index arrays for summing CSR matrices into a
    common sparsity template.  Returns (ind_arrays, indptr, indices, N)
    where `indptr`/`indices` define the union-pattern template and
    ind_arrays[i][j] is the template data index of the j-th stored element
    of csr_matrices[i] (reference: matrixtools.csr_sum_indices:1713)."""
    import scipy.sparse as _sps
    if len(csr_matrices) == 0:
        return [], np.empty(0, np.int64), np.empty(0, np.int64), 0
    N = csr_matrices[0].shape[0]
    for mx in csr_matrices:
        if mx.shape != (N, N):
            raise ValueError("Matrices must have the same square shape!")
    pattern = sum(
        _sps.csr_matrix((np.ones(m.nnz), m.indices.copy(),
                         m.indptr.copy()), shape=(N, N))
        for m in csr_matrices).tocsr()
    pattern.sort_indices()
    tptr, tcols = pattern.indptr, pattern.indices
    ind_arrays = []
    for m in csr_matrices:
        dest = np.empty(m.nnz, np.int64)
        for r in range(N):
            t0, t1 = tptr[r], tptr[r + 1]
            row_cols = tcols[t0:t1]
            for i in range(m.indptr[r], m.indptr[r + 1]):
                dest[i] = t0 + np.searchsorted(row_cols, m.indices[i])
        ind_arrays.append(dest)
    return (ind_arrays, tptr.astype(np.int64), tcols.astype(np.int64), N)


def csr_sum(data, coeffs, csr_mxs, csr_sum_indices):
    """In-place `data += sum_i coeffs[i] * csr_mxs[i].data` scattered through
    the precomputed destination indices (reference:
    matrixtools.csr_sum:1770)."""
    for coeff, mx, inds in zip(coeffs, csr_mxs, csr_sum_indices):
        data[inds] += coeff * mx.data


def csr_sum_flat_indices(csr_matrices):
    """Flattened variant of :func:`csr_sum_indices` for fast linear
    combinations: returns (flat_dest_index_array, flat_csr_mx_data,
    mx_nnz_indptr, indptr, indices, N) (reference:
    matrixtools.csr_sum_flat_indices:1808)."""
    ind_arrays, indptr, indices, N = csr_sum_indices(csr_matrices)
    if len(ind_arrays) == 0:
        return (np.empty(0, np.int64), np.empty(0, 'd'),
                np.zeros(1, np.int64), indptr, indices, N)
    flat_dest = np.ascontiguousarray(np.concatenate(ind_arrays),
                                      dtype=np.int64)
    flat_data = np.ascontiguousarray(
        np.concatenate([m.data for m in csr_matrices]), dtype=complex)
    nnz_indptr = np.cumsum([0] + [m.nnz for m in csr_matrices],
                            dtype=np.int64)
    return flat_dest, flat_data, nnz_indptr, indptr, indices, N


def csr_sum_flat(data, coeffs, flat_dest_index_array, flat_csr_mx_data,
                 mx_nnz_indptr):
    """In-place flat-form linear combination
    `data[flat_dest] += coeff[i] * flat_data` (reference:
    matrixtools.csr_sum_flat:1855).  Vectorized with np.add.at (the
    destination indices repeat across matrices)."""
    n_mxs = len(mx_nnz_indptr) - 1
    coeff_per_elem = np.repeat(np.ascontiguousarray(coeffs, complex),
                                np.diff(mx_nnz_indptr))
    np.add.at(data, flat_dest_index_array,
               coeff_per_elem * flat_csr_mx_data)


# -- exp(A) @ v helpers (reference: matrixtools.py:1933-2180; the reference
#    re-implements scipy's expm_multiply internals + Cython core.  Here the
#    prep simply captures the matrix and its trace shift, and the fast apply
#    defers to scipy's Al-Mohy/Higham implementation).

EXPM_DEFAULT_TOL = 2.0 ** -53  # as in the reference (double precision)


def expm_multiply_prep(a, tol=EXPM_DEFAULT_TOL):
    """Precompute meta-info for repeated exp(a) @ v products via
    :func:`expm_multiply_fast` (reference:
    matrixtools.expm_multiply_prep:1933)."""
    import scipy.sparse as _sps
    a = _sps.csr_matrix(a)
    n = a.shape[0]
    mu = a.diagonal().sum() / float(n)
    a_shifted = (a - mu * _sps.identity(n, a.dtype, format='csr')).tocsr()
    a_shifted.sort_indices()
    return (a_shifted, mu)


def expm_multiply_fast(prep_a, v, tol=EXPM_DEFAULT_TOL):
    """Compute exp(A) @ v using meta-info from :func:`expm_multiply_prep`
    (reference: matrixtools.expm_multiply_fast:1994)."""
    import scipy.sparse.linalg as _spsl
    a_shifted, mu = prep_a
    return np.exp(mu) * _spsl.expm_multiply(a_shifted, v)


def expop_multiply_prep(op, a_1_norm=None, tol=EXPM_DEFAULT_TOL):
    """:func:`expm_multiply_prep` for a scipy LinearOperator (reference:
    matrixtools.expop_multiply_prep:2075).  The operator cannot be
    trace-shifted without materializing it, so mu = 0."""
    return (op, 0.0)


# -- OperatorLike protocol (reference: matrixtools.py:2643-2704) -------------

try:
    from typing import Protocol as _Protocol, runtime_checkable \
        as _runtime_checkable

    @_runtime_checkable
    class OperatorLike(_Protocol):
        """Structural type for objects usable as linear operators: need
        `.T`, `.conj()`, and matmul (reference:
        matrixtools.OperatorLike:2643)."""

        @property
        def T(self):  # noqa: N802
            ...

        def __matmul__(self, other):
            ...

        def __rmatmul__(self, other):
            ...

        def conj(self):
            ...
except ImportError:  # pragma: no cover - Protocol always present on py3.8+
    OperatorLike = object


class IdentityOperator(object):
    """The identity operator on any vector space: matmul returns the other
    operand unchanged (reference: matrixtools.IdentityOperator:2659)."""

    # make ndarray @ IdentityOperator dispatch to our __rmatmul__
    __array_priority__ = 101

    def __matmul__(self, other):
        return other

    def __rmatmul__(self, other):
        return other

    @property
    def T(self):  # noqa: N802
        return self

    def conj(self):
        return self


def to_operatorlike(obj):
    """Coerce `obj` to an OperatorLike: None becomes the identity operator
    (reference: matrixtools.to_operatorlike:2694)."""
    if obj is None:
        return IdentityOperator()
    if isinstance(obj, OperatorLike):
        return obj
    raise ValueError("Cannot interpret %s as OperatorLike" % type(obj))
