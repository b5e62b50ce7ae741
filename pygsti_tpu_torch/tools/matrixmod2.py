"""GF(2) linear algebra (reference: pygsti/tools/matrixmod2.py)."""

from __future__ import annotations

import numpy as np


def dot_mod2(m1, m2):
    return np.dot(m1, m2) % 2


def multidot_mod2(mats):
    out = mats[0]
    for m in mats[1:]:
        out = dot_mod2(out, m)
    return out


def det_mod2(m):
    return int(round(np.linalg.det(np.asarray(m)))) % 2


def matrix_directsum(m1, m2):
    n1, n2 = m1.shape[0], m2.shape[0]
    out = np.zeros((n1 + n2, m1.shape[1] + m2.shape[1]), dtype=m1.dtype)
    out[:n1, :m1.shape[1]] = m1
    out[n1:, m1.shape[1]:] = m2
    return out


def inv_mod2(m):
    """Inverse of a matrix over GF(2) via Gaussian elimination."""
    m = np.array(m, dtype=np.int64) % 2
    n = m.shape[0]
    aug = np.concatenate([m, np.identity(n, np.int64)], axis=1)
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if aug[row, col] == 1:
                pivot = row
                break
        if pivot is None:
            raise ValueError("Matrix is singular over GF(2)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        for row in range(n):
            if row != col and aug[row, col] == 1:
                aug[row] = (aug[row] + aug[col]) % 2
    return aug[:, n:]


def gaussian_elimination_mod2(m):
    """Row-reduce over GF(2) (in place on a copy; returns the result)."""
    m = np.array(m, dtype=np.int64) % 2
    rows, cols = m.shape
    r = 0
    for c in range(cols):
        if r >= rows:
            break
        pivot = None
        for row in range(r, rows):
            if m[row, c] == 1:
                pivot = row
                break
        if pivot is None:
            continue
        if pivot != r:
            m[[r, pivot]] = m[[pivot, r]]
        for row in range(rows):
            if row != r and m[row, c] == 1:
                m[row] = (m[row] + m[r]) % 2
        r += 1
    return m


def rank_mod2(m):
    red = gaussian_elimination_mod2(m)
    return int(np.sum(red.any(axis=1)))


def solve_mod2(A, b):
    """Solve A x = b over GF(2); returns one solution or None."""
    A = np.array(A, dtype=np.int64) % 2
    b = np.array(b, dtype=np.int64).reshape(-1, 1) % 2
    rows, cols = A.shape
    aug = np.concatenate([A, b], axis=1)
    pivots = []
    r = 0
    for c in range(cols):
        if r >= rows:
            break
        pivot = None
        for row in range(r, rows):
            if aug[row, c] == 1:
                pivot = row
                break
        if pivot is None:
            continue
        if pivot != r:
            aug[[r, pivot]] = aug[[pivot, r]]
        for row in range(rows):
            if row != r and aug[row, c] == 1:
                aug[row] = (aug[row] + aug[r]) % 2
        pivots.append((r, c))
        r += 1
    x = np.zeros(cols, dtype=np.int64)
    for (row, col) in pivots:
        x[col] = aug[row, cols]
    # check consistency
    if np.any((A @ x) % 2 != b.ravel()):
        return None
    return x


def strictly_upper_triangle(m):
    return np.triu(m, 1)


def diagonal_as_vec(m):
    return np.diagonal(m).copy()


def diagonal_as_matrix(m):
    return np.diag(np.diagonal(m))


def random_invertible_matrix(n, rand_state=None):
    rng = rand_state if rand_state is not None else np.random.RandomState()
    while True:
        m = rng.randint(0, 2, (n, n))
        if det_mod2(m) == 1 or rank_mod2(m) == n:
            return m


def random_bitstring(n, p=0.5, rand_state=None):
    rng = rand_state if rand_state is not None else np.random.RandomState()
    return np.array(rng.binomial(1, p, n), dtype=np.int64)


def Axb_mod2(A, b):  # noqa: N802,N803
    """Solve A x = b over GF(2); returns x as a column vector (reference:
    matrixmod2.Axb_mod2:114)."""
    return solve_mod2(A, np.asarray(b).ravel()).reshape(-1, 1)


def parity_bitstring(n, parity, rand_state=None):
    """Random length-n bitstring with the given parity."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    for _ in range(200):
        b = rng.randint(0, 2, n)
        if int(b.sum()) % 2 == parity:
            return np.array(b, dtype=np.int64)
    raise RuntimeError("failed to sample parity bitstring")


def onesify(a, maxfailcount=100, rand_state=None):
    """Random invertible M such that M a M^T has an all-ones diagonal
    (reference: matrixmod2.onesify; used by the Albert factorization)."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    t = len(a)
    diag = np.diag(np.asarray(a) % 2)
    for _ in range(maxfailcount):
        rows = []
        tries = 0
        while len(rows) < t and tries < 200:
            b = parity_bitstring(t, rng.randint(0, 2), rand_state=rng)
            if int(np.dot(b, diag)) % 2 == 1 and \
                    not any(np.array_equal(b, r) for r in rows):
                rows.append(b)
            else:
                tries += 1
        if len(rows) == t:
            M = np.array(rows, dtype=np.int64)
            if det_mod2(M) == 1:
                return M
    raise RuntimeError("onesify failed; input may have a zero diagonal "
                       "in every basis")


def permute_top(a, i):
    """Swap the first and i-th rows & columns; returns (PaP, P) (reference:
    matrixmod2.permute_top)."""
    t = len(a)
    P = np.eye(t, dtype=np.int64)
    if i != 0:
        P[0, 0] = P[i, i] = 0
        P[0, i] = P[i, 0] = 1
    return multidot_mod2([P, a, P]), P


def fix_top(a):
    """Permutation P making the lower-right (t-1)x(t-1) block of P a P
    invertible (reference: matrixmod2.fix_top)."""
    t = len(a)
    if t == 1:
        return np.eye(1, dtype=np.int64)
    for ind in range(t):
        aa, P = permute_top(a, ind)
        if det_mod2(aa[1:, 1:]) == 1:
            return P
    raise RuntimeError("fix_top failed: no permutation makes the "
                       "trailing block invertible")


def proper_permutation(a):
    """Permutation P such that every trailing principal submatrix of P a P
    is invertible (reference: matrixmod2.proper_permutation)."""
    a = np.array(a, dtype=np.int64) % 2
    t = len(a)
    Ps = []
    for ind in range(t):
        perm = fix_top(a[ind:, ind:])
        full = np.eye(t, dtype=np.int64)
        full[ind:, ind:] = perm
        a = multidot_mod2([full, a, full.T])
        Ps.append(full)
    return multidot_mod2(list(reversed(Ps)))


def _is_proper_permutation_of(a):
    t = len(a)
    return all(det_mod2(a[ind:, ind:]) == 1 for ind in range(t))


def albert_factor(d, rand_state=None):
    """Factor a symmetric GF(2) matrix with a nonzero diagonal direction as
    d = L L^T (Albert factorization; MacWilliams, Amer. Math. Monthly 76
    (1969) 152; reference: matrixmod2.albert_factor:236).  Randomized: the
    factor L is not unique."""
    d = np.array(d, dtype=np.int64) % 2
    rng = rand_state if rand_state is not None else np.random.RandomState()
    for _ in range(100):
        N = onesify(d, rand_state=rng)
        aa = multidot_mod2([N, d, N.T])
        P = proper_permutation(aa)
        A = multidot_mod2([P, aa, P.T])
        if _is_proper_permutation_of(A):
            break
    else:
        raise RuntimeError("albert_factor: could not find a proper form")
    t = len(A)
    L = np.array([[1]], dtype=np.int64)
    for ind in range(t - 2, -1, -1):
        block = A[ind:, ind:]
        z = block[0, 1:]
        B = block[1:, 1:]
        nvec = Axb_mod2(B, z).T
        x = np.array(np.dot(nvec, L) % 2, dtype=np.int64)
        L = np.block([[np.eye(1, dtype=np.int64), x],
                      [np.zeros((t - ind - 1, 1), np.int64), L]])
    Qinv = inv_mod2(dot_mod2(P, N))
    return dot_mod2(Qinv, L)


def random_invertable_matrix(n, rand_state=None):
    """Reference-spelled alias of random_invertible_matrix."""
    return random_invertible_matrix(n, rand_state=rand_state)


def random_symmetric_invertable_matrix(n, rand_state=None):
    """Random symmetric invertible GF(2) matrix M = A A^T (reference:
    matrixmod2.random_symmetric_invertable_matrix)."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    for _ in range(200):
        A = random_invertible_matrix(n, rand_state=rng)
        M = dot_mod2(A, A.T)
        if det_mod2(M) == 1:
            return M
    raise RuntimeError("failed to sample a symmetric invertible matrix")
