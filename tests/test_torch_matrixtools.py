"""The port's tools/matrixtools.py against the JAX package's: every
function on the same seeded inputs (those of tests/test_tools.py and
tests/test_api_surface.py), outputs equal to 1e-12 or exactly, and the
same errors raised."""

import numpy as np
import pytest
import scipy.linalg as spl
import scipy.sparse as sps

import pygsti_tpu.tools.matrixtools as jmt
import pygsti_tpu_torch.tools.matrixtools as tmt


def _herm(n, seed):
    r = np.random.RandomState(seed)
    a = r.randn(n, n) + 1j * r.randn(n, n)
    return (a + a.conj().T) / 2


def _rank_deficient(seed, m=5, n=8, r=3):
    rr = np.random.RandomState(seed)
    return rr.randn(m, r) @ rr.randn(r, n)


def _unitary_superop():
    from pygsti_tpu_torch.tools.optools import unitary_to_superop
    th = 0.3
    u = np.array([[np.cos(th), -1j * np.sin(th)], [-1j * np.sin(th), np.cos(th)]])
    return np.real(unitary_to_superop(u, 'pp'))


def _kite_case():
    rng = np.random.RandomState(3)
    th = 0.3
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    G0 = np.kron(np.eye(2), rot)
    evals0, u0 = np.linalg.eig(G0)
    idx = np.argsort(evals0)
    evals0, u0 = evals0[idx], u0[:, idx]
    kite = jmt.compute_kite(evals0)
    A = rng.randn(4, 4) * 0.05
    Q = spl.expm(A - A.T)
    G = Q @ G0 @ Q.T
    evals, u = np.linalg.eig(G)
    idx = np.argsort(evals)
    u = u[:, idx]
    return (u, np.linalg.inv(u), u0, np.linalg.inv(u0), kite)


def _csr_mats():
    rng = np.random.RandomState(0)
    return [sps.random(6, 6, density=0.3, random_state=rng, format='csr') for _ in range(3)]


# name -> a function giving the positional arguments (fresh each call, so
# that a function that writes into its input sees the same input in both)
CASES = {
    'is_hermitian': [lambda: (_herm(4, 1),), lambda: (np.arange(9.).reshape(3, 3),)],
    'is_pos_def': [lambda: (np.diag([1.0, 2.0]),), lambda: (np.diag([1.0, -2.0]),)],
    'is_valid_density_mx': [lambda: (np.diag([0.25, 0.75]),), lambda: (np.diag([0.5, 0.6]),)],
    'mx_to_string': [lambda: (np.eye(2) + 0j,), lambda: (np.arange(6.).reshape(2, 3) / 7,)],
    'unitary_superoperator_matrix_log': [lambda: (_unitary_superop(), 'pp')],
    'real_matrix_log': [lambda: (np.diag([1.0, 0.95, 0.9]),)],
    'approximate_matrix_log': [lambda: (np.diag([1.0, 0.95, 0.9]), np.zeros((3, 3)))],
    'nullspace': [lambda: (_rank_deficient(1),), lambda: (np.eye(4)[:, :2].T,)],
    'nice_nullspace': [lambda: (_rank_deficient(2),),
                       lambda: (_rank_deficient(3), 1e-7, True)],
    'column_basis_vector': [lambda: (2, 5)],
    'safe_onenorm': [lambda: (np.random.RandomState(14).randn(4, 4),)],
    'mx_rank': [lambda: (_rank_deficient(4),)],
    'safe_expm': [lambda: (0.1 * np.random.RandomState(5).randn(4, 4),)],
    'random_hermitian': [lambda: (3, 7)],
    'project_onto_antikite': [lambda: (np.arange(16.).reshape(4, 4), [2, 1, 1])],
    'project_onto_kite': [lambda: (np.arange(16.).reshape(4, 4), [1, 3])],
    'gram_matrix': [lambda: (np.random.RandomState(6).randn(4, 3),),
                    lambda: (np.random.RandomState(6).randn(4, 3), True)],
    'is_projector': [lambda: (np.diag([1.0, 0.0]),), lambda: (np.diag([1.0, 0.5]),)],
    'normalize_columns': [lambda: (np.random.RandomState(7).randn(4, 3),),
                          lambda: (np.random.RandomState(7).randn(4, 3), True, np.array([1, 2, 1]))],
    'column_norms': [lambda: (np.random.RandomState(8).randn(4, 3),),
                     lambda: (np.random.RandomState(8).randn(4, 3), [1, 2, np.inf])],
    'scale_columns': [lambda: (np.ones((3, 3)), np.array([1.0, 2.0, 3.0]))],
    'sign_fix_qr': [lambda: np.linalg.qr(np.random.RandomState(9).randn(5, 3))],
    'columns_are_orthogonal': [lambda: (np.eye(3),), lambda: (np.array([[1., 1.], [0., 1.]]),)],
    'columns_are_orthonormal': [lambda: (np.eye(3),), lambda: (2 * np.eye(3),)],
    'independent_columns': [lambda: (np.array([[1, 0, 1.], [0, 1, 1.]]),),
                            lambda: (np.array([[2., 0.], [0., 1.]]), np.array([[1.], [0.]])),
                            lambda: (_rank_deficient(10), _rank_deficient(11)[:, :1])],
    'matrix_sign': [lambda: (np.diag([2.0, -3.0]),)],
    'eigenvalues': [lambda: (np.diag([1.0, 2.0, 3.0]),)],
    'eigendecomposition': [lambda: (np.diag([1.0, 2.0, 3.0]) + np.triu(np.ones((3, 3)), 1),)],
    'vec': [lambda: (np.arange(4.).reshape(2, 2),)],
    'unvec': [lambda: (np.arange(4.).reshape(4, 1),)],
    'norm1': [lambda: (_herm(3, 12),)],
    'norm1to1': [lambda: (np.eye(4),), lambda: (_unitary_superop(), 4, 'pp', True)],
    'to_unitary': [lambda: (1.5 * np.eye(2),)],
    'sorted_eig': [lambda: (np.diag([3.0, 1.0, 2.0]),)],
    'intersection_space': [lambda: (np.eye(4)[:, :2], np.eye(4)[:, 1:3]),
                           lambda: (np.eye(4)[:, :3], np.eye(4)[:, 1:], 1e-7, True)],
    'union_space': [lambda: (np.eye(4)[:, :2], np.eye(4)[:, 1:3])],
    'zvals_to_dense': [lambda: ([0, 1],), lambda: ([1, 0, 1], False)],
    'assert_hermitian': [lambda: (np.eye(2), 1e-12),
                         lambda: (np.array([[0, 1.0], [0, 0]]), 1e-12)],
    'assert_projector': [lambda: (np.diag([1.0, 0.0]),), lambda: (np.diag([1.0, 0.5]),)],
    'nullspace_qr': [lambda: (np.random.RandomState(3).randn(3, 6),)],
    'prime_factors': [lambda: (60,), lambda: (97,)],
    'safe_norm': [lambda: (sps.csr_matrix(np.array([[1.0, 0], [0, 2.0]])),),
                  lambda: (np.array([1 + 2j, 3j]), 'imag')],
    'sparse_equal': [lambda: (sps.csr_matrix(np.eye(2)), sps.csr_matrix(np.eye(2))),
                     lambda: (sps.csr_matrix(np.eye(2)), sps.csr_matrix(2 * np.eye(2)))],
    'sparse_onenorm': [lambda: (sps.csr_matrix(np.array([[1.0, 0], [-3, 2.0]])),)],
    'int64_parity': [lambda: (7,), lambda: (6,)],
    'mx_to_string_complex': [lambda: (np.eye(2) + 0.5j,)],
    'near_identity_matrix_log': [lambda: (np.diag([1.0, 0.95, 0.95, 0.9]),)],
    'minweight_match': [lambda: _minweight_inputs()],
    'minweight_match_realmxeigs': [lambda: _realmxeigs_inputs()],
    'compute_kite': [lambda: ([1.0, 1.0, 2.0, 3.0, 3.0, 3.0],)],
    'complex_compare': [lambda: (1 + 2j, 1 + 3j), lambda: (2 + 0j, 1 + 9j), lambda: (1j, 1j)],
    'induced_projector': [lambda: _projector_input(), lambda: (np.random.RandomState(2).randn(4, 4),)],
    'pivot_indices_after_deflation': [lambda: (np.random.RandomState(4).randn(6, 2),
                                               np.random.RandomState(5).randn(6, 4))],
    'pinv_of_matrix_with_orthogonal_columns': [
        lambda: (np.linalg.qr(np.random.RandomState(2).randn(5, 3))[0] * np.array([2.0, 3.0, 0.5]),)],
    'jamiolkowski_angle': [lambda: (np.zeros((2, 2)),), lambda: (0.1 * _herm(2, 13),)],
    'find_zero_communtant_connection': [_kite_case],
    'zvals_int64_to_dense': [lambda: (1, 1), lambda: (5, 3)],
    'csr_sum_indices': [lambda: (_csr_mats(),), lambda: ([],)],
    'csr_sum_flat_indices': [lambda: (_csr_mats(),)],
    'expm_multiply_fast': [lambda: (jmt.expm_multiply_prep(
        sps.random(8, 8, density=0.4, random_state=np.random.RandomState(1), format='csr')),
        np.random.RandomState(1).randn(8))],
}


def _minweight_inputs():
    rng = np.random.RandomState(2)
    a = rng.randn(6) + 1j * rng.randn(6)
    return a, a[rng.permutation(6)] + 0.01 * rng.randn(6)


def _realmxeigs_inputs():
    rng = np.random.RandomState(4)
    a = rng.randn(4, 4)
    return a, a + 0.01 * rng.randn(4, 4)


def _projector_input():
    V = np.linalg.qr(np.random.RandomState(2).randn(5, 2))[0]
    return (3.7 * V @ V.T,)


def _same(a, b):
    """Equal values: arrays (and sparse matrices) within 1e-12, sequences
    and dicts item by item, everything else by ==."""
    if sps.issparse(a) or sps.issparse(b):
        return sps.issparse(a) and sps.issparse(b) and abs(a - b).max() < 1e-12
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and (a.size == 0 or np.max(np.abs(a - b)) < 1e-12)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and \
            all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) < 1e-12
    return a == b


def _outcome(fn, args):
    try:
        return ('value', fn(*args))
    except (ValueError, AssertionError) as e:
        return ('raised', type(e).__name__)


@pytest.mark.parametrize("name,k", [(n, k) for n in sorted(CASES) for k in range(len(CASES[n]))])
def test_function_matches_jax(name, k):
    args = CASES[name][k]
    j = _outcome(getattr(jmt, name), args())
    t = _outcome(getattr(tmt, name), args())
    assert j[0] == t[0], (j, t)
    assert _same(j[1], t[1]), (j, t)


def test_every_function_has_a_case():
    """Each public function of the JAX package's module is in CASES or
    among the ones tested below; the port has all of them."""
    below = {'print_mx', 'csr_sum', 'csr_sum_flat', 'expm_multiply_prep',
             'expop_multiply_prep', 'ndarray_base', 'to_operatorlike'}
    funcs = {n for n, f in vars(jmt).items()
             if callable(f) and not n.startswith('_') and getattr(f, '__module__', '') == jmt.__name__
             and not isinstance(f, type)}
    assert funcs - set(CASES) - below == set()
    assert all(hasattr(tmt, n) for n in funcs)


def test_print_mx(capsys):
    m = np.arange(6.).reshape(2, 3) / 7
    jmt.print_mx(m)
    j = capsys.readouterr().out
    tmt.print_mx(m)
    assert capsys.readouterr().out == j


@pytest.mark.parametrize("flat", [False, True])
def test_csr_sums_write_the_same(flat):
    """csr_sum / csr_sum_flat write the same data into a template; it
    equals the sparse linear combination."""
    coeffs = [1.5, -0.5, 2.0]
    mats = _csr_mats()
    ref = sum(c * m for c, m in zip(coeffs, mats))
    out = []
    for mt in (jmt, tmt):
        if flat:
            fd, fdata, nnzp, ip, cols, N = mt.csr_sum_flat_indices(mats)
            data = np.zeros(len(cols), complex)
            mt.csr_sum_flat(data, np.array(coeffs), fd, fdata, nnzp)
        else:
            inds, ip, cols, N = mt.csr_sum_indices(mats)
            data = np.zeros(len(cols), complex)
            mt.csr_sum(data, coeffs, mats, inds)
        out.append(data)
        assert abs(sps.csr_matrix((data, cols, ip), shape=(N, N)) - ref).max() < 1e-12
    assert np.array_equal(out[0], out[1])


def test_expm_prep_and_operator_helpers():
    A = sps.random(8, 8, density=0.4, random_state=np.random.RandomState(1), format='csr')
    (ja, jmu), (ta, tmu) = jmt.expm_multiply_prep(A), tmt.expm_multiply_prep(A)
    assert abs(ja - ta).max() == 0 and jmu == tmu
    op = object()
    assert tmt.expop_multiply_prep(op) == (op, 0.0) == jmt.expop_multiply_prep(op)
    base = np.zeros(12)
    assert tmt.ndarray_base(base.reshape(3, 4)[1:, :2]) is base
    ident = tmt.to_operatorlike(None)
    x = np.random.RandomState(0).randn(3, 3)
    assert ident @ x is x and x @ ident is x and ident.T is ident and ident.conj() is ident
    assert isinstance(np.eye(2), tmt.OperatorLike)
    with pytest.raises(ValueError):
        tmt.to_operatorlike(42)
    with pytest.raises(ValueError):
        jmt.to_operatorlike(42)
