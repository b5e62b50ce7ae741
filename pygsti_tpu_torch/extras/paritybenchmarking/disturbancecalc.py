"""Weight-X residual TVDs and disturbances between datasets (counterpart of
pygsti_tpu/extras/paritybenchmarking/disturbancecalc.py; reference:
pygsti/extras/paritybenchmarking/disturbancecalc.py: ResidualTVD:309,
build_basis:247/277, transition_matrix:201, compute_disturbances:1767).

The weight-X residual TVD is min_T TVD(q, T p) over transition matrices
T = I + sum_k t_k G_k built from weight-X (or less) classical bit-flip
processes.  The reference solves this with cvxpy; here it is posed directly
as a linear program and solved with scipy's HiGHS backend (cvxpy is not a
dependency of this framework).  Host work only.
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np
import scipy.special
from scipy.optimize import linprog


def n_matrices_per_weight(weight, n_bits):
    """Number of weight-`weight` bit subsets (reference:
    disturbancecalc.py:181)."""
    return int(scipy.special.binom(n_bits, weight))


def n_parameters_per_matrix(weight, n_bits):
    """Off-diagonal count of a 2^w transition matrix (reference: :186)."""
    return 2 ** weight * (2 ** weight - 1)


def n_parameters(weight, n_bits):
    """Total parameter count of a weight-w transition map (reference: :191)."""
    return n_parameters_per_matrix(weight, n_bits) * \
        n_matrices_per_weight(weight, n_bits)


def transition_matrix(v, dimension):
    """Column-stochastic matrix from its off-diagonal parameters
    (reference: disturbancecalc.py:201).  v lists, for each row index i, the
    off-diagonal entries of row i (column-major after transpose)."""
    v = np.asarray(v, float)
    if len(v) != dimension * (dimension - 1):
        raise ValueError("%d parameters given; a %d x %d transition matrix has %d"
                         % (len(v), dimension, dimension, dimension * (dimension - 1)))
    full = []
    pos = 0
    for i in range(dimension):
        row = list(v[pos:pos + dimension - 1])
        pos += dimension - 1
        row.insert(i, 1 - sum(row))
        full.extend(row)
    return np.reshape(full, (dimension, dimension)).T


def _swell(mx, which_bits, n_bits):
    """Embed a transition matrix on `which_bits` into the full 2^n space
    (identity on the remaining bits)."""
    which_bits = list(which_bits)
    other = [b for b in range(n_bits) if b not in which_bits]
    full = np.kron(mx, np.eye(2 ** len(other)))
    # axis order: which_bits then other -> permute to 0..n-1
    order = which_bits + other
    perm = [order.index(b) for b in range(n_bits)]
    t = full.reshape([2] * (2 * n_bits))
    t = np.transpose(t, [perm[i] for i in range(n_bits)]
                     + [n_bits + perm[i] for i in range(n_bits)])
    return t.reshape(2 ** n_bits, 2 ** n_bits)


@lru_cache(maxsize=32)
def build_basis(weight, n_bits):
    """(basis list G_k, constraint matrix C with C t <= 1) such that
    T = I + sum t_k G_k is column-stochastic for t >= 0, C t <= 1
    (reference: disturbancecalc.py:247)."""
    n_w = n_parameters_per_matrix(weight, n_bits)
    n_a = n_matrices_per_weight(weight, n_bits)
    dim = 2 ** n_bits
    pairs = list(itertools.combinations(range(n_bits), weight))
    basis, constraints = [], []
    for ind in range(n_w * n_a):
        v = np.zeros(n_w * n_a)
        v[ind] = 1.0
        vs = v.reshape(n_a, n_w)
        ctm = sum(_swell(transition_matrix(vrow, 2 ** weight), pair, n_bits)
                  for vrow, pair in zip(vs, pairs)) - n_a * np.eye(dim)
        basis.append(ctm)
        constraints.append(-np.diag(ctm))
    return basis, np.array(constraints).T


def comprehensive_transition_matrix(v, weight, n_bits):
    """Weight-w transition matrix from a full parameter vector
    (reference: disturbancecalc.py:212)."""
    n_w = n_parameters_per_matrix(weight, n_bits)
    n_a = n_matrices_per_weight(weight, n_bits)
    vs = np.reshape(v, (n_a, n_w))
    pairs = list(itertools.combinations(range(n_bits), weight))
    return sum(_swell(transition_matrix(vrow, 2 ** weight), pair, n_bits)
               for vrow, pair in zip(vs, pairs)) / n_a


class ResidualTVD(object):
    """min_T TVD(Q, T P) over weight-`weight` transition maps, as an LP
    (reference: disturbancecalc.py:309).  `solver` (a cvxpy solver name in
    the reference) is accepted for API parity: the LP is solved exactly
    with scipy's HiGHS here, which returns the same optimal value as any
    converged cvxpy LP solver."""

    def __init__(self, weight, n_bits, initial_treg_factor=1e-6, solver=None):
        self.weight = weight
        self.n_bits = n_bits
        self.n = 2 ** n_bits
        self.exactly_zero = bool(weight == n_bits)
        self.reg = initial_treg_factor
        if 0 < weight < n_bits:
            self.t_basis, self.cons = build_basis(weight, n_bits)
            self.dim = len(self.t_basis)
        else:
            self.t_basis, self.cons = [], None
            self.dim = 0
        self.t_params = np.zeros(self.dim)

    def build_transfer_mx(self, t_params=None):
        if t_params is None:
            t_params = self.t_params
        T = np.eye(self.n)
        for tk, G in zip(t_params, self.t_basis):
            T = T + tk * G
        return T

    def __call__(self, p, q, verbosity=0):
        p = np.asarray(p, float)
        q = np.asarray(q, float)
        if self.exactly_zero:
            self.t_params = np.zeros(self.dim)
            return 0.0
        if self.weight == 0:
            return 0.5 * np.sum(np.abs(q - p))
        n, dim = self.n, self.dim
        # LP variables x = [t (dim), s (n)]
        # minimize 0.5 sum(s) + reg * sum(t)
        # s.t.  r - A t <= s ; -(r - A t) <= s ; C t <= 1 ; t, s >= 0
        A = np.column_stack([G @ p for G in self.t_basis])   # [n, dim]
        r = q - p
        c = np.concatenate([self.reg * np.ones(dim), 0.5 * np.ones(n)])
        A_ub = np.block([[-A, -np.eye(n)],
                         [A, -np.eye(n)],
                         [self.cons, np.zeros((self.cons.shape[0], n))]])
        b_ub = np.concatenate([-r, r, np.ones(self.cons.shape[0])])
        res = linprog(c, A_ub=A_ub, b_ub=b_ub,
                      bounds=[(0, None)] * (dim + n), method='highs')
        if not res.success:
            raise RuntimeError("Residual-TVD LP failed: %s" % res.message)
        self.t_params = res.x[:dim]
        T = self.build_transfer_mx(self.t_params)
        return float(0.5 * np.sum(np.abs(q - T @ p)))


def _counts_to_probs(data, add_one=False):
    d = np.asarray(data, float)
    if add_one:
        d = d + 1.0
    return d / d.sum()


def compute_residual_tvds(n_bits, data_ref, data_test, max_weight=None,
                          add_one_to_data=False, solver=None, verbosity=0,
                          confidence_percent=None):
    """{weight: residual TVD} between the empirical distributions of two
    datasets (reference: disturbancecalc.py:1385)."""
    if confidence_percent is not None:
        raise NotImplementedError(
            "confidence_percent (bootstrap error bars on the residual TVDs) "
            "is not implemented here; use compute_disturbances, whose "
            "bootstrap loop provides uncertainties")
    if max_weight is None:
        max_weight = n_bits
    p = _counts_to_probs(data_ref, add_one_to_data)
    q = _counts_to_probs(data_test, add_one_to_data)
    out = {}
    for w in range(max_weight + 1):
        out[w] = ResidualTVD(w, n_bits, solver=solver)(p, q)
    return out


def resample_data(data, n_data_points=None, seed=None):
    """Multinomial bootstrap resample of a counts array (reference:
    disturbancecalc.py:1508)."""
    rng = np.random.RandomState(seed)
    d = np.asarray(data, float)
    n = int(d.sum()) if n_data_points is None else n_data_points
    return rng.multinomial(n, d / d.sum()).astype(float)


def compute_disturbances(n_bits, data_ref, data_test,
                         num_bootstrap_samples=20, max_weight=None,
                         solver=None, verbosity=0, seed=0,
                         add_one_to_data=True):
    """Weight-X disturbances delta_X = RTVD(X-1) - RTVD(X) with bootstrap
    1-sigma error bars; returns [(disturbance, errorbar), ...] for
    X = 1..max_weight (reference: disturbancecalc.py:1767)."""
    if max_weight is None:
        max_weight = n_bits
    rtvds = compute_residual_tvds(n_bits, data_ref, data_test, max_weight,
                                  add_one_to_data=False, solver=solver)
    ml = [rtvds[w - 1] - rtvds[w] for w in range(1, max_weight + 1)]

    boots = []
    for k in range(num_bootstrap_samples):
        dr = resample_data(np.asarray(data_ref, float)
                           + (1.0 if add_one_to_data else 0.0),
                           seed=seed + 2 * k)
        dt = resample_data(np.asarray(data_test, float)
                           + (1.0 if add_one_to_data else 0.0),
                           seed=seed + 2 * k + 1)
        r = compute_residual_tvds(n_bits, dr, dt, max_weight, solver=solver)
        boots.append([r[w - 1] - r[w] for w in range(1, max_weight + 1)])
    if boots:
        err = np.std(np.asarray(boots), axis=0)
    else:
        err = np.zeros(max_weight)
    return [(ml[i], float(err[i])) for i in range(max_weight)]
