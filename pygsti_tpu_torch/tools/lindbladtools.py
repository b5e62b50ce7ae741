"""Elementary error-generator constructors, host numpy, run once when a
Lindblad member is built (counterpart of pygsti_tpu/tools/lindbladtools.py).

The four elementary error generators acting on a density matrix rho
(arXiv:2103.01928):

  H:  L(rho) = -i [p, rho]
  S:  L(rho) = p rho p^dag - (1/2){p^dag p, rho}
  C:  L(rho) = p rho q^dag + q rho p^dag - (1/2){p^dag q + q^dag p, rho}
  A:  L(rho) = i (p rho q^dag - q rho p^dag + (1/2){p^dag q - q^dag p, rho})

Superoperators use the row-major vec convention: vec(A rho B) =
(A kron B^T) vec(rho).
"""

from __future__ import annotations

import numpy as np


def _sandwich(a, b):
    """Superop of rho -> a rho b^dag in the std (row-major vec) basis."""
    return np.kron(a, b.conj())


def _left(a):
    return np.kron(a, np.identity(a.shape[0]))


def _right(a):
    return np.kron(np.identity(a.shape[0]), a.T)


def create_elementary_errorgen(typ, p, q=None):
    """Elementary error generator superoperator in the std basis."""
    p = np.asarray(p, dtype=complex)
    pdag = p.conj().T
    if typ in ('H', 'S'):
        if q is not None:
            raise ValueError("%r-type elementary error generators take one matrix" % typ)
        if typ == 'H':
            return -1j * (_left(p) - _right(p))
        pdp = pdag @ p
        return _sandwich(p, p) - 0.5 * (_left(pdp) + _right(pdp))
    if typ in ('C', 'A'):
        q = np.asarray(q, dtype=complex)
        qdag = q.conj().T
        if typ == 'C':
            anti = pdag @ q + qdag @ p
            return _sandwich(p, q) + _sandwich(q, p) - 0.5 * (_left(anti) + _right(anti))
        anti = pdag @ q - qdag @ p
        return 1j * (_sandwich(p, q) - _sandwich(q, p) + 0.5 * (_left(anti) + _right(anti)))
    raise ValueError("Invalid elementary errorgen type %r" % typ)


def create_elementary_errorgen_dual(typ, p, q=None):
    """Dual elementary error generator in the std basis, scaled so that
    Tr(dual^dag errorgen) = 1 for the H/S/C/A family on a trace-orthonormal
    basis of a qubit (the reference's convention)."""
    p = np.asarray(p, dtype=complex)
    d = p.shape[0]
    if typ == 'H':
        return -1j * (_left(p) - _right(p)) / (2.0 * d)
    if typ == 'S':
        return _sandwich(p, p) / d
    if typ in ('C', 'A'):
        q = np.asarray(q, dtype=complex)
        if typ == 'C':
            return (_sandwich(p, q) + _sandwich(q, p)) / (2 * d)
        return 1j * (_sandwich(p, q) - _sandwich(q, p)) / (2 * d)
    raise ValueError("Invalid elementary errorgen type %r" % typ)


def create_pairing_normalized_errorgen_dual(typ, p, q=None):
    """A dual scaled so <dual, elementary_errorgen(typ, p, q)> = 1 EXACTLY
    at any Hilbert dimension (the fixed-scale duals above match the
    reference's convention, which pairs to 1 only at d = 2; coefficient
    extraction needs the exact pairing)."""
    out = create_elementary_errorgen_dual(typ, p, q)
    prim = create_elementary_errorgen(typ, p, q)
    scale = np.real(np.vdot(out, prim))
    assert abs(scale) > 1e-300, "degenerate elementary errorgen"
    return out / scale


def create_lindbladian_term_errorgen(typ, lindblad_term_basis_mx, other_mx=None):
    """Lindblad-term generators in the std basis: 'H' is the elementary H
    generator; 'O' is the general term
    L(rho) = A rho B^dag - (1/2){B^dag A, rho} (B = A when not given)."""
    a = np.asarray(lindblad_term_basis_mx, dtype=complex)
    if typ == 'H':
        return -1j * (_left(a) - _right(a))
    if typ == 'O':
        b = np.asarray(other_mx, dtype=complex) if other_mx is not None else a
        bda = b.conj().T @ a
        return _sandwich(a, b) - 0.5 * (_left(bda) + _right(bda))
    raise ValueError("Invalid lindblad term type %r" % typ)


def random_CPTP_error_generator_rates(num_qubits, errorgen_types=('H', 'S', 'C', 'A'),
                                      max_weights=None, H_params=(0., .01),
                                      SCA_params=(0., .01), error_metric=None,
                                      error_metric_value=None, seed=None):
    """Sample random error-generator rates whose exponential is CPTP
    (reference: lindbladtools.random_CPTP_error_generator_rates:767).

    H rates are normal(H_params); the S/C/A rates come from a randomly
    sampled positive-semidefinite Pauli-pair matrix M = A A^dag (scaled by
    SCA_params[1]), whose diagonal gives S rates and off-diagonals give
    C (real part) and A (imaginary part) rates -- PSD M guarantees the
    Lindbladian is completely positive.  `max_weights` restricts the Pauli
    weight per type; `error_metric='total_generator_error'` rescales so
    sum(S) + sum(H^2) equals `error_metric_value`.  Returns
    {ElementaryErrorgenLabel: rate}.
    """
    from pygsti_tpu_torch.tools.errgenproptools import _all_pauli_labels
    from pygsti_tpu_torch.errorgenpropagation.errorpropagator import (
        ElementaryErrorgenLabel)
    rng = np.random.default_rng(seed)
    max_weights = max_weights or {}
    paulis = _all_pauli_labels(num_qubits)

    def wt(pl):
        x, z = pl.x_bits, pl.z_bits
        return bin(x | z).count('1')

    out = {}
    if 'H' in errorgen_types:
        wH = max_weights.get('H')
        for pl in paulis:
            if wH is not None and wt(pl) > wH:
                continue
            out[ElementaryErrorgenLabel('H', pl)] = float(
                rng.normal(H_params[0], H_params[1]))
    sca = [t for t in errorgen_types if t in ('S', 'C', 'A')]
    if sca:
        wS = max_weights.get('S')
        allowed = [pl for pl in paulis if wS is None or wt(pl) <= wS]
        K = len(allowed)
        A = rng.normal(0, 1, (K, K)) + 1j * rng.normal(0, 1, (K, K))
        M = (A @ A.conj().T) * (SCA_params[1] ** 2 / (2 * K))
        if 'C' not in errorgen_types and 'A' not in errorgen_types:
            M = np.diag(np.diag(M))  # diagonal-only stays PSD
        for i, pi in enumerate(allowed):
            if 'S' in errorgen_types:
                out[ElementaryErrorgenLabel('S', pi)] = float(np.real(M[i, i]))
            for j in range(i + 1, K):
                pj = allowed[j]
                if 'C' in errorgen_types:
                    out[ElementaryErrorgenLabel('C', pi, pj)] = \
                        float(np.real(M[i, j]))
                if 'A' in errorgen_types:
                    out[ElementaryErrorgenLabel('A', pi, pj)] = \
                        float(np.imag(M[i, j]))
    if error_metric is not None:
        if error_metric not in ('total_generator_error', 'generator_infidelity'):
            raise ValueError("Invalid error_metric %r" % (error_metric,))
        s_total = sum(v for k, v in out.items() if k.errorgen_type == 'S')
        h_total = sum(v ** 2 for k, v in out.items() if k.errorgen_type == 'H')
        cur = s_total + h_total
        if cur > 0:
            t = error_metric_value / cur
            for k in out:
                out[k] = out[k] * (t if k.errorgen_type != 'H'
                                   else np.sqrt(t))
    return out


def elementary_errorgens_matrix(typ, basis_elements, mx_basis='pp'):
    """[n, d**2, d**2]: the elementary generators of type `typ` made from
    the basis elements after the first (the identity), in `mx_basis`; 'C'
    and 'A' take each pair i < j, row-major."""
    from pygsti_tpu_torch.tools.basistools import change_basis
    els = np.asarray(basis_elements)
    n = els.shape[0]
    if typ in ('H', 'S'):
        gens = [create_elementary_errorgen(typ, els[i]) for i in range(1, n)]
    else:
        gens = [create_elementary_errorgen(typ, els[i], els[j])
                for i in range(1, n) for j in range(i + 1, n)]
    if not gens:
        return np.zeros((0, els.shape[1] ** 2, els.shape[1] ** 2))
    return np.stack([change_basis(eg, 'std', mx_basis) for eg in gens])


def create_elementary_errorgen_pauli(typ, p, q=None, sparse=False):
    """create_elementary_errorgen of Pauli matrices (dense: the reference's
    Pauli-specialized route gives the same matrix)."""
    return create_elementary_errorgen(typ, p, q)


def create_elementary_errorgen_dual_pauli(typ, p, q=None, sparse=False):
    """create_elementary_errorgen_dual of Pauli matrices."""
    return create_elementary_errorgen_dual(typ, p, q)
