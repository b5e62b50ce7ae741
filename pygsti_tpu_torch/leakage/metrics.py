"""Leakage metrics of 3-level superoperators, host numpy (counterpart of
pygsti_tpu/leakage/metrics.py)."""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.tools.basistools import change_basis, vec_to_stdmx, stdmx_to_vec


def _apply_superop_to_mx(superop_gm, rho_std):
    """Apply a gm-basis superop to a density matrix (3-level)."""
    vec = stdmx_to_vec(rho_std, 'gm')
    out = np.asarray(superop_gm) @ vec
    return vec_to_stdmx(out, 'gm')


def gate_leakage_rate(superop, mx_basis='gm', comp_levels=(0, 1), leak_levels=(2,)):
    """Average probability of leaking out of the computational subspace:
    mean over computational-basis inputs of the population transferred to
    leakage levels (reference: leakage/metrics leakage rate)."""
    d = int(round(np.sqrt(np.asarray(superop).shape[0])))
    superop_gm = change_basis(np.asarray(superop), mx_basis, 'gm')
    rates = []
    for i in comp_levels:
        rho = np.zeros((d, d), dtype=complex)
        rho[i, i] = 1.0
        out = _apply_superop_to_mx(superop_gm, rho)
        rates.append(np.real(sum(out[l, l] for l in leak_levels)))
    return float(np.mean(rates))


def gate_seepage_rate(superop, mx_basis='gm', comp_levels=(0, 1), leak_levels=(2,)):
    """Average probability of returning from the leakage subspace."""
    d = int(round(np.sqrt(np.asarray(superop).shape[0])))
    superop_gm = change_basis(np.asarray(superop), mx_basis, 'gm')
    rates = []
    for l in leak_levels:
        rho = np.zeros((d, d), dtype=complex)
        rho[l, l] = 1.0
        out = _apply_superop_to_mx(superop_gm, rho)
        rates.append(np.real(sum(out[i, i] for i in comp_levels)))
    return float(np.mean(rates))


def _subspace_restriction_map(op_basis='gm', d=3, comp_levels=(0, 1)):
    """W [d^2, k^2]: HS overlaps of the d-level basis with the embedded
    k-level computational-subspace basis (k = len(comp_levels))."""
    from pygsti_tpu_torch.baseobjs.basis import Basis
    k = len(comp_levels)
    B_big = Basis.cast(op_basis if isinstance(op_basis, str) else op_basis,
                       d * d).elements
    B_small = Basis.cast('gm' if k != 2 else 'pp', k * k).elements
    W = np.zeros((d * d, k * k), dtype=complex)
    for j in range(k * k):
        emb = np.zeros((d, d), dtype=complex)
        for a, la in enumerate(comp_levels):
            for b, lb in enumerate(comp_levels):
                emb[la, lb] = B_small[j][a, b]
        for i in range(d * d):
            W[i, j] = np.trace(B_big[i].conj().T @ emb)
    return W


def subspace_restriction(op, op_basis='gm', comp_levels=(0, 1)):
    """The operation restricted to the computational subspace, as a
    k-level superoperator (reference: leakage/metrics subspace_* family)."""
    op = np.asarray(op)
    d = int(round(np.sqrt(op.shape[0])))
    W = _subspace_restriction_map(op_basis, d, comp_levels)
    return np.real_if_close(W.conj().T @ op @ W)


def subspace_entanglement_fidelity(op_x, op_y, op_basis='gm',
                                   comp_levels=(0, 1)):
    """Entanglement fidelity of the subspace-restricted operations
    (reference: leakage/metrics.subspace_entanglement_fidelity:146)."""
    from pygsti_tpu_torch.tools.optools import entanglement_fidelity
    basis_small = 'pp' if len(comp_levels) == 2 else 'gm'
    return entanglement_fidelity(
        subspace_restriction(op_x, op_basis, comp_levels),
        subspace_restriction(op_y, op_basis, comp_levels), basis_small)


def subspace_jtracedist(op_x, op_y, op_basis='gm', comp_levels=(0, 1)):
    """Jamiolkowski trace distance of the restricted operations (reference:
    leakage/metrics.subspace_jtracedist:155)."""
    from pygsti_tpu_torch.tools.optools import jtracedist
    basis_small = 'pp' if len(comp_levels) == 2 else 'gm'
    return jtracedist(subspace_restriction(op_x, op_basis, comp_levels),
                      subspace_restriction(op_y, op_basis, comp_levels),
                      basis_small)


def subspace_superop_fro_dist(op_x, op_y, op_basis='gm', comp_levels=(0, 1)):
    """Frobenius distance of the restricted operations (reference:
    leakage/metrics.subspace_superop_fro_dist:176)."""
    return float(np.linalg.norm(
        subspace_restriction(op_x, op_basis, comp_levels)
        - subspace_restriction(op_y, op_basis, comp_levels)))


def subspace_diamonddist(op_x, op_y, op_basis='gm', comp_levels=(0, 1)):
    """Half diamond distance of the restricted operations (reference:
    leakage/metrics.subspace_diamonddist:186)."""
    from pygsti_tpu_torch.tools.optools import diamonddist
    basis_small = 'pp' if len(comp_levels) == 2 else 'gm'
    return 0.5 * diamonddist(
        subspace_restriction(op_x, op_basis, comp_levels),
        subspace_restriction(op_y, op_basis, comp_levels), basis_small)
