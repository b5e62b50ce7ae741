"""Superoperator conversions and gate/state metrics, host numpy
(counterpart of pygsti_tpu/tools/optools.py).  Row-major vectorization: the
std-basis superoperator of rho -> U rho U^dag is kron(U, U.conj())."""

from __future__ import annotations

import numpy as np
import scipy.linalg as spl

from pygsti_tpu_torch.tools.basistools import change_basis


def unitary_to_std_process_mx(u):
    """Unitary (d x d) -> superoperator in the std basis (d**2 x d**2)."""
    u = np.asarray(u, dtype=complex)
    return np.kron(u, u.conj())


def unitary_to_superop(u, mx_basis='pp'):
    """Unitary -> superoperator matrix in `mx_basis`."""
    return change_basis(unitary_to_std_process_mx(u), 'std', mx_basis)


def superop_to_unitary(superop, mx_basis='pp', check=True):
    """Invert unitary_to_superop (the superoperator must be a unitary map):
    the Choi matrix of a unitary map has rank one, |u>><<u|.  The phase is
    fixed so that the entry of largest magnitude is real and positive."""
    std = change_basis(np.asarray(superop), mx_basis, 'std')
    d2 = std.shape[0]
    d = int(round(np.sqrt(d2)))
    choi = std.reshape(d, d, d, d).transpose(0, 2, 1, 3).reshape(d2, d2) / d
    evals, evecs = np.linalg.eigh((choi + choi.conj().T) / 2)
    if check and not np.isclose(evals[-1], 1.0, atol=1e-6):
        raise ValueError("Superoperator is not unitary (top Choi eigenvalue %g != 1)"
                         % evals[-1])
    u = evecs[:, -1].reshape(d, d) * np.sqrt(d)
    idx = np.unravel_index(np.argmax(np.abs(u)), u.shape)
    return u / (u[idx] / abs(u[idx]))


def std_process_mx_to_unitary(superop):
    """Unitary of a std-basis process matrix that is a unitary channel."""
    return superop_to_unitary(superop, 'std')


def kraus_decomposition(superop, mx_basis='pp', tol=1e-9):
    """Kraus operators of a CP map from the eigendecomposition of its
    std-basis Choi matrix: each eigenvector with an eigenvalue above `tol`
    unvecs (row-major) to one Kraus operator."""
    from pygsti_tpu_torch.tools.jamiolkowski import fast_jamiolkowski_iso_std
    choi = fast_jamiolkowski_iso_std(superop, mx_basis)
    d2 = choi.shape[0]
    d = int(round(np.sqrt(d2)))
    evals, evecs = np.linalg.eigh((choi + choi.conj().T) / 2)
    return [evecs[:, i].reshape(d, d) * np.sqrt(d * evals[i])
            for i in range(d2 - 1, -1, -1) if evals[i] > tol]


def decompose_gate_matrix(op_mx):
    """A gate matrix's eigenvalues, whether it is unitary, its rotation
    angle in units of pi (the largest eigenvalue phase), the mean decay of
    its eigenvalues and, for one qubit, the axis of rotation [0, nx, ny, nz]
    (the +1 eigenvector of its unital block)."""
    m = np.asarray(op_mx)
    evals = np.linalg.eigvals(m)
    mags = np.abs(evals)
    out = {'isValid': True, 'eigenvalues': evals,
           'isUnitary': bool(np.allclose(mags, 1.0, atol=1e-6)),
           'pi rotations': float(np.max(np.abs(np.angle(evals))) / np.pi),
           'decay of diagonal rotation terms': float(1.0 - np.mean(mags))}
    if m.shape[0] == 4:
        evals_r, evecs_r = np.linalg.eig(np.real(m[1:, 1:]))
        axis = np.real(evecs_r[:, int(np.argmin(np.abs(evals_r - 1.0)))])
        nrm = np.linalg.norm(axis)
        if nrm > 1e-12:
            axis = axis / nrm
        out['axis of rotation'] = np.concatenate([[0.0], axis])
    return out


# -- metrics -------------------------------------------------------------------

def fidelity(a, b):
    """State fidelity (Tr sqrt(sqrt(a) b sqrt(a)))^2 of two density
    matrices; where one of them has rank one it is <psi|other|psi>."""
    a = np.asarray(a, dtype=complex)
    b = np.asarray(b, dtype=complex)
    for x, y in ((a, b), (b, a)):
        evals = np.linalg.eigvalsh((x + x.conj().T) / 2)
        if np.isclose(np.max(evals), 1.0, atol=1e-6) and np.isclose(np.sum(evals), 1.0,
                                                                    atol=1e-6):
            psi = np.linalg.eigh((x + x.conj().T) / 2)[1][:, -1]
            return float(np.real(psi.conj() @ y @ psi))
    sqrt_a = spl.sqrtm(a)
    evals = np.linalg.eigvals(sqrt_a @ b @ sqrt_a)
    return float(np.real(np.sum(np.sqrt(np.clip(np.real(evals), 0, None))) ** 2))


def frobeniusdist(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)))


def frobeniusdist_squared(a, b):
    return frobeniusdist(a, b) ** 2


def tracenorm(m):
    """The sum of the singular values."""
    return float(np.sum(np.linalg.svd(np.asarray(m), compute_uv=False)))


def tracedist(a, b):
    """0.5 * ||a - b||_1."""
    return 0.5 * tracenorm(np.asarray(a) - np.asarray(b))


def jtracedist(a, b, mx_basis='pp'):
    """The trace distance of the two superoperators' Choi matrices."""
    from pygsti_tpu_torch.tools.jamiolkowski import jamiolkowski_iso
    return tracedist(jamiolkowski_iso(a, mx_basis), jamiolkowski_iso(b, mx_basis))


def entanglement_fidelity(a, b, mx_basis='pp'):
    """The fidelity of the two superoperators' Choi matrices."""
    from pygsti_tpu_torch.tools.jamiolkowski import jamiolkowski_iso
    return fidelity(jamiolkowski_iso(a, mx_basis), jamiolkowski_iso(b, mx_basis))


def process_fidelity(a, b, mx_basis='pp'):
    return entanglement_fidelity(a, b, mx_basis)


def entanglement_infidelity(a, b, mx_basis='pp'):
    return 1.0 - entanglement_fidelity(a, b, mx_basis)


def average_gate_fidelity(a, b, mx_basis='pp'):
    """(d F_e + 1) / (d + 1)."""
    d = int(round(np.sqrt(np.asarray(a).shape[0])))
    return float((d * entanglement_fidelity(a, b, mx_basis) + 1) / (d + 1))


def average_gate_infidelity(a, b, mx_basis='pp'):
    return 1.0 - average_gate_fidelity(a, b, mx_basis)


def unitarity(a, mx_basis='pp'):
    """Tr(E_u^dag E_u) / (d^2 - 1) of the unital block E_u in the 'gm'
    basis."""
    b = change_basis(np.asarray(a), mx_basis, 'gm')
    unital = b[1:, 1:]
    return float(np.real(np.trace(unital.conj().T @ unital)) / (b.shape[0] - 1))


def diamonddist(a, b, mx_basis='pp', return_x=False):
    """||a - b||_diamond, maximized over pure inputs on the doubled space
    (tools/sdptools.diamond_norm_distance)."""
    from pygsti_tpu_torch.tools import sdptools
    return sdptools.diamond_norm_distance(a, b, mx_basis)


# -- error generators: elementary generators, their duals, projections ----

def is_cptp(superop, mx_basis='pp', tol=1e-7):
    """Check complete positivity (Choi PSD) and trace preservation."""
    from pygsti_tpu_torch.tools.jamiolkowski import jamiolkowski_iso
    choi = jamiolkowski_iso(superop, mx_basis)
    cp = bool(np.all(np.linalg.eigvalsh((choi + choi.conj().T) / 2) > -tol))
    std = change_basis(np.asarray(superop), mx_basis, 'std')
    d2 = std.shape[0]
    d = int(round(np.sqrt(d2)))
    # TP: identity left-eigenvector: vec(I)^T S = vec(I)^T
    vec_id = np.identity(d).flatten()
    tp = bool(np.allclose(vec_id @ std, vec_id, atol=tol))
    return cp and tp


def error_generator(gate, target_op, mx_basis='pp', typ='logGTi'):
    """Error generator L with gate = target_op * exp(L) ('logGTi' type,
    the reference default; optools.error_generator)."""
    gate = np.asarray(gate)
    target = np.asarray(target_op)
    if typ == 'logGTi':
        rel = np.linalg.inv(target) @ gate
        L = spl.logm(rel)
        if np.linalg.norm(L.imag) > 1e-8:
            import warnings
            warnings.warn("Error generator has imaginary part; taking real part")
        return L.real
    elif typ == 'logTiG':
        rel = gate @ np.linalg.inv(target)
        return spl.logm(rel).real
    elif typ == 'logG-logT':
        return (spl.logm(gate) - spl.logm(target)).real
    raise ValueError("Unknown error generator type %r" % typ)


def operation_from_error_generator(error_gen, target_op, typ='logGTi'):
    """Inverse of error_generator."""
    if typ == 'logGTi':
        return np.asarray(target_op) @ spl.expm(np.asarray(error_gen))
    elif typ == 'logTiG':
        return spl.expm(np.asarray(error_gen)) @ np.asarray(target_op)
    raise ValueError("Unknown error generator type %r" % typ)


def is_trace_preserving(a, mx_basis='pp', tol=1e-8):
    """Whether superoperator `a` is trace preserving (reference:
    optools.is_trace_preserving:480)."""
    from pygsti_tpu_torch.baseobjs.basis import Basis
    from pygsti_tpu_torch.tools.basistools import stdmx_to_vec
    a = np.asarray(a)
    dim = a.shape[0]
    basis = Basis.cast(mx_basis, dim) if isinstance(mx_basis, str) else mx_basis
    if getattr(basis, 'first_element_is_identity', True):
        return bool(np.isclose(a[0, 0], 1.0, atol=tol)
                    and np.allclose(a[0, 1:], 0.0, atol=tol))
    udim = int(round(np.sqrt(dim)))
    i_vec = np.asarray(stdmx_to_vec(np.eye(udim).astype(complex),
                                    basis)).ravel()
    expect = (a.T.conj() if np.iscomplexobj(a) else a.T) @ i_vec
    return bool(np.linalg.norm(i_vec - expect) <= tol * udim)


def elementary_errorgens(dim, typ, basis):
    """Dict of {LocalElementaryErrorgenLabel: dense generator (std basis)}
    for all elementary generators of `typ` built from non-identity `basis`
    elements (reference: optools.elementary_errorgens:1859)."""
    from pygsti_tpu_torch.baseobjs.basis import Basis
    from pygsti_tpu_torch.baseobjs.errorgenlabel import LocalElementaryErrorgenLabel
    from pygsti_tpu_torch.tools import lindbladtools as _lt
    if typ not in ('H', 'S', 'C', 'A'):
        raise ValueError("Invalid elementary errorgen type %r" % (typ,))
    b = Basis.cast(basis, dim) if isinstance(basis, str) else basis
    lbls = list(b.labels[1:])
    mxs = [np.asarray(e) for e in b.elements[1:]]
    out = {}
    if typ in 'HS':
        for lbl, mx in zip(lbls, mxs):
            out[LocalElementaryErrorgenLabel(typ, (str(lbl),))] = \
                _lt.create_elementary_errorgen(typ, mx)
    else:
        for i, (la, ma) in enumerate(zip(lbls, mxs)):
            for lb, mb in zip(lbls[i + 1:], mxs[i + 1:]):
                out[LocalElementaryErrorgenLabel(typ, (str(la), str(lb)))] = \
                    _lt.create_elementary_errorgen(typ, ma, mb)
    return out


def elementary_errorgens_dual(dim, typ, basis):
    """Duals of elementary_errorgens, normalized so
    <dual_i, errgen_j> = delta_ij (reference:
    optools.elementary_errorgens_dual:1914)."""
    from pygsti_tpu_torch.baseobjs.basis import Basis
    from pygsti_tpu_torch.baseobjs.errorgenlabel import LocalElementaryErrorgenLabel
    from pygsti_tpu_torch.tools import lindbladtools as _lt
    if typ not in ('H', 'S', 'C', 'A'):
        raise ValueError("Invalid elementary errorgen type %r" % (typ,))
    b = Basis.cast(basis, dim) if isinstance(basis, str) else basis
    lbls = list(b.labels[1:])
    mxs = [np.asarray(e) for e in b.elements[1:]]
    out = {}
    if typ in 'HS':
        for lbl, mx in zip(lbls, mxs):
            out[LocalElementaryErrorgenLabel(typ, (str(lbl),))] = \
                _lt.create_pairing_normalized_errorgen_dual(typ, mx)
    else:
        for i, (la, ma) in enumerate(zip(lbls, mxs)):
            for lb, mb in zip(lbls[i + 1:], mxs[i + 1:]):
                out[LocalElementaryErrorgenLabel(typ, (str(la), str(lb)))] = \
                    _lt.create_pairing_normalized_errorgen_dual(typ, ma, mb)
    return out


def project_errorgen(errorgen, elementary_errorgen_type,
                     elementary_errorgen_basis, errorgen_basis='pp',
                     return_dual_elementary_errorgens=False,
                     return_projected_errorgen=False):
    """Project a dense error generator onto the elementary generators of one
    type: rate_i = <dual_i, errorgen> (reference:
    optools.project_errorgen:2055).  Returns {label: rate} plus optionally
    the dual generators and/or the projected (reconstructed) generator, all
    in `errorgen_basis`."""
    eg_std = change_basis(np.asarray(errorgen), errorgen_basis, 'std')
    dim = eg_std.shape[0]
    duals = elementary_errorgens_dual(dim, elementary_errorgen_type,
                                      elementary_errorgen_basis)
    projections = {lbl: float(np.real(np.vdot(dual, eg_std)))
                   for lbl, dual in duals.items()}
    ret = [projections]
    if return_dual_elementary_errorgens:
        ret.append(duals)
    if return_projected_errorgen:
        prims = elementary_errorgens(dim, elementary_errorgen_type,
                                     elementary_errorgen_basis)
        proj_std = sum(projections[lbl] * prims[lbl] for lbl in prims)
        ret.append(change_basis(proj_std, 'std', errorgen_basis))
    return ret[0] if len(ret) == 1 else tuple(ret)


def extract_elementary_errorgen_coefficients(errorgen,
                                             elementary_errorgen_labels,
                                             elementary_errorgen_basis='PP',
                                             errorgen_basis='pp',
                                             return_projected_errorgen=False):
    """Rates of the specified elementary-errorgen labels within a dense
    error generator (reference:
    optools.extract_elementary_errorgen_coefficients:1972)."""
    from pygsti_tpu_torch.baseobjs.errorgenlabel import LocalElementaryErrorgenLabel
    eg_std = change_basis(np.asarray(errorgen), errorgen_basis, 'std')
    dim = eg_std.shape[0]
    basis_for_duals = 'pp' if str(elementary_errorgen_basis).upper() == 'PP' \
        else elementary_errorgen_basis
    by_type = {}
    out = {}
    proj_std = np.zeros_like(eg_std)
    for lbl in elementary_errorgen_labels:
        if not isinstance(lbl, LocalElementaryErrorgenLabel):
            lbl = LocalElementaryErrorgenLabel(
                lbl[0], tuple(str(b) for b in lbl[1:])) \
                if not hasattr(lbl, 'errorgen_type') else lbl
        typ = lbl.errorgen_type
        if typ not in by_type:
            by_type[typ] = (
                elementary_errorgens_dual(dim, typ, basis_for_duals),
                elementary_errorgens(dim, typ, basis_for_duals))
        duals, prims = by_type[typ]
        rate = float(np.real(np.vdot(duals[lbl], eg_std)))
        out[lbl] = rate
        if return_projected_errorgen:
            proj_std = proj_std + rate * prims[lbl]
    if return_projected_errorgen:
        return out, change_basis(proj_std, 'std', errorgen_basis)
    return out


def create_elementary_errorgen_nqudit(typ, basis_element_labels, basis_1q,
                                      normalize=False, sparse=False,
                                      tensorprod_basis=False):
    """An n-qudit elementary error generator (std basis, dense) built from
    per-qudit basis-label strings, e.g. ('XY',) for a 2-qubit H generator
    (reference: optools.create_elementary_errorgen_nqudit:2193)."""
    from pygsti_tpu_torch.baseobjs.basis import Basis
    from pygsti_tpu_torch.tools import lindbladtools as _lt
    b1 = basis_1q if isinstance(basis_1q, Basis) else Basis.cast(basis_1q, 4)
    lbl_to_el = {str(l): np.asarray(e)
                 for l, e in zip(b1.labels, b1.elements)}

    def kron_label(label_str):
        m = np.ones((1, 1), complex)
        for ch in label_str:
            m = np.kron(m, lbl_to_el[ch])
        return m

    mats = [kron_label(s) for s in basis_element_labels]
    if typ in ('H', 'S'):
        if len(mats) != 1:
            raise ValueError("%r generators take one basis element label" % typ)
        out = _lt.create_elementary_errorgen(typ, mats[0])
    else:
        if len(mats) != 2:
            raise ValueError("%r generators take two basis element labels" % typ)
        out = _lt.create_elementary_errorgen(typ, mats[0], mats[1])
    if normalize:
        nrm = np.linalg.norm(out)
        if nrm > 1e-300:
            out = out / nrm
    if sparse:
        import scipy.sparse as _sps
        return _sps.csr_matrix(out)
    return out


def create_elementary_errorgen_nqudit_dual(typ, basis_element_labels,
                                           basis_1q, normalize=False,
                                           sparse=False,
                                           tensorprod_basis=False):
    """Dual of create_elementary_errorgen_nqudit (reference:
    optools.create_elementary_errorgen_nqudit_dual)."""
    from pygsti_tpu_torch.baseobjs.basis import Basis
    from pygsti_tpu_torch.tools import lindbladtools as _lt
    b1 = basis_1q if isinstance(basis_1q, Basis) else Basis.cast(basis_1q, 4)
    lbl_to_el = {str(l): np.asarray(e)
                 for l, e in zip(b1.labels, b1.elements)}

    def kron_label(label_str):
        m = np.ones((1, 1), complex)
        for ch in label_str:
            m = np.kron(m, lbl_to_el[ch])
        return m

    mats = [kron_label(s) for s in basis_element_labels]
    if typ in ('H', 'S'):
        out = _lt.create_pairing_normalized_errorgen_dual(typ, mats[0])
    else:
        out = _lt.create_pairing_normalized_errorgen_dual(typ, mats[0],
                                                          mats[1])
    if normalize:
        nrm = np.linalg.norm(out)
        if nrm > 1e-300:
            out = out / nrm
    if sparse:
        import scipy.sparse as _sps
        return _sps.csr_matrix(out)
    return out


def bulk_create_elementary_errorgen_nqudit(typ, basis_element_labels,
                                           basis_1q, normalize=False,
                                           sparse=False,
                                           tensorprod_basis=False):
    """List of n-qudit elementary error generators, one per (typ, labels)
    pair (reference: optools.bulk_create_elementary_errorgen_nqudit:2276)."""
    typs = [typ] * len(basis_element_labels) if isinstance(typ, str) else typ
    return [create_elementary_errorgen_nqudit(t, lbls, basis_1q, normalize,
                                              sparse, tensorprod_basis)
            for t, lbls in zip(typs, basis_element_labels)]


def bulk_create_elementary_errorgen_nqudit_dual(typ, basis_element_labels,
                                                basis_1q, normalize=False,
                                                sparse=False,
                                                tensorprod_basis=False):
    """Duals of bulk_create_elementary_errorgen_nqudit (reference:
    optools.bulk_create_elementary_errorgen_nqudit_dual)."""
    typs = [typ] * len(basis_element_labels) if isinstance(typ, str) else typ
    return [create_elementary_errorgen_nqudit_dual(t, lbls, basis_1q,
                                                   normalize, sparse,
                                                   tensorprod_basis)
            for t, lbls in zip(typs, basis_element_labels)]
