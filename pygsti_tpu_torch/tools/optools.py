"""Superoperator conversions and gate/state metrics, host numpy
(counterpart of pygsti_tpu/tools/optools.py).  Row-major vectorization: the
std-basis superoperator of rho -> U rho U^dag is kron(U, U.conj())."""

from __future__ import annotations

import functools

import numpy as np
import scipy.linalg as spl

from pygsti_tpu_torch.baseobjs.basis import Basis
from pygsti_tpu_torch.tools.basistools import change_basis, stdmx_to_vec, vec_to_stdmx


def unitary_to_std_process_mx(u):
    """Unitary (d x d) -> superoperator in the std basis (d**2 x d**2)."""
    u = np.asarray(u, dtype=complex)
    return np.kron(u, u.conj())


def unitary_to_superop(u, mx_basis='pp'):
    """Unitary -> superoperator matrix in `mx_basis`."""
    return change_basis(unitary_to_std_process_mx(u), 'std', mx_basis)


def unitary_to_pauligate(u):
    """Unitary -> Pauli-transfer matrix (the 'pp' superoperator)."""
    return unitary_to_superop(u, 'pp')


def unitary_to_process_mx(u):
    """unitary_to_std_process_mx under the reference's other name."""
    return unitary_to_std_process_mx(u)


def operation_from_unitary(u, mx_basis='pp'):
    return unitary_to_superop(u, mx_basis)


def state_to_dmvec(psi):
    """Pure state |psi> -> its density matrix, flattened row-major (the
    std basis)."""
    psi = np.asarray(psi).reshape(-1, 1)
    return (psi @ psi.conj().T).flatten()


def dmvec_to_state(dmvec, tol=1e-6):
    """A pure state's flattened (std) density matrix -> |psi>."""
    dmvec = np.asarray(dmvec)
    d = int(round(np.sqrt(len(dmvec))))
    dm = dmvec.reshape(d, d)
    evals, evecs = np.linalg.eigh((dm + dm.conj().T) / 2)
    if abs(evals[-1] - 1.0) > tol:
        raise ValueError("Density matrix is not a pure state")
    return evecs[:, -1]


def spam_from_state(psi, basis='pp'):
    """Pure state -> (prep vector, effect vector) in `basis`."""
    rho = np.outer(np.asarray(psi), np.asarray(psi).conj())
    v = stdmx_to_vec(rho, basis)
    return v, v.copy()


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


def process_mx_to_unitary(superop, mx_basis='pp'):
    """superop_to_unitary under the reference's other name."""
    return superop_to_unitary(superop, mx_basis)


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
    (tools/sdptools.diamond_norm_distance); with `return_x`, (distance,
    psi), psi the maximizing unit input in C^(d*d)."""
    from pygsti_tpu_torch.tools import sdptools
    return sdptools.diamond_norm_distance(a, b, mx_basis, return_x=return_x)


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


@functools.lru_cache(maxsize=None)
def _named_basis_duals(dim, typ, basis_name):
    """elementary_errorgens_dual of a basis given by name, made once per
    (dim, type, name): a report's error bars project thousands of nearby
    generators onto the same duals.  The arrays are read-only."""
    duals = elementary_errorgens_dual(dim, typ, basis_name)
    for dual in duals.values():
        dual.setflags(write=False)
    return duals


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
    if isinstance(elementary_errorgen_basis, str):
        duals = _named_basis_duals(dim, elementary_errorgen_type, elementary_errorgen_basis)
    else:
        duals = elementary_errorgens_dual(dim, elementary_errorgen_type,
                                          elementary_errorgen_basis)
    projections = {lbl: float(np.real(np.vdot(dual, eg_std)))
                   for lbl, dual in duals.items()}
    ret = [projections]
    if return_dual_elementary_errorgens:
        ret.append(dict(duals))
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


# -- eigenvalue metrics --------------------------------------------------------

def _matched_eigenvalues(a, b):
    """The eigenvalues of `a` and of `b`, paired by a minimum-weight
    matching of |ev_a - ev_b| (the reference's minweight_match).  The JAX
    package pairs them in sort_complex order, which mismatches eigenvalues
    whose real parts tie, such as a rotation's i and -i on two qubits
    (ROADMAP.md section 3); where that order pairs each eigenvalue with the
    nearest one, the two pairings agree."""
    from scipy.optimize import linear_sum_assignment
    ev_a = np.linalg.eigvals(np.asarray(a))
    ev_b = np.linalg.eigvals(np.asarray(b))
    ri, ci = linear_sum_assignment(np.abs(ev_a[:, None] - ev_b[None, :]))
    return ev_a[ri], ev_b[ci]


def eigenvalue_entanglement_infidelity(a, b, mx_basis='pp'):
    """1 - |sum_i ev_a,i conj(ev_b,i)| / d**2 over the matched eigenvalues
    of two superoperators; gauge invariant."""
    ev_a, ev_b = _matched_eigenvalues(a, b)
    return float(np.real(1.0 - np.abs(np.sum(ev_a * ev_b.conj())) / len(ev_a)))


def eigenvalue_fidelity(x, y, gauge_invariant=True):
    """<sqrt v(x), sqrt v(y)>^2 of the eigenvalues of two Hermitian PSD
    matrices (density or Choi matrices), an upper bound on F(x, y): sorted
    (gauge_invariant) or matched by eigenvector overlap."""
    x = np.asarray(x)
    y = np.asarray(y)
    if gauge_invariant:
        vx = np.sort(spl.eigvalsh(x))
        vy = np.sort(spl.eigvalsh(y))
    else:
        from scipy.optimize import linear_sum_assignment
        valsX, vecsX = spl.eigh(x)
        valsY, vecsY = spl.eigh(y)
        # the reference's dissimilarity |1 - |x . y|| takes the plain dot
        # product of the eigenvectors, not the Hermitian one
        ri, ci = linear_sum_assignment(np.abs(1 - np.abs(vecsX.T @ vecsY)))
        vx, vy = valsX[ri], valsY[ci]
    vx = np.maximum(vx, 0)
    vy = np.maximum(vy, 0)
    return float((np.sqrt(vx) @ np.sqrt(vy)) ** 2)


def eigenvalue_infidelity(a, b, gauge_invariant=True):
    return 1.0 - eigenvalue_fidelity(a, b, gauge_invariant)


def generator_infidelity(a, b, mx_basis='pp'):
    """The sum of the squared Hamiltonian rates and of the stochastic rates
    of the 'logGTi' error generator of `a` against its target `b`.  Where
    the generator cannot be taken (a singular target) this raises; the JAX
    package returns nan there."""
    errgen = error_generator(np.asarray(a), np.asarray(b), mx_basis, 'logGTi')
    h = project_errorgen(errgen, 'H', 'pp', mx_basis)
    s = project_errorgen(errgen, 'S', 'pp', mx_basis)
    return float(sum(v ** 2 for v in h.values()) + sum(s.values()))


def fidelity_upper_bound(operation_mx):
    """The largest eigenvalue of the Choi matrix: an upper bound on the
    process fidelity to any unitary."""
    from pygsti_tpu_torch.tools.jamiolkowski import jamiolkowski_iso
    choi = jamiolkowski_iso(np.asarray(operation_mx))
    return float(np.max(np.linalg.eigvalsh((choi + choi.conj().T) / 2)))


# -- model-level metrics ---------------------------------------------------------

def gateset_infidelity(model, target_model, itype='EI', weights=None,
                       mx_basis=None, is_tp=None, is_unitary=None):
    """The weighted mean over the target's operations of the entanglement
    ('EI') or average-gate ('AGI') infidelity."""
    if itype not in ('EI', 'AGI'):
        raise ValueError("itype must be 'EI' or 'AGI', not %r" % (itype,))
    if mx_basis is None:
        mx_basis = getattr(model, 'basis', 'pp')
    metric = entanglement_infidelity if itype == 'EI' else average_gate_infidelity
    total = wtotal = 0.0
    for lbl in target_model.operations.keys():
        w = 1.0 if weights is None else float(weights.get(lbl, 1.0))
        total += w * float(np.real(metric(model.operations[lbl].dense(),
                                          target_model.operations[lbl].dense(), mx_basis)))
        wtotal += w
    return total / max(wtotal, 1e-300)


def _povm_map(model, povmlbl):
    """A POVM's measurement map rho -> sum_k tr(E_k rho)|k><k| as a square
    std-basis superoperator; comparing two POVMs' maps gives gauge-consistent
    POVM metrics.  Defined for at most d outcomes (d the Hilbert
    dimension), where the outcome register embeds in the diagonal."""
    dense = np.asarray(model.povms[povmlbl].dense())       # [n_out, dim] superkets
    effects = [vec_to_stdmx(dense[i], model.basis) for i in range(dense.shape[0])]
    n_out = len(effects)
    udim = int(round(np.sqrt(model.dim)))
    if n_out > udim:
        raise ValueError("POVM map is only defined for <= %d outcomes (Hilbert dim) but "
                         "POVM '%s' has %d" % (udim, str(povmlbl), n_out))
    M = np.zeros((model.dim, model.dim), complex)
    for k, E in enumerate(effects):
        proj = np.zeros((udim, udim), complex)
        proj[k, k] = 1.0
        M += np.outer(proj.reshape(-1), E.conj().reshape(-1))   # tr(E rho) on vec(rho)
    return M


def compute_povm_map(model, povmlbl):
    """The POVM's measurement map as a superoperator in `model.basis`."""
    return change_basis(_povm_map(model, povmlbl), 'std', model.basis)


def povm_fidelity(model, target_model, povmlbl):
    """Entanglement fidelity of two models' POVM maps."""
    return float(np.real(entanglement_fidelity(
        _povm_map(model, povmlbl), _povm_map(target_model, povmlbl), 'std')))


def povm_jtracedist(model, target_model, povmlbl):
    """Jamiolkowski trace distance of two models' POVM maps."""
    return float(jtracedist(_povm_map(model, povmlbl), _povm_map(target_model, povmlbl),
                            'std'))


def povm_diamonddist(model, target_model, povmlbl):
    """Diamond distance of two models' POVM maps."""
    return float(diamonddist(_povm_map(model, povmlbl), _povm_map(target_model, povmlbl),
                             'std'))


def instrument_infidelity(a, b, mx_basis):
    """1 - (sum_k sqrt(F_e(A_k, B_k)))^2 of two instruments' members."""
    sqrt_fids = [np.sqrt(max(0.0, float(np.real(entanglement_fidelity(
        a[lbl].dense(), b[lbl].dense(), mx_basis))))) for lbl in a.member_labels]
    return 1.0 - float(sum(sqrt_fids)) ** 2


def instrument_diamonddist(a, b, mx_basis):
    """Diamond distance of two instruments as quantum -> (classical x
    quantum) maps: one d x d block per member on the diagonal of a space of
    n_members * d."""
    labels = list(a.member_labels)
    d = int(round(np.sqrt(a[labels[0]].dense().shape[0])))
    D = len(labels) * d
    big = []
    for inst in (a, b):
        out = np.zeros((D, D, d, d), complex)
        for k, lbl in enumerate(labels):
            mem = change_basis(inst[lbl].dense(), mx_basis, 'std').reshape(d, d, d, d)
            out[k * d:(k + 1) * d, k * d:(k + 1) * d] = mem
        # rows (big i, big j) of the embedded output, columns (i2, j2) of the
        # input, which is the first d x d block of the big space
        full = np.zeros((D * D, D * D), complex)
        cols = (np.arange(d)[:, None] * D + np.arange(d)[None, :]).reshape(-1)
        full[:, cols] = out.reshape(D * D, d * d)
        big.append(full)
    return float(diamonddist(big[0], big[1], 'std'))


# -- projections and gauge ----------------------------------------------------------

def project_model(model, target_model, projectiontypes=('H', 'S', 'H+S', 'LND'),
                  gen_type='logG-logT', logG_weight=None):
    """Each operation's error generator projected onto the Hamiltonian
    ('H'), stochastic ('S'), both ('H+S'), or full Lindbladian generators,
    the latter made completely positive ('LND') or not ('LNDF'); returns
    (models, parameter counts), one per projection type, each model the
    copy of `model` whose operations are the projected ones (full
    matrices)."""
    from pygsti_tpu_torch.tools import lindbladtools as _lt
    from pygsti_tpu_torch.modelmembers.operations import FullArbitraryOp

    d2 = model.dim
    basis = Basis.cast('pp', d2)
    els = basis.elements
    n = els.shape[0] - 1
    ham_gens = np.stack([np.real(change_basis(_lt.create_elementary_errorgen('H', els[i]),
                                              'std', basis)) for i in range(1, n + 1)])
    pair_gens = np.empty((n, n, d2, d2), complex)
    for a in range(n):
        for b in range(n):
            pair_gens[a, b] = change_basis(
                _lt.create_lindbladian_term_errorgen('O', els[a + 1], els[b + 1]), 'std', basis)
    # the least-squares projector onto span{ham_gens, pair_gens}
    A = np.concatenate([ham_gens.reshape(n, -1), pair_gens.reshape(n * n, -1)], axis=0).T
    A_pinv = np.linalg.pinv(A, rcond=1e-12)
    diag_gens = np.stack([pair_gens[i, i].real for i in range(n)])

    out_models = {p: model.copy() for p in projectiontypes}
    n_params = {p: 0 for p in projectiontypes}
    for gl in model.operations.keys():
        G = model.operations[gl].dense()
        T = target_model.operations[gl].dense()
        errgen = error_generator(G, T, basis, gen_type)
        coeffs = A_pinv @ errgen.reshape(-1)
        h = np.real(coeffs[:n])
        M = coeffs[n:].reshape(n, n)
        M = (M + M.conj().T) / 2
        ham_eg = np.tensordot(h, ham_gens, (0, 0))
        sto_eg = np.real(np.tensordot(np.real(np.diag(M)), diag_gens, (0, 0)))
        lnd_eg = ham_eg + np.real(np.tensordot(M, pair_gens, ((0, 1), (0, 1))))
        evals, U = np.linalg.eigh(M)
        Mcp = (U * evals.clip(0, None)[None, :]) @ U.conj().T
        lnd_cp_eg = ham_eg + np.real(np.tensordot(Mcp, pair_gens, ((0, 1), (0, 1))))
        pieces = {'H': (ham_eg, n), 'S': (sto_eg, n), 'H+S': (ham_eg + sto_eg, 2 * n),
                  'LND': (lnd_cp_eg, n + n * n), 'LNDF': (lnd_eg, n + n * n)}
        for p in projectiontypes:
            eg, npar = pieces[p]
            if gen_type == 'logG-logT':
                newG = spl.expm(spl.logm(T).real + eg)
            else:
                newG = operation_from_error_generator(eg, T, gen_type)
            out_models[p].operations[gl] = FullArbitraryOp(np.real(newG))
            n_params[p] += npar
    return ([out_models[p] for p in projectiontypes],
            [n_params[p] for p in projectiontypes])


def spam_error_generator(spamvec, target_spamvec, mx_basis='pp', typ="logGTi"):
    """The error generator L of a SPAM vector, spamvec = exp(L) target, for
    the error map E = I + (v - t) t^T / |t|^2, which moves the target
    along the error."""
    if typ != "logGTi":
        raise ValueError("Only logGTi spam error generators are supported")
    v = np.asarray(spamvec).ravel()
    t = np.asarray(target_spamvec).ravel()
    E = np.eye(len(v)) + np.outer(v - t, t) / float(np.dot(t, t))
    return spl.logm(E).real


def project_to_target_eigenspace(model, target_model, eps=1e-6):
    """A copy of the target whose operations are the model's, each
    projected onto its target's eigenspaces: G -> sum_i P_i G P_i over the
    target's eigenprojectors P_i (this removes the errors that couple
    eigenvalues more than `eps` apart)."""
    from pygsti_tpu_torch.modelmembers.operations import FullArbitraryOp
    ret = target_model.copy()
    for gl, target_op in target_model.operations.items():
        evals, V = np.linalg.eig(target_op.dense())
        Vinv = np.linalg.inv(V)
        g_in_eig = Vinv @ model.operations[gl].dense() @ V
        mask = np.abs(evals[:, None] - evals[None, :]) < eps
        ret.operations[gl] = FullArbitraryOp(np.real(V @ (g_in_eig * mask) @ Vinv))
    return ret


def compute_best_case_gauge_transform(gate_mx, target_gate_mx, return_all=False):
    """The transform U = V_G V_T^-1 that maps the target's eigenvectors onto
    the gate's, the eigenvalues matched by a minimum-weight assignment;
    with `return_all` also the matched eigenvalues."""
    from scipy.optimize import linear_sum_assignment
    evG, VG = np.linalg.eig(np.asarray(gate_mx))
    evT, VT = np.linalg.eig(np.asarray(target_gate_mx))
    ri, ci = linear_sum_assignment(np.abs(evG[:, None] - evT[None, :]))
    U = VG[:, ri] @ np.linalg.inv(VT[:, ci])
    if return_all:
        return U, (evG[ri], evT[ci])
    return U


# -- the rest of the reference's surface ------------------------------------------

def rotation_gate_mx(r, mx_basis='pp'):
    """The superoperator of exp(-i sum_k (r_k / 2) P_k) over the
    non-identity unnormalized Pauli products P_k, so r = [pi/2, 0, 0] gives
    Gxpi2."""
    import itertools
    d2 = len(r) + 1
    nq = int(round(np.log2(d2) / 2))
    if 4 ** nq != d2:
        raise ValueError("r must have length 4^n - 1")
    sigma = [np.eye(2), np.array([[0, 1], [1, 0]], complex),
             np.array([[0, -1j], [1j, 0]]), np.diag([1, -1.0])]
    paulis = []
    for combo in itertools.product(range(4), repeat=nq):
        m = np.array([[1.0]], complex)
        for i in combo:
            m = np.kron(m, sigma[i])
        paulis.append(m)
    gen = sum(float(rk) * 0.5 * paulis[k + 1] for k, rk in enumerate(r))
    return unitary_to_superop(spl.expm(-1j * gen), mx_basis)


def superket_trace(superket, basis):
    """The trace of the density matrix a superket stands for."""
    if getattr(basis, 'first_element_is_identity', False):
        udim = int(round(np.sqrt(len(np.ravel(superket)))))
        # an identity-first orthonormal basis: sqrt(udim) times component 0
        return float(np.real(np.ravel(superket)[0]) * np.sqrt(udim))
    return float(np.real(np.trace(vec_to_stdmx(np.asarray(superket), basis))))


def superop_is_unitary(superop_mx, mx_basis='pp', rank_tol=1e-6):
    """Whether a superoperator acts as a unitary: its Choi matrix has
    rank one."""
    from pygsti_tpu_torch.tools.jamiolkowski import jamiolkowski_iso
    J = np.asarray(jamiolkowski_iso(np.asarray(superop_mx), mx_basis, 'std'))
    return bool(np.linalg.matrix_rank(J, rank_tol) == 1)


def is_valid_lindblad_paramtype(typ):
    """Whether `typ` names a Lindblad parameterization: 'GLND', 'CPTP',
    'CPTPLND', or blocks of 'H', 'S', 's', 'D', 'd' joined by '+'."""
    if typ in ('GLND', 'CPTP', 'CPTPLND'):
        return True
    parts = typ.split('+')
    return bool(parts) and all(p in {'H', 'S', 's', 'D', 'd'} for p in parts)


def effect_label_to_outcome(povm_and_effect_lbl):
    """The outcome of a simplified 'POVM_effect' label ('NONE' for None)."""
    if povm_and_effect_lbl is None:
        return "NONE"
    name = getattr(povm_and_effect_lbl, 'name', povm_and_effect_lbl)
    return name[name.rindex('_') + 1:]


def effect_label_to_povm(povm_and_effect_lbl):
    """The POVM of a simplified 'POVM_effect' label ('NONE' for None)."""
    if povm_and_effect_lbl is None:
        return "NONE"
    name = getattr(povm_and_effect_lbl, 'name', povm_and_effect_lbl)
    return name[:name.rindex('_')]


def fast_density_rank(rho, tol=1e-9):
    """The number of eigenvalues of a Hermitian matrix above `tol`."""
    return int(np.sum(np.linalg.eigvalsh(np.asarray(rho)) > tol))


def minimal_kraus_decomposition(superop, mx_basis='pp', tol=1e-9):
    """kraus_decomposition keeping the operators of weight above `tol`."""
    return kraus_decomposition(superop, mx_basis, tol)


def tensorized_with_eye(op, op_basis, ten_basis=None, std_basis=None, ten_std_basis=None):
    """The superoperator of op (x) I, with an identity factor of op's
    Hilbert dimension, in `ten_basis` (default: 'pp' of the doubled
    space)."""
    op = np.asarray(op)
    d2 = op.shape[0]
    d = int(round(np.sqrt(d2)))
    op_std = change_basis(op, op_basis, 'std').reshape(d, d, d, d)
    eye = np.eye(d)
    # big[(r1 r2)(c1 c2), (r1' r2')(c1' c2')] = op_std[r1 c1, r1' c1'] d(r2 r2') d(c2 c2')
    big_std = np.einsum('acef,bg,dh->abcdegfh', op_std, eye, eye).reshape(d2 * d2, d2 * d2)
    tb = ten_basis if ten_basis is not None else Basis.cast('pp', d2 * d2)
    return change_basis(big_std, 'std', tb)


def rootconj_superop(kraus_op, mx_basis='pp'):
    """The superoperator rho -> K rho K^dag of one Kraus operator."""
    K = np.asarray(kraus_op)
    return change_basis(np.kron(K, K.conj()), 'std', mx_basis)


def relaxed_scalar_tolerance(a, b, rtol=1e-8, atol=1e-10):
    """max(atol, rtol * max(|a|, |b|)): a tolerance for comparing two
    scalars."""
    return max(atol, rtol * max(abs(a), abs(b)))
