"""Reportable quantities: metrics of a model against its target, with
optional confidence-region error bars (counterpart of
pygsti_tpu/report/reportables.py).

Gate functions take dense superoperator matrices ``(a, b, mx_basis)`` with
``a`` the estimate and ``b`` the target; circuit functions take
``(model_a, model_b, circuit)``; SPAM functions take basis vectors.  Where
tools/optools.py computes a metric, the reportable calls it.  ``evaluate``
propagates error bars through a callable or a ModelFunction; the tables
pass ModelFunctions, so only the parameters of the members a metric reads
are differenced.  A metric that cannot be computed raises: nothing here
returns nan or drops a row in its place.
"""

from __future__ import annotations

import collections

import numpy as np
import scipy.linalg as _spl

from pygsti_tpu_torch.report.modelfunction import ModelFunction as _ModelFunction
from pygsti_tpu_torch.report.modelfunction import modelfn_factory as _modelfn_factory
from pygsti_tpu_torch.tools import jamiolkowski as _jam
from pygsti_tpu_torch.tools import matrixtools as _mt
from pygsti_tpu_torch.tools import optools as _ot
from pygsti_tpu_torch.tools.basistools import change_basis, vec_to_stdmx


def evaluate(fn_of_model, model, crf_view=None):
    """A scalar function of a model (a callable or a ModelFunction) at
    `model`, with its error bar from a confidence-region view when one is
    given: (value, error bar)."""
    val = fn_of_model.evaluate(model) if isinstance(fn_of_model, _ModelFunction) \
        else fn_of_model(model)
    if crf_view is not None:
        return val, crf_view.compute_uncertainty(fn_of_model, model)
    return val


def minweight_match(a, b, metricfn=None, return_pairs=True):
    """Minimum-weight matching between two eigenvalue lists: the matched
    distances (and the index pairs)."""
    from scipy.optimize import linear_sum_assignment
    a = np.asarray(a)
    b = np.asarray(b)
    metricfn = metricfn or (lambda x, y: abs(x - y))
    D = np.array([[metricfn(x, y) for y in b] for x in a], dtype=float)
    ri, ci = linear_sum_assignment(D)
    dists = D[ri, ci]
    if return_pairs:
        return dists, list(zip(ri.tolist(), ci.tolist()))
    return dists


# =============================================================================
# per-gate metrics  (a = estimate superop, b = target superop)
# =============================================================================

def entanglement_fidelity(a, b, mx_basis='pp'):
    return _ot.entanglement_fidelity(a, b, mx_basis)


def entanglement_infidelity(a, b, mx_basis='pp'):
    return _ot.entanglement_infidelity(a, b, mx_basis)


def avg_gate_infidelity(a, b, mx_basis='pp'):
    return _ot.average_gate_infidelity(a, b, mx_basis)


def process_fidelity(a, b, mx_basis='pp'):
    return _ot.process_fidelity(a, b, mx_basis)


def frobenius_diff(a, b, mx_basis='pp'):
    return _ot.frobeniusdist(a, b)


def jtrace_diff(a, b, mx_basis='pp'):
    return _ot.jtracedist(a, b, mx_basis)


def half_diamond_norm(a, b, mx_basis='pp'):
    return 0.5 * _ot.diamonddist(a, b, mx_basis)


def unitarity(a, mx_basis='pp'):
    return _ot.unitarity(a, mx_basis)


def std_unitarity(a, b, mx_basis='pp'):
    """Unitarity of the error channel a b^-1."""
    return _ot.unitarity(np.dot(a, np.linalg.inv(b)), mx_basis)


def eigenvalue_unitarity(a, b):
    """Gauge-invariant unitarity from the eigenvalues of a b^-1."""
    Lambda = np.dot(a, np.linalg.inv(b))
    d2 = Lambda.shape[0]
    lmb = np.linalg.eigvals(Lambda)
    return float(np.real(np.linalg.norm(lmb) ** 2) - 1.0) / (d2 - 1.0)


def nonunitary_entanglement_infidelity(a, b, mx_basis='pp'):
    """(d2-1)/d2 * (1 - sqrt(U)) with U = std_unitarity."""
    d2 = np.asarray(a).shape[0]
    U = std_unitarity(a, b, mx_basis)
    return (d2 - 1.0) / d2 * (1.0 - np.sqrt(max(U, 0.0)))


def nonunitary_avg_gate_infidelity(a, b, mx_basis='pp'):
    d2 = np.asarray(a).shape[0]
    d = int(round(np.sqrt(d2)))
    U = std_unitarity(a, b, mx_basis)
    return (d - 1.0) / d * (1.0 - np.sqrt(max(U, 0.0)))


def eigenvalue_nonunitary_entanglement_infidelity(a, b, mx_basis='pp'):
    d2 = np.asarray(a).shape[0]
    U = eigenvalue_unitarity(a, b)
    return (d2 - 1.0) / d2 * (1.0 - np.sqrt(max(U, 0.0)))


def eigenvalue_nonunitary_avg_gate_infidelity(a, b, mx_basis='pp'):
    d2 = np.asarray(a).shape[0]
    d = int(round(np.sqrt(d2)))
    U = eigenvalue_unitarity(a, b)
    return (d - 1.0) / d * (1.0 - np.sqrt(max(U, 0.0)))


def eigenvalue_entanglement_infidelity(a, b, mx_basis='pp'):
    """Infidelity from min-weight-matched superoperator eigenvalues."""
    return _ot.eigenvalue_entanglement_infidelity(a, b, mx_basis)


def eigenvalue_avg_gate_infidelity(a, b, mx_basis='pp'):
    """AGI from the eigenvalue entanglement fidelity via
    F_g = (d F_p + 1)/(d + 1)."""
    d = round(np.asarray(a).size ** 0.25)
    F_p = 1.0 - eigenvalue_entanglement_infidelity(a, b, mx_basis)
    return 1.0 - (d * F_p + 1) / (1 + d)


def eigenvalue_diamondnorm(a, b, mx_basis='pp'):
    """(d2-1)/d2 * the largest matched-eigenvalue distance."""
    d2 = np.asarray(a).shape[0]
    dists = minweight_match(np.linalg.eigvals(a), np.linalg.eigvals(b),
                            lambda x, y: abs(x - y), return_pairs=False)
    return (d2 - 1.0) / d2 * float(np.max(dists))


def eigenvalue_nonunitary_diamondnorm(a, b, mx_basis='pp'):
    d2 = np.asarray(a).shape[0]
    dists = minweight_match(np.linalg.eigvals(a), np.linalg.eigvals(b),
                            lambda x, y: abs(abs(x) - abs(y)), return_pairs=False)
    return (d2 - 1.0) / d2 * float(np.max(dists))


def generator_infidelity(a, b, mx_basis='pp'):
    """sum_k H_k^2 + sum_k S_k of the 'logGTi' error generator's rates
    (optools.generator_infidelity)."""
    return _ot.generator_infidelity(a, b, mx_basis)


def eigenvalues(g, mx_basis='pp'):
    return np.linalg.eigvals(np.asarray(g))


def rel_eigenvalues(a, b, mx_basis='pp'):
    """Eigenvalues of b^-1 a."""
    return np.linalg.eigvals(np.linalg.inv(b) @ a).astype(complex)


def rel_log_tig_eigenvalues(a, b, mx_basis='pp'):
    return np.linalg.eigvals(_ot.error_generator(a, b, mx_basis, 'logTiG')).astype(complex)


def rel_log_gti_eigenvalues(a, b, mx_basis='pp'):
    return np.linalg.eigvals(_ot.error_generator(a, b, mx_basis, 'logGTi')).astype(complex)


def rel_log_diff_eigenvalues(a, b, mx_basis='pp'):
    return np.linalg.eigvals(_ot.error_generator(a, b, mx_basis, 'logG-logT')).astype(complex)


rel_gate_eigenvalues = rel_eigenvalues


def rel_circuit_eigenvalues(model_a, model_b, circuit):
    """Eigenvalues of B(circuit)^-1 A(circuit)."""
    A, B = _circuit_pair(model_a, model_b, circuit)
    return np.linalg.eigvals(np.linalg.inv(B) @ A).astype(complex)


# -- Choi matrix quantities ---------------------------------------------------

def choi_matrix(gate, mx_basis='pp'):
    return _jam.jamiolkowski_iso(gate, mx_basis, mx_basis)


def choi_eigenvalues(gate, mx_basis='pp'):
    choi = _jam.fast_jamiolkowski_iso_std(gate, mx_basis)
    return np.array(sorted(np.linalg.eigvalsh(choi)))


def choi_trace(gate, mx_basis='pp'):
    choi = _jam.fast_jamiolkowski_iso_std(gate, mx_basis)
    return float(np.real(np.trace(choi)))


def upper_bound_fidelity(gate, mx_basis='pp'):
    """Upper bound on the process fidelity with any unitary: the largest
    Choi eigenvalue."""
    choi = _jam.fast_jamiolkowski_iso_std(gate, mx_basis)
    return float(np.max(np.linalg.eigvalsh(choi)))


def closest_ujmx(gate, mx_basis='pp'):
    """Jamiolkowski state of the closest unitary: the rank-1 projector onto
    the dominant Choi eigenvector."""
    choi = _jam.fast_jamiolkowski_iso_std(gate, mx_basis)
    _, evecs = np.linalg.eigh(choi)
    v = evecs[:, -1]
    return np.outer(v, v.conj())


def maximum_fidelity(gate, mx_basis='pp'):
    """Fidelity between the gate's Choi state and the closest unitary's."""
    closest = closest_ujmx(gate, mx_basis)
    choi = _jam.fast_jamiolkowski_iso_std(gate, mx_basis)
    return _ot.fidelity(choi, closest)


def maximum_trace_dist(gate, mx_basis='pp'):
    """J-trace distance to the closest unitary."""
    closest = closest_ujmx(gate, mx_basis)
    choi = _jam.fast_jamiolkowski_iso_std(gate, mx_basis)
    return _ot.tracedist(choi, closest)


def closest_unitary_fidelity(a, b, mx_basis='pp'):
    """Fidelity between b and the closest unitary to a."""
    decomp = _ot.decompose_gate_matrix(np.asarray(a))
    if decomp.get('isUnitary', False):
        return _ot.entanglement_fidelity(a, b, mx_basis)
    closest_a_jmx = closest_ujmx(a, mx_basis)
    choi_b = _jam.fast_jamiolkowski_iso_std(b, mx_basis)
    return _ot.fidelity(closest_a_jmx, choi_b)


# -- decompositions & rotation axes -------------------------------------------

def decomposition(gate):
    """Rotation decomposition of a 1-qubit gate: axis, angle, decays."""
    return _ot.decompose_gate_matrix(np.asarray(gate))


def gate_rotation_angle(g, mx_basis='pp'):
    info = _ot.decompose_gate_matrix(np.asarray(g))
    return info.get('pi rotations', np.nan) * np.pi


def _axis_angle(di, dj):
    """The angle (/pi) between two decompositions' rotation axes; nan where
    either has no axis or (almost) no rotation."""
    ai, aj = di.get('axis of rotation'), dj.get('axis of rotation')
    ri, rj = di.get('pi rotations', np.nan), dj.get('pi rotations', np.nan)
    if ai is None or aj is None or not np.isfinite(ri) or not np.isfinite(rj) \
            or abs(ri) < 1e-4 or abs(rj) < 1e-4:
        return np.nan
    return np.arccos(abs(np.clip(np.real(np.dot(ai, aj)), -1.0, 1.0))) / np.pi


def angles_btwn_rotn_axes(model):
    """[n_ops, n_ops] matrix of angles between the gates' rotation axes
    (/pi; nan on the diagonal and where an axis is undefined)."""
    op_labels = list(model.operations.keys())
    n = len(op_labels)
    angles = np.nan * np.ones((n, n))
    decomps = [_ot.decompose_gate_matrix(model.operations[lbl].dense()) for lbl in op_labels]
    for i in range(n):
        for j in range(n):
            if i != j:
                angles[i, j] = _axis_angle(decomps[i], decomps[j])
    return angles


def model_model_angles_btwn_axes(a, b, mx_basis='pp'):
    """Angle between the rotation axes of a and b."""
    return _axis_angle(_ot.decompose_gate_matrix(np.asarray(a)),
                       _ot.decompose_gate_matrix(np.asarray(b)))


def general_decomposition(model_a, model_b):
    """Hamiltonian-projection decomposition of each gate: axis (normalized
    H-projections), angle (2|H|/pi), Hamiltonian eigenvalues and pairwise
    axis angles, for any Hilbert dimension.  A gate whose logarithm cannot
    be taken gets nan entries (pyGSTi's convention for this table)."""
    import warnings
    from pygsti_tpu_torch.baseobjs.basis import Basis
    decomp = {}
    op_labels = list(model_a.operations.keys())
    mx_basis = model_b.basis
    basis_name = mx_basis if isinstance(mx_basis, str) else mx_basis.name
    dim = model_a.dim
    basis_mxs = np.asarray(Basis.cast('pp', dim).elements)

    for gl in op_labels:
        gate = model_a.operations[gl].dense()
        target_op = model_b.operations[gl].dense()
        gls = str(gl)
        failed = False
        try:
            if np.any(np.isclose(np.linalg.eigvals(target_op), -1.0)):
                target_logG = _mt.unitary_superoperator_matrix_log(target_op, basis_name)
                logG = _mt.approximate_matrix_log(gate, target_logG)
            else:
                logG = _mt.real_matrix_log(gate, "warn")
                if np.linalg.norm(np.imag(logG)) > 1e-6:
                    warnings.warn("Truncating imaginary logarithm!")
                logG = np.real(logG)
        except (np.linalg.LinAlgError, AssertionError, ValueError) as e:
            warnings.warn(str(e))
            failed = True

        if failed:
            decomp[gls + ' log inexactness'] = np.nan
            decomp[gls + ' axis'] = np.nan * np.ones(dim - 1)
            decomp[gls + ' angle'] = np.nan
            decomp[gls + ' hamiltonian eigenvalues'] = np.nan * np.ones(basis_mxs[0].shape[0])
            continue

        decomp[gls + ' log inexactness'] = float(np.linalg.norm(_spl.expm(logG) - gate))
        ham_projs = _hamiltonian_projections(logG, basis_mxs, basis_name)
        norm = np.linalg.norm(ham_projs)
        decomp[gls + ' axis'] = ham_projs / norm if norm > 1e-15 else ham_projs
        decomp[gls + ' angle'] = norm * 2.0 / np.pi
        hamMx = sum(c * bmx for c, bmx in zip(ham_projs, basis_mxs[1:]))
        decomp[gls + ' hamiltonian eigenvalues'] = np.linalg.eigvals(hamMx)

    for gl in op_labels:
        for gl_other in op_labels:
            rotn = decomp[str(gl) + ' angle']
            rotn_o = decomp[str(gl_other) + ' angle']
            key = str(gl) + "," + str(gl_other) + " axis angle"
            if not (np.isfinite(rotn) and np.isfinite(rotn_o)):
                decomp[key] = np.nan
                continue
            if gl == gl_other or abs(rotn) < 1e-4 or abs(rotn_o) < 1e-4:
                decomp[key] = 10000.0  # sentinel for an irrelevant angle
                continue
            real_dot = np.clip(np.real(np.dot(decomp[str(gl) + ' axis'],
                                              decomp[str(gl_other) + ' axis'])), -1.0, 1.0)
            decomp[key] = np.arccos(real_dot) / np.pi
    return decomp


def _projections(errgen_std, gens):
    """Re<gen, errgen> / <gen, gen> for each generator."""
    out = []
    for gen in gens:
        nrm2 = np.real(np.vdot(gen, gen))
        out.append(np.real(np.vdot(gen, errgen_std)) / nrm2 if nrm2 > 1e-15 else 0.0)
    return np.asarray(out)


def _hamiltonian_projections(errgen, basis_mxs, mx_basis):
    """Project an error generator onto the Hamiltonian-type elementary
    generators of each traceless basis element."""
    from pygsti_tpu_torch.tools.lindbladtools import create_elementary_errorgen
    return _projections(change_basis(errgen, mx_basis, 'std'),
                        [create_elementary_errorgen('H', bmx) for bmx in basis_mxs[1:]])


# -- error generators & projections -------------------------------------------

def error_generator(gate, target, mx_basis='pp', typ='logGTi'):
    return _ot.error_generator(gate, target, mx_basis, typ)


def errorgen_and_projections(errgen, mx_basis='pp'):
    """Project an error generator onto the Hamiltonian, stochastic and
    affine elementary generators of the traceless 'pp' elements."""
    from pygsti_tpu_torch.baseobjs.basis import Basis
    from pygsti_tpu_torch.tools.lindbladtools import create_elementary_errorgen
    errgen = np.asarray(errgen)
    dim = errgen.shape[0]
    errgen_std = change_basis(errgen, mx_basis, 'std')
    basis_mxs = np.asarray(Basis.cast('pp', dim).elements)[1:]
    ret = {'error generator': errgen}
    for typ, key in (('H', 'hamiltonian projections'), ('S', 'stochastic projections'),
                     ('A', 'affine projections')):
        gens = [_affine_errorgen(bmx, dim) if typ == 'A' else create_elementary_errorgen(typ, bmx)
                for bmx in basis_mxs]
        ret[key] = _projections(errgen_std, gens)
    return ret


def _affine_errorgen(bmx, dim):
    """Affine-type elementary generator: rho -> tr(rho) * bmx (std basis)."""
    udim = int(round(np.sqrt(dim)))
    ident = np.eye(udim) / udim
    return np.outer(bmx.reshape(-1), ident.conj().reshape(-1)).astype(complex)


def log_tig_and_projections(a, b, mx_basis='pp'):
    """log(T^-1 G) error generator and its projections."""
    return errorgen_and_projections(_ot.error_generator(a, b, mx_basis, 'logTiG'), mx_basis)


def log_gti_and_projections(a, b, mx_basis='pp'):
    return errorgen_and_projections(_ot.error_generator(a, b, mx_basis, 'logGTi'), mx_basis)


def log_diff_and_projections(a, b, mx_basis='pp'):
    return errorgen_and_projections(_ot.error_generator(a, b, mx_basis, 'logG-logT'), mx_basis)


# =============================================================================
# circuit-level metrics (products of gates along a circuit)
# =============================================================================

def _circuit_product(model, circuit):
    G = np.eye(model.dim)
    for lbl in circuit.layertup:
        G = model.operations[lbl].dense() @ G
    return G


def _circuit_pair(model_a, model_b, circuit):
    return _circuit_product(model_a, circuit), _circuit_product(model_b, circuit)


def _circuit_metric(fn):
    def circuit_fn(model_a, model_b, circuit):
        A, B = _circuit_pair(model_a, model_b, circuit)
        return fn(A, B, model_b.basis)
    circuit_fn.__name__ = 'circuit_' + fn.__name__
    circuit_fn.__doc__ = "%s of the circuit's product under the two models." % fn.__name__
    return circuit_fn


circuit_frobenius_diff = _circuit_metric(frobenius_diff)
circuit_entanglement_infidelity = _circuit_metric(entanglement_infidelity)
circuit_avg_gate_infidelity = _circuit_metric(avg_gate_infidelity)
circuit_jtrace_diff = _circuit_metric(jtrace_diff)
circuit_half_diamond_norm = _circuit_metric(half_diamond_norm)
circuit_generator_infidelity = _circuit_metric(generator_infidelity)
circuit_nonunitary_entanglement_infidelity = _circuit_metric(nonunitary_entanglement_infidelity)
circuit_nonunitary_avg_gate_infidelity = _circuit_metric(nonunitary_avg_gate_infidelity)
circuit_eigenvalue_entanglement_infidelity = _circuit_metric(eigenvalue_entanglement_infidelity)
circuit_eigenvalue_avg_gate_infidelity = _circuit_metric(eigenvalue_avg_gate_infidelity)
circuit_eigenvalue_nonunitary_entanglement_infidelity = \
    _circuit_metric(eigenvalue_nonunitary_entanglement_infidelity)
circuit_eigenvalue_nonunitary_avg_gate_infidelity = \
    _circuit_metric(eigenvalue_nonunitary_avg_gate_infidelity)
circuit_eigenvalue_diamondnorm = _circuit_metric(eigenvalue_diamondnorm)
circuit_eigenvalue_nonunitary_diamondnorm = _circuit_metric(eigenvalue_nonunitary_diamondnorm)


# =============================================================================
# SPAM metrics
# =============================================================================

def vec_fidelity(rho_vec_a, rho_vec_b, mx_basis='pp'):
    return _ot.fidelity(vec_to_stdmx(np.asarray(rho_vec_a), mx_basis),
                        vec_to_stdmx(np.asarray(rho_vec_b), mx_basis))


def vec_infidelity(rho_vec_a, rho_vec_b, mx_basis='pp'):
    return 1.0 - vec_fidelity(rho_vec_a, rho_vec_b, mx_basis)


def vec_trace_diff(rho_vec_a, rho_vec_b, mx_basis='pp'):
    return _ot.tracedist(vec_to_stdmx(np.asarray(rho_vec_a), mx_basis),
                         vec_to_stdmx(np.asarray(rho_vec_b), mx_basis))


def vec_as_stdmx(vec, mx_basis='pp'):
    return vec_to_stdmx(np.asarray(vec), mx_basis)


def vec_as_stdmx_eigenvalues(vec, mx_basis='pp'):
    return np.linalg.eigvalsh(vec_to_stdmx(np.asarray(vec), mx_basis))


def spam_dotprods(rho_vecs, povms):
    """<E|rho> table [n_effects_total, n_preps] of prep members (or
    vectors) and POVM members."""
    effects = [np.asarray(e).reshape(-1) for povm in povms for _, e in povm.items()]
    ret = np.empty((len(effects), len(rho_vecs)))
    for i, rho in enumerate(rho_vecs):
        rho_dense = np.asarray(rho.dense() if hasattr(rho, 'dense') else rho).reshape(-1)
        for j, e_dense in enumerate(effects):
            ret[j, i] = float(np.real(np.vdot(e_dense, rho_dense)))
    return ret


def povm_entanglement_infidelity(model_a, model_b, povmlbl):
    """Entanglement infidelity of the two models' POVM maps (each POVM as a
    channel into the classical outcome register; optools._povm_map)."""
    return 1.0 - _ot.povm_fidelity(model_a, model_b, povmlbl)


def povm_jtrace_diff(model_a, model_b, povmlbl):
    return _ot.povm_jtracedist(model_a, model_b, povmlbl)


def povm_half_diamond_norm(model_a, model_b, povmlbl):
    return 0.5 * _ot.povm_diamonddist(model_a, model_b, povmlbl)


# =============================================================================
# instrument metrics
# =============================================================================

def instrument_infidelity(model_a, model_b, inst_lbl):
    """1 - (sum_k sqrt(F_e(A_k, B_k)))^2 over the instruments' members."""
    return _ot.instrument_infidelity(model_a.instruments[inst_lbl],
                                     model_b.instruments[inst_lbl], model_b.basis)


def instrument_half_diamond_norm(model_a, model_b, inst_lbl):
    """Half the diamond distance of the joint quantum-to-(classical x
    quantum) instrument maps (optools.instrument_diamonddist)."""
    return 0.5 * _ot.instrument_diamonddist(model_a.instruments[inst_lbl],
                                            model_b.instruments[inst_lbl], model_b.basis)


# =============================================================================
# model-level quantities
# =============================================================================

def average_gateset_infidelity(model_a, model_b):
    """Mean per-gate entanglement infidelity over the gates of both."""
    vals = [_ot.entanglement_infidelity(model_a.operations[lbl].dense(),
                                        model_b.operations[lbl].dense(), model_b.basis)
            for lbl in model_a.operations if lbl in model_b.operations]
    return float(np.mean(vals)) if vals else np.nan


def predicted_rb_number(model_a, model_b):
    """First-order RB number r = (d-1)/d * (1 - p), p the mean
    depolarization (unital-block trace) of the gates' error channels."""
    d2 = model_a.dim
    d = int(round(np.sqrt(d2)))
    ps = [float(np.real(np.trace((model_a.operations[lbl].dense()
                                  @ np.linalg.inv(model_b.operations[lbl].dense()))[1:, 1:]))
                / (d2 - 1))
          for lbl in model_a.operations if lbl in model_b.operations]
    if not ps:
        return np.nan
    return (d - 1.0) / d * (1.0 - float(np.mean(ps)))


# =============================================================================
# name-keyed dispatch used by report tables
# =============================================================================

_OPFN_INFO = {
    'inf': (entanglement_infidelity, "Entanglement Infidelity"),
    'agi': (avg_gate_infidelity, "Avg. Gate Infidelity"),
    'trace': (jtrace_diff, "1/2 Trace Distance"),
    'diamond': (half_diamond_norm, "1/2 Diamond-Dist"),
    'nuinf': (nonunitary_entanglement_infidelity, "Non-unitary Ent. Infidelity"),
    'nuagi': (nonunitary_avg_gate_infidelity, "Non-unitary Avg. Gate Infidelity"),
    'evinf': (eigenvalue_entanglement_infidelity, "Eigenvalue Ent. Infidelity"),
    'evagi': (eigenvalue_avg_gate_infidelity, "Eigenvalue Avg. Gate Infidelity"),
    'evnuinf': (eigenvalue_nonunitary_entanglement_infidelity,
                "Eigenvalue Non-unitary Ent. Infidelity"),
    'evnuagi': (eigenvalue_nonunitary_avg_gate_infidelity,
                "Eigenvalue Non-unitary Avg. Gate Infidelity"),
    'evdiamond': (eigenvalue_diamondnorm, "Eigenvalue 1/2 Diamond-Dist"),
    'evnudiamond': (eigenvalue_nonunitary_diamondnorm,
                    "Eigenvalue Non-unitary 1/2 Diamond-Dist"),
    'geninf': (generator_infidelity, "Generator Infidelity"),
    'frob': (frobenius_diff, "Frobenius Distance"),
    'unmodeled': (None, "Un-modeled Error"),
    'wildcard': (None, "Un-modeled Error"),
}


def info_of_opfn_by_name(name):
    """(fn, nice name) of a gate metric's short name."""
    if name not in _OPFN_INFO:
        raise ValueError("Invalid gate-metric name: %r" % name)
    return _OPFN_INFO[name]


class _GateMetric(_ModelFunction):
    """fn(operation's matrix, target's, basis) of one gate, which reads
    that gate's parameters only."""

    def __init__(self, model, fn, target_dense, oplabel, basis):
        self.fn, self.target_dense, self.oplabel, self.basis = fn, target_dense, oplabel, basis
        super().__init__(model, [("gate", oplabel)])

    def evaluate(self, model):
        return self.fn(model.operations[self.oplabel].dense(), self.target_dense, self.basis)


class _PrepMetric(_ModelFunction):
    """fn(prep vector, target's, basis) of one state preparation."""

    def __init__(self, model, fn, target_dense, lbl, basis):
        self.fn, self.target_dense, self.lbl, self.basis = fn, target_dense, lbl, basis
        super().__init__(model, [("prep", lbl)])

    def evaluate(self, model):
        return self.fn(model.preps[self.lbl].dense(), self.target_dense, self.basis)


def evaluate_opfn_by_name(name, model, target_model, op_label_or_string,
                          confidence_region_info=None):
    """A gate metric by short name on a gate label or a circuit, with its
    error bar when a confidence-region view is given."""
    from pygsti_tpu_torch.circuits.circuit import Circuit
    fn, _ = info_of_opfn_by_name(name)
    if fn is None:
        raise ValueError("Metric %r is not model-evaluable" % name)
    basis = model.basis
    key = op_label_or_string
    if isinstance(key, (Circuit, tuple, list)):
        circuit = key if isinstance(key, Circuit) else Circuit(key)

        def fn_of_model(mdl):
            return fn(_circuit_product(mdl, circuit), _circuit_product(target_model, circuit),
                      basis)
        return evaluate(fn_of_model, model, confidence_region_info)
    if fn is half_diamond_norm:
        mfn = HalfDiamondNorm(model, target_model, key)
    else:
        mfn = _GateMetric(model, fn, target_model.operations[key].dense(), key, basis)
    return evaluate(mfn, model, confidence_region_info)


# =============================================================================
# model-level tables (used by the HTML report factory)
# =============================================================================

_GATE_METRICS = {
    'entanglement_infidelity': entanglement_infidelity,
    'avg_gate_infidelity': avg_gate_infidelity,
    'process_fidelity': process_fidelity,
    'jtrace_diff': jtrace_diff,
    'frobenius_diff': frobenius_diff,
    'half_diamond_norm': half_diamond_norm,
    'eigenvalue_entanglement_infidelity': eigenvalue_entanglement_infidelity,
    'eigenvalue_avg_gate_infidelity': eigenvalue_avg_gate_infidelity,
    'nonunitary_entanglement_infidelity': nonunitary_entanglement_infidelity,
    'generator_infidelity': generator_infidelity,
    'unitarity': lambda a, b, basis: unitarity(a, basis),
}


def gate_metrics_table(model, target, metrics=('entanglement_infidelity',
                                               'avg_gate_infidelity',
                                               'jtrace_diff', 'frobenius_diff',
                                               'unitarity'),
                       crf_view=None):
    """Per-gate metrics {gate_label: {metric: value or (value, errbar)}};
    with a confidence-region view every metric but unitarity carries an
    error bar (the half diamond norm's by HalfDiamondNorm's linearization)."""
    out = collections.OrderedDict()
    basis = model.basis
    for lbl in model.operations:
        if lbl not in target.operations:
            continue
        t_dense = target.operations[lbl].dense()
        row = collections.OrderedDict()
        for m in metrics:
            if crf_view is not None and m != 'unitarity':
                mfn = HalfDiamondNorm(model, target, lbl) if m == 'half_diamond_norm' \
                    else _GateMetric(model, _GATE_METRICS[m], t_dense, lbl, basis)
                row[m] = evaluate(mfn, model, crf_view)
            else:
                row[m] = _GATE_METRICS[m](model.operations[lbl].dense(), t_dense, basis)
        out[lbl] = row
    return out


def spam_metrics_table(model, target, crf_view=None):
    """Per prep {fidelity, trace_dist} (with error bars under a view) and
    per POVM {frobenius_diff, entanglement_infidelity}."""
    out = collections.OrderedDict()
    basis = model.basis
    for lbl in model.preps:
        if lbl in target.preps:
            t_dense = target.preps[lbl].dense()
            row = {}
            for m, fn in (('fidelity', vec_fidelity), ('trace_dist', vec_trace_diff)):
                if crf_view is not None:
                    row[m] = evaluate(_PrepMetric(model, fn, t_dense, lbl, basis), model,
                                      crf_view)
                else:
                    row[m] = fn(model.preps[lbl].dense(), t_dense, basis)
            out[('prep', lbl)] = row
    for lbl in model.povms:
        if lbl in target.povms:
            diff = np.linalg.norm(model.povms[lbl].dense() - target.povms[lbl].dense())
            out[('povm', lbl)] = {
                'frobenius_diff': float(diff),
                'entanglement_infidelity': povm_entanglement_infidelity(model, target, lbl),
            }
    return out


def errorgen_projections_table(model, target, typ='logGTi'):
    """Per-gate H/S/A error-generator projections
    {gate: {'hamiltonian projections': ..., ...}}."""
    out = collections.OrderedDict()
    for lbl in model.operations:
        if lbl in target.operations:
            eg = _ot.error_generator(model.operations[lbl].dense(),
                                     target.operations[lbl].dense(), model.basis, typ)
            out[lbl] = errorgen_and_projections(eg, model.basis)
    return out


def gate_decomposition_table(model, target):
    """Per-gate rotation decompositions and closest-unitary metrics."""
    out = collections.OrderedDict()
    basis = model.basis
    for lbl in model.operations:
        g = model.operations[lbl].dense()
        out[lbl] = collections.OrderedDict([
            ('decomposition', _ot.decompose_gate_matrix(g)),
            ('choi_eigenvalues', choi_eigenvalues(g, basis)),
            ('choi_trace', choi_trace(g, basis)),
            ('upper_bound_fidelity', upper_bound_fidelity(g, basis)),
            ('maximum_fidelity', maximum_fidelity(g, basis)),
            ('maximum_trace_dist', maximum_trace_dist(g, basis))])
    return out


def germ_amplified_metrics_table(model, target, germs, max_power=8):
    """Eigenvalue metrics of each germ's product: the quantities GST
    amplifies."""
    out = collections.OrderedDict()
    for germ in germs:
        A, B = _circuit_pair(model, target, germ)
        out[germ] = {
            'eigenvalue_entanglement_infidelity':
                eigenvalue_entanglement_infidelity(A, B, model.basis),
            'eigenvalue_diamondnorm': eigenvalue_diamondnorm(A, B, model.basis),
            'rel_eigenvalues': rel_eigenvalues(A, B, model.basis),
        }
    return out


def model_violation_table(results, estimate_key=None):
    """2*DeltaLogL, its degrees of freedom and N_sigma of a GST estimate."""
    estimate_key = estimate_key or list(results.estimates.keys())[0]
    est = results.estimates[estimate_key]
    p = est.parameters
    return {'final_2dlogl': p.get('final_objfn_value'),
            'final_dof': p.get('final_dof'),
            'n_sigma': est.misfit_sigma()}


# =============================================================================
# leakage reportables, eigenvalue and diamond-norm model functions
# =============================================================================

def leaky_entanglement_infidelity(a, b, mx_basis):
    """1 - the computational subspace's entanglement fidelity."""
    from pygsti_tpu_torch.leakage import metrics as _lm
    return 1 - _lm.subspace_entanglement_fidelity(a, b, mx_basis)


def leaky_maximum_trace_dist(gate, mx_basis):
    """Subspace Jamiolkowski trace distance from `gate` to its closest
    unitary."""
    from pygsti_tpu_torch.algorithms.core import find_closest_unitary_opmx
    from pygsti_tpu_torch.leakage import metrics as _lm
    return _lm.subspace_jtracedist(gate, find_closest_unitary_opmx(gate, mx_basis), mx_basis)


def _leakage_profile(op, mx_basis, direction='leak'):
    """Per-computational-state leakage (or seepage) rates of `op`: the
    probability each computational basis state leaks into (or a leakage
    state seeps back from) the leakage levels; empty where the basis does
    not imply leakage modeling."""
    from pygsti_tpu_torch.baseobjs.basis import Basis
    op = np.asarray(op)
    dim = op.shape[0]
    b = Basis.cast(mx_basis, dim) if isinstance(mx_basis, str) else mx_basis
    if not getattr(b, 'implies_leakage_modeling', lambda: False)():
        return []
    udim = int(round(np.sqrt(dim)))
    comp = list(range(udim - 1))   # leakage convention: the last level leaks
    leak = [udim - 1]
    op_std = change_basis(op, b, 'std')
    src_levels, dst_levels = (comp, leak) if direction == 'leak' else (leak, comp)
    rates = []
    for i in src_levels:
        rho = np.zeros((udim, udim), complex)
        rho[i, i] = 1.0
        out = (op_std @ rho.reshape(-1)).reshape(udim, udim)
        rates.append(float(np.real(sum(out[j, j] for j in dst_levels))))
    return rates


def pergate_leakrate_reduction(op, ignore, mx_basis, reduction):
    """max/min per-state leakage rate of an op; nan when the basis does not
    imply leakage modeling."""
    rates = _leakage_profile(op, mx_basis, 'leak')
    return reduction(rates) if rates else np.nan


def pergate_leakrate_max(op, ignore, mx_basis):
    return pergate_leakrate_reduction(op, ignore, mx_basis, max)


def pergate_leakrate_min(op, ignore, mx_basis):
    return pergate_leakrate_reduction(op, ignore, mx_basis, min)


def pergate_seeprate(op, ignore, mx_basis):
    """The largest per-state seepage rate."""
    rates = _leakage_profile(op, mx_basis, 'seep')
    return max(rates) if rates else np.nan


def diamonddist_to_leakfree_cptp(op, ignore, mx_basis):
    """Diamond distance from `op` to the nearest leak-free CPTP map, an SDP
    that needs cvxpy: ImportError without it."""
    from pygsti_tpu_torch.tools.sdptools import CVXPY_ENABLED
    if not CVXPY_ENABLED:
        raise ImportError("cvxpy is required for SDP leak-free projections")
    raise NotImplementedError("SDP leak-free projection requires the cvxpy solver path")


def subspace_diamonddist_to_leakfree_cptp(op, ignore, mx_basis):
    """Subspace variant of diamonddist_to_leakfree_cptp; needs cvxpy."""
    return diamonddist_to_leakfree_cptp(op, ignore, mx_basis)


def POVM_half_diamond_norm(model_a, model_b, povmlbl):  # noqa: N802
    """Half diamond distance of two models' POVM maps."""
    return povm_half_diamond_norm(model_a, model_b, povmlbl)


def _sorted_eigenvalues(mx):
    evals = np.linalg.eigvals(mx)
    return np.array(sorted(evals, key=lambda x: (-abs(x), -x.real)))


class GateEigenvalues(_ModelFunction):
    """Eigenvalues of a gate, by decreasing modulus."""

    def __init__(self, model, oplabel):
        self.oplabel = oplabel
        super().__init__(model, [("gate", oplabel)])

    def evaluate(self, model):
        return _sorted_eigenvalues(model.operations[self.oplabel].dense())


class CircuitEigenvalues(_ModelFunction):
    """Eigenvalues of a circuit's product map, by decreasing modulus."""

    def __init__(self, model, circuit):
        self.circuit = circuit
        super().__init__(model, ["all"])

    def evaluate(self, model):
        return _sorted_eigenvalues(_circuit_product(model, self.circuit))


class HalfDiamondNorm(_ModelFunction):
    """Half the diamond distance between a model's gate and its target's.

    ``evaluate`` is the full maximization (optools.diamonddist), and keeps
    the maximizing input psi* (polished to the maximizer).
    ``evaluate_nearby`` is half the trace norm of ((A - B) x I)(|psi*><psi*|)
    at that fixed psi*: by Danskin's theorem its first derivative is the
    norm's, and it costs one SVD instead of the optimizer's restarts, so the
    error bar's forward differences use it."""

    def __init__(self, model_a, model_b, oplabel):
        self.oplabel = oplabel
        self.model_b = model_b
        self.psi = None
        super().__init__(model_a, [("gate", oplabel)])

    def _mats(self, model):
        return (model.operations[self.oplabel].dense(),
                self.model_b.operations[self.oplabel].dense())

    def evaluate(self, model):
        a, b = self._mats(model)
        dist, psi = _ot.diamonddist(a, b, model.basis, return_x=True)
        if model is self.base_model:
            self.psi = psi
        return 0.5 * dist

    def evaluate_nearby(self, nearby_model):
        from pygsti_tpu_torch.tools.sdptools import trace_norm_at_input
        if self.psi is None:
            self.evaluate(self.base_model)
        a, b = self._mats(nearby_model)
        return 0.5 * trace_norm_at_input(a - b, self.psi, nearby_model.basis)


class CircuitHalfDiamondNorm(_ModelFunction):
    """Half the diamond distance between a circuit's product maps under two
    models."""

    def __init__(self, model_a, model_b, circuit):
        self.circuit = circuit
        self.model_b = model_b
        super().__init__(model_a, ["all"])

    def evaluate(self, model):
        return 0.5 * _ot.diamonddist(_circuit_product(model, self.circuit),
                                     _circuit_product(self.model_b, self.circuit), model.basis)


def evaluate_instrumentfn_by_name(name, model, target_model, inst_label,
                                  confidence_region_info=None):
    """A named instrument metric: 'infidelity' or 'half diamond norm'."""
    if name in ('infidelity', 'instrument infidelity'):
        return instrument_infidelity(model, target_model, inst_label)
    if name in ('half diamond norm', 'instrument half diamond norm'):
        return instrument_half_diamond_norm(model, target_model, inst_label)
    raise ValueError("Unknown instrument function name: %s" % name)


def _is_qubits(dim):
    d = int(round(np.sqrt(dim)))
    return d * d == dim and d & (d - 1) == 0


def robust_log_gti_and_projections(model_a, model_b, synthetic_idle_circuits):
    """Gauge-robust error-generator projections from synthetic idles.

    For each synthetic-idle circuit s (one whose `model_b` product is the
    identity), the error generator log(A(s) B(s)^-1) is, to first order, a
    known linear combination of the per-gate elementary error generators.
    Stacking these linear systems over the circuits and solving by SVD gives
    gauge-robust linear combinations of per-gate H/S/C/A rates.  Returns
    {combination: rate}."""
    from pygsti_tpu_torch.baseobjs.basis import Basis
    from pygsti_tpu_torch.baseobjs.errorgenlabel import LocalElementaryErrorgenLabel
    mx_basis = model_b.basis
    dim = model_a.dim
    Id = np.identity(dim, 'd')
    op_labels = [gl for gl, gate in model_b.operations.items()
                 if not np.allclose(gate.dense(), Id)]
    eeg_basis = Basis.cast('PP' if _is_qubits(dim) else mx_basis, dim)
    nonI = eeg_basis.labels[1:]
    pairs = [(b1, b2) for i, b1 in enumerate(nonI) for b2 in nonI[i + 1:]]

    def keys(ptype):
        return [(bel,) for bel in nonI] if ptype in ("H", "S") else pairs

    error_superops, error_labels = [], []
    for ptype in ("H", "S", "C", "A"):
        duals = _ot.elementary_errorgens_dual(dim, ptype, eeg_basis)
        for k in keys(ptype):
            error_superops.append(change_basis(
                duals[LocalElementaryErrorgenLabel(ptype, k)], "std", mx_basis))
            error_labels.append("%s(%s)" % (ptype, ",".join(k)))
    n_superops = len(error_superops)

    def projection_vec(errgen):
        proj = []
        for ptype in ("H", "S", "C", "A"):
            projections = _ot.project_errorgen(errgen, ptype, eeg_basis, mx_basis)
            proj.extend(projections[LocalElementaryErrorgenLabel(ptype, k)] for k in keys(ptype))
        return np.array(proj)

    def product_of_labels(labels):
        G = np.eye(dim)
        for lbl in labels:
            G = model_b.operations[lbl].dense() @ G
        return G

    def errgen_jacobian(layers):
        jac = np.empty((n_superops, n_superops * len(op_labels)), complex)
        for i, gl in enumerate(op_labels):
            for k, err_on_gate in enumerate(error_superops):
                noise = np.zeros((dim, dim), complex)
                for n, layer in enumerate(layers):
                    if layer == gl:
                        noise += product_of_labels(layers[n + 1:]) @ err_on_gate \
                            @ product_of_labels(layers[:n + 1])
                jac[:, i * n_superops + k] = [np.vdot(e, noise) for e in error_superops]
        assert np.linalg.norm(jac.imag) < 1e-6, "error generator jacobian should be real!"
        return jac.real

    jacs, ys = [], []
    for s in synthetic_idle_circuits:
        Sa = _circuit_product(model_a, s)
        Sb = _circuit_product(model_b, s)
        assert np.linalg.norm(Sb - Id) < 1e-6, "Synthetic idle %s is not an idle!!" % str(s)
        ys.append(projection_vec(_ot.error_generator(Sa, Sb, mx_basis, "logGTi")))
        jacs.append(errgen_jacobian(tuple(s.layertup)))
    running_jac, running_y = np.concatenate(jacs, axis=0), np.concatenate(ys, axis=0)

    RANK_TOL, COEFF_TOL = 1e-8, 1e-1
    U, sv, Vt = np.linalg.svd(running_jac)
    rank = int(np.count_nonzero(sv > RANK_TOL))
    vals = np.diag(1.0 / sv[:rank]) @ (U[:, :rank].conj().T @ running_y)
    op_error_labels = ["%s.%s" % (gl, el) for gl in op_labels for el in error_labels]
    ret = {}
    for combo, val in zip(Vt[:rank, :], vals):
        combo_str = " + ".join("%.1f*%s" % (c, el) for c, el in zip(combo, op_error_labels)
                               if abs(c) > COEFF_TOL)
        ret[combo_str] = val
    return ret


Robust_LogGTi_and_projections = _modelfn_factory(robust_log_gti_and_projections)
