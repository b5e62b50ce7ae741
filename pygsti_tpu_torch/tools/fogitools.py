"""First-order-gauge-invariant (FOGI) analysis, host numpy/scipy in float64
(counterpart of pygsti_tpu/tools/fogitools.py).

To first order, a gauge transformation exp(K) changes each gate's error
generator by  delta L = K - U K U^-1  (U = the ideal/target superoperator)
and the SPAM error maps by +K (prep) and -K (effects).  Stacking the
elementary-errorgen coefficients of these shifts over all gauge directions
K_j gives per-op gauge-action matrices; FOGI quantities are constructed
from their null spaces:

* *intrinsic* quantities -- left null vectors of a single op's gauge
  action: error rates of that op no gauge transformation can change;
* *relational* quantities -- for each gauge direction that acts faithfully
  on two op sets (the intersection of their "commutant complements"), the
  difference of its action on the two sets:
  fogi_dir^T = eps^T (pinv(ga_A), -pinv(ga_B)), which annihilates the
  stacked gauge action.

This mirrors the reference's construct_fogi_quantities
(fogitools.py:339-768) with dense numpy (the reference uses scipy.sparse),
including its normalization conventions: fogi *vectors* are normalized to 1
under an 'auto' norm order (1-norm for pure-S combinations, else 2-norm)
and fogi *directions* (duals) are vec / ||vec||_2^2, with relational
directions carrying an 'r' factor converting between gauge-space and
errgen-space normalizations.
"""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.tools import matrixtools as _mt


# ---------------------------------------------------------------------------
# gauge action matrices (reference fogitools.py:21-330; dense, full-space --
# explicit models act on the entire state space so no embedding is needed)
# ---------------------------------------------------------------------------

def first_order_gauge_action_matrix(op_superop, gauge_gens, row_duals):
    """Dense gauge-action matrix of a gate: column j holds the row-dual
    projections of  K_j - U K_j U^-1  (reference fogitools.py:21, with the
    conjugation done in a single basis instead of via std-basis embedding --
    the projections are basis-invariant).

    op_superop : [d2, d2] ideal superoperator (model basis)
    gauge_gens : [n_gauge, d2, d2] elementary errorgen superops (same basis)
    row_duals : [n_rows, d2, d2] dual superops for the row projections
    """
    U = np.asarray(op_superop)
    Uinv = np.linalg.inv(U)
    n_gauge = len(gauge_gens)
    n_rows = len(row_duals)
    mx = np.zeros((n_rows, n_gauge))
    duals = np.stack([np.asarray(d) for d in row_duals])
    for j in range(n_gauge):
        K = np.asarray(gauge_gens[j])
        dL = K - U @ K @ Uinv
        vals = np.einsum('kab,ab->k', duals.conj(), dL)
        assert np.linalg.norm(vals.imag) < 1e-9
        mx[:, j] = vals.real
    return mx


def _relevant_gauge_projector(element_action_cols, sign=+1.0, tol=1e-7):
    """(sign *) projector onto the gauge directions that visibly move a SPAM
    element; the reference uses this as the SPAM 'gauge action' matrix
    (fogitools.py:197-210, 258-272: SVD -> normalize-largest-to-+1 ->
    unit-normalize -> V V^dag)."""
    _, s, Vh = np.linalg.svd(element_action_cols, full_matrices=False)
    n = int(np.count_nonzero(s > tol))
    relevant_basis = Vh[0:n, :].T.conj()
    for j in range(relevant_basis.shape[1]):
        i_max = np.argmax(np.abs(relevant_basis[:, j]))
        if abs(relevant_basis[i_max, j]) > 1e-6:
            relevant_basis[:, j] /= relevant_basis[i_max, j]
    relevant_basis = _mt.normalize_columns(relevant_basis)
    return sign * (relevant_basis @ relevant_basis.T.conj())


def first_order_gauge_action_matrix_for_prep(prep_superket, gauge_gens):
    """SPAM gauge action for a preparation: +identity on the subspace of
    gauge directions that move rho (reference fogitools.py:150)."""
    cols = np.stack([np.asarray(g) @ np.asarray(prep_superket)
                     for g in gauge_gens], axis=1)
    return np.real(_relevant_gauge_projector(cols, +1.0))


def first_order_gauge_action_matrix_for_povm(effect_superbras, gauge_gens):
    """SPAM gauge action for a POVM: -identity on the subspace of gauge
    directions that move the effects (reference fogitools.py:238)."""
    cols = np.stack([
        np.concatenate([-np.asarray(g).T.conj() @ np.asarray(v)
                        for v in effect_superbras])
        for g in gauge_gens], axis=1)
    return np.real(_relevant_gauge_projector(cols, -1.0))


def _create_op_errgen_indices_dict(primitive_op_labels,
                                   errorgen_coefficient_labels):
    """op label -> slice into the stacked errorgen-coefficient vector
    (reference fogitools.py:330)."""
    op_errgen_indices = {}
    off = 0
    for op_label in primitive_op_labels:
        n = len(errorgen_coefficient_labels[op_label])
        op_errgen_indices[op_label] = slice(off, off + n)
        off += n
    return op_errgen_indices


# ---------------------------------------------------------------------------
# FOGI quantity construction (reference fogitools.py:339-768)
# ---------------------------------------------------------------------------

def construct_fogi_quantities(primitive_op_labels, gauge_action_matrices,
                              errorgen_coefficient_labels, op_errgen_indices,
                              gauge_space, op_label_abbrevs=None,
                              dependent_fogi_action='drop', norm_order='auto'):
    """Construct FOGI directions + metadata for a gate set.

    gauge_action_matrices : {op_label: dense [n_op_errgens, n_gauge_dirs]}
    errorgen_coefficient_labels : {op_label: list of labels} (global labels
        preferred -- used for naming and 'auto' norm-order resolution)
    gauge_space : ErrorgenSpace whose `vectors` express the gauge directions
        in `gauge_space.elemgen_basis` (used for naming relational dirs)

    Returns (fogi_dirs [n_errgens, n_fogi], fogi_meta, dep_dirs, dep_meta);
    meta entries have 'name', 'abbrev', 'r', 'gaugespace_dir', 'opset'.
    """
    if dependent_fogi_action not in ('drop', 'mark'):
        raise ValueError("Invalid dependent_fogi_action: %r" % (dependent_fogi_action,))
    orthogonalize_relationals = True
    if op_label_abbrevs is None:
        op_label_abbrevs = {}
    if op_errgen_indices is None:
        op_errgen_indices = _create_op_errgen_indices_dict(
            primitive_op_labels, errorgen_coefficient_labels)
    num_elem_errgens = sum(len(labels) for labels
                           in errorgen_coefficient_labels.values())

    ccomms = {}
    fogi_dirs = np.zeros((num_elem_errgens, 0))
    fogi_meta = []
    dep_fogi_dirs = np.zeros((num_elem_errgens, 0))
    dep_fogi_meta = []

    def resolve_norm_order(vecs_to_normalize, label_lists, given):
        """Per-column norm orders: 1 when only 'S' rates contribute, else 2
        (reference fogitools.py:403 'auto' intelligence)."""
        if isinstance(given, (int, np.integer)):
            return np.ones(vecs_to_normalize.shape[1], dtype=np.int64) * given
        if given != 'auto':
            raise ValueError("Invalid norm_order: %s" % str(given))
        lbl_lookup = {}
        off = 0
        for label_list in label_lists:
            lbl_lookup.update({i + off: lbl for i, lbl in enumerate(label_list)})
            off += len(label_list)
        TOL = 1e-8
        orders = []
        for j in range(vecs_to_normalize.shape[1]):
            lbl_types = set(lbl_lookup[i].errorgen_type
                            for i, v in enumerate(vecs_to_normalize[:, j])
                            if abs(v) > TOL)
            orders.append(1 if lbl_types == {'S'} else 2)
        return np.array(orders, dtype=np.int64)

    def add_relational_fogi_dirs(dirs_to_add, gauge_vecs, gauge_dirs,
                                 initial_dirs, metadata, existing_opset,
                                 new_op_label, new_opset, norm_orders):
        vecs_to_add, nrms = _mt.normalize_columns(dirs_to_add, ord=norm_orders,
                                                  return_norms=True)
        L2norm2s = _mt.column_norms(vecs_to_add) ** 2
        L2norm2s[L2norm2s == 0.0] = 1.0
        dirs_scaled = _mt.scale_columns(vecs_to_add, 1 / L2norm2s)  # DUAL NORM
        resulting = np.concatenate([initial_dirs, dirs_scaled], axis=1)

        full_gauge_vecs = gauge_space.vectors @ gauge_vecs
        gauge_names = elem_vec_names(full_gauge_vecs,
                                     gauge_space.elemgen_basis.labels)
        gauge_names_abbrev = elem_vec_names(full_gauge_vecs,
                                            gauge_space.elemgen_basis.labels,
                                            include_type=False)
        names = ["ga(%s)_%s - ga(%s)_%s" % (
            iname, "|".join(op_label_abbrevs.get(l, str(l))
                            for l in existing_opset),
            iname, op_label_abbrevs.get(new_op_label, str(new_op_label)))
            for iname in gauge_names]
        abbrevs = ["ga(%s)" % n for n in gauge_names_abbrev]
        for j, (name, abbrev, nrm, L2n2) in enumerate(
                zip(names, abbrevs, nrms, L2norm2s)):
            metadata.append({'name': name, 'abbrev': abbrev,
                             'r': 1 / (nrm * L2n2),
                             'gaugespace_dir': gauge_dirs[:, j],
                             'opset': new_opset})
        return resulting

    # ---- Step 1: intrinsic quantities + per-op reference frames ----------
    for op_label in primitive_op_labels:
        ga = np.asarray(gauge_action_matrices[op_label])
        lbl_str = op_label if isinstance(op_label, str) else \
            (op_label.name if hasattr(op_label, 'name') else str(op_label))
        if isinstance(lbl_str, str) and (lbl_str.startswith('rho')
                                         or lbl_str.startswith('M')):
            # SPAM: no intrinsic quantities; record faithful-rep complement
            commutant = _mt.nice_nullspace(ga)
            complement = _mt.nice_nullspace(commutant.T)
            ccomms[(op_label,)] = complement
            continue

        commutant = _mt.nice_nullspace(ga, orthogonalize=True)
        local_fogi_dirs = _mt.nice_nullspace(ga.T, orthogonalize=True)

        ord_to_use = resolve_norm_order(
            local_fogi_dirs, [errorgen_coefficient_labels[op_label]],
            norm_order)
        local_fogi_vecs = _mt.normalize_columns(local_fogi_dirs,
                                                ord=ord_to_use)
        L2norm2s = np.array([np.linalg.norm(local_fogi_vecs[:, j]) ** 2
                             for j in range(local_fogi_vecs.shape[1])])
        local_fogi_dirs = local_fogi_vecs / L2norm2s[None, :]  # DUAL NORM
        assert _mt.columns_are_orthogonal(local_fogi_dirs)

        new_dirs = np.zeros((num_elem_errgens, local_fogi_dirs.shape[1]))
        new_dirs[op_errgen_indices[op_label], :] = local_fogi_dirs
        fogi_dirs = np.concatenate([fogi_dirs, new_dirs], axis=1)

        op_elemgen_labels = errorgen_coefficient_labels[op_label]
        errgen_names = elem_vec_names(local_fogi_vecs, op_elemgen_labels)
        errgen_names_abbrev = elem_vec_names(local_fogi_vecs,
                                             op_elemgen_labels,
                                             include_type=False)
        for egname, egabbrev in zip(errgen_names, errgen_names_abbrev):
            egname_with_op = "%s_%s" % (
                ("(%s)" % egname) if (' ' in egname) else egname,
                op_label_abbrevs.get(op_label, str(op_label)))
            fogi_meta.append({'name': egname_with_op, 'abbrev': egabbrev,
                              'r': 0, 'gaugespace_dir': None,
                              'opset': (op_label,)})

        complement = _mt.nice_nullspace(commutant.T, orthogonalize=True)
        ccomms[(op_label,)] = complement

    # ---- Step 2: relational quantities over growing op sets --------------
    smaller_sets = [(op_label,) for op_label in primitive_op_labels]
    max_size = len(primitive_op_labels)
    for set_size in range(1, max_size):
        larger_sets = []
        num_indep_from_smaller = fogi_dirs.shape[1]
        for op_label in primitive_op_labels:
            for existing_set in smaller_sets:
                if op_label in existing_set:
                    continue
                new_set = tuple(sorted(existing_set + (op_label,),
                                       key=str))
                if new_set in larger_sets:
                    continue
                ccommA = ccomms.get(existing_set, None)
                ccommB = ccomms[(op_label,)]
                if ccommA is not None and ccommA.shape[1] > 0 \
                        and ccommB.shape[1] > 0:
                    intersection_space = _mt.intersection_space(
                        ccommA, ccommB, use_nice_nullspace=True)
                    union_space = _mt.union_space(ccommA, ccommB)

                    if intersection_space.shape[1] > 0:
                        gauge_action = np.concatenate(
                            [np.asarray(gauge_action_matrices[ol])
                             for ol in existing_set]
                            + [np.asarray(gauge_action_matrices[op_label])],
                            axis=0)
                        n = sum(np.asarray(gauge_action_matrices[ol]).shape[0]
                                for ol in existing_set)
                        inv_diff_gauge_action = np.concatenate(
                            (np.linalg.pinv(gauge_action[0:n, :], rcond=1e-7),
                             -np.linalg.pinv(gauge_action[n:, :], rcond=1e-7)),
                            axis=1).T

                        if orthogonalize_relationals:
                            test_dirs = inv_diff_gauge_action @ intersection_space
                            Q, R = np.linalg.qr(test_dirs)
                            Q, R = _mt.sign_fix_qr(Q, R)
                            intersection_space = intersection_space @ np.linalg.inv(R)

                        int_in_geb = gauge_space.vectors @ intersection_space
                        ord_to_use = resolve_norm_order(
                            int_in_geb, [gauge_space.elemgen_basis.labels],
                            norm_order)
                        int_vecs_in_geb = _mt.normalize_columns(int_in_geb,
                                                                ord=ord_to_use)
                        int_vecs = np.linalg.pinv(gauge_space.vectors) \
                            @ int_vecs_in_geb
                        L2norm2s = np.array(
                            [np.linalg.norm(int_vecs[:, j]) ** 2
                             for j in range(int_vecs.shape[1])])
                        L2norm2s[L2norm2s == 0.0] = 1.0
                        intersection_space = int_vecs / L2norm2s[None, :]

                        local_fogi_dirs = inv_diff_gauge_action \
                            @ intersection_space
                        assert np.linalg.norm(gauge_action.T
                                              @ local_fogi_dirs) < 1e-8
                        norm_order_array = resolve_norm_order(
                            local_fogi_dirs,
                            [errorgen_coefficient_labels[ol]
                             for ol in existing_set + (op_label,)],
                            norm_order)

                        new_dirs = np.zeros((num_elem_errgens,
                                             local_fogi_dirs.shape[1]),
                                            dtype=local_fogi_dirs.dtype)
                        off = 0
                        for ol in existing_set + (op_label,):
                            nn = len(errorgen_coefficient_labels[ol])
                            new_dirs[op_errgen_indices[ol], :] = \
                                local_fogi_dirs[off:off + nn, :]
                            off += nn

                        indep_cols = _mt.independent_columns(new_dirs,
                                                             fogi_dirs)
                        if dependent_fogi_action == 'drop':
                            dep_cols_to_add = []
                        else:  # 'mark'
                            smallset_indep = _mt.independent_columns(
                                new_dirs,
                                fogi_dirs[:, 0:num_indep_from_smaller])
                            indep_set = set(indep_cols)
                            dep_cols_to_add = [i for i in smallset_indep
                                               if i not in indep_set]

                        fogi_dirs = add_relational_fogi_dirs(
                            new_dirs[:, indep_cols],
                            np.take(int_vecs, indep_cols, axis=1),
                            np.take(intersection_space, indep_cols, axis=1),
                            fogi_dirs, fogi_meta, existing_set, op_label,
                            new_set, norm_order_array[indep_cols])
                        dep_fogi_dirs = add_relational_fogi_dirs(
                            new_dirs[:, dep_cols_to_add],
                            np.take(int_vecs, dep_cols_to_add, axis=1),
                            np.take(intersection_space, dep_cols_to_add, axis=1),
                            dep_fogi_dirs, dep_fogi_meta, existing_set,
                            op_label, new_set,
                            norm_order_array[dep_cols_to_add])

                    ccomms[new_set] = union_space
                larger_sets.append(new_set)
        smaller_sets = larger_sets

    if np.linalg.norm(np.imag(fogi_dirs)) < 1e-6:
        fogi_dirs = fogi_dirs.real
    if np.linalg.norm(np.imag(dep_fogi_dirs)) < 1e-6:
        dep_fogi_dirs = dep_fogi_dirs.real
    return fogi_dirs, fogi_meta, dep_fogi_dirs, dep_fogi_meta


def compute_maximum_relational_errors(primitive_op_labels,
                                      errorgen_coefficients,
                                      gauge_action_matrices, gauge_space_dim):
    """Upper bounds on relational errors: for each op, the norm of the
    errorgen change a best-case gauge transformation could induce
    (simplified version of reference fogitools.py:803)."""
    out = {}
    for op_label in primitive_op_labels:
        ga = np.asarray(gauge_action_matrices[op_label])
        e = np.asarray(errorgen_coefficients[op_label])
        delta = ga @ np.linalg.pinv(ga, rcond=1e-7) @ e
        out[op_label] = float(np.linalg.norm(delta))
    return out


# ---------------------------------------------------------------------------
# naming (reference fogitools.py:1085-1157)
# ---------------------------------------------------------------------------

def _label_parts(elem_lbl):
    """(errorgen_type, basis_element_labels, sslbls_str) for naming."""
    egtype = elem_lbl.errorgen_type
    bels = elem_lbl.basis_element_labels
    sslbls = getattr(elem_lbl, 'sslbls', None)
    sslbls_str = ''.join(map(str, sslbls)) if sslbls is not None else None
    return egtype, bels, sslbls_str


def elem_vec_name(vec, elem_labels, include_type=True):
    """Human-readable name of a vector over elementary errorgens, e.g.
    '0.5 S(X:0) + 0.5 S(Z:0)' (reference fogitools.py:1111)."""
    name = ""
    for i, elem_lbl in enumerate(elem_labels):
        egtype, bels, sslbls_str = _label_parts(elem_lbl)
        val = vec[i]
        if abs(val) < 1e-6:
            continue
        sign = ' + ' if val > 0 else ' - '
        abs_val_str = '' if np.isclose(abs(val), 1.0) else ("%g " % abs(val))
        if sslbls_str is not None:
            basis_str = ','.join("%s:%s" % (b, sslbls_str) for b in bels)
        else:
            basis_str = ','.join(map(str, bels))
        if include_type:
            name += sign + abs_val_str + "%s(%s)" % (egtype, basis_str)
        else:
            name += sign + abs_val_str + basis_str
    if name.startswith(' + '):
        name = name[3:]
    if name.startswith(' - '):
        name = '-' + name[3:]
    return name


def elem_vec_names(vecs, elem_labels, include_type=True):
    return [elem_vec_name(vecs[:, j], elem_labels, include_type)
            for j in range(vecs.shape[1])]


def op_elem_vec_name(vec, elem_op_labels, op_label_abbrevs):
    """Name over (op, elem-errorgen) pairs: 'H(X:0)_Gx - H(X:0)_Gy'
    (reference fogitools.py:1085)."""
    name = ""
    for i, (op_lbl, elem_lbl) in enumerate(elem_op_labels):
        egtype, bels, sslbls_str = _label_parts(elem_lbl)
        val = vec[i]
        if abs(val) < 1e-6:
            continue
        sign = ' + ' if val > 0 else ' - '
        abs_val_str = '' if np.isclose(abs(val), 1.0) else ("%g " % abs(val))
        if sslbls_str is not None:
            basis_str = ','.join("%s:%s" % (b, sslbls_str) for b in bels)
        else:
            basis_str = ','.join(map(str, bels))
        name += sign + abs_val_str + "%s(%s)_%s" % (
            egtype, basis_str, op_label_abbrevs.get(op_lbl, str(op_lbl)))
    if name.startswith(' + '):
        name = name[3:]
    if name.startswith(' - '):
        name = '-' + name[3:]
    return name


def op_elem_vec_names(vecs, elem_op_labels, op_label_abbrevs):
    if op_label_abbrevs is None:
        op_label_abbrevs = {}
    return [op_elem_vec_name(vecs[:, j], elem_op_labels, op_label_abbrevs)
            for j in range(vecs.shape[1])]
