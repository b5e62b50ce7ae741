"""First-order gauge-invariant (FOGI) store, host numpy (counterpart of
pygsti_tpu/models/fogistore.py).

Holds the FOGI analysis of a gate set: the FOGI directions (dual vectors in
elementary-errorgen space), their metadata (names, opsets, gauge-space
directions, r-factors), the complementary first-order gauge-*variant*
(FOGV) directions, and conversion methods between errorgen vectors, per-op
coefficient dicts, and FOGI/FOGV component arrays.
"""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.tools import fogitools as _fogit
from pygsti_tpu_torch.tools import matrixtools as _mt


def _slice_indices(s):
    return list(range(s.start, s.stop))


class FirstOrderGaugeInvariantStore(object):
    """See module docstring (reference: fogistore.py:25)."""

    def __init__(self, primitive_op_labels, gauge_space,
                 elem_errorgen_labels_by_op, op_errorgen_indices,
                 fogi_directions, fogi_metadata, dependent_dir_indices,
                 fogv_directions, allop_gauge_action, gauge_space_directions,
                 norm_order='auto', dependent_fogi_action='drop'):
        self.primitive_op_labels = tuple(primitive_op_labels)
        self.gauge_space = gauge_space
        self.elem_errorgen_labels_by_op = elem_errorgen_labels_by_op
        self.op_errorgen_indices = op_errorgen_indices
        self.fogi_directions = np.asarray(fogi_directions)
        self.fogi_metadata = fogi_metadata
        self.dependent_dir_indices = dependent_dir_indices
        self.fogv_directions = np.asarray(fogv_directions)
        self.allop_gauge_action = np.asarray(allop_gauge_action)
        self.gauge_space_directions = gauge_space_directions
        self.norm_order = norm_order
        self._dependent_fogi_action = dependent_fogi_action

        self.errorgen_space_op_elem_labels = tuple(
            (op_label, elem_lbl) for op_label in self.primitive_op_labels
            for elem_lbl in self.elem_errorgen_labels_by_op[op_label])
        self.fogv_labels = ["%d gauge action" % i
                            for i in range(self.fogv_directions.shape[1])]

    @classmethod
    def from_gauge_action_matrices(cls, gauge_action_matrices_by_op,
                                   gauge_action_gauge_spaces_by_op,
                                   errorgen_coefficient_labels_by_op,
                                   op_label_abbrevs=None,
                                   dependent_fogi_action='drop',
                                   norm_order='auto'):
        """Build the store from per-op gauge-action matrices (reference:
        fogistore.py:126): intersect the per-op gauge spaces into a common
        gauge space, re-express each op's action on it, construct FOGI
        quantities, and compute the FOGV complement."""
        gauge_action_matrices_by_op = dict(gauge_action_matrices_by_op)
        primitive_op_labels = tuple(gauge_action_matrices_by_op.keys())

        common_gauge_space = None
        for op_label, gs in gauge_action_gauge_spaces_by_op.items():
            common_gauge_space = gs if common_gauge_space is None else \
                common_gauge_space.intersection(gs,
                                                free_on_unspecified_space=True,
                                                use_nice_nullspace=True)
        common_gauge_space.normalize()
        gauge_space = common_gauge_space

        elem_errorgen_labels_by_op = errorgen_coefficient_labels_by_op
        op_errorgen_indices = _fogit._create_op_errgen_indices_dict(
            primitive_op_labels, elem_errorgen_labels_by_op)
        errorgen_space_op_elem_labels = tuple(
            (op_label, elem_lbl) for op_label in primitive_op_labels
            for elem_lbl in elem_errorgen_labels_by_op[op_label])
        num_elem_errgens = sum(len(lbls) for lbls
                               in elem_errorgen_labels_by_op.values())
        allop_gauge_action = np.zeros(
            (num_elem_errgens, gauge_space.vectors.shape[1]))

        # restrict each op's gauge action to the common gauge space:
        # W = V alpha (common vectors as combos of op's own gauge vectors)
        for op_label, orig_gauge_space in gauge_action_gauge_spaces_by_op.items():
            gauge_action = np.asarray(gauge_action_matrices_by_op[op_label])
            op_elemgen_lbls = orig_gauge_space.elemgen_basis.labels
            W = gauge_space.vectors[
                gauge_space.elemgen_basis.label_indices(op_elemgen_lbls), :]
            V = orig_gauge_space.vectors
            alpha = np.linalg.pinv(V) @ W
            restricted = gauge_action @ alpha
            allop_gauge_action[op_errorgen_indices[op_label], :] = restricted
            gauge_action_matrices_by_op[op_label] = restricted

        (indep_dirs, indep_meta, dep_dirs, dep_meta) = \
            _fogit.construct_fogi_quantities(
                primitive_op_labels, gauge_action_matrices_by_op,
                elem_errorgen_labels_by_op, op_errorgen_indices, gauge_space,
                op_label_abbrevs, dependent_fogi_action, norm_order)
        fogi_directions = np.concatenate([indep_dirs, dep_dirs], axis=1)
        fogi_metadata = indep_meta + dep_meta
        dependent_dir_indices = np.arange(len(indep_meta), len(fogi_metadata))
        for j, meta in enumerate(fogi_metadata):
            meta['raw'] = _fogit.op_elem_vec_name(
                fogi_directions[:, j], errorgen_space_op_elem_labels,
                op_label_abbrevs if op_label_abbrevs is not None else {})

        assert len(errorgen_space_op_elem_labels) == fogi_directions.shape[0]

        # first-order gauge-VARIANT directions: complement of FOGI dirs
        fogv_directions = _mt.nullspace(fogi_directions.T)
        pinv_allop = np.linalg.pinv(allop_gauge_action, rcond=1e-7)
        gauge_space_directions = pinv_allop @ fogv_directions

        store = cls(primitive_op_labels, gauge_space,
                    elem_errorgen_labels_by_op, op_errorgen_indices,
                    fogi_directions, fogi_metadata, dependent_dir_indices,
                    fogv_directions, allop_gauge_action,
                    gauge_space_directions, norm_order, dependent_fogi_action)
        store._check_fogi_store()
        return store

    def _check_fogi_store(self):
        """Sanity checks (reference fogistore.py:280)."""
        fogi_dirs = self.fogi_directions
        fogv_dirs = self.fogv_directions
        assert np.linalg.norm(self.allop_gauge_action.T @ fogi_dirs) < 1e-8
        if self._dependent_fogi_action == 'drop' and fogi_dirs.shape[1]:
            assert np.linalg.norm(fogi_dirs.T @ np.linalg.pinv(fogi_dirs.T)
                                  - np.identity(fogi_dirs.shape[1])) < 1e-6
        if fogv_dirs.shape[1]:
            assert _mt.columns_are_orthogonal(fogv_dirs)
            assert np.linalg.norm(fogv_dirs.T @ np.linalg.pinv(fogv_dirs.T)
                                  - np.identity(fogv_dirs.shape[1])) < 1e-6

    def _require_independent(self):
        if self._dependent_fogi_action != 'drop':
            raise ValueError("Cannot invert with linearly-dependent FOGI directions")

    # -- dimensions & labels -------------------------------------------------
    @property
    def errorgen_space_dim(self):
        return self.fogi_directions.shape[0]

    @property
    def gauge_space_dim(self):
        return self.gauge_space.vectors.shape[1]

    @property
    def num_fogi_directions(self):
        return self.fogi_directions.shape[1]

    @property
    def num_fogv_directions(self):
        return self.fogv_directions.shape[1]

    def fogi_errorgen_direction_labels(self, typ='normal'):
        """typ: 'normal' | 'raw' | 'abbrev'."""
        if typ == 'normal':
            return tuple(m['name'] for m in self.fogi_metadata)
        elif typ == 'raw':
            return tuple(m['raw'] for m in self.fogi_metadata)
        elif typ in ('abbrev', 'abrev'):
            return tuple(m['abbrev'] for m in self.fogi_metadata)
        raise ValueError("Invalid `typ` argument: %s" % str(typ))

    def fogv_errorgen_direction_labels(self, typ='normal'):
        return tuple(self.fogv_labels if typ == 'normal'
                     else [''] * len(self.fogv_labels))

    # -- conversions ----------------------------------------------------------
    def errorgen_vec_to_fogi_components_array(self, errorgen_vec):
        coeffs = self.fogi_directions.T @ errorgen_vec
        assert np.linalg.norm(np.imag(coeffs)) < 1e-8
        return np.real(coeffs)

    def errorgen_vec_to_fogv_components_array(self, errorgen_vec):
        coeffs = self.fogv_directions.T @ errorgen_vec
        assert np.linalg.norm(np.imag(coeffs)) < 1e-8
        return np.real(coeffs)

    def _opcoeffs_to_errorgen_vec(self, op_coeffs):
        vec = np.zeros(self.errorgen_space_dim, 'd')
        for i, (op_label, elem_lbl) in enumerate(
                self.errorgen_space_op_elem_labels):
            vec[i] += op_coeffs[op_label].get(elem_lbl, 0.0)
        return vec

    def opcoeffs_to_fogi_components_array(self, op_coeffs):
        return self.errorgen_vec_to_fogi_components_array(
            self._opcoeffs_to_errorgen_vec(op_coeffs))

    def opcoeffs_to_fogv_components_array(self, op_coeffs):
        return self.errorgen_vec_to_fogv_components_array(
            self._opcoeffs_to_errorgen_vec(op_coeffs))

    def opcoeffs_to_fogiv_components_array(self, op_coeffs):
        vec = self._opcoeffs_to_errorgen_vec(op_coeffs)
        return (self.errorgen_vec_to_fogi_components_array(vec),
                self.errorgen_vec_to_fogv_components_array(vec))

    def fogi_components_array_to_errorgen_vec(self, fogi_components):
        self._require_independent()
        return np.linalg.pinv(self.fogi_directions.T, rcond=1e-7) \
            @ fogi_components

    def fogv_components_array_to_errorgen_vec(self, fogv_components):
        self._require_independent()
        return np.linalg.pinv(self.fogv_directions.T, rcond=1e-7) \
            @ fogv_components

    def fogiv_components_array_to_errorgen_vec(self, fogi_components,
                                               fogv_components):
        self._require_independent()
        return np.linalg.pinv(
            np.concatenate([self.fogi_directions, self.fogv_directions],
                           axis=1).T, rcond=1e-7) \
            @ np.concatenate([fogi_components, fogv_components])

    def errorgen_vec_to_opcoeffs(self, errorgen_vec):
        op_coeffs = {op_label: {} for op_label in self.primitive_op_labels}
        for (op_label, elem_lbl), val in zip(
                self.errorgen_space_op_elem_labels, errorgen_vec):
            op_coeffs[op_label][elem_lbl] = val
        return op_coeffs

    def fogi_components_array_to_opcoeffs(self, fogi_components):
        return self.errorgen_vec_to_opcoeffs(
            self.fogi_components_array_to_errorgen_vec(fogi_components))

    def fogv_components_array_to_opcoeffs(self, fogv_components):
        return self.errorgen_vec_to_opcoeffs(
            self.fogv_components_array_to_errorgen_vec(fogv_components))

    def fogiv_components_array_to_opcoeffs(self, fogi_components,
                                           fogv_components):
        return self.errorgen_vec_to_opcoeffs(
            self.fogiv_components_array_to_errorgen_vec(fogi_components,
                                                        fogv_components))

    # -- aggregation / binning -------------------------------------------------
    def create_binned_fogi_infos(self, tol=1e-5):
        """Nested dict bins[opset][types][qubits] -> list of per-FOGI info
        dicts (reference fogistore.py:556)."""
        elemgen_info = {}
        for k, (op_label, eglabel) in enumerate(
                self.errorgen_space_op_elem_labels):
            elemgen_info[k] = {
                'type': eglabel.errorgen_type,
                'qubits': getattr(eglabel, 'sslbls', ()),
                'op_label': op_label,
                'elemgen_label': eglabel,
            }
        bins = {}
        dependent = set(np.asarray(self.dependent_dir_indices).tolist())
        for i, meta in enumerate(self.fogi_metadata):
            fogi_dir = self.fogi_directions[:, i]
            present = np.where(np.abs(fogi_dir) > tol)[0]
            ops_involved, qubits, types = set(), set(), set()
            for k in present:
                ops_involved.add(elemgen_info[k]['op_label'])
                qubits.update(elemgen_info[k]['qubits'])
                types.add(elemgen_info[k]['type'])
            info = {'op_set': ops_involved, 'types': types, 'qubits': qubits,
                    'fogi_index': i, 'label': meta['name'],
                    'label_raw': meta['raw'], 'label_abbrev': meta['abbrev'],
                    'dependent': bool(i in dependent),
                    'gauge_dir': meta['gaugespace_dir'],
                    'fogi_dir': fogi_dir, 'r_factor': meta['r']}
            okey = tuple(sorted(ops_involved, key=str))
            tkey = tuple(sorted(types))
            qkey = tuple(sorted(qubits, key=str))
            bins.setdefault(okey, {}).setdefault(tkey, {}) \
                .setdefault(qkey, []).append(info)
        return bins

    def create_elementary_errorgen_space(self, op_elem_errgen_labels):
        """Columns spanning the given (op, elem-errorgen) pairs
        (reference fogistore.py:622)."""
        lbl_to_index = {}
        for op_label in self.primitive_op_labels:
            lbls = self.elem_errorgen_labels_by_op[op_label]
            idxs = _slice_indices(self.op_errorgen_indices[op_label])
            lbl_to_index.update({(op_label, lbl): index
                                 for lbl, index in zip(lbls, idxs)})
        ret = np.zeros((self.fogi_directions.shape[0],
                        len(op_elem_errgen_labels)))
        for i, lbl in enumerate(op_elem_errgen_labels):
            ret[lbl_to_index[lbl], i] = 1.0
        return ret

    def create_fogi_aggregate_space(self, op_set='all', errorgen_types='all',
                                    target='all'):
        """FOGI directions within the given categories (reference
        fogistore.py:655)."""
        binned = self.create_binned_fogi_infos()
        selected = []
        for ops, by_type in binned.items():
            if op_set == 'all' or ops == op_set:
                for type_tup, by_target in by_type.items():
                    if errorgen_types == 'all' or type_tup == errorgen_types:
                        for tgt, info_lst in by_target.items():
                            if target == 'all' or tgt == target:
                                selected.extend(info_lst)
        return np.take(self.fogi_directions,
                       [info['fogi_index'] for info in selected], axis=1)

    def create_fogi_aggregate_single_op_space(self, op_label,
                                              errorgen_type='H',
                                              intrinsic_or_relational='intrinsic',
                                              target='all'):
        """Columns spanning a single op's intrinsic/relational FOGI subspace
        (reference fogistore.py:705)."""
        binned = self.create_binned_fogi_infos()
        elem_lbls = self.elem_errorgen_labels_by_op[op_label]
        elem_indices = _slice_indices(self.op_errorgen_indices[op_label])

        op_elem_space = np.zeros((self.fogi_directions.shape[0],
                                  len(elem_indices)))
        for i, index in enumerate(elem_indices):
            op_elem_space[index, i] = 1.0

        if target == 'all' and errorgen_type == 'all':
            on_target = elem_indices
        else:
            on_target = []
            for index, lbl in zip(elem_indices, elem_lbls):
                if errorgen_type in ('all', lbl.errorgen_type):
                    support = getattr(lbl, 'sslbls', None)
                    if target == 'all' or target == support:
                        on_target.append(index)
        support_elem_space = np.zeros((self.fogi_directions.shape[0],
                                       len(on_target)))
        for i, index in enumerate(on_target):
            support_elem_space[index, i] = 1.0

        if intrinsic_or_relational in ('intrinsic', 'relational'):
            selected = []
            for ops, by_type in binned.items():
                if ops == (op_label,):
                    for _, by_target in by_type.items():
                        for _, info_lst in by_target.items():
                            selected.extend(info_lst)
            fogi_indices = [info['fogi_index'] for info in selected]
            full_int_space = np.take(self.fogi_directions, fogi_indices,
                                     axis=1)
            if intrinsic_or_relational == 'intrinsic':
                space = _mt.intersection_space(support_elem_space,
                                               full_int_space,
                                               use_nice_nullspace=True)
            else:
                local_support = op_elem_space.T @ support_elem_space
                local_int = op_elem_space.T @ full_int_space
                local_rel = _mt.nice_nullspace(local_int.T)
                support_rel = _mt.intersection_space(local_support, local_rel,
                                                     use_nice_nullspace=True)
                space = op_elem_space @ support_rel
        elif intrinsic_or_relational == 'all':
            space = support_elem_space
        else:
            raise ValueError("Invalid intrinsic_or_relational value: %s"
                             % str(intrinsic_or_relational))
        return space[:, _mt.independent_columns(space)]

    @classmethod
    def merge_binned_fogi_infos(cls, binned_fogi_infos, index_offsets):
        """Merge several stores' binned infos, offsetting fogi indices
        (reference fogistore.py:801)."""
        merged = {}
        for store_index, (bins, offset) in enumerate(
                zip(binned_fogi_infos, index_offsets)):
            for okey, by_type in bins.items():
                for tkey, by_target in by_type.items():
                    for qkey, info_lst in by_target.items():
                        dest = merged.setdefault(okey, {}) \
                            .setdefault(tkey, {}).setdefault(qkey, [])
                        for info in info_lst:
                            info = dict(info)
                            info['fogi_index'] += offset
                            info['store_index'] = store_index
                            dest.append(info)
        return merged
