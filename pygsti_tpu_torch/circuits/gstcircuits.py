"""GST circuit-list construction (counterpart of
pygsti_tpu/circuits/gstcircuits.py: ``create_lsgst_circuit_lists`` with
whole germ powers, nested lists and the LGST circuits included).

Builds the nested per-max-length lists of long-sequence GST,
prep_fiducial + germ^(L // len(germ)) + meas_fiducial, without duplicates.
"""

from __future__ import annotations

import collections

from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.circuits.circuitstructure import (
    GermFiducialPairPlaquette, PlaquetteGridCircuitStructure)


def create_lgst_circuits(prep_fiducials, meas_fiducials, op_label_src):
    """All fiducial pairs, then the fiducial/gate/fiducial sandwiches."""
    op_labels = list(op_label_src.operations.keys()) \
        if hasattr(op_label_src, 'operations') else list(op_label_src)
    seen = set()
    out = []

    def add(c):
        if c not in seen:
            seen.add(c)
            out.append(c)

    for f1 in prep_fiducials:
        for f2 in meas_fiducials:
            add(f1 + f2)
    for g in op_labels:
        gc = Circuit((g,), prep_fiducials[0].line_labels if prep_fiducials else None)
        for f1 in prep_fiducials:
            for f2 in meas_fiducials:
                add(f1 + gc + f2)
    return out


def make_lsgst_structs(op_label_src, prep_fiducials, meas_fiducials, germs,
                       max_lengths):
    """One PlaquetteGridCircuitStructure per max length, nested, with the
    LGST circuits first and one plaquette per (L, germ)."""
    plaquettes = collections.OrderedDict()
    germs = list(germs)
    line_labels = germs[0].line_labels if germs else \
        (list(prep_fiducials) + list(meas_fiducials))[0].line_labels
    empty_germ = Circuit((), line_labels)
    struct_germs = germs if empty_germ in germs else [empty_germ] + germs
    lgst_circuits = create_lgst_circuits(prep_fiducials, meas_fiducials,
                                         op_label_src)
    first_L = next((l for l in max_lengths if l != 0), None)

    lists = []
    for L in max_lengths:
        if L != 0:
            if L == first_L:
                # the LGST fiducial pairs as an empty-germ plaquette
                fidpairs0 = collections.OrderedDict(
                    ((j, i), (f1, f2))
                    for (i, f1) in enumerate(prep_fiducials)
                    for (j, f2) in enumerate(meas_fiducials))
                plaquettes[(L, empty_germ)] = GermFiducialPairPlaquette(
                    empty_germ, 1, fidpairs0, len(meas_fiducials),
                    len(prep_fiducials))
            for germ in germs:
                reps = L // germ.depth if germ.depth > 0 else 0
                if reps == 0:
                    continue
                fidpairs = collections.OrderedDict(
                    ((j, i), (f1, f2))
                    for (i, f1) in enumerate(prep_fiducials)
                    for (j, f2) in enumerate(meas_fiducials))
                plaquettes[(L, germ)] = GermFiducialPairPlaquette(
                    germ, reps, fidpairs, len(meas_fiducials),
                    len(prep_fiducials))
        lists.append(PlaquetteGridCircuitStructure(
            dict(plaquettes), [l for l in max_lengths if l <= L], struct_germs,
            "L", "germ", lgst_circuits))
    return lists


def create_lsgst_circuit_lists(op_label_src, prep_fiducials, meas_fiducials,
                               germs, max_lengths):
    """The nested GST circuit lists, one per max length."""
    return make_lsgst_structs(op_label_src, prep_fiducials, meas_fiducials,
                              germs, max_lengths)
