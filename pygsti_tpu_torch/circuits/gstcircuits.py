"""GST circuit-list construction (counterpart of
pygsti_tpu/circuits/gstcircuits.py).

Builds the per-max-length lists of long-sequence GST,
prep_fiducial + germ^(L // len(germ)) + meas_fiducial, without duplicates,
with the JAX package's options: fiducial-pair reduction (``fid_pairs``),
random pair subsets (``keep_fraction``/``keep_seed``, drawn in the JAX
package's order so that the lists match draw for draw), per-germ length
limits, the three truncation schemes and a dataset check.
"""

from __future__ import annotations

import collections

import numpy as np

from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.circuits.circuitstructure import (
    FiducialPairPlaquette, GermFiducialPairPlaquette, PlaquetteGridCircuitStructure)


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


def repeat_with_max_length(circuit, max_length):
    """germ^(max_length // len(germ)): 'whole germ powers'."""
    if circuit.depth == 0:
        return circuit
    return circuit.repeat(max_length // circuit.depth)


def repeat_and_truncate(circuit, max_length):
    """The circuit repeated, then cut to exactly max_length layers."""
    if circuit.depth == 0:
        return circuit
    reps = -(-max_length // circuit.depth)
    return circuit.repeat(reps)[:max_length]


def make_lsgst_structs(op_label_src, prep_fiducials, meas_fiducials, germs,
                       max_lengths, fid_pairs=None, trunc_scheme="whole germ powers",
                       nest=True, include_lgst=True, germ_length_limits=None,
                       op_label_aliases=None, dscheck=None,
                       action_if_missing="raise", verbosity=0,
                       keep_fraction=1, keep_seed=None):
    """One PlaquetteGridCircuitStructure per max length, each holding the
    plaquettes of every length up to its own: the LGST circuits first (with
    ``include_lgst``), then one plaquette per (L, germ).

    ``fid_pairs`` is a list of (prep index, meas index) pairs for every
    germ, or a dict germ -> such a list (a germ absent from it keeps every
    pair).  ``keep_fraction < 1`` keeps round(keep_fraction * n_pairs) pairs
    per (germ, L), drawn from RandomState(keep_seed); the pairs that
    ``fid_pairs`` names are always kept and random ones top them up.
    ``dscheck``: circuits missing from that dataset raise ValueError, or are
    left out with ``action_if_missing`` other than "raise".  As in the JAX
    package, every list holds the plaquettes of all shorter lengths whatever
    ``nest`` says, and ``verbosity`` prints nothing."""
    germ_length_limits = germ_length_limits or {}
    plaquettes = collections.OrderedDict()
    lgst_circuits = []
    germs = list(germs)
    line_labels = germs[0].line_labels if germs else \
        (list(prep_fiducials) + list(meas_fiducials))[0].line_labels
    empty_germ = Circuit((), line_labels)
    struct_germs = [empty_germ] + germs if (include_lgst and empty_germ not in germs) \
        else germs
    all_pairs = [(f1, f2) for f1 in prep_fiducials for f2 in meas_fiducials]
    if keep_fraction < 1.0:
        rndm = np.random.RandomState(keep_seed)
        n_keep = int(round(float(keep_fraction) * len(all_pairs)))
    else:
        rndm = None
    if include_lgst and (len(max_lengths) == 0 or max_lengths[0] != 0):
        lgst_circuits = create_lgst_circuits(prep_fiducials, meas_fiducials, op_label_src)

    def pairs_for_germ(germ):
        pair_idxs = fid_pairs.get(germ) if isinstance(fid_pairs, dict) else fid_pairs
        if pair_idxs is None:
            return all_pairs
        return [(prep_fiducials[i], meas_fiducials[j]) for (i, j) in pair_idxs]

    def every_pair():
        return collections.OrderedDict(((j, i), (f1, f2))
                                       for (i, f1) in enumerate(prep_fiducials)
                                       for (j, f2) in enumerate(meas_fiducials))

    first_L = next((l for l in max_lengths if l != 0), None)
    lists = []
    for L in max_lengths:
        if L != 0:
            if include_lgst and L == first_L:
                # the LGST fiducial pairs as an empty-germ plaquette; no
                # pair reduction applies to them
                plaquettes[(L, empty_germ)] = GermFiducialPairPlaquette(
                    empty_germ, 1, every_pair(), len(meas_fiducials),
                    len(prep_fiducials), op_label_aliases)
            for germ in germs:
                Lg = min(L, germ_length_limits.get(germ, L))
                if trunc_scheme == "whole germ powers":
                    reps = Lg // germ.depth if germ.depth > 0 else 0
                    if reps == 0:
                        continue
                    base = germ.repeat(reps)
                elif trunc_scheme == "truncated germ powers":
                    reps = 0
                    base = repeat_and_truncate(germ, Lg)
                elif trunc_scheme == "length as exponent":
                    reps = Lg
                    base = germ.repeat(Lg)
                else:
                    raise ValueError("Unknown trunc_scheme %r" % trunc_scheme)
                germ_pairs = set(pairs_for_germ(germ))
                if rndm is not None:
                    given = fid_pairs is not None and \
                        (not isinstance(fid_pairs, dict) or germ in fid_pairs)
                    base_pairs = germ_pairs if given else set()
                    remaining = [pr for pr in all_pairs if pr not in base_pairs]
                    n_choose = max(0, min(n_keep - len(base_pairs), len(remaining)))
                    chosen = rndm.choice(len(remaining), n_choose, replace=False) \
                        if n_choose else []
                    germ_pairs = set(base_pairs) | {remaining[int(k)] for k in chosen}
                fidpairs = collections.OrderedDict()
                for (i, f1), (j, f2) in ((iv, jv) for iv in enumerate(prep_fiducials)
                                         for jv in enumerate(meas_fiducials)):
                    if (f1, f2) not in germ_pairs:
                        continue
                    if dscheck is not None and (f1 + base + f2) not in dscheck:
                        if action_if_missing == "raise":
                            raise ValueError("Circuit %s missing from dataset"
                                             % (f1 + base + f2).str)
                        continue
                    fidpairs[(j, i)] = (f1, f2)
                if reps == 0 and base.depth > 0:    # truncated germ powers
                    plaquettes[(L, germ)] = FiducialPairPlaquette(
                        base, fidpairs, len(meas_fiducials), len(prep_fiducials),
                        op_label_aliases)
                else:
                    plaquettes[(L, germ)] = GermFiducialPairPlaquette(
                        germ, reps, fidpairs, len(meas_fiducials), len(prep_fiducials),
                        op_label_aliases)
        lists.append(PlaquetteGridCircuitStructure(
            dict(plaquettes), [l for l in max_lengths if l <= L], struct_germs,
            "L", "germ", lgst_circuits, op_label_aliases))
    return lists


def create_lsgst_circuit_lists(op_label_src, prep_fiducials, meas_fiducials, germs,
                               max_lengths, fid_pairs=None, trunc_scheme="whole germ powers",
                               nest=True, include_lgst=True, germ_length_limits=None,
                               op_label_aliases=None, dscheck=None,
                               action_if_missing="raise", verbosity=0,
                               keep_fraction=1, keep_seed=None):
    """The GST circuit lists, one per max length (make_lsgst_structs)."""
    return make_lsgst_structs(op_label_src, prep_fiducials, meas_fiducials,
                              germs, max_lengths, fid_pairs, trunc_scheme,
                              nest, include_lgst, germ_length_limits,
                              op_label_aliases, dscheck, action_if_missing,
                              verbosity, keep_fraction, keep_seed)


def create_lsgst_circuits(op_label_src, prep_fiducials, meas_fiducials, germs,
                          max_lengths, fid_pairs=None,
                          trunc_scheme="whole germ powers", keep_fraction=1,
                          keep_seed=None, include_lgst=True):
    """Every circuit of the experiment: the last list, as a plain list."""
    lists = create_lsgst_circuit_lists(
        op_label_src, prep_fiducials, meas_fiducials, germs, max_lengths,
        fid_pairs=fid_pairs, trunc_scheme=trunc_scheme,
        include_lgst=include_lgst, keep_fraction=keep_fraction,
        keep_seed=keep_seed)
    return list(lists[-1])
