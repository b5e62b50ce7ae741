"""Gram-matrix rank analysis of a dataset (counterpart of
pygsti_tpu/algorithms/grammatrix.py; reference: pygsti/algorithms/grammatrix.py).

The Gram matrix G_ij = p(S_i S_j) over a fiducial set {S_i} reveals the
effective dimension of the state/measurement space reachable by the
experiment: rank(G) < d^2 signals informational incompleteness.  The
target's probabilities are simulated on `device`; the rest is host numpy.
"""

from __future__ import annotations

import itertools

import numpy as np

from pygsti_tpu_torch.circuits.circuit import Circuit


def _iter_all_tuples(op_labels, min_len, max_len):
    for L in range(min_len, max_len + 1):
        for combo in itertools.product(op_labels, repeat=L):
            yield combo


def max_gram_basis(op_labels, dataset, max_length=0):
    """A maximal set of circuits {S_i} such that all pair concatenations
    S_i S_j are present in `dataset` (reference: grammatrix.max_gram_basis:21)."""
    ds_strings = list(dataset.keys())
    min_length = min(len(s) for s in ds_strings)
    if max_length <= 0:
        max_length = max(len(s) for s in ds_strings)
    lls = ds_strings[0].line_labels if ds_strings else None

    def have_all_data(strings):
        for a in strings:
            for b in strings:
                if Circuit(tuple(a) + tuple(b), line_labels=lls) not in dataset:
                    return False
        return True

    max_set = []
    for p in _iter_all_tuples(list(op_labels), (min_length + 1) // 2, max_length // 2):
        if have_all_data(max_set + [p]):
            max_set.append(p)
    return max_set


def _gram_rank_and_evals(dataset, prep_strs, effect_strs, target_model, device):
    """(rank, singular values, target singular values) of the data Gram
    matrix over the given fiducials."""
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    ds_keys = list(dataset.keys())
    lls = ds_keys[0].line_labels if ds_keys else None
    povm_lbl = target_model._default_povm_label()
    outcome0 = (target_model.povms[povm_lbl].outcome_labels[0],)
    circuits = [[Circuit(tuple(r) + tuple(e), line_labels=lls) for r in prep_strs]
                for e in effect_strs]

    G = np.zeros((len(effect_strs), len(prep_strs)))
    for i, row_circuits in enumerate(circuits):
        for j, c in enumerate(row_circuits):
            row = dataset[c]
            G[i, j] = row.counts.get(outcome0, 0) / max(row.total, 1)
    svals = np.linalg.svd(G, compute_uv=False)

    probs = SimpleForwardSimulator(target_model, device).bulk_probs(
        [c for row_circuits in circuits for c in row_circuits])
    Gt = np.array([[float(probs[c][outcome0]) for c in row_circuits]
                   for row_circuits in circuits]).reshape(G.shape)
    tsvals = np.linalg.svd(Gt, compute_uv=False)

    tol = max(svals) * 1e-6 if len(svals) else 0
    rank = int(np.sum(svals > tol))
    return rank, svals, tsvals


def max_gram_rank_and_eigenvalues(dataset, target_model, max_basis_string_length=10,
                                  fixed_lists=None, device="cuda"):
    """Rank and singular values of the maximal Gram matrix (reference:
    grammatrix.max_gram_rank_and_eigenvalues:68).  Returns
    (rank, singular_values, target_singular_values)."""
    if fixed_lists is not None:
        prep_strs, effect_strs = fixed_lists
        prep_strs = [tuple(c.layertup) if isinstance(c, Circuit) else tuple(c)
                     for c in prep_strs]
        effect_strs = [tuple(c.layertup) if isinstance(c, Circuit) else tuple(c)
                       for c in effect_strs]
    else:
        basis = max_gram_basis(list(target_model.operations.keys()), dataset,
                               max_basis_string_length)
        prep_strs = effect_strs = basis
    return _gram_rank_and_evals(dataset, prep_strs, effect_strs, target_model, device)
