"""Core GST algorithms: LGST, iterative long-sequence GST and the closest
unitary of an operation (counterpart of pygsti_tpu/algorithms/core.py).

LGST is linear algebra on a d^2 x d^2 matrix of measured frequencies.  In
the JAX package it is numpy on the host, with no JAX in it, and it stays
numpy on the host here: that is the algorithm's home in both packages, not a
path taken for want of a card.  The fits run on ``device``.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from pygsti_tpu_torch.baseobjs.profiler import DummyProfiler
from pygsti_tpu_torch.baseobjs.verbosityprinter import VerbosityPrinter
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.modelmembers import operations as _opm
from pygsti_tpu_torch.modelmembers import povms as _pvm
from pygsti_tpu_torch.modelmembers import states as _stm
from pygsti_tpu_torch.objectivefns.objectivefns import ObjectiveFunctionBuilder
from pygsti_tpu_torch.optimize.simplerlm import SimplerLMOptimizer
from pygsti_tpu_torch.tools.jamiolkowski import jamiolkowski_iso
from pygsti_tpu_torch.tools.optools import unitary_to_superop


def run_lgst(dataset, prep_fiducials, effect_fiducials, target_model,
             op_labels=None, svd_truncate_to=None, verbosity=0):
    """Linear-inversion GST.

    Builds the fiducial data matrix A~[(meas_fid, outcome), prep_fid] of
    measured frequencies, truncates it to rank d^2 by SVD, expresses each
    gate in the SVD frame and rotates into the target model's gauge using
    the target's fiducial maps.  Returns a copy of `target_model` holding
    the estimate, each member in its family of parameterization; the
    target's instruments are carried over unchanged, not estimated (as in
    the JAX package).
    """
    printer = VerbosityPrinter.create_printer(verbosity)
    if op_labels is None:
        op_labels = list(target_model.operations.keys())
    d2 = target_model.dim
    trunc = svd_truncate_to if svd_truncate_to is not None else d2

    povm_lbl = target_model._default_povm_label()
    prep_lbl = target_model._default_prep_label()
    outcome_lbls = target_model.povms[povm_lbl].outcome_labels
    n_out = len(outcome_lbls)
    nP, nM = len(prep_fiducials), len(effect_fiducials)
    if not (nM * n_out >= trunc and nP >= trunc):
        raise ValueError("Fiducials not informationally complete (need >= %d)" % trunc)

    def probs_matrix(mid_circuit):
        """[(meas_fid, outcome) x prep_fid] matrix of dataset frequencies."""
        M = np.empty((nM * n_out, nP))
        for j, f1 in enumerate(prep_fiducials):
            for i, f2 in enumerate(effect_fiducials):
                c = f1 + mid_circuit + f2 if mid_circuit is not None else f1 + f2
                row = dataset[c]
                total = row.total
                for e, ol in enumerate(outcome_lbls):
                    M[i * n_out + e, j] = row.counts.get((ol,), 0) / total
        return M

    AB = probs_matrix(None)
    U, s, Vh = np.linalg.svd(AB, full_matrices=False)
    printer.log("LGST: singular values of AB: %s" % s[:trunc + 2], 2)
    Ud = U[:, :trunc]          # [nME, d2]
    Vd = Vh[:trunc, :].T       # [nP, d2]
    T = Ud.T @ AB @ Vd         # [d2, d2] invertible
    Tinv = np.linalg.inv(T)

    # target-model fiducial maps for gauge-fixing
    tgt_ops = {l: o.dense() for l, o in target_model.operations.items()}
    E_stack = target_model.povms[povm_lbl].dense()  # [n_out, d2]
    A_rows = np.empty((nM * n_out, d2))
    for i, f2 in enumerate(effect_fiducials):
        H = np.eye(d2)
        for l in f2.layertup:
            H = tgt_ops[l] @ H
        for e in range(n_out):
            A_rows[i * n_out + e] = E_stack[e] @ H
    Mt = Ud.T @ A_rows         # [d2, d2] frame map (target gauge)
    Mt_inv = np.linalg.inv(Mt)

    mdl = target_model.copy()
    for g_lbl in op_labels:
        gc = Circuit((g_lbl,), prep_fiducials[0].line_labels if prep_fiducials else None)
        PG = probs_matrix(gc)
        G_frame = (Ud.T @ PG @ Vd) @ Tinv   # = M G M^-1 in frame
        G_est = Mt_inv @ G_frame @ Mt
        mdl.operations[g_lbl] = _relparam_op(mdl.operations[g_lbl], G_est)

    # rho estimate: column of AB at the empty prep fiducial if present
    rho_frame = Ud.T @ AB  # [d2, nP] = M (F_j rho) cols
    j0 = _index_of_empty(prep_fiducials)
    if j0 is not None:
        rho_est = Mt_inv @ rho_frame[:, j0]
        mdl.preps[prep_lbl] = _relparam_prep(mdl.preps[prep_lbl], rho_est)
    i0 = _index_of_empty(effect_fiducials)
    if i0 is not None:
        E_frame = (AB @ Vd @ Tinv)  # rows: E' M^-1
        effects = collections.OrderedDict()
        for e, ol in enumerate(outcome_lbls):
            effects[ol] = E_frame[i0 * n_out + e] @ Mt
        mdl.povms[povm_lbl] = _relparam_povm(mdl.povms[povm_lbl], effects)
    return mdl


def _index_of_empty(fiducials):
    for i, f in enumerate(fiducials):
        if f.depth == 0:
            return i
    return None


def _relparam_op(old_op, mx):
    """Re-wrap a dense estimate in the same parameterization family."""
    if isinstance(old_op, _opm.FullTPOp):
        mx = np.array(mx)
        mx[0, :] = 0
        mx[0, 0] = 1.0
        return _opm.FullTPOp(mx)
    return _opm.FullArbitraryOp(mx)


def _relparam_prep(old_p, vec):
    if isinstance(old_p, _stm.TPState):
        v = np.array(vec)
        udim = int(round(np.sqrt(len(vec))))
        v[0] = 1.0 / np.sqrt(udim)
        return _stm.TPState(v)
    return _stm.FullState(vec)


def _relparam_povm(old_povm, effects):
    if isinstance(old_povm, _pvm.TPPOVM):
        # adjust so effects sum to identity-vec
        dim = len(next(iter(effects.values())))
        udim = int(round(np.sqrt(dim)))
        id_vec = np.zeros(dim)
        id_vec[0] = np.sqrt(udim)
        keys = list(effects.keys())
        total = np.sum([effects[k] for k in keys[:-1]], axis=0)
        effects[keys[-1]] = id_vec - total
        return _pvm.TPPOVM(effects)
    return _pvm.UnconstrainedPOVM(effects)


def run_gst_fit_simple(dataset, start_model, circuits, optimizer,
                       objective_function_builder, verbosity=0, device="cuda"):
    """Convenience: build the objective and optimize `start_model` in place;
    returns (result, objective)."""
    optimizer = SimplerLMOptimizer.cast(optimizer)
    objective = ObjectiveFunctionBuilder.cast(objective_function_builder).build(
        start_model, dataset, circuits, device=device)
    return optimizer.run(objective), objective


def run_gst_fit(mdc_store, optimizer, objective_function_builder):
    """Fit the store's model to its data; returns (result, objective)."""
    optimizer = SimplerLMOptimizer.cast(optimizer)
    builder = ObjectiveFunctionBuilder.cast(objective_function_builder)
    objective = builder.build_from_store(mdc_store)
    return optimizer.run(objective), objective


def iterative_gst_generator(dataset, start_model, circuit_lists, optimizer,
                            iteration_objfn_builders, final_objfn_builders,
                            starting_index=0, verbosity=0, profiler=None,
                            device="cuda"):
    """Yields (opt_results_list, model copy) per circuit list, each stage
    seeded by the previous one's model; the last list also runs the final
    builders.  `optimizer` is one optimizer (or settings dict, or None) for
    every list, or a list of one per circuit list
    (validate_and_extend_optimizer).

    When every list is a prefix of the last one (the standard GST
    structure), all stages share the last list's layout, with counts
    beyond the active prefix masked: one layout, one set of device index
    tensors and depth buckets for the whole fit.  `profiler` (a Profiler)
    accumulates the seconds of each stage's objective build and
    optimization."""
    printer = VerbosityPrinter.create_printer(verbosity)
    profiler = profiler if profiler is not None else DummyProfiler()
    optimizers = [SimplerLMOptimizer.cast(o) for o in
                  validate_and_extend_optimizer(optimizer, len(circuit_lists))]
    iteration_objfn_builders = [ObjectiveFunctionBuilder.cast(b)
                                for b in iteration_objfn_builders]
    final_objfn_builders = [ObjectiveFunctionBuilder.cast(b)
                            for b in final_objfn_builders]
    mdl = start_model.copy()
    lists = [list(cl) for cl in circuit_lists]
    n_iters = len(lists)
    nested = all(lists[i] == lists[-1][:len(lists[i])] for i in range(n_iters - 1))
    shared_layout = SimpleForwardSimulator(mdl, device).create_layout(lists[-1], dataset) \
        if nested else None

    def make_objective(builder, i):
        if nested:
            return builder.build(mdl, dataset, lists[-1], device=device,
                                 layout=shared_layout, num_active_circuits=len(lists[i]))
        return builder.build(mdl, dataset, lists[i], device=device)

    for i in range(starting_index, n_iters):
        printer.log("--- Iterative GST: Iter %d of %d  (%d circuits) ---"
                    % (i + 1, n_iters, len(lists[i])))
        builders = list(iteration_objfn_builders)
        if i == n_iters - 1:
            builders += final_objfn_builders
        opt_results = []
        for b in builders:
            t0 = time.time()
            with profiler.timing('iteration %d: %s objective build' % (i, b.name)):
                objective = make_objective(b, i)
            with profiler.timing('iteration %d: %s optimize' % (i, b.name)):
                result = optimizers[i].run(objective)
            opt_results.append(result)
            profiler.add_count('LM stages')
            printer.log("    %s stage: %.1fs (f=%.1f)" % (b.name, time.time() - t0, result.f))
        yield opt_results, mdl.copy()


def run_iterative_gst(dataset, start_model, circuit_lists, optimizer,
                      iteration_objfn_builders, final_objfn_builders,
                      verbosity=0, device="cuda"):
    """Run all iterations; returns (models, opt_results) per iteration."""
    models, results = [], []
    for opt_results, mdl in iterative_gst_generator(
            dataset, start_model, circuit_lists, optimizer,
            iteration_objfn_builders, final_objfn_builders, verbosity=verbosity,
            device=device):
        models.append(mdl)
        results.append(opt_results)
    return models, results


def gram_rank_and_eigenvalues(dataset, prep_fiducials, effect_fiducials,
                              target_model, device="cuda"):
    """(rank, singular values, the target's singular values) of the Gram
    matrix G_ij = p(prep_j + effect_i, first outcome) of the dataset's
    frequencies over the given fiducials; rank below d^2 signals fiducials
    that are not informationally complete.  The target's probabilities are
    simulated on `device`."""
    circuits = [r + e for e in effect_fiducials for r in prep_fiducials]
    povm = target_model.povms[target_model._default_povm_label()]
    outcome0 = (povm.outcome_labels[0],)
    shape = (len(effect_fiducials), len(prep_fiducials))
    G = np.array([dataset[c].counts.get(outcome0, 0) / max(dataset[c].total, 1)
                  for c in circuits]).reshape(shape)
    svals = np.linalg.svd(G, compute_uv=False)
    probs = SimpleForwardSimulator(target_model, device).bulk_probs(circuits)
    Gt = np.array([probs[c][outcome0] for c in circuits]).reshape(shape)
    tsvals = np.linalg.svd(Gt, compute_uv=False)
    tol = max(svals) * 1e-6 if len(svals) else 0
    return int(np.sum(svals > tol)), svals, tsvals


def find_closest_unitary_opmx(operation_mx, op_basis='pp'):
    """The unitary superoperator closest to `operation_mx` in process
    fidelity: the dominant eigenvector of its Choi matrix read as an
    operator, projected onto the unitaries by its polar decomposition."""
    J = np.asarray(jamiolkowski_iso(np.asarray(operation_mx), op_basis, 'std'))
    evals, evecs = np.linalg.eigh((J + J.conj().T) / 2)
    kraus = evecs[:, -1]
    d = int(round(np.sqrt(len(kraus))))
    u_svd, _, vh = np.linalg.svd(kraus.reshape(d, d) * np.sqrt(d))
    return np.real_if_close(unitary_to_superop(u_svd @ vh, op_basis))


def validate_and_extend_optimizer(optimizer, size):
    """The `optimizer` argument of iterative GST as a list of `size`: one
    optimizer (or settings dict, or None for the default) repeated, or a
    list of length 1 (repeated) or `size`."""
    if optimizer is None:
        optimizer = SimplerLMOptimizer.cast(None)
    if isinstance(optimizer, list) and len(optimizer) == 1:
        optimizer = optimizer * size
    if isinstance(optimizer, (SimplerLMOptimizer, dict)):
        return [optimizer] * size
    if not isinstance(optimizer, list):
        raise ValueError("Invalid argument for optimizers of type %s; supported types are "
                         "list, Optimizer, or dict." % type(optimizer))
    if len(optimizer) not in (1, size):
        raise ValueError("Optimizers must be length 1 or length %d" % size)
    return optimizer
