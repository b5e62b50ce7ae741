"""Fiducial pair reduction (counterpart of
pygsti_tpu/algorithms/fiducialpairreduction.py; reference:
pygsti/algorithms/fiducialpairreduction.py:59,302,511).

For each germ, only a subset of (prep_fiducial, meas_fiducial) pairs is
needed to detect the germ's amplified parameters.  Per germ the sensitivity
matrix M[(i,j,e), k] = d p_{ije} / d (amplified direction k) -- the
derivative of the fiducial-pair probability through the germ's twirled
derivative -- is one einsum over [n_prep, n_meas, n_out, n_amp] on
`device`, for every germ's twirled derivative computed in one batch; the
greedy search then scores every remaining pair of a step with one stacked
svd and keeps the JAX package's tie rule (the first pair in order wins a
tie).  Those stacks of small matrices go to the host's LAPACK, each large
step split over worker processes (`_SvdWorkers`): a card's solver takes
them one matrix at a time, at about 6.6 ms each on an H100 (PERF.md
section 6).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import torch

from pygsti_tpu_torch.algorithms.germselection import (_nongauge_projector,
                                                       _projected_twirls, svd, svdvals)
from pygsti_tpu_torch.algorithms.fiducialselection import _FiducialRows
from pygsti_tpu_torch.baseobjs.verbosityprinter import VerbosityPrinter
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.tools.argchecks import check_unsupported as _check_unsupported


def _sensitivities(model, germs, prep_fiducials, meas_fiducials, proj, eps=1e-6,
                   device="cuda"):
    """Per germ: (rows [n_pairs*n_outcomes, n_amp] on the device, pair
    index, n_amp, amplified directions [n_amp, P] complex on the device)."""
    d = model.dim
    Tri = _projected_twirls(model, list(germs), proj, eps, device)
    T = torch.complex(Tri[:, :d * d], Tri[:, d * d:])                  # [C, d*d, P]
    _, s, Vh = svd(T)
    prep_rows = _FiducialRows(model, 'prep', device)
    meas_rows = _FiducialRows(model, 'meas', device)
    ip = model.prep_keys.index(model._default_prep_label())
    povm = model._default_povm_label()
    e0 = sum(model.povms[l].num_outcomes for l in model.povm_keys[:model.povm_keys.index(povm)])
    n_out = model.povms[povm].num_outcomes
    n_preps = len(model.prep_keys)
    rho = prep_rows.matrix(list(prep_fiducials)).reshape(len(prep_fiducials), n_preps, d)[:, ip]
    E = meas_rows.matrix(list(meas_fiducials)).reshape(len(meas_fiducials), -1, d)[
        :, e0:e0 + n_out]
    pair_index = [(i, j) for i in range(len(prep_fiducials))
                  for j in range(len(meas_fiducials)) for _ in range(n_out)]
    out = []
    for c in range(len(germs)):
        keep = s[c] > 1e-8 * max(float(s[c, 0]), 1e-30)
        directions = Vh[c][keep]                                          # [n_amp, P]
        D = (T[c] @ directions.conj().T).T.reshape(-1, d, d)             # [n_amp, d, d]
        rows = torch.einsum('jea,kab,ib->ijek', E.to(D.dtype), D, rho.to(D.dtype)).real
        out.append((rows.reshape(-1, D.shape[0]), pair_index, D.shape[0], directions))
    return out


def _germ_pair_sensitivities(model, germ, prep_fiducials, meas_fiducials,
                             non_gauge_projector=None, eps=1e-6, device="cuda"):
    """[n_pairs*n_outcomes, n_amp] sensitivity matrix (numpy), the pair of
    each row, the number of amplified directions and the directions."""
    proj = non_gauge_projector if non_gauge_projector is not None \
        else _nongauge_projector(model, device=device)
    rows, pair_index, n_amp, dirs = _sensitivities(model, [germ], prep_fiducials,
                                                   meas_fiducials, proj, eps, device)[0]
    return rows.cpu().numpy(), pair_index, n_amp, dirs.cpu().numpy()


def _pair_rows(pair_index):
    """{pair: [row indices]} in the order the pairs first appear."""
    out = {}
    for r, pi in enumerate(pair_index):
        out.setdefault(pi, []).append(r)
    return out


def _greedy_rank_pairs(M, pair_index, n_amp, stack_svdvals=None):
    """Add the pair whose rows most raise the rank, then the least singular
    value, until the rows reach rank n_amp: every remaining pair of a step
    in one stacked svd (`stack_svdvals(M, index)`, by default numpy's in
    this process), the first pair winning a tie.  Host numpy: M is an
    array, and each matrix is decomposed by numpy's LAPACK, as the JAX
    package decomposes it."""
    if stack_svdvals is None:
        def stack_svdvals(M, index):
            return np.linalg.svd(M[index], compute_uv=False)
    pair_rows = _pair_rows(pair_index)
    remaining = list(pair_rows.keys())
    chosen_pairs, chosen = [], []
    cur_rank = 0
    while cur_rank < n_amp and remaining:
        sv = stack_svdvals(M, np.array([chosen + pair_rows[pi] for pi in remaining]))
        best = None
        for pi, s in zip(remaining, sv):
            rank = int(np.sum(s > 1e-8 * max(s[0], 1e-30)))
            smin = s[min(rank, n_amp) - 1] if rank > 0 else 0.0
            if best is None or (rank, smin) > (best[1], best[2]):
                best = (pi, rank, smin)
        chosen_pairs.append(best[0])
        chosen.extend(pair_rows[best[0]])
        remaining.remove(best[0])
        cur_rank = best[1]
    return chosen_pairs, cur_rank


# Seconds to start the worker processes and have each answer once: 0.88 s
# for 8 workers on an H100 machine's host (chip_smoke.py phase 23 logs it).
# The searches go to the workers when their predicted time in this process
# passes this: 330 s for phase 23's 22 germs at 2 qubits, far less at 1
# qubit, whose searches stay in this process.
WORKER_START_S = 1.0


def _search_work(n_pairs, n_out, n_amp, steps):
    """SVD work of a search's first `steps` steps: step k decomposes
    n_pairs - k matrices of (k + 1) n_out rows by n_amp, each at
    min(m, n)^2 max(m, n)."""
    m = n_out * np.arange(1, steps + 1, dtype=float)
    return float(np.sum((n_pairs - np.arange(steps)) * np.minimum(m, n_amp) ** 2
                        * np.maximum(m, n_amp)))


class _SvdWorkers:
    """`stack_svdvals` for _greedy_rank_pairs: each stack split over `n`
    worker processes (`_svdworker.py`, numpy on one BLAS thread, so the
    cores are not oversubscribed), each matrix decomposed by the same numpy
    call as in this process.  A context manager: leaving it stops them."""

    def __init__(self, n):
        env = dict(os.environ, OMP_NUM_THREADS='1', OPENBLAS_NUM_THREADS='1',
                   MKL_NUM_THREADS='1')
        worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), '_svdworker.py')
        self.procs = [subprocess.Popen([sys.executable, worker], stdin=subprocess.PIPE,
                                       stdout=subprocess.PIPE, env=env) for _ in range(n)]
        self.matrix = None

    def __call__(self, M, index):
        if M is not self.matrix:
            for p in self.procs:
                pickle.dump(('matrix', M), p.stdin, protocol=pickle.HIGHEST_PROTOCOL)
            self.matrix = M
        parts = [part for part in np.array_split(index, len(self.procs)) if len(part)]
        for p, part in zip(self.procs, parts):
            pickle.dump(part, p.stdin, protocol=pickle.HIGHEST_PROTOCOL)
            p.stdin.flush()
        return np.concatenate([pickle.load(p.stdout) for p in self.procs[:len(parts)]])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        """EOF ends each worker; one that does not end is killed."""
        for p in self.procs:
            try:
                p.stdin.close()
            except BrokenPipeError:                  # the worker has ended
                pass
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            p.stdout.close()


def _greedy_rank_pairs_many(jobs, stats=None):
    """_greedy_rank_pairs over [(M, pair_index, n_amp)], numpy arrays M, on
    the host's CPU.  The first step of the largest search, timed in this
    process, prices the searches' SVD work (`_search_work` over the steps
    each needs at least); when that passes WORKER_START_S and the host has
    more than one core, every step is split over one worker process per
    core (`_SvdWorkers`).  `stats`, a dict, receives the predicted seconds,
    the number of workers (0: all in this process) and their start-up
    seconds."""
    stats = {} if stats is None else stats
    stats.update(predicted_s=0.0, workers=0, worker_start_s=0.0)
    if not jobs:
        return []
    shapes = [(len(_pair_rows(pi)), M.shape[0] // len(_pair_rows(pi)), n_amp)
              for M, pi, n_amp in jobs]
    work = [_search_work(P, n_out, n_amp, -(-n_amp // n_out)) for P, n_out, n_amp in shapes]
    big = int(np.argmax(work))
    M, pi, _ = jobs[big]
    t0 = time.time()
    np.linalg.svd(M[np.array(list(_pair_rows(pi).values()))], compute_uv=False)
    stats['predicted_s'] = (time.time() - t0) * sum(work) / _search_work(*shapes[big], 1)
    n = os.cpu_count() or 1
    if n < 2 or stats['predicted_s'] < WORKER_START_S:
        return [_greedy_rank_pairs(*job) for job in jobs]
    t0 = time.time()
    with _SvdWorkers(n) as svdvals:
        svdvals(M, np.zeros((n, 1), dtype=np.intp))
        stats.update(workers=n, worker_start_s=time.time() - t0)
        return [_greedy_rank_pairs(M, pair_index, n_amp, svdvals)
                for M, pair_index, n_amp in jobs]


def _randomized_for_fpr(target_model, seed):
    return target_model.rotate(max_rotate=1e-2, seed=seed) \
        if target_model.num_qubits == 1 else \
        target_model.depolarize(max_op_noise=1e-2, seed=seed)


def find_sufficient_fiducial_pairs_per_germ(target_model, prep_fiducials,
                                            meas_fiducials, germs,
                                            prepovm_tuples="first", search_mode="greedy",
                                            constrain_to_tp=True, n_random=100,
                                            min_iterations=None, base_loweig_tol=1e-1,
                                            seed=None, verbosity=0, num_soln_returned=1,
                                            type_soln_returned='best', retry_for_smaller=True,
                                            mem_limit=None, device="cuda", stats=None):
    """Per-germ fiducial pair reduction (reference:
    fiducialpairreduction.find_sufficient_fiducial_pairs_per_germ:302).
    Returns {germ: [(iPrep, iMeas), ...]}.

    The greedy rank-building search is the only implemented mode;
    multi-solution returns and non-default prepovm tuples raise.  `device`
    holds the projector and the sensitivities; the searches' stacked SVDs
    run on the host's CPU (`_greedy_rank_pairs_many`, whose numbers `stats`,
    a dict, receives)."""
    _check_unsupported('find_sufficient_fiducial_pairs_per_germ',
                       prepovm_tuples=(prepovm_tuples, 'first'),
                       search_mode=(search_mode, 'greedy'),
                       constrain_to_tp=(constrain_to_tp, True),
                       min_iterations=(min_iterations, None),
                       num_soln_returned=(num_soln_returned, 1),
                       type_soln_returned=(type_soln_returned, 'best'))
    printer = VerbosityPrinter.create_printer(verbosity)
    model = _randomized_for_fpr(target_model, seed)
    proj = _nongauge_projector(model, device=device)
    sens = _sensitivities(model, germs, prep_fiducials, meas_fiducials, proj, device=device)
    jobs = [(M.cpu().numpy(), pair_index, n_amp) for M, pair_index, n_amp, _ in sens
            if n_amp > 0]
    found = iter(_greedy_rank_pairs_many(jobs, stats))
    out = {}
    for germ, (_, _, n_amp, _) in zip(germs, sens):
        if n_amp == 0:
            out[germ] = [(0, 0)]
            continue
        chosen_pairs, cur_rank = next(found)
        out[germ] = chosen_pairs
        printer.log("  germ %s: %d/%d pairs (rank %d/%d)"
                    % (germ.str, len(chosen_pairs),
                       len(prep_fiducials) * len(meas_fiducials), cur_rank, n_amp), 2)
    return out


def find_sufficient_fiducial_pairs_per_germ_greedy(
        target_model, prep_fiducials, meas_fiducials, germs,
        prepovm_tuples="first", inv_trace_tol=10.0, initial_seed_mode='greedy',
        evd_tol=1e-10, sensitivity_threshold=1e-10, check_complete_fid_set=True,
        seed=None, verbosity=0, mem_limit=None, device="cuda"):
    """Score-based greedy per-germ FPR (reference:
    fiducialpairreduction.find_sufficient_fiducial_pairs_per_germ_greedy:511):
    keep adding the pair that least raises the sum of inverse eigenvalues of
    the pair-sensitivity Gram until it is within `inv_trace_tol` times that
    of the full pair set."""
    _check_unsupported('find_sufficient_fiducial_pairs_per_germ_greedy',
                       prepovm_tuples=(prepovm_tuples, 'first'),
                       initial_seed_mode=(initial_seed_mode, 'greedy'),
                       evd_tol=(evd_tol, 1e-10),
                       sensitivity_threshold=(sensitivity_threshold, 1e-10),
                       check_complete_fid_set=(check_complete_fid_set, True))
    printer = VerbosityPrinter.create_printer(verbosity)
    model = _randomized_for_fpr(target_model, seed)
    proj = _nongauge_projector(model, device=device)
    out = {}
    for germ, (M, pair_index, n_amp, _dirs) in zip(germs, _sensitivities(
            model, germs, prep_fiducials, meas_fiducials, proj, device=device)):
        if n_amp == 0:
            out[germ] = [(0, 0)]
            continue

        def inv_traces(idx_lists):
            sv = np.linalg.svd(M[torch.as_tensor(idx_lists, device=M.device)].cpu().numpy(),
                               compute_uv=False)
            out_ = []
            for s in sv:
                ev = np.zeros(n_amp)
                ev[:min(len(s), n_amp)] = (s ** 2)[:n_amp]
                out_.append(float(np.sum(1.0 / np.clip(ev, 1e-30, None))))
            return out_

        pair_rows = _pair_rows(pair_index)
        target_score = inv_traces([[r for rows in pair_rows.values() for r in rows]])[0] \
            * inv_trace_tol
        chosen_pairs, chosen = [], []
        remaining = list(pair_rows.keys())
        last = np.inf
        while remaining:
            best = None
            for pi, s in zip(remaining, inv_traces([chosen + pair_rows[pi]
                                                     for pi in remaining])):
                if best is None or s < best[1]:
                    best = (pi, s)
            chosen_pairs.append(best[0])
            chosen.extend(pair_rows[best[0]])
            remaining.remove(best[0])
            last = best[1]
            if best[1] <= target_score:
                break
        out[germ] = chosen_pairs
        printer.log("  germ %s: %d/%d pairs (inv-trace %.3g <= %.3g)"
                    % (germ.str, len(chosen_pairs), len(pair_rows), last, target_score), 2)
    return out


def find_sufficient_fiducial_pairs_per_germ_power(
        target_model, prep_fiducials, meas_fiducials, germs, max_lengths,
        prepovm_tuples="first", search_mode="greedy", constrain_to_tp=True,
        trunc_scheme="whole germ powers", n_random=100, min_iterations=None,
        base_loweig_tol=1e-1, seed=None, verbosity=0, mem_limit=None, device="cuda"):
    """Per-(germ, L) fiducial pair reduction (reference:
    fiducialpairreduction.find_sufficient_fiducial_pairs_per_germ_power:668):
    sensitivities of the germ RAISED TO ITS POWER at each max length L.
    Returns {(germ, L): [(iPrep, iMeas), ...]}."""
    _check_unsupported('find_sufficient_fiducial_pairs_per_germ_power',
                       prepovm_tuples=(prepovm_tuples, 'first'),
                       search_mode=(search_mode, 'greedy'),
                       constrain_to_tp=(constrain_to_tp, True),
                       min_iterations=(min_iterations, None))
    printer = VerbosityPrinter.create_printer(verbosity)
    model = _randomized_for_fpr(target_model, seed)
    proj = _nongauge_projector(model, device=device)
    keys, powers = [], []
    for germ in germs:
        glen = max(len(germ.layertup), 1)
        for L in max_lengths:
            power = max(L // glen, 1) if trunc_scheme == "whole germ powers" else max(L, 1)
            keys.append((germ, L))
            powers.append(Circuit(germ.layertup * power, germ.line_labels))
    sens = _sensitivities(model, powers, prep_fiducials, meas_fiducials, proj, device=device)
    found = iter(_greedy_rank_pairs_many([(M.cpu().numpy(), pair_index, n_amp)
                                          for M, pair_index, n_amp, _ in sens if n_amp > 0]))
    out = {}
    for key, (_, pair_index, n_amp, _) in zip(keys, sens):
        if n_amp == 0:
            out[key] = [(0, 0)]
            continue
        out[key], _ = next(found)
        printer.log("  germ %s L=%d: %d/%d pairs"
                    % (key[0].str, key[1], len(out[key]), len(_pair_rows(pair_index))), 2)
    return out


def find_sufficient_fiducial_pairs(target_model, prep_fiducials, meas_fiducials,
                                   germs, test_lengths=(256, 2048), prepovm_tuples="first",
                                   tol=0.75, search_mode="sequential", n_random=100,
                                   seed=None, verbosity=0, test_pair_list=None,
                                   mem_limit=None, minimum_pairs=1, device="cuda"):
    """Global (same pairs for all germs) reduction: the union of the
    per-germ needs (reference: fiducialpairreduction.find_sufficient_fiducial_pairs:59).
    Sufficiency is the per-germ rank criterion, so non-default
    `test_lengths`/`tol` raise, as does `test_pair_list`."""
    _check_unsupported('find_sufficient_fiducial_pairs',
                       test_lengths=(tuple(test_lengths), ((256, 2048),)),
                       prepovm_tuples=(prepovm_tuples, 'first'),
                       tol=(tol, 0.75),
                       test_pair_list=(test_pair_list, None),
                       minimum_pairs=(minimum_pairs, 1))
    per_germ = find_sufficient_fiducial_pairs_per_germ(
        target_model, prep_fiducials, meas_fiducials, germs, seed=seed,
        verbosity=verbosity, device=device)
    union = set()
    for pairs in per_germ.values():
        union.update(pairs)
    return sorted(union)


def _rank(mx, rel=1e-8):
    s = svdvals(mx[None])[0].cpu().numpy()
    return int(np.sum(s > rel * max(s[0] if len(s) else 0.0, 1e-30)))


def test_fiducial_pairs(fid_pairs, target_model, prep_fiducials, meas_fiducials, germs,
                        test_lengths=(256, 2048), prep_povm_tuples="first", tol=0.75,
                        verbosity=0, mem_limit=None, device="cuda"):
    """How many (non-gauge) model parameters the given fiducial pairs
    amplify (reference: fiducialpairreduction.test_fiducial_pairs:870):
    the rank of the pair-restricted sensitivity rows of all germs, mapped
    back to parameter space.  `fid_pairs` is a global list of (iPrep, iMeas)
    or a per-germ dict of such lists; non-default `test_lengths`/`tol` raise."""
    _check_unsupported('test_fiducial_pairs',
                       test_lengths=(tuple(test_lengths), ((256, 2048),)),
                       prep_povm_tuples=(prep_povm_tuples, 'first'),
                       tol=(tol, 0.75))
    proj = _nongauge_projector(target_model, device=device)
    total_rows = []
    for germ, (rows, pair_index, n_amp, directions) in zip(germs, _sensitivities(
            target_model, germs, prep_fiducials, meas_fiducials, proj, device=device)):
        pairs = fid_pairs[germ] if isinstance(fid_pairs, dict) else fid_pairs
        pair_set = set(tuple(p) for p in pairs)
        sel = [k for k, pi in enumerate(pair_index) if pi in pair_set]
        if not sel:
            continue
        total_rows.append(rows[sel].to(directions.dtype) @ directions)
    if not total_rows:
        return 0
    return _rank(torch.cat(total_rows))


def find_sufficient_fiducial_pairs_per_germ_global(
        target_model, prep_fiducials, meas_fiducials, germs=None,
        initial_seed_mode='greedy', evd_tol=1e-10, sensitivity_threshold=1e-10,
        seed=None, verbosity=0, num_soln_returned=1, type_soln_returned='best',
        retry_for_smaller=True, mem_limit=None, germ_vector_spanning_set=None,
        precomputed_jacobians=None, device="cuda"):
    """Per-germ fiducial-pair reduction scored against the GLOBAL germ-set
    amplified directions (reference:
    fiducialpairreduction.find_sufficient_fiducial_pairs_per_germ_global:668):
    each addition is judged by the rank of the union of all selected rows
    across germs, so later germs cover only what earlier ones left.  Every
    candidate pair of a step is ranked in one batched svdvals."""
    _check_unsupported('find_sufficient_fiducial_pairs_per_germ_global',
                       initial_seed_mode=(initial_seed_mode, 'greedy'),
                       evd_tol=(evd_tol, 1e-10),
                       sensitivity_threshold=(sensitivity_threshold, 1e-10),
                       num_soln_returned=(num_soln_returned, 1),
                       type_soln_returned=(type_soln_returned, 'best'),
                       germ_vector_spanning_set=(germ_vector_spanning_set, None),
                       precomputed_jacobians=(precomputed_jacobians, None))
    printer = VerbosityPrinter.create_printer(verbosity)
    proj = _nongauge_projector(target_model, device=device)
    germ_data = {}
    all_rows = []
    for germ, (rows, pair_index, n_amp, directions) in zip(germs, _sensitivities(
            target_model, germs, prep_fiducials, meas_fiducials, proj, device=device)):
        rows_full = rows.to(directions.dtype) @ directions           # [n_rows, P]
        germ_data[germ] = (rows_full, pair_index)
        all_rows.append(rows_full)
    global_rank = _rank(torch.cat(all_rows))

    out = {}
    selected_rows = []
    current_rank = 0
    for germ in germs:
        rows_full, pair_index = germ_data[germ]
        pairs_order = list(dict.fromkeys(pair_index))
        chosen = []
        germ_target = _rank(torch.cat(selected_rows + [rows_full]))
        while current_rank < germ_target and len(chosen) < len(pairs_order):
            cands = [c for c in pairs_order if c not in chosen]
            trials = torch.stack([
                torch.cat(selected_rows + [rows_full[[k for k, pi in enumerate(pair_index)
                                                      if pi in chosen or pi == cand]]])
                for cand in cands])
            ranks = (np.linalg.svd(trials.cpu().numpy(), compute_uv=False)
                     > sensitivity_threshold).sum(axis=1)
            best = None
            for cand, rank in zip(cands, ranks):
                if best is None or int(rank) > best[1]:
                    best = (cand, int(rank))
            if best is None or best[1] <= current_rank and chosen:
                if best[1] <= current_rank:
                    break
            chosen.append(best[0])
            current_rank = best[1]
        sel = [k for k, pi in enumerate(pair_index) if pi in chosen]
        selected_rows.append(rows_full[sel])
        out[germ] = chosen
        printer.log("  germ %s: %d pairs (union rank %d/%d)"
                    % (germ.str, len(chosen), current_rank, global_rank), 2)
    return out


get_per_germ_fid_pairs_global = find_sufficient_fiducial_pairs_per_germ_global


def filter_useless_fid_pairs(fid_pairs, target_model, prep_fiducials, meas_fiducials, germ,
                             sensitivity_threshold=1e-10, device="cuda"):
    """Drop pairs whose sensitivity rows are (numerically) zero for `germ`
    (reference: fiducialpairreduction.filter_useless_fid_pairs)."""
    rows, pair_index, _, _dirs = _germ_pair_sensitivities(
        target_model, germ, prep_fiducials, meas_fiducials, device=device)
    useful = set()
    for k, pi in enumerate(pair_index):
        if np.linalg.norm(rows[k]) > sensitivity_threshold:
            useful.add(pi)
    return [p for p in fid_pairs if tuple(p) in useful]


def compute_jacobian_dicts(target_model, germs, prep_fiducials, meas_fiducials, comm=None,
                           mem_limit=None, verbosity=0, device="cuda"):
    """Per-germ sensitivity Jacobians keyed by germ: {'jacobian', 'pair_index',
    'num_amplified'} (reference: fiducialpairreduction.compute_jacobian_dicts).
    The JAX package's version unpacks three of the four values its
    sensitivity function returns and raises ValueError (ROADMAP.md section 3)."""
    out = {}
    proj = _nongauge_projector(target_model, device=device)
    for germ, (rows, pair_index, n_amp, _dirs) in zip(germs, _sensitivities(
            target_model, germs, prep_fiducials, meas_fiducials, proj, device=device)):
        out[germ] = {'jacobian': rows.cpu().numpy(), 'pair_index': pair_index,
                     'num_amplified': n_amp}
    return out


def construct_compact_evd_cache(fiducial_indices, complete_jacobian, element_map,
                                eigenvalue_tolerance=1e-10):
    """{fid_index: U sqrt(e)} compact halves of each fiducial pair's
    Jacobian Gramian, element_map giving each pair's rows of the complete
    Jacobian (reference: fiducialpairreduction.construct_compact_evd_cache:1519)."""
    from pygsti_tpu_torch.algorithms.germselection import compact_EVD
    sqrteU = {}
    for fid_index in fiducial_indices:
        rows = np.take(complete_jacobian, element_map[fid_index], axis=0)
        e, U = compact_EVD(rows.T @ rows, eigenvalue_tolerance, assume_hermitian=True)
        sqrteU[fid_index] = U @ np.diag(np.sqrt(np.abs(e)))
    return sqrteU
