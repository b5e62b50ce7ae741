"""Fiducial selection: informationally complete prep/meas fiducial sets
(counterpart of pygsti_tpu/algorithms/fiducialselection.py; reference:
pygsti/algorithms/fiducialselection.py:29).

Prep fiducials F_j must make {F_j |rho>>} span superket space; measurement
fiducials H_i must make {<<E_e| H_i} span superbra space.  Scoring uses the
eigenvalues of the Gram matrix R^T R ('all' = sum of inverse eigenvalues,
'worst' = 1/min eigenvalue); selection is greedy from short candidate words.

Every candidate's rows are computed once, on a card for all candidates of
one length at once (the ops applied one after another, as the JAX package
applies them; on the CPU by numpy's products one fiducial at a time, bit
for bit the JAX package's); a step of the search scores every candidate set
with one batched Gram and one batched ``eigvalsh``.  The searches keep the JAX
package's candidate order, strict comparisons and random draws.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from pygsti_tpu_torch.algorithms.germselection import (_OpStack, _by_length, eigvalsh, gram,
                                                       qubit_labels_of, GRAM_STACK_BYTES)
from pygsti_tpu_torch.baseobjs.verbosityprinter import VerbosityPrinter
from pygsti_tpu_torch.circuits.circuit import Circuit


def _dense_spam(model, device):
    """(prep vectors [n_preps, d], effect rows [n_effects, d]) on `device`."""
    dev = torch.device(device)
    preps = torch.as_tensor(np.stack([model.preps[l].dense() for l in model.prep_keys]),
                            dtype=torch.float64, device=dev)
    effects = torch.as_tensor(np.concatenate([model.povms[l].dense()
                                              for l in model.povm_keys]),
                              dtype=torch.float64, device=dev)
    return preps, effects


class _FiducialRows(object):
    """Per fiducial, its block of prep rows F|rho> (one per prep) or of
    measurement rows <E|H (one per effect), batched on the device."""

    def __init__(self, model, prep_or_meas, device="cuda"):
        if prep_or_meas not in ('prep', 'meas'):
            raise ValueError("prep_or_meas must be 'prep' or 'meas'")
        self.model, self.kind = model, prep_or_meas
        self.stack = _OpStack(model, device)
        self.preps, self.effects = _dense_spam(model, device)
        self._rows = {}

    def ensure(self, fiducials):
        new = [f for f in dict.fromkeys(fiducials) if f not in self._rows]
        if not new:
            return
        d, dev = self.model.dim, self.stack.device
        if dev.type == 'cpu':
            # the host path: numpy's products, one fiducial at a time, in
            # the JAX package's order, so that its rows come out bit for bit
            ops = {l: m.dense() for l, m in self.model.operations.items()}
            for f in new:
                if self.kind == 'prep':
                    rows = []
                    for plbl in self.model.prep_keys:
                        rho = self.model.preps[plbl].dense()
                        for l in f.layertup:
                            rho = ops[l] @ rho
                        rows.append(rho)
                else:
                    H = np.eye(d)
                    for l in f.layertup:
                        H = ops[l] @ H
                    rows = [evec @ H for mlbl in self.model.povm_keys
                            for evec in self.model.povms[mlbl].dense()]
                self._rows[f] = torch.from_numpy(np.stack(rows))
            return
        for poss, idx in _by_length(self.stack, new):
            C, n = idx.shape
            if self.kind == 'prep':
                v = self.preps.T.expand(C, d, self.preps.shape[0])
                for j in range(n):
                    v = self.stack.G[idx[:, j]] @ v
                rows = v.transpose(1, 2)                                 # [C, n_preps, d]
            else:
                H = torch.eye(d, dtype=torch.float64, device=dev).expand(C, d, d)
                for j in range(n):
                    H = self.stack.G[idx[:, j]] @ H
                rows = self.effects @ H                                 # [C, n_eff, d]
            for i, p in enumerate(poss):
                self._rows[new[p]] = rows[i]

    def matrix(self, fiducials):
        """[rows, d] of a fiducial list, fiducial by fiducial."""
        self.ensure(fiducials)
        return torch.cat([self._rows[f] for f in fiducials])

    def top_evals(self, fid_lists):
        """[n_lists, d] descending eigenvalues of each list's R^T R (numpy)."""
        lists = [list(fl) for fl in fid_lists]
        self.ensure([f for fl in lists for f in fl])
        d = self.model.dim
        out = np.zeros((len(lists), d))
        by_len = {}
        for i, fl in enumerate(lists):
            by_len.setdefault(len(fl), []).append(i)
        for k, members in by_len.items():
            if k == 0:
                continue
            width = k * next(iter(self._rows.values())).shape[0]
            cap = max(1, GRAM_STACK_BYTES // (width * d * 8 * 2))
            for a in range(0, len(members), cap):
                part = members[a:a + cap]
                R = torch.stack([self.matrix(lists[i]) for i in part])
                out[part] = eigvalsh(gram(R)).cpu().numpy()[:, ::-1]
        return out

    def score_many(self, fid_lists, score_func='all'):
        """[(score, n_spanned, eigenvalues)] of each list."""
        out = []
        d2 = self.model.dim
        for ev in self.top_evals(fid_lists):
            n_spanned = int(np.sum(ev > 1e-10 * max(ev[0], 1e-30)))
            safe = np.clip(ev[:d2], 1e-30, None)
            score = float(np.sum(1.0 / safe)) if score_func == 'all' \
                else float(1.0 / safe[-1])
            out.append((score, n_spanned, ev))
        return out


def _prep_vectors(model, fiducials, device="cuda"):
    """[n_fid * n_preps, d] of F|rho> vectors (numpy)."""
    return _FiducialRows(model, 'prep', device).matrix(list(fiducials)).cpu().numpy()


def _meas_vectors(model, fiducials, device="cuda"):
    """[n_fid * n_effects, d] of <E|H vectors (numpy)."""
    return _FiducialRows(model, 'meas', device).matrix(list(fiducials)).cpu().numpy()


def compute_composite_fiducial_score(model, fiducials, prep_or_meas, score_func='all',
                                     device="cuda"):
    """(score, n_spanned, eigenvalues) for a fiducial set."""
    return _FiducialRows(model, prep_or_meas, device).score_many([list(fiducials)],
                                                                 score_func)[0]


def test_fiducial_list(model, fiducials, prep_or_meas, score_func='all',
                       return_all=False, threshold=1e6, device="cuda"):
    """True if the fiducial set is informationally complete."""
    score, n_spanned, evals = compute_composite_fiducial_score(
        model, fiducials, prep_or_meas, score_func, device)
    ok = (n_spanned >= model.dim) and score < threshold
    if return_all:
        return ok, score, evals
    return ok


def find_fiducials(target_model, omit_identity=True, eq_thresh=1e-6,
                   ops_to_omit=None, force_empty=True, candidate_fid_counts=4,
                   algorithm='greedy', algorithm_kwargs=None, verbosity=1,
                   prep_fids=True, meas_fids=True, assume_clifford=False,
                   candidate_list=None, device="cuda"):
    """Find prep and measurement fiducial sets (reference:
    fiducialselection.find_fiducials:29).  Returns (prep_fiducials,
    meas_fiducials) (either None if disabled)."""
    from pygsti_tpu_torch.baseobjs.label import Label
    printer = VerbosityPrinter.create_printer(verbosity)
    model = target_model
    op_labels = [l for l in model.operations.keys()
                 if not (ops_to_omit and l in ops_to_omit)]
    if omit_identity:
        op_labels = [l for l in op_labels if l != Label(())]
    lls = qubit_labels_of(model)

    if candidate_list is not None:
        candidates = list(candidate_list)
    else:
        max_len = candidate_fid_counts if isinstance(candidate_fid_counts, int) else 4
        candidates = [Circuit(combo, lls) for L in range(0 if force_empty else 1, max_len + 1)
                      for combo in itertools.product(op_labels, repeat=L)]

    def greedy(rows):
        chosen = [Circuit((), lls)] if force_empty else []
        d2 = model.dim
        best_score, n_spanned, _ = rows.score_many([chosen])[0] if chosen \
            else (np.inf, 0, None)
        while n_spanned < d2:
            rest = [c for c in candidates if c not in chosen]
            if not rest:
                break
            best = None
            for cand, (s, ns, _) in zip(rest, rows.score_many([chosen + [c] for c in rest])):
                if best is None or (ns, -s) > (best[1], -best[2]):
                    best = (cand, ns, s)
            chosen.append(best[0])
            n_spanned, best_score = best[1], best[2]
            printer.log("  %s fiducials: added %s -> %d/%d spanned"
                        % (rows.kind, best[0].str, n_spanned, d2), 2)
        assert n_spanned >= d2, "Could not find complete %s fiducials" % rows.kind
        # a few more greedy adds can improve conditioning: add the first
        # candidate (in order) that cuts the score below 0.7 of it, again
        improved = True
        while improved:
            improved = False
            rest = [c for c in candidates if c not in chosen]
            for cand, (s, ns, _) in zip(rest, rows.score_many([chosen + [c] for c in rest])):
                if s < 0.7 * best_score:
                    chosen.append(cand)
                    best_score = s
                    improved = True
                    break
        return chosen

    algorithm_kwargs = dict(algorithm_kwargs or {})

    def run(prep_or_meas):
        rows = _FiducialRows(model, prep_or_meas, device)
        if algorithm == 'greedy':
            return greedy(rows)
        if algorithm == 'slack':
            return _integer_slack(model, candidates, rows, force_empty, printer,
                                  **algorithm_kwargs)
        if algorithm == 'grasp':
            return _grasp(model, candidates, rows, force_empty, printer, greedy,
                          **algorithm_kwargs)
        raise ValueError("Invalid algorithm: %r" % algorithm)

    prep = run('prep') if prep_fids else None
    meas = run('meas') if meas_fids else None
    return prep, meas


def _integer_slack(model, candidates, rows, force_empty, printer, fixed_slack=None,
                   slack_frac=None, initial_weights=None, max_iters=10000, **_ignored):
    """Integer-weight slack optimization (reference:
    fiducialselection.optimize_integer_fiducials_slack:29): start from the
    full candidate pool and remove fiducials while the score stays within
    the slack and the set stays informationally complete; each iteration's
    removals scored in one batch."""
    if fixed_slack is None and slack_frac is None:
        slack_frac = 0.1
    lls = qubit_labels_of(model)
    chosen = list(dict.fromkeys(([Circuit((), lls)] if force_empty else [])
                                + list(candidates)))
    d2 = model.dim
    cur_score, n_spanned, _ = rows.score_many([chosen])[0]
    assert n_spanned >= d2, "Candidate pool is not informationally complete"
    for _ in range(max_iters):
        slack = fixed_slack if fixed_slack is not None else abs(cur_score) * slack_frac
        free = [f for f in chosen if not (force_empty and f.depth == 0)]
        trials = [[x for x in chosen if x != f] for f in free]
        best = None
        for f, (s, ns, _) in zip(free, rows.score_many(trials) if trials else []):
            if ns >= d2 and s <= cur_score + slack:
                if best is None or s < best[1]:
                    best = (f, s)
        if best is None:
            break
        chosen.remove(best[0])
        cur_score = best[1]
        printer.log("  slack: removed %s -> %d fiducials (score %.3g)"
                    % (best[0].str, len(chosen), cur_score), 2)
    return chosen


def _grasp(model, candidates, rows, force_empty, printer, greedy_fn, iterations=5,
           alpha=0.5, seed=None, **_ignored):
    """GRASP fiducial search: randomized-greedy construction (each step's
    candidates scored in one batch) + pruning local search, best of
    `iterations` restarts (reference: fiducialselection GRASP mode via
    algorithms/grasp.py)."""
    rng = np.random.RandomState(seed)
    d2 = model.dim
    lls = qubit_labels_of(model)
    best_solution = None
    for it in range(iterations):
        chosen = [Circuit((), lls)] if force_empty else []
        n_spanned = 0
        while n_spanned < d2:
            rest = [c for c in candidates if c not in chosen]
            if not rest:
                break
            scored = [(c, ns, s) for c, (s, ns, _)
                      in zip(rest, rows.score_many([chosen + [c] for c in rest]))]
            best_ns = max(x[1] for x in scored)
            top = sorted([x for x in scored if x[1] == best_ns], key=lambda x: x[2])
            rcl = top[:max(1, int(np.ceil(alpha * len(top))))]
            pick = rcl[rng.randint(len(rcl))]
            chosen.append(pick[0])
            n_spanned = pick[1]
        if n_spanned < d2:
            continue
        base_s = rows.score_many([chosen])[0][0]
        improved = True
        while improved:
            improved = False
            for f in list(chosen):
                if force_empty and f.depth == 0:
                    continue
                trial = [x for x in chosen if x != f]
                s, ns, _ = rows.score_many([trial])[0]
                if ns >= d2 and s <= base_s * 1.1:
                    chosen = trial
                    base_s = s
                    improved = True
        s = rows.score_many([chosen])[0][0]
        q = (-len(chosen), -s)
        if best_solution is None or q > best_solution[0]:
            best_solution = (q, chosen)
        printer.log("  GRASP iter %d: %d fiducials (score %.3g)" % (it, len(chosen), s), 2)
    assert best_solution is not None, "GRASP found no complete fiducial set"
    return best_solution[1]


def create_prep_mxs(model, prep_fid_list, prep_cache=None, device="cuda"):
    """One matrix per model preparation: columns are the fiducial-evolved
    prep superkets (reference: fiducialselection.create_prep_mxs:731)."""
    return [np.stack(_prep_vectors(model, prep_fid_list, device), axis=1)]


def create_meas_mxs(model, meas_fid_list, meas_cache=None, device="cuda"):
    """One matrix per measurement effect: columns are the back-propagated
    effect rows (reference: fiducialselection.create_meas_mxs:790)."""
    return [np.stack(_meas_vectors(model, meas_fid_list, device), axis=1)]


def create_candidate_fiducial_list(target_model, omit_identity=True, ops_to_omit=None,
                                   candidate_fid_counts=2, max_fid_length=None,
                                   eq_thresh=1e-6, candidate_seed=None, device="cuda"):
    """Candidate fiducial circuits: all gate words up to a length bound,
    deduplicated by the superoperator they produce (reference:
    fiducialselection.create_candidate_fiducial_list:1911).
    `candidate_fid_counts` is an int max length, or a dict
    {length: 'all upto' | count}."""
    from pygsti_tpu_torch.algorithms.germselection import create_circuit_cache as _products
    if max_fid_length is not None:
        candidate_fid_counts = int(max_fid_length)
    ops_to_omit = set(ops_to_omit or ())
    op_labels = [gl for gl in target_model.operations.keys() if gl not in ops_to_omit]
    if omit_identity:
        op_labels = [gl for gl in op_labels
                     if getattr(gl, 'name', str(gl)) not in ('Gi', '[]', '')]
    lls = qubit_labels_of(target_model)
    counts = {candidate_fid_counts: 'all upto'} if isinstance(candidate_fid_counts, int) \
        else dict(candidate_fid_counts)
    rng = np.random.RandomState(candidate_seed)
    fids = [Circuit((), lls)]
    seen_words = {()}
    for length, how in counts.items():
        if how == 'all upto':
            for L in range(1, length + 1):
                for combo in itertools.product(op_labels, repeat=L):
                    if combo not in seen_words:
                        seen_words.add(combo)
                        fids.append(Circuit(combo, lls))
        else:
            for _ in range(int(how)):
                combo = tuple(op_labels[rng.randint(len(op_labels))] for _ in range(length))
                if combo not in seen_words:
                    seen_words.add(combo)
                    fids.append(Circuit(combo, lls))
    cache = _products(target_model, fids[1:], device)
    kept, prods = [], []
    for c in fids:
        prod = np.eye(target_model.dim) if len(c.layertup) == 0 else cache[c]
        if any(np.linalg.norm(prod - p2) < eq_thresh for p2 in prods):
            continue
        prods.append(prod)
        kept.append(c)
    return kept


# ---------------------------------------------------------------------------
# Greedy-search support: PTM/prep/meas caches, candidate cleaning, compact
# EVD halves, and penalty terms (reference: fiducialselection.py:412-1935).
# ---------------------------------------------------------------------------

def xor(*args):
    """True iff exactly one argument is truthy (reference: fiducialselection.xor:412)."""
    return sum(bool(x) for x in args) == 1


def create_circuit_cache(model, circuit_list, device="cuda"):
    """{circuit.str: PTM} product cache for the candidate fiducials
    (reference: fiducialselection.create_circuit_cache:607)."""
    from pygsti_tpu_torch.algorithms.germselection import create_circuit_cache as _products
    circuit_list = list(circuit_list)
    nonempty = [c for c in circuit_list if len(c.layertup)]
    cache = _products(model, nonempty, device) if nonempty else {}
    return {c.str: (cache[c] if len(c.layertup) else np.eye(model.dim))
            for c in circuit_list}


def clean_fid_list(model, circuit_cache, available_fid_list, drop_identities=True,
                   drop_duplicates=True, eq_thresh=1e-6, assume_clifford=False):
    """Drop identity-acting and PTM-duplicate fiducials from the candidate
    list (reference: fiducialselection.clean_fid_list:433).  Returns
    (cleaned_fid_list, cleaned_circuit_cache); the first circuit of each
    duplicate group (in list order) is kept, and the empty circuit is never
    dropped as an identity."""
    cache = dict(circuit_cache)
    if drop_identities:
        ident = np.identity(model.dim, 'd')
        for key in list(cache.keys()):
            if key in ('{}', ()) or key == '':
                continue
            if np.linalg.norm(cache[key] - ident) < eq_thresh:
                del cache[key]
    if drop_duplicates:
        groups = {}
        for key, ptm in cache.items():
            inv = (round(float(np.real(np.trace(ptm))), 7),
                   int(np.count_nonzero(np.abs(ptm) > 1e-8)))
            groups.setdefault(inv, []).append(key)
        kept = {}
        for group_keys in groups.values():
            reps = []
            for key in group_keys:
                ptm = cache[key]
                if any(np.linalg.norm(ptm - cache[r]) < eq_thresh for r in reps):
                    continue
                reps.append(key)
            for r in reps:
                kept[r] = cache[r]
        cache = kept
    cleaned = [c for c in available_fid_list if c.str in cache]
    return cleaned, cache


def create_prep_cache(model, available_prep_fid_list, circuit_cache=None, device="cuda"):
    """{(rho_param_bytes, fid.str): F @ |rho>} effective-prep cache plus the
    rho key list (reference: fiducialselection.create_prep_cache:638)."""
    if circuit_cache is None:
        circuit_cache = create_circuit_cache(model, available_prep_fid_list, device)
    prep_cache, keylist = {}, []
    for rho in model.preps.values():
        key = np.asarray(rho.to_vector()).tobytes()
        keylist.append(key)
        vec = np.asarray(rho.dense())
        for fid in available_prep_fid_list:
            prep_cache[(key, fid.str)] = circuit_cache[fid.str] @ vec
    return prep_cache, keylist


def create_meas_cache(model, available_meas_fid_list, circuit_cache=None, device="cuda"):
    """{(povm_bytes, effect_bytes, fid.str): <E| @ F} effective-measurement
    cache plus the (povm, effect) key-pair list (reference:
    fiducialselection.create_meas_cache:683)."""
    if circuit_cache is None:
        circuit_cache = create_circuit_cache(model, available_meas_fid_list, device)
    meas_cache, keypairs = {}, []
    for povm in model.povms.values():
        dense = np.asarray(povm.dense())
        pkey = dense.tobytes()
        for evec in np.atleast_2d(dense):
            ekey = evec.tobytes()
            keypairs.append((pkey, ekey))
            for fid in available_meas_fid_list:
                meas_cache[(pkey, ekey, fid.str)] = evec @ circuit_cache[fid.str]
    return meas_cache, keypairs


def build_bitvec_mx(n, k):
    """All length-n binary vectors of Hamming weight k, as the rows of a
    (binom(n,k), n) array (reference: fiducialselection.build_bitvec_mx:1066)."""
    combos = list(itertools.combinations(range(n), k))
    mx = np.zeros((len(combos), n))
    for i, locs in enumerate(combos):
        mx[i, list(locs)] = 1
    return mx


def construct_compact_evd_cache(model, fids_list, prep_or_meas, fid_cache,
                                eigenvalue_tolerance=1e-10, device="cuda"):
    """{fiducial: U sqrt(e)} compact halves of each single-fiducial Gramian
    (reference: fiducialselection.construct_compact_evd_cache:1852)."""
    from pygsti_tpu_torch.algorithms.germselection import compact_EVD
    if prep_or_meas not in ('prep', 'meas'):
        raise ValueError("prep_or_meas must be 'prep' or 'meas'")
    rows = _FiducialRows(model, prep_or_meas, device)
    sqrteU = {}
    for fiducial in fids_list:
        fid_mat = rows.matrix([fiducial]).cpu().numpy().T
        e, U = compact_EVD(fid_mat @ fid_mat.conj().T, eigenvalue_tolerance,
                           assume_hermitian=True)
        sqrteU[fiducial] = U @ np.diag(np.sqrt(np.abs(e)))
    return sqrteU


def add_penalties_greedy(unpenalized_score, fid_list, l1_penalty=0, op_penalty=0,
                         gate_penalty=None):
    """Add l1 / op-count / per-gate penalties to a greedy fiducial-set score
    (reference: fiducialselection.add_penalties_greedy:1871)."""
    score = unpenalized_score
    score += l1_penalty * len(fid_list)
    score += op_penalty * sum(len(fiducial) for fiducial in fid_list)
    if gate_penalty is not None:
        for gate, penalty in gate_penalty.items():
            for fiducial in fid_list:
                score += fiducial.str.count(str(gate)) * penalty
    return score
