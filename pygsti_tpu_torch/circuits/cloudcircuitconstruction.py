"""Cloud-noise GST circuit construction (counterpart of
pygsti_tpu/circuits/cloudcircuitconstruction.py).

Builds `fiducial1 + germ^power + fiducial2` circuit sets that amplify every
parameter of a cloud-noise model.  Which parameters a candidate circuit
amplifies is read numerically, as in the JAX package: for germ power p the
probability Jacobian is J(p) = J0 + p A + O(error), so A = J(2 p0) - J(p0)
at the ideal (zero-error) point, one Jacobian of all candidate fiducial
pairs per power, computed from the port's model tensors on `device`.
Fiducial pairs are then chosen greedily by the rank they add.
"""

from __future__ import annotations

import collections
import itertools

import numpy as np

from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.baseobjs.verbosityprinter import VerbosityPrinter
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.circuits.circuitstructure import (GermFiducialPairPlaquette,
                                                        PlaquetteGridCircuitStructure)

__all__ = ['create_cloudnoise_circuits', 'create_kcoverage_template',
           'check_kcoverage_template']


# ---------------------------------------------------------------------------
# k-coverage templates
# ---------------------------------------------------------------------------

def create_kcoverage_template(n, k, verbosity=0):
    """A "k-coverage" set of length-`n` rows over the alphabet {0..k-1}:
    for every choice of `k` distinct positions, every permutation of the
    `k` distinct symbols appears at those positions in at least one row.

    Used to tile `k`-qubit fiducial-pair templates across `n` qubits so
    that every size-`k` qubit subset experiences the full template.  The
    row count is not guaranteed minimal.

    Construction: greedy repair -- iterate over (positions, permutation)
    requirements and satisfy each by completing a partially-assigned row
    when compatible, else appending a new row; open slots are filled
    cyclically at the end.  Correct by construction and verified by
    :func:`check_kcoverage_template`.
    """
    assert n >= k >= 1, "need n >= k >= 1"
    printer = VerbosityPrinter.create_printer(verbosity)
    if k == 1:
        return [[0] * n]

    rows = []  # partial rows: entries are ints or None
    for positions in itertools.combinations(range(n), k):
        for perm in itertools.permutations(range(k)):
            placed = False
            for row in rows:
                if all(row[p] is None or row[p] == s
                       for p, s in zip(positions, perm)):
                    for p, s in zip(positions, perm):
                        row[p] = s
                    placed = True
                    break
            if not placed:
                row = [None] * n
                for p, s in zip(positions, perm):
                    row[p] = s
                rows.append(row)
    for row in rows:
        for i, val in enumerate(row):
            if val is None:
                row[i] = i % k
    printer.log("create_kcoverage_template(n=%d, k=%d): %d rows"
                % (n, k, len(rows)), 1)
    check_kcoverage_template(rows, n, k)
    return rows


def check_kcoverage_template(rows, n, k, verbosity=0):
    """Assert `rows` is a valid k-coverage template."""
    for positions in itertools.combinations(range(n), k):
        covered = set(tuple(row[p] for p in positions) for row in rows)
        for perm in itertools.permutations(range(k)):
            assert perm in covered, \
                "k-coverage violation: %s missing at positions %s" \
                % (perm, positions)
    if verbosity > 0:
        print("check_kcoverage_template(n=%d,k=%d): %d rows OK"
              % (n, k, len(rows)))


# the private name of the JAX package
_check_kcoverage_template = check_kcoverage_template


# ---------------------------------------------------------------------------
# numeric amplification analysis
# ---------------------------------------------------------------------------

def _fiducial_circuit(pieces, qubit_labels, line_labels):
    """Parallel 1-qubit fiducial: pieces[i] is a gate-name tuple applied to
    qubit_labels[i]; all pieces laid out layer-by-layer."""
    depth = max((len(p) for p in pieces), default=0)
    layers = []
    for d in range(depth):
        layer = [Label(p[d], (q,)) for p, q in zip(pieces, qubit_labels)
                 if d < len(p)]
        if len(layer) == 1:
            layers.append(layer[0])
        elif layer:
            layers.append(tuple(layer))
        else:
            layers.append(())
    return Circuit(tuple(layers), line_labels=line_labels)


def _amped_matrices(model, germ, power0, fidpair_circuits, device="cuda"):
    """First-order amplification matrix for each candidate fiducial pair:
    A_c = J_c(2*power0) - J_c(power0), the linear-in-power part of the
    probability Jacobian, evaluated in two batched dprobs calls."""
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    sim = SimpleForwardSimulator(model, device)
    mats = {}
    for mult in (1, 2):
        base = germ.repeat(mult * power0)
        circuits = [prep + base + meas for (prep, meas) in fidpair_circuits]
        layout = sim.create_layout(circuits)
        mats[mult] = (layout, sim.bulk_fill_dprobs(None, layout))
    layout1, J1 = mats[1]
    layout2, J2 = mats[2]
    out = []
    for i in range(len(fidpair_circuits)):
        s1, s2 = layout1.element_slices[i], layout2.element_slices[i]
        out.append(J2[s2.start:s2.stop] - J1[s1.start:s1.stop])
    return out


def _greedy_rank_select(amped_mats, already_spanned, tol=1e-7, printer=None):
    """Greedily pick candidate indices whose amplification matrices add rank
    beyond `already_spanned` (an orthonormal-row matrix [r, P] or None).
    Returns (chosen_indices, updated_orthonormal_basis).

    Q is kept orthonormal to rounding: each residual is projected off Q
    twice ("twice is enough"), and the rows added are orthonormalized
    against Q once more.  The JAX package projects once, so Q's rows drift
    from orthonormal with every row added (1.6e-9 after one 3-qubit germ);
    once the drift nears `tol`, spanned directions leave residuals above the
    cut, are added as new rank, and the drift feeds itself: its 3-qubit
    cloud design reached "rank" 717 of 534 parameters, keeping every
    candidate of the last germ, and which candidates fell past that point
    depended on the last bits of the Jacobians, so the card and the CPU
    chose different designs.  Where the drift stays far below `tol` (the
    2-qubit designs) both choose the same pairs."""
    P = amped_mats[0].shape[1] if amped_mats else 0
    Q = np.zeros((0, P)) if already_spanned is None else already_spanned

    def residual(A, Q):
        for _ in range(2 if Q.shape[0] else 0):
            A = A - (A @ Q.T) @ Q
        return A

    def residual_rank(A, Q):
        R = residual(A, Q)
        if R.size == 0:
            return 0, R
        sv = np.linalg.svd(R, compute_uv=False)
        scale = max(np.max(sv), tol)
        return int(np.sum(sv > tol * max(1.0, scale))), R

    chosen = []
    while True:
        best_i, best_gain = None, 0
        for i, A in enumerate(amped_mats):
            if i in chosen:
                continue
            gain, _ = residual_rank(A, Q)
            if gain > best_gain:
                best_i, best_gain = i, gain
        if best_i is None:
            break
        chosen.append(best_i)
        _, R = residual_rank(amped_mats[best_i], Q)
        u, s, vt = np.linalg.svd(R, full_matrices=False)
        keep = s > tol * max(1.0, s.max() if s.size else 0.0)
        new = np.linalg.qr(residual(vt[keep], Q).T)[0].T
        Q = np.vstack([Q, new])
        if printer is not None:
            printer.log("  + fidpair %d: amped rank now %d"
                        % (best_i, Q.shape[0]), 2)
    return chosen, Q


# ---------------------------------------------------------------------------
# main construction
# ---------------------------------------------------------------------------

def create_cloudnoise_circuits(processor_spec, max_lengths, single_q_fiducials,
                               max_idle_weight=1, maxhops=0,
                               extra_weight_1_hops=0, extra_gate_weight=0,
                               parameterization="H+S", verbosity=0,
                               cache=None, idle_only=False,
                               idt_pauli_dicts=None, algorithm="greedy",
                               idle_op_str=((),), comm=None,
                               max_candidates=256, seed=0, device="cuda"):
    """Construct `fid1 + germ^power + fid2` circuits amplifying all
    parameters of the cloud-noise model defined by the weight/hop arguments.

    `single_q_fiducials` is a list of 1-qubit gate-name tuples (or a
    [prep_fiducials, meas_fiducials] pair of such lists).  Germs are the
    global idle plus each primitive gate; fiducial pairs are selected
    greedily from per-cloud products of the 1-qubit fiducials by numeric
    first-order amplification rank (see module docstring).  Returns a
    :class:`PlaquetteGridCircuitStructure` with (L, germ) plaquettes.
    The Jacobians are computed on `device`; `cache`, `idt_pauli_dicts`,
    `algorithm` and `comm` are accepted and not used.
    """
    from pygsti_tpu_torch.models.cloudnoisemodel import \
        create_cloud_crosstalk_model_from_hops_and_weights

    printer = VerbosityPrinter.create_printer(verbosity)
    pspec = processor_spec
    qlbls = tuple(pspec.qubit_labels)
    rng = np.random.RandomState(seed)

    # a parameterization linear in the rates, so that first-order
    # amplification shows in the derivative at the zero-error point
    ptype = 'H' if parameterization.upper() == 'H' else (
        's' if parameterization.upper() in ('S', 'D') else 'H+s')

    model = create_cloud_crosstalk_model_from_hops_and_weights(
        pspec, max_idle_weight=max_idle_weight, maxhops=maxhops,
        extra_weight_1_hops=extra_weight_1_hops,
        extra_gate_weight=extra_gate_weight, gate_type=ptype)

    if isinstance(single_q_fiducials[0], (list,)) and \
       len(single_q_fiducials) == 2 and \
       all(isinstance(f, (tuple, list)) for f in single_q_fiducials[0]):
        prep_fids_1q = [tuple(f) for f in single_q_fiducials[0]]
        meas_fids_1q = [tuple(f) for f in single_q_fiducials[1]]
    else:
        prep_fids_1q = [tuple(f) for f in single_q_fiducials]
        meas_fids_1q = prep_fids_1q

    def candidate_fidpairs(support):
        """(prep_circuit, meas_circuit, descriptor) candidates whose
        non-trivial action is on `support` qubits (identity elsewhere),
        capped at `max_candidates` by seeded subsampling."""
        support = tuple(support)
        prep_choices = list(itertools.product(prep_fids_1q,
                                              repeat=len(support)))
        meas_choices = list(itertools.product(meas_fids_1q,
                                              repeat=len(support)))
        pairs = list(itertools.product(prep_choices, meas_choices))
        if len(pairs) > max_candidates:
            sel = rng.choice(len(pairs), size=max_candidates, replace=False)
            pairs = [pairs[i] for i in sorted(sel)]
        out = []
        for prep_pieces, meas_pieces in pairs:
            pc = _fiducial_circuit(prep_pieces, support, qlbls)
            mc = _fiducial_circuit(meas_pieces, support, qlbls)
            out.append((pc, mc, (prep_pieces, meas_pieces, support)))
        return out

    # --- germ list ---------------------------------------------------------
    germs = []
    if isinstance(idle_op_str, Circuit):
        idle_germ = idle_op_str.copy() if hasattr(idle_op_str, 'copy') \
            else idle_op_str
    else:
        idle_germ = Circuit(tuple(idle_op_str), line_labels=qlbls)
    if max_idle_weight > 0:
        germs.append(('idle', idle_germ, qlbls))
    if not idle_only:
        graph = pspec.qubit_graph
        for name in pspec.gate_names:
            if name in ('{idle}', '(idle)'):
                continue
            for targets in pspec.resolved_availability(name):
                targets = tuple(targets)
                cloud = tuple(sorted(
                    graph.radius(list(targets), maxhops + extra_weight_1_hops),
                    key=lambda x: qlbls.index(x)))
                germ = Circuit((Label(name, targets),), line_labels=qlbls)
                germs.append(('gate', germ, cloud))

    # --- per-germ amplification analysis -----------------------------------
    Q_global = None
    germ_fidpairs = collections.OrderedDict()
    for kind, germ, support in germs:
        printer.log("Analyzing germ %s (support %s)" % (germ.str, support), 1)
        cands = candidate_fidpairs(support)
        power0 = max(1, min(max_lengths) // max(germ.depth, 1)) \
            if max_lengths else 1
        amped = _amped_matrices(model, germ, power0,
                                [(p, m) for p, m, _ in cands], device)
        chosen, Q_global = _greedy_rank_select(amped, Q_global,
                                               printer=printer)
        if not chosen and cands:
            chosen = [0]  # always keep at least one pair per germ
        germ_fidpairs[germ] = [(cands[i][0], cands[i][1]) for i in chosen]
        printer.log(" -> %d fiducial pairs; cumulative amped rank %d / %d"
                    % (len(chosen), Q_global.shape[0], model.num_params), 1)

    # --- assemble plaquette structure --------------------------------------
    plaquettes = {}
    Ls = sorted(set(int(L) for L in max_lengths))
    for germ, fidpairs in germ_fidpairs.items():
        d = max(germ.depth, 1)
        for L in Ls:
            power = L // d
            if power < 1:
                continue
            plaquettes[(L, germ)] = GermFiducialPairPlaquette(
                germ, power,
                {(0, j): (prep, meas)
                 for j, (prep, meas) in enumerate(fidpairs)})
    return PlaquetteGridCircuitStructure(plaquettes, Ls,
                                         list(germ_fidpairs.keys()),
                                         "L", "germ")
