"""The comparison that decides `correct`.

For each checked fit of a run, the plain reference (reference/) builds its
own model from the fitted parameters theta and the fit's counts, and
compares what the program produced:

  prob_gap   max |p_program - p_reference| over every circuit and outcome at
             theta: the program's model tensors and forward scan
  value_gap  |value the fit reported - the reference's value at theta| /
             the reference's value: the program's objective (chi2, or
             2 Delta logL)
  grad_gap   max_j |g_program - g_reference| / max_j sum_e |dp_e/dtheta_j|
             |dterm_e/dp_e| at theta: the program's gradient 2 J^T f through
             its blocked Jacobian (the kernel's route) against autograd's,
             on the scale of its terms' own magnitudes
  decrement  the fall of the objective's terms one Newton step from theta
             would give, by the reference's Gauss-Newton Hessian: whether
             theta is the fit of the data it was given

Each number is the largest over the checked fits, and fails above its
limit (limits/<workload>.json).  The control puts the reference, computed
in float32, in the program's place for the first three; the fourth judges
the fit itself, and reads its upper end at a planted fault (faults.py): a
fit that leaves its state unchanged, or a fitted vector altered with its
reported value made to agree.
"""

from __future__ import annotations

import numpy as np
import torch

from gstbench.reference.objective import Problem

NUMBERS = ('prob_gap', 'value_gap', 'grad_gap', 'decrement')


def reference_problem(gen, rec, dtype):
    totals = rec['counts'].sum(dim=1)
    return Problem(gen.ref, gen.design['layers'], gen.seqs, rec['counts'], totals,
                   gen.check_kind, gen.check_regs, dtype, gen.device)


def element_order(layout, outcomes):
    """(circuit index, outcome index) of each of the layout's elements."""
    where = {o: i for i, o in enumerate(outcomes)}
    circ = np.asarray(layout.elem_to_circuit, dtype=np.int64)
    flat = [where[o[-1]] for outs in layout.outcomes for o in outs]
    return torch.as_tensor(circ), torch.as_tensor(np.asarray(flat, dtype=np.int64))


def program_outputs(gen, rec):
    """(probabilities [N, M], gradient [P]) of the program at the fit's
    theta: its objective's forward scan and 2 J^T f of its blocked
    Jacobian."""
    obj = gen.program_objective(rec)
    theta = rec['theta']
    p_flat = torch.as_tensor(obj.probs(theta), device=gen.device)
    ci, oi = element_order(obj.layout, gen.outcomes)
    p = torch.zeros(gen.truth_probs.shape, dtype=torch.float64, device=gen.device)
    p[ci.to(gen.device), oi.to(gen.device)] = p_flat
    _, _, jtf = obj.jtj_jtf(theta)
    g = 2.0 * torch.as_tensor(jtf, device=gen.device)
    del obj
    return p, g


def numbers(gen, rec, control=False):
    """The check's numbers for one fit; with `control` the float32
    reference's outputs stand in for the program's."""
    ref = reference_problem(gen, rec, torch.float64)
    theta = rec['theta']
    p_ref = ref.probs(theta).detach()
    g_ref = ref.gradient(theta)
    v_ref = ref.value(theta)
    dec, J, dterms = ref.newton_decrement(theta)
    scale = float((J.abs() * dterms.abs()[:, None]).sum(0).max())
    del J
    if control:
        low = reference_problem(gen, rec, torch.float32)
        p = low.probs(theta).detach().double()
        g = low.gradient(theta).double()
        reported = low.value(theta)
    else:
        p, g = program_outputs(gen, rec)
        reported = rec['reported']
    return {'prob_gap': float((p - p_ref).abs().max()),
            'value_gap': abs(reported - v_ref) / abs(v_ref),
            'grad_gap': float((g - g_ref).abs().max()) / scale,
            'decrement': dec}


def start_decrement(gen, rec):
    """The decrement at the fit's start: what a fit that returned its
    state unchanged reads."""
    ref = reference_problem(gen, rec, torch.float64)
    return ref.newton_decrement(gen.theta_start())[0]


def judge(per_fit, limits):
    """(correct, {number: {'value', 'limit'}}) from the numbers of the
    checked fits: each number's largest against its limit."""
    out, ok = {}, True
    for name in NUMBERS:
        vals = [n[name] for n in per_fit]
        v = max(vals) if vals else float('nan')
        lim = float(limits[name])
        good = bool(np.isfinite(v) and v <= lim)
        ok = ok and good
        out[name] = {'value': v, 'limit': lim}
    return ok and bool(per_fit), out
