"""Experiment-design tools: run-time estimates, Fisher information, idle
padding (counterpart of pygsti_tpu/tools/edesigntools.py).

The Fisher information of N shots of a circuit is N sum_o j_o j_o^T / p_o
(j_o = d p_o / d params), less N sum_o d2 p_o / d params2 in its exact
form.  Summed over circuits it is the weighted Gram of the probability
Jacobian with w = N / p, through the blocked Jacobian's kernel on a
'blocked' layout (objectivefns ``weighted_gram``), and the exact form's
second term is the objective's ``probs_hessian_sum`` with w = -N.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from pygsti_tpu_torch import DTYPE


def calculate_edesign_estimated_runtime(edesign, gate_time_dict=None, gate_time_1Q=None,
                                        gate_time_2Q=None, measure_reset_time=0.0,
                                        interbatch_latency=0.0, total_shots_per_circuit=1000,
                                        shots_per_circuit_per_batch=None,
                                        circuits_per_batch=None):
    """The wall time to take the design's data: each circuit's layers (a
    layer takes its slowest gate) and its measurement and reset, times the
    shots, plus the latency between batches."""
    assert gate_time_dict is not None or (gate_time_1Q is not None and gate_time_2Q is not None), \
        "Specify gate_time_dict, or gate_time_1Q and gate_time_2Q"

    def comp_time(comp):
        if gate_time_dict is not None:
            t = gate_time_dict.get(comp, None)
            if t is None:
                t = gate_time_dict.get(comp.name, None)
            assert t is not None, "no gate time for %s" % str(comp)
            return t
        nq = len(comp.sslbls) if comp.sslbls else 1
        return gate_time_1Q if nq == 1 else gate_time_2Q

    def layer_time(layer):
        comps = layer.components if not layer.is_simple else (layer,)
        return max((comp_time(c) for c in comps), default=0.0)

    circuits = list(edesign.all_circuits_needing_data)
    circuit_times = [sum(layer_time(c.layertup[i]) for i in range(c.depth)) + measure_reset_time
                     for c in circuits]
    circuits_per_batch = len(circuits) if circuits_per_batch is None else circuits_per_batch
    if shots_per_circuit_per_batch is None:
        shots_per_circuit_per_batch = total_shots_per_circuit
    n_batches = int(np.ceil(len(circuits) / circuits_per_batch))
    n_rounds = int(np.ceil(total_shots_per_circuit / shots_per_circuit_per_batch))
    return sum(circuit_times) * shots_per_circuit_per_batch * n_rounds \
        + interbatch_latency * n_batches * n_rounds


def _probability_objective(model, circuits, device):
    """An objective of the circuits' dense layout with no data: the
    probabilities, their Jacobian, Grams and Hessian sums (its counts are
    zero and not used)."""
    from pygsti_tpu_torch.data.dataset import DataSet
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.objectivefns.objectivefns import (RawPoissonPicDeltaLogLFunction,
                                                            TimeIndependentMDCObjectiveFunction)
    empty = DataSet()
    for c in circuits:
        empty.add_count_dict(c, {})
    layout = SimpleForwardSimulator(model, device).create_layout(circuits)
    return TimeIndependentMDCObjectiveFunction(RawPoissonPicDeltaLogLFunction(), model, empty,
                                               circuits, layout=layout, device=device)


def _shots_per_element(obj, circuits, num_shots):
    n = np.array([num_shots[c] if isinstance(num_shots, dict) else num_shots for c in circuits],
                 dtype=float)
    return n[obj.layout.elem_to_circuit]


def calculate_fisher_information_per_circuit(model, circuits, approx=True, regularization=1e-8,
                                             verbosity=0, comm=None, mem_limit=None,
                                             device="cuda"):
    """{circuit: the Fisher information of one shot [P, P]}:
    sum_o j_o j_o^T / max(p_o, regularization), less sum_o d2 p_o unless
    `approx`."""
    circuits = list(circuits)
    obj = _probability_objective(model, circuits, device)
    p = np.clip(obj.probs(), regularization, None)
    J = obj.probs_jacobian()
    out = {}
    for i, c in enumerate(circuits):
        sl = obj.layout.element_slices[i]
        F = (J[sl] / p[sl, None]).T @ J[sl]
        if not approx:
            w = np.zeros(obj.layout.num_elements)
            w[sl] = -1.0
            F = F + obj.probs_hessian_sum(w)
        out[c] = F
    return out


def calculate_fisher_information_matrix(model, circuits, num_shots=1, term_cache=None,
                                        approx=True, regularization=1e-8, verbosity=0, comm=None,
                                        mem_limit=None, device="cuda"):
    """The Fisher information of the circuit list, `num_shots` (an int or
    {circuit: int}) shots each: the Gram of the probability Jacobian with
    w = N / max(p, regularization), less sum N d2 p unless `approx`.  A
    `term_cache` that holds every circuit's one-shot matrix is summed
    instead."""
    circuits = list(circuits)
    if term_cache is not None and circuits and all(c in term_cache for c in circuits):
        return sum((num_shots[c] if isinstance(num_shots, dict) else num_shots) * term_cache[c]
                   for c in circuits)
    obj = _probability_objective(model, circuits, device)
    n = _shots_per_element(obj, circuits, num_shots)
    p = torch.as_tensor(obj.probs(), dtype=DTYPE, device=obj.device)
    F = obj.weighted_gram(torch.as_tensor(n, dtype=DTYPE, device=obj.device)
                          / torch.clamp(p, min=regularization))
    if not approx:
        F = F + obj.probs_hessian_sum(-n)
    return F


def calculate_fisher_information_matrices_by_L(model, circuit_lists, Ls, num_shots=1,
                                               term_cache=None, approx=True, regularization=1e-8,
                                               cumulative=True, verbosity=0, comm=None,
                                               mem_limit=None, device="cuda"):
    """{L: the Fisher information of list L}; where a list holds the one
    before it (nested GST lists) only its new circuits are added to the
    last matrix.  With `cumulative` False, each L gets the difference from
    the L before."""
    out = collections.OrderedDict()
    prev, prev_set = None, set()
    for L, cl in zip(Ls, circuit_lists):
        cl = list(cl)
        if prev is not None and prev_set <= set(cl):
            new = [c for c in cl if c not in prev_set]
            F = prev + (calculate_fisher_information_matrix(
                model, new, num_shots, term_cache, approx, regularization, device=device)
                if new else 0)
        else:
            F = calculate_fisher_information_matrix(model, cl, num_shots, term_cache, approx,
                                                    regularization, device=device)
        out[L] = F
        prev, prev_set = F, set(cl)
    if not cumulative:
        prev = None
        for L in list(out.keys()):
            cur = out[L].copy()
            if prev is not None:
                out[L] = cur - prev
            prev = cur
    return out


def pad_edesign_with_idle_lines(edesign, line_labels):
    """The design with every circuit on `line_labels` (the lines it does
    not use stay idle)."""
    from pygsti_tpu_torch.circuits.circuit import Circuit
    from pygsti_tpu_torch.protocols.protocol import CircuitListsDesign, ExperimentDesign

    def pad(c):
        return Circuit(list(c.layertup), tuple(line_labels))

    if hasattr(edesign, 'circuit_lists'):
        return CircuitListsDesign([[pad(c) for c in cl] for cl in edesign.circuit_lists],
                                  qubit_labels=tuple(line_labels))
    return ExperimentDesign([pad(c) for c in edesign.all_circuits_needing_data],
                            qubit_labels=tuple(line_labels))
