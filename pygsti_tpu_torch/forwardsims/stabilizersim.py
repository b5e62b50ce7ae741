"""Stabilizer (Clifford-only) forward simulation -- the large-n path
(reference: pygsti/evotypes/stabilizer/ C++ reps + weak fwd sims).

Computes exact outcome probabilities of Clifford circuits on any number of
qubits in polynomial time via the symplectic-tableau representation."""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.baseobjs.outcomelabeldict import OutcomeLabelDict
from pygsti_tpu_torch.tools import symplectic as _sym


class StabilizerForwardSimulator(object):
    """Exact Clifford-circuit probabilities at scale.

    Not tied to a parameterized model: operates directly on circuits of
    named Clifford gates (optionally using a processor spec for gate
    definitions)."""

    def __init__(self, pspec=None, srep_dict=None):
        self.pspec = pspec
        self._srep_dict = srep_dict

    def _sreps(self):
        d = dict(_sym.compute_internal_gate_symplectic_representations())
        if self.pspec is not None:
            d.update(self.pspec.compute_clifford_symplectic_reps())
        if self._srep_dict:
            d.update(self._srep_dict)
        return d

    def _final_state(self, circuit):
        q_labels = list(circuit.line_labels) if circuit.line_labels != ('*',) \
            else (list(self.pspec.qubit_labels) if self.pspec else None)
        assert q_labels is not None, "circuit needs line labels or a pspec"
        n = len(q_labels)
        s, p = _sym.symplectic_rep_of_clifford_circuit(
            circuit, srep_dict=self._sreps(),
            pspec=None if circuit.line_labels != ('*',) else self.pspec)
        state = _sym.prep_stabilizer_state(n, [0] * n)
        return n, _sym.apply_clifford_to_stabilizer_state(s, p, *state)

    def probability(self, circuit, outcome_bits):
        """p(outcome_bits | circuit) starting from |0...0>."""
        n, (st_s, st_p) = self._final_state(circuit)
        bits = [int(b) for b in (outcome_bits if not isinstance(outcome_bits, str)
                                 else list(outcome_bits))]
        return _sym.stabilizer_outcome_probability(st_s, st_p, bits)

    def probs(self, circuit, outcomes=None):
        """All-outcome distribution (exponential in the number of *random*
        measurement bits only; deterministic bits don't branch).
        `outcomes` restricts the returned dict."""
        n, (st_s, st_p) = self._final_state(circuit)
        out = OutcomeLabelDict()

        def recurse(s, p, qubit, prefix, prob):
            if qubit == n:
                out["".join(str(b) for b in prefix)] = prob
                return
            p0, st0, p1, st1 = _sym.pauli_z_measurement(s, p, qubit)
            if p0 > 0:
                recurse(st0[0], st0[1], qubit + 1, prefix + [0], prob * p0)
            if p1 > 0:
                recurse(st1[0], st1[1], qubit + 1, prefix + [1], prob * p1)

        recurse(st_s, st_p, 0, [], 1.0)
        if outcomes is not None:
            keep = {OutcomeLabelDict.to_outcome(o) for o in outcomes}
            out = OutcomeLabelDict((k, v) for k, v in out.items()
                                   if k in keep)
        return out
