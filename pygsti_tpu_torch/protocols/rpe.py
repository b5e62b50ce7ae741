"""Robust phase estimation protocol (counterpart of pygsti_tpu/protocols/rpe.py):
the design of cosine and sine circuits at depths 2^k, the protocol that
reads their counts and RobustPhaseEstimation's results."""

from __future__ import annotations

from pygsti_tpu_torch.algorithms.robust_phase_estimation import RobustPhaseEstimation
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.protocols.protocol import ExperimentDesign, Protocol, ProtocolResults


class RobustPhaseEstimationDesign(ExperimentDesign):
    """At each depth d: the cosine circuit cos_prep + gate^d + cos_meas and
    the sine circuit sin_prep + gate^d + sin_meas.  `req_counts` is
    accepted and not used, as in the JAX package."""

    def __init__(self, gate_label, depths, qubit_labels=None, req_counts=None,
                 sin_prep=(), sin_meas=(), cos_prep=(), cos_meas=(), line_labels=None):
        self.gate_label = gate_label
        self.depths = list(depths)
        lls = line_labels if line_labels is not None else \
            (qubit_labels if qubit_labels is not None else (0,))
        self.cos_circuits, self.sin_circuits = [], []
        for d in self.depths:
            base = Circuit([gate_label], lls).repeat(d)
            self.cos_circuits.append(Circuit(list(cos_prep), lls) + base
                                     + Circuit(list(cos_meas), lls))
            self.sin_circuits.append(Circuit(list(sin_prep), lls) + base
                                     + Circuit(list(sin_meas), lls))
        super().__init__(self.cos_circuits + self.sin_circuits, qubit_labels)


class RobustPhaseEstimationResults(ProtocolResults):
    def __init__(self, data, protocol_instance, angle_estimates):
        super().__init__(data, protocol_instance)
        self.angle_estimates = angle_estimates

    @property
    def angle_estimate(self):
        return self.angle_estimates[-1]


class RobustPhaseEstimationProtocol(Protocol):
    """The rotation angle from RPE data: at each generation the fraction of
    `cos_outcome_plus` in the cosine circuit and of `sin_outcome_plus` in
    the sine circuit."""

    def __init__(self, name=None, cos_outcome_plus='0', sin_outcome_plus='1'):
        super().__init__(name)
        self.cos_outcome_plus = cos_outcome_plus
        self.sin_outcome_plus = sin_outcome_plus

    def run(self, data, memlimit=None, comm=None):
        design, ds = data.edesign, data.dataset

        def plus_minus(circ, plus):
            row = ds[circ]
            n_plus = row.counts.get((plus,), 0)
            return n_plus, row.total - n_plus

        class _Q:
            measured = {k: plus_minus(design.cos_circuits[k], self.cos_outcome_plus)
                        + plus_minus(design.sin_circuits[k], self.sin_outcome_plus)
                        for k in range(len(design.depths))}
        return RobustPhaseEstimationResults(data, self,
                                            RobustPhaseEstimation(_Q()).angle_estimates)


RobustPhaseEstimation_Protocol = RobustPhaseEstimationProtocol
RPEDesign = RobustPhaseEstimationDesign
RPE = RobustPhaseEstimationProtocol
RPEResults = RobustPhaseEstimationResults
