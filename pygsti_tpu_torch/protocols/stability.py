"""Stability analysis protocol (counterpart of pygsti_tpu/protocols/stability.py).

Wraps the drift spectral analysis: for every circuit with time-series
(clickstream) data, power spectra per outcome on `device`, the corrected
instability tests, and probability-trajectory estimates of the circuits
found drifting.
"""

from __future__ import annotations

from pygsti_tpu_torch.extras.drift.stabilityanalyzer import StabilityAnalyzer
from pygsti_tpu_torch.protocols.protocol import ExperimentDesign, Protocol, ProtocolResults


class StabilityAnalysis(Protocol):
    """Detect drift in time-series data by spectral analysis ('auto'
    tests, the JAX package's defaults)."""

    def __init__(self, significance=0.05, transform='dct', estimate_trajectories=True,
                 name=None, device="cuda"):
        super().__init__(name)
        self.significance = significance
        self.transform = transform
        self.estimate_trajectories = estimate_trajectories
        self.device = device

    def run(self, data, memlimit=None, comm=None):
        analyzer = StabilityAnalyzer(data.dataset, self.transform, self.significance,
                                     device=self.device)
        analyzer.compute_spectra()
        analyzer.run_instability_detection()
        trajectories = {}
        if self.estimate_trajectories:
            for c in analyzer.unstable_circuits():
                for o, traj in analyzer.probability_trajectories(c).items():
                    trajectories[(c, o)] = traj
        return StabilityAnalysisResults(data, self, analyzer,
                                        list(analyzer.unstable_circuits()), trajectories)


class StabilityAnalysisResults(ProtocolResults):
    """The analyzer, the circuits found drifting and their estimated
    {(circuit, outcome): p(t)} trajectories."""

    def __init__(self, data, protocol_instance, analyzer, unstable_circuits,
                 probability_trajectories=None):
        super().__init__(data, protocol_instance)
        self.stabilityanalyzer = analyzer
        self.unstable_circuits = unstable_circuits
        self.probability_trajectories = probability_trajectories or {}

    @property
    def instability_detected(self):
        return self.stabilityanalyzer.instability_detected

    def __str__(self):
        if self.instability_detected:
            return "StabilityAnalysis: drift DETECTED in %d circuits" % len(
                self.unstable_circuits)
        return "StabilityAnalysis: no drift detected"


class StabilityAnalysisDesign(ExperimentDesign):
    """An experiment design for stability analysis: any circuit list, whose
    data must carry timestamps."""

    def __init__(self, circuits, qubit_labels=None):
        self.needs_timestamps = True
        super().__init__(circuits, qubit_labels=qubit_labels)
