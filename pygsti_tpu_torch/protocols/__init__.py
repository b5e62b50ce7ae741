"""Protocols: the top-level user API (counterpart of
pygsti_tpu/protocols)."""

from pygsti_tpu_torch.protocols.protocol import (
    ExperimentDesign, CircuitListsDesign, CombinedExperimentDesign,
    SimultaneousExperimentDesign, FreeformDesign, ProtocolData, Protocol,
    ProtocolResults, ProtocolResultsDir, ProtocolCheckpoint, DefaultRunner,
    MultiPassProtocol, MultiPassResults, ProtocolPostProcessor, TreeRunner, SimpleRunner,
    SlurmSettings, DataCountsSimulator,
)
from pygsti_tpu_torch.protocols.gst import (
    GateSetTomographyDesign, StandardGSTDesign, GSTInitialModel, GSTBadFitOptions,
    GSTObjFnBuilders, GSTGaugeOptSuite, GateSetTomography, LinearGateSetTomography,
    StandardGST, ModelEstimateResults, GateSetTomographyCheckpoint,
    StandardGSTCheckpoint,
)
from pygsti_tpu_torch.protocols.estimate import Estimate
from pygsti_tpu_torch.protocols.modeltest import ModelTest
from pygsti_tpu_torch.protocols.rb import (
    BenchmarkingDesign, CliffordRBDesign, DirectRBDesign, MirrorRBDesign,
    BinaryRBDesign, InterleavedRBDesign, RandomizedBenchmarking,
    RandomizedBenchmarkingResults, InterleavedRandomizedBenchmarking,
    InterleavedRandomizedBenchmarkingResults,
)
from pygsti_tpu_torch.protocols.vb import (
    ByDepthDesign, SummaryStatistics, ByDepthSummaryStatistics,
    SummaryStatisticsResults, PeriodicMirrorCircuitDesign,
)
from pygsti_tpu_torch.protocols.rpe import (
    RobustPhaseEstimationDesign, RobustPhaseEstimationResults,
    RobustPhaseEstimationProtocol,
)
from pygsti_tpu_torch.protocols.stability import (StabilityAnalysis,
                                                  StabilityAnalysisResults)
from pygsti_tpu_torch.protocols.confidenceregionfactory import (
    ConfidenceRegionFactory, ConfidenceRegionFactoryView)
from pygsti_tpu_torch.protocols.freeformsim import (DataSimulator,
                                                    FreeformDataSimulator,
                                                    ModelFreeformSimulator)
