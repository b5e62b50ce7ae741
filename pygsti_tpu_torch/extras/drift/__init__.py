"""Drift and stability analysis (counterpart of pygsti_tpu/extras/drift/)."""

from pygsti_tpu_torch.extras.drift.signal import (dct_power_spectrum, lsp_power_spectrum,
                                                  power_significance_threshold,
                                                  dct_basis_function, dct_power_spectra,
                                                  lsp_power_spectra)
from pygsti_tpu_torch.extras.drift.stabilityanalyzer import StabilityAnalyzer
from pygsti_tpu_torch.extras.drift import probtrajectory
from pygsti_tpu_torch.extras.drift.probtrajectory import (
    ProbTrajectory, ConstantProbTrajectory, CosineProbTrajectory,
    negloglikelihood, maxlikelihood, amplitude_compression)
from pygsti_tpu_torch.extras.drift import trmodel
from pygsti_tpu_torch.extras.drift.trmodel import TimeResolvedModel
