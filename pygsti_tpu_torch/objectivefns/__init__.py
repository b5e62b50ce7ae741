"""Objective functions, wildcard budgets and the time-resolved objectives
(counterpart of pygsti_tpu/objectivefns)."""

from pygsti_tpu_torch.objectivefns.objectivefns import (
    RawChi2Function, RawFreqWeightedChi2Function, RawPoissonPicDeltaLogLFunction,
    RawDeltaLogLFunction, RawTVDFunction, ObjectiveFunctionBuilder,
    ModelDatasetCircuitsStore, TimeIndependentMDCObjectiveFunction,
    logl, logl_max, two_delta_logl, chi2,
)
