"""Optimizers: the Levenberg-Marquardt loops, wildcard-budget optimization
and general minimization (counterpart of pygsti_tpu/optimize)."""

from pygsti_tpu_torch.optimize.simplerlm import (
    SimplerLMOptimizer, CustomLMOptimizer, OptimizerResult, simplish_leastsq,
)
from pygsti_tpu_torch.optimize.device_lm import make_device_lm
from pygsti_tpu_torch.optimize import wildcardopt
from pygsti_tpu_torch.optimize.optimize import minimize, check_jac
