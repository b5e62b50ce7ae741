"""Parity benchmarking: weight-X residual TVDs and disturbances
(counterpart of pygsti_tpu/extras/paritybenchmarking/)."""

from pygsti_tpu_torch.extras.paritybenchmarking.disturbancecalc import (
    ResidualTVD, compute_residual_tvds, compute_disturbances,
    comprehensive_transition_matrix, n_parameters)
