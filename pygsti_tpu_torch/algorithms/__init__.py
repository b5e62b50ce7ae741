"""Algorithms: LGST, iterative GST, gauge optimization, germ and fiducial
selection, RB sampling and fitting, RPE, contraction (counterpart of
pygsti_tpu/algorithms)."""

from pygsti_tpu_torch.algorithms.core import (
    run_lgst, run_gst_fit, run_gst_fit_simple, iterative_gst_generator,
    run_iterative_gst,
)
from pygsti_tpu_torch.algorithms.gaugeopt import gaugeopt_to_target
from pygsti_tpu_torch.algorithms.germselection import (
    find_germs, test_germs_list_completeness, compute_composite_germ_set_score,
)
from pygsti_tpu_torch.algorithms.fiducialselection import (
    find_fiducials, test_fiducial_list, compute_composite_fiducial_score,
)
from pygsti_tpu_torch.algorithms.fiducialpairreduction import (
    find_sufficient_fiducial_pairs, find_sufficient_fiducial_pairs_per_germ,
    find_sufficient_fiducial_pairs_per_germ_greedy,
    find_sufficient_fiducial_pairs_per_germ_power,
)
from pygsti_tpu_torch.algorithms.contract import contract
from pygsti_tpu_torch.algorithms.robust_phase_estimation import RobustPhaseEstimation
from pygsti_tpu_torch.algorithms import scoring
from pygsti_tpu_torch.algorithms import grasp
