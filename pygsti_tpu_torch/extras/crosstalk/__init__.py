"""Crosstalk detection: PC-algorithm causal discovery + pairwise
conditional-independence tests (counterpart of pygsti_tpu/extras/crosstalk/)."""

from pygsti_tpu_torch.extras.crosstalk.core import (do_basic_crosstalk_detection,
                                                    do_pairwise_crosstalk_detection,
                                                    do_crosstalk_detection_on_dataset,
                                                    form_ct_data_matrix,
                                                    form_ct_data_tuples,
                                                    tuples_to_data_matrix,
                                                    crosstalk_detection_experiment,
                                                    PairwiseCrosstalkResults)
from pygsti_tpu_torch.extras.crosstalk.objects import CrosstalkResults
from pygsti_tpu_torch.extras.crosstalk import pcalg
