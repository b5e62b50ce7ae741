"""Model pack: the RPE design of one Y(pi/2) gate (counterpart of
pygsti_tpu/modelpacks/smq1Q_Ypi2_rpe.py)."""

import numpy as np

from pygsti_tpu_torch.protocols import rpe as _rpe


def create_rpe_experiment_design(max_max_length, qubit_labels=None, req_counts=None):
    """The RPE design of the Gypi2 rotation angle at depths 1, 2, 4, ...,
    max_max_length: cosine circuits Gypi2^L, sine circuits one Gypi2
    more."""
    max_log = np.log2(max_max_length)
    if int(max_log) != max_log:
        raise ValueError("max_max_length must be an integer power of 2")
    if qubit_labels is not None and tuple(qubit_labels) != (0,):
        raise ValueError("this design is on qubit 0 only")
    return _rpe.RobustPhaseEstimationDesign(
        ('Gypi2', 0), [2 ** i for i in range(int(max_log) + 1)], qubit_labels=(0,),
        req_counts=req_counts, sin_prep=(), sin_meas=[('Gypi2', 0)], cos_prep=(),
        cos_meas=(), line_labels=(0,))
