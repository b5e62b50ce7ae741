"""Interpolated gates: continuously parameterized operations built from
sampled (physics-simulation) process matrices (counterpart of
pygsti_tpu/extras/interpygate/)."""

from pygsti_tpu_torch.extras.interpygate.core import (InterpolatedDenseOp,
                                                      InterpolatedOpFactory)
from pygsti_tpu_torch.extras.interpygate.process_tomography import (
    run_process_tomography, multi_kron)
