"""One-call drivers (counterpart of pygsti_tpu/drivers)."""

from pygsti_tpu_torch.drivers.longsequence import (run_long_sequence_gst, run_stdpractice_gst,
                                                   run_model_test)
