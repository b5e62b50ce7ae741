"""Config-driven robust phase estimation (counterpart of pygsti_tpu/extras/rpe/)."""

from pygsti_tpu_torch.extras.rpe.rpeconfig import RPEconfig
from pygsti_tpu_torch.extras.rpe.rpeconfig_gxpi2_gypi2_00 import rpeconfig_gxpi2_gypi2_00
from pygsti_tpu_torch.extras.rpe import rpetools
from pygsti_tpu_torch.extras.rpe import rpeconstruction
