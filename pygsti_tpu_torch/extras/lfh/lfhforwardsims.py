"""Module path of the LFH forward simulators (counterpart of
pygsti_tpu/extras/lfh/lfhforwardsims.py); they live in lfh.py."""

from pygsti_tpu_torch.extras.lfh.lfh import (LFHIntegratingForwardSimulator,
                                             LFHWeakForwardSimulator,
                                             LFHSigmaForwardSimulator,
                                             GaussianParamFluctuation)
