"""Locally-fluctuating-Hamiltonian (LFH) models (counterpart of
pygsti_tpu/extras/lfh/)."""

from pygsti_tpu_torch.extras.lfh.lfh import (GaussianParamFluctuation,
                                             LFHIntegratingForwardSimulator,
                                             LFHWeakForwardSimulator,
                                             LFHSigmaForwardSimulator)
