"""Forward simulators (counterpart of pygsti_tpu/forwardsims)."""

from pygsti_tpu_torch.forwardsims.forwardsim import (
    ForwardSimulator, SimpleForwardSimulator, MatrixForwardSimulator, MapForwardSimulator,
    create_forward_simulator,
)
from pygsti_tpu_torch.forwardsims.statevecsim import StateVectorForwardSimulator
from pygsti_tpu_torch.forwardsims.torchfwdsim import TorchForwardSimulator
