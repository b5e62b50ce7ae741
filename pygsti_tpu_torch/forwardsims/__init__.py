"""Forward simulators (counterpart of pygsti_tpu/forwardsims).  The JAX
package's simulator base class and its aliases (ForwardSimulator,
MatrixForwardSimulator, MapForwardSimulator, create_forward_simulator,
TorchForwardSimulator) are not ported yet (ROADMAP.md queue 1, item 9)."""

from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.forwardsims.statevecsim import StateVectorForwardSimulator
