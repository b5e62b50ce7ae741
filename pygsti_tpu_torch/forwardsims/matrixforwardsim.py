"""The module path of MatrixForwardSimulator (counterpart of
pygsti_tpu/forwardsims/matrixforwardsim.py): the matrix- and map-style
simulators are one simulator here (forwardsims/forwardsim.py)."""

from pygsti_tpu_torch.forwardsims.forwardsim import (MatrixForwardSimulator,  # noqa: F401
                                                     SimpleForwardSimulator)
