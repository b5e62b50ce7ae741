"""The module path of MapForwardSimulator (counterpart of
pygsti_tpu/forwardsims/mapforwardsim.py)."""

from pygsti_tpu_torch.forwardsims.forwardsim import (MapForwardSimulator,  # noqa: F401
                                                     SimpleForwardSimulator)
