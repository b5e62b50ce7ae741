"""The module path of DistributableForwardSimulator (counterpart of
pygsti_tpu/forwardsims/distforwardsim.py): distribution is a mesh over
torch.distributed on the simulator (``sim.mesh``, parallel/mesh.py)."""

from pygsti_tpu_torch.forwardsims.forwardsim import DistributableForwardSimulator  # noqa: F401
