"""The module path of ResourceAllocation (counterpart of
pygsti_tpu/baseobjs/resourceallocation.py): the class is
parallel/mesh.py's, which carries a torch.distributed process group."""

from pygsti_tpu_torch.parallel.mesh import ResourceAllocation  # noqa: F401
