"""Parallelism: device meshes over torch.distributed (counterpart of
pygsti_tpu/parallel)."""

from pygsti_tpu_torch.parallel.mesh import (circuit_mesh, grid_mesh, shard_circuits, replicated,
                                            pad_to_multiple, ResourceAllocation)
