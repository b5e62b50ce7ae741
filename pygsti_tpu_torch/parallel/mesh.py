"""Device meshes over torch.distributed (counterpart of
pygsti_tpu/parallel/mesh.py).

The JAX package is one controller over many devices: a ``jax.sharding``
mesh shards the circuit axis and XLA inserts the collectives.  The port is
SPMD: every rank runs the same program on its own device, inside a
``torch.distributed`` process group that the caller initializes (address,
world size and rank).  A mesh is a ``DeviceMesh`` with the axis
'circuits', or the axes ('circuits', 'params'):

* each rank simulates its shard of the circuits (``circuit_shard``);
* the probabilities and residuals are gathered, so every rank holds all
  of them, and J^T J, J^T f are summed over 'circuits', so every rank
  holds them whole;
* on a grid, each rank pushes its block of the parameters' forward
  tangents, and the blocks are gathered over 'params'.

Every rank then takes the same Levenberg-Marquardt steps.  A mesh without
an initialized process group raises: nothing falls back to a serial run.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _require_process_group():
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh needs an initialized torch.distributed process group: "
                           "call torch.distributed.init_process_group with its address, "
                           "world size and rank on every rank first")


def _mesh(device_type, shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    _require_process_group()
    need = int(np.prod(shape))
    if need != dist.get_world_size():
        raise ValueError("the mesh needs %d ranks; the process group has %d"
                         % (need, dist.get_world_size()))
    if device_type is None:
        device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return DeviceMesh(device_type, torch.arange(need).reshape(shape), mesh_dim_names=names)


def circuit_mesh(n_devices=None, device_type=None):
    """1-D mesh over the circuit axis, one rank per device (all ranks of
    the process group; `n_devices`, when given, must equal their number).
    `device_type` defaults to 'cuda' under NCCL, else 'cpu'."""
    _require_process_group()
    n = dist.get_world_size() if n_devices is None else n_devices
    return _mesh(device_type, (n,), ('circuits',))


def grid_mesh(n_circuit_devices, n_param_devices, device_type=None):
    """2-D ('circuits', 'params') mesh: the circuit axis sharded over
    'circuits', the parameters' forward tangents over 'params'."""
    return _mesh(device_type, (n_circuit_devices, n_param_devices), ('circuits', 'params'))


def _axis(mesh, name):
    """(process group or None, size, this rank's coordinate) along `name`."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None, 1, 0
    dim = mesh.mesh_dim_names.index(name)
    return mesh.get_group(dim), mesh.size(dim), mesh.get_local_rank(dim)


def param_axis_size(mesh):
    """Number of ranks along 'params' (1 for a 1-D mesh)."""
    return _axis(mesh, 'params')[1]


def slice_bounds(n, num_slices):
    """Bounds [(start, stop), ...] of `num_slices` contiguous slices of
    range(n), larger ones first."""
    base, extra = divmod(n, num_slices)
    sizes = [base + 1] * extra + [base] * (num_slices - extra)
    stops = np.cumsum(sizes)
    return [(int(b - s), int(b)) for s, b in zip(sizes, stops)]


def circuit_shard(mesh, n_circuits):
    """(c0, c1, all bounds) of this rank's circuits along 'circuits'."""
    _, size, coord = _axis(mesh, 'circuits')
    bounds = slice_bounds(n_circuits, size)
    return bounds[coord][0], bounds[coord][1], bounds


def param_shard(mesh, n_params):
    """(j0, j1, all bounds) of this rank's parameter block along 'params'."""
    _, size, coord = _axis(mesh, 'params')
    bounds = slice_bounds(n_params, size)
    return bounds[coord][0], bounds[coord][1], bounds


def shard_circuits(mesh, arr, axis_name='circuits'):
    """This rank's slice of `arr` along its leading axis."""
    _, size, coord = _axis(mesh, axis_name)
    a, b = slice_bounds(len(arr), size)[coord]
    return arr[a:b]


def replicated(mesh, arr):
    """`arr` as a tensor on this rank's device: every rank holds it whole."""
    dev = torch.device('cuda', torch.cuda.current_device()) \
        if mesh.device_type == 'cuda' else torch.device('cpu')
    return torch.as_tensor(np.asarray(arr) if not torch.is_tensor(arr) else arr, device=dev)


def pad_to_multiple(n, k):
    """Smallest multiple of k that is >= n."""
    return ((n + k - 1) // k) * k


def gather_along(mesh, name, local, sizes, dim=0):
    """Concatenation along `dim` of every rank's `local` over the mesh axis
    `name`, rank by rank, where rank i holds sizes[i] entries there."""
    group, size, _ = _axis(mesh, name)
    if group is None:
        return local
    local = local.contiguous()
    width = max(sizes)
    pad = [0, 0] * (local.dim() - 1 - dim) + [0, width - local.shape[dim]]
    buf = torch.nn.functional.pad(local, pad) if width > local.shape[dim] else local
    parts = [torch.empty_like(buf) for _ in range(size)]
    dist.all_gather(parts, buf, group=group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim=dim)


def sum_along(mesh, name, *tensors):
    """Each tensor summed over the mesh axis `name` (in place)."""
    group = _axis(mesh, name)[0]
    if group is not None:
        for t in tensors:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return tensors


class ResourceAllocation(object):
    """The JAX package's ResourceAllocation: a process group (`comm`; the
    default group when one is initialized and `comm` is None), a memory
    limit and an optional mesh.  Rank and size come from the group."""

    @classmethod
    def cast(cls, obj):
        if isinstance(obj, cls):
            return obj
        return cls(comm=obj)

    def __init__(self, comm=None, mem_limit=None, profiler=None, distribute_method="default",
                 mesh=None):
        if comm is None and dist.is_available() and dist.is_initialized():
            comm = dist.group.WORLD
        self.comm = comm
        self.mem_limit = mem_limit
        self.profiler = profiler
        self.distribute_method = distribute_method
        self.mesh = mesh

    @property
    def comm_rank(self):
        return 0 if self.comm is None else dist.get_rank(self.comm)

    @property
    def comm_size(self):
        return 1 if self.comm is None else dist.get_world_size(self.comm)

    def is_host_leader(self):
        return self.comm_rank == 0
