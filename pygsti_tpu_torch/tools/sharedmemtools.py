"""Shared-memory array helpers (counterpart of
pygsti_tpu/tools/sharedmemtools.py).

The reference shares large numpy work arrays between the MPI ranks of one
host through POSIX shared memory.  Here each rank holds its own tensors on
its own device and exchanges them through torch.distributed, so nothing
is shared: the helpers keep the calling convention with plain ndarrays
(shared_mem_is_enabled() is False, as in the JAX package)."""

import numpy as _np


class LocalNumpyArray(_np.ndarray):
    """ndarray carrying the host-array and shared-memory attributes the
    reference attaches; here they are always None."""

    def __new__(cls, *args, **kwargs):
        host_array = kwargs.pop('host_array', None)
        slices_into_host_array = kwargs.pop('slices_into_host_array', None)
        shared_memory_handle = kwargs.pop('shared_memory_handle', None)
        obj = super().__new__(cls, *args, **kwargs)
        obj.host_array = host_array
        obj.slices_into_host_array = slices_into_host_array
        obj.shared_memory_handle = shared_memory_handle
        return obj

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.host_array = getattr(obj, 'host_array', None)
        self.slices_into_host_array = getattr(obj, 'slices_into_host_array', None)
        self.shared_memory_handle = getattr(obj, 'shared_memory_handle', None)


def shared_mem_is_enabled():
    """False: ranks share no host memory here."""
    return False


def create_shared_ndarray(resource_alloc, shape, dtype, zero_out=False, memory_tracker=None):
    """A plain ndarray and no shared-memory handle: (array, None)."""
    if memory_tracker is not None and hasattr(memory_tracker, 'add_tracked_memory'):
        memory_tracker.add_tracked_memory(int(_np.prod(shape)))
    ar = _np.zeros(shape, dtype) if zero_out else _np.empty(shape, dtype)
    return ar, None


def cleanup_shared_ndarray(shm):
    """Close and unlink a shared-memory handle; arrays of
    create_shared_ndarray carry none."""
    if shm is not None:
        shm.close()
        shm.unlink()
