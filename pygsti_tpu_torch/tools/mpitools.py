"""Work-distribution utilities over torch.distributed (counterpart of
pygsti_tpu/tools/mpitools.py).

Every function has its serial semantics with ``comm=None``.  Where the JAX
package passes an mpi4py-style communicator through, the port takes a
``torch.distributed`` process group (or a ResourceAllocation, whose
``comm`` is one): broadcasts, gathers and sums go through the group's
object collectives, so they run on the CPU under gloo as on the card.
"""

from __future__ import annotations

import numpy as np


def _unwrap_comm(comm):
    """(process group or None, ResourceAllocation or None)."""
    from pygsti_tpu_torch.baseobjs.resourceallocation import ResourceAllocation
    if isinstance(comm, ResourceAllocation):
        return comm.comm, comm
    return comm, None


def _size_rank(comm):
    if comm is None:
        return 1, 0
    import torch.distributed as dist
    return dist.get_world_size(comm), dist.get_rank(comm)


def _bcast(comm, obj, root):
    """`obj` of the group's rank `root`, on every rank."""
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(comm, root), group=comm)
    return box[0]


def _allgather(comm, obj):
    """[obj of rank 0, obj of rank 1, ...] on every rank."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size(comm)
    dist.all_gather_object(out, obj, group=comm)
    return out


def _allreduce_sum(comm, x):
    """The sum over the group's ranks, added in rank order on every rank
    (so every rank holds the same value)."""
    parts = _allgather(comm, x)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def mpi4py_comm():
    """mpi4py's COMM_WORLD, or None where mpi4py is not installed."""
    try:
        from mpi4py import MPI
        return MPI.COMM_WORLD
    except ImportError:
        return None


def distribute_indices_base(indices, nprocs, rank, allow_split_comm=True):
    """Partition `indices` evenly among `nprocs` abstract processors;
    returns (loc_indices, owners, peer_ranks) for the given `rank`.  With
    more processors than indices and `allow_split_comm`, several processors
    share the same single index (the first of each group "owns" it)."""
    n = len(indices)
    if n == 0:
        return [], {}, ()
    if nprocs >= n:
        if allow_split_comm:
            nloc = nprocs // n           # procs per index (base)
            extra = nprocs - nloc * n    # first `extra` indices get nloc+1
            if rank < extra * (nloc + 1):
                k = rank // (nloc + 1)
                loc_indices = [indices[k]]
                peer_ranks = tuple(range(k * (nloc + 1), (k + 1) * (nloc + 1)))
            else:
                k = (rank - extra * (nloc + 1)) // nloc
                loc_indices = [indices[extra + k]]
                base = extra * (nloc + 1)
                peer_ranks = tuple(range(base + k * nloc, base + (k + 1) * nloc))
            owners = {indices[i]: i * (nloc + 1) for i in range(extra)}
            owners.update({indices[i]: extra * (nloc + 1) + (i - extra) * nloc
                           for i in range(extra, n)})
        else:
            loc_indices = [indices[rank]] if rank < n else []
            owners = {indices[i]: i for i in range(n)}
            peer_ranks = ()
    else:
        nloc = n // nprocs
        extra = n - nloc * nprocs
        if rank < extra:
            count, start = nloc + 1, rank * (nloc + 1)
        else:
            count, start = nloc, extra * (nloc + 1) + (rank - extra) * nloc
        loc_indices = list(indices[start:start + count])
        owners = {}
        for r in range(nprocs):
            if r < extra:
                c, s = nloc + 1, r * (nloc + 1)
            else:
                c, s = nloc, extra * (nloc + 1) + (r - extra) * nloc
            for i in range(s, s + c):
                owners[indices[i]] = r
        peer_ranks = ()
    return loc_indices, owners, peer_ranks


def _split(comm, nprocs, rank, peers_of):
    """This rank's subgroup when the group's ranks are split into the
    groups peers_of(r).  torch.distributed makes new groups collectively
    over the whole world, so `comm` must span it."""
    import torch.distributed as dist
    if nprocs != dist.get_world_size():
        raise ValueError("splitting a process group needs one that spans every rank")
    groups = sorted({tuple(dist.get_global_rank(comm, p) for p in peers_of(r))
                     for r in range(nprocs)})
    mine, _ = dist.new_subgroups_by_enumeration([list(g) for g in groups])
    return mine


def distribute_indices(indices, comm, allow_split_comm=True):
    """Partition `indices` among `comm`'s ranks; returns (loc_indices,
    owners, loc_comm), loc_comm the subgroup of the ranks that share this
    rank's index (None unless there are more ranks than indices).  Serial
    (comm=None): everything is local and loc_comm is None."""
    comm, _ = _unwrap_comm(comm)
    nprocs, rank = _size_rank(comm)
    loc_indices, owners, peer_ranks = distribute_indices_base(indices, nprocs, rank,
                                                              allow_split_comm)
    loc_comm = None
    if comm is not None and nprocs > len(indices) > 0 and allow_split_comm and peer_ranks:
        loc_comm = _split(comm, nprocs, rank, lambda r: distribute_indices_base(
            indices, nprocs, r, allow_split_comm)[2])
    return loc_indices, owners, loc_comm


def slice_up_range(n, num_slices, start=0):
    """Divide range(start, start+n) into `num_slices` contiguous slices,
    larger ones first."""
    base = n // num_slices
    m1 = n - base * num_slices
    out, off = [], start
    for _ in range(m1):
        out.append(slice(off, off + base + 1))
        off += base + 1
    for _ in range(num_slices - m1):
        out.append(slice(off, off + base))
        off += base
    return out


def slice_up_slice(slc, num_slices):
    """Divide slice `slc` (step 1) into `num_slices` contiguous sub-slices."""
    assert slc.step is None or slc.step == 1
    start = 0 if slc.start is None else slc.start
    return slice_up_range(slc.stop - start, num_slices, start)


def distribute_slice(s, comm, allow_split_comm=True):
    """Partition the contiguous slice `s` among `comm`'s ranks; returns
    (slices, loc_slice, owners, loc_comm)."""
    comm, _ = _unwrap_comm(comm)
    nprocs, rank = _size_rank(comm)
    start = 0 if s.start is None else s.start
    n = s.stop - start
    num_slices = min(nprocs, n) if n > 0 else 1
    slices = slice_up_range(n, num_slices, start)
    loc_indices, owners_by_idx, peer_ranks = distribute_indices_base(
        list(range(num_slices)), nprocs, rank, allow_split_comm)
    loc_slice = slices[loc_indices[0]] if loc_indices else slice(0, 0)
    owners = {i: owners_by_idx[i] for i in range(num_slices)}
    loc_comm = None
    if comm is not None and nprocs > num_slices and allow_split_comm and peer_ranks:
        loc_comm = _split(comm, nprocs, rank, lambda r: distribute_indices_base(
            list(range(num_slices)), nprocs, r, allow_split_comm)[2])
    return slices, loc_slice, owners, loc_comm


def _index(ar, axes, slcs):
    index = [slice(None)] * ar.ndim
    for axis, slc in zip(axes, slcs):
        index[axis] = slc
    return tuple(index)


def gather_slices(slices, slice_owners, ar_to_fill, ar_to_fill_inds, axes, comm,
                  max_buffer_size=None):
    """Gather the slices of `ar_to_fill` owned by different ranks so every
    rank holds the full array.  Serial: a no-op."""
    comm, _ = _unwrap_comm(comm)
    nprocs, rank = _size_rank(comm)
    if nprocs == 1:
        return
    axes = (axes,) if isinstance(axes, int) else tuple(axes)
    for i, slc_or_tup in enumerate(slices):
        slcs = (slc_or_tup,) if isinstance(slc_or_tup, slice) else slc_or_tup
        owner = slice_owners[i]
        index = _index(ar_to_fill, axes, slcs)
        buf = np.ascontiguousarray(ar_to_fill[index]) if rank == owner else None
        buf = _bcast(comm, buf, owner)
        if rank != owner:
            ar_to_fill[index] = buf


def gather_slices_by_owner(current_slices, ar_to_fill, ar_to_fill_inds, axes, comm,
                           max_buffer_size=None):
    """gather_slices where each rank lists the slices it owns."""
    comm, _ = _unwrap_comm(comm)
    if _size_rank(comm)[0] == 1:
        return
    axes = (axes,) if isinstance(axes, int) else tuple(axes)
    mine = []
    for slc_or_tup in current_slices:
        slcs = (slc_or_tup,) if isinstance(slc_or_tup, slice) else slc_or_tup
        mine.append((slcs, np.ascontiguousarray(ar_to_fill[_index(ar_to_fill, axes, slcs)])))
    for payload in _allgather(comm, mine):
        for slcs, data in payload:
            ar_to_fill[_index(ar_to_fill, axes, slcs)] = data


def gather_indices(indices, index_owners, ar_to_fill, ar_to_fill_inds, axes, comm,
                   max_buffer_size=None):
    """Gather per-index (fancy-indexed) pieces of `ar_to_fill` from the
    ranks that own them."""
    comm, _ = _unwrap_comm(comm)
    nprocs, rank = _size_rank(comm)
    if nprocs == 1:
        return
    axes = (axes,) if isinstance(axes, int) else tuple(axes)
    for i, ind_or_tup in enumerate(indices):
        inds = (ind_or_tup,) if not isinstance(ind_or_tup, tuple) else ind_or_tup
        owner = index_owners[i]
        index = _index(ar_to_fill, axes, inds)
        buf = np.ascontiguousarray(ar_to_fill[index]) if rank == owner else None
        buf = _bcast(comm, buf, owner)
        if rank != owner:
            ar_to_fill[index] = buf


def distribute_for_dot(a_shape, b_shape, comm):
    """Row and column slices assigning blocks of a distributed A @ B to
    each rank; returns (row_slice, col_slice, slice_tuples_by_rank)."""
    comm, _ = _unwrap_comm(comm)
    nprocs, rank = _size_rank(comm)
    if nprocs == 1:
        loc = (slice(0, a_shape[0]), slice(0, b_shape[1]))
        return loc[0], loc[1], [loc]
    nrows, ncols = a_shape[0], b_shape[1]
    ngroups_c = min(nprocs, ncols) if ncols >= nrows else \
        max(1, nprocs // max(1, min(nprocs, nrows)))
    ngroups_r = max(1, nprocs // ngroups_c)
    row_slices = slice_up_range(nrows, ngroups_r)
    col_slices = slice_up_range(ncols, ngroups_c)
    slice_tuples = [(row_slices[(r // ngroups_c) % ngroups_r], col_slices[r % ngroups_c])
                    for r in range(nprocs)]
    my_row, my_col = slice_tuples[rank]
    return my_row, my_col, slice_tuples


def mpidot(a, b, loc_row_slice, loc_col_slice, slice_tuples_by_rank, comm, out=None,
           out_shm=None):
    """Distributed matrix product: each rank computes its block, then the
    blocks are gathered.  Serial: `a @ b`."""
    comm, _ = _unwrap_comm(comm)
    nprocs, rank = _size_rank(comm)
    if nprocs == 1:
        result = np.dot(a, b)
        if out is not None:
            out[:, :] = result
            return out
        return result
    result = out if out is not None else np.zeros((a.shape[0], b.shape[1]), a.dtype)
    result[loc_row_slice, loc_col_slice] = np.dot(a[loc_row_slice, :], b[:, loc_col_slice])
    for r, (rs, cs) in enumerate(slice_tuples_by_rank):
        buf = np.ascontiguousarray(result[rs, cs]) if r == rank else None
        buf = _bcast(comm, buf, r)
        if r != rank:
            result[rs, cs] = buf
    return result


def parallel_apply(f, l, comm):
    """`f` of every element of `l`, the work spread over `comm`'s ranks;
    every rank returns the full list."""
    comm, _ = _unwrap_comm(comm)
    if _size_rank(comm)[0] == 1:
        return [f(x) for x in l]
    loc_indices, _, _ = distribute_indices(list(range(len(l))), comm, allow_split_comm=False)
    results = [None] * len(l)
    for chunk in _allgather(comm, {i: f(l[i]) for i in loc_indices}):
        for i, val in chunk.items():
            results[i] = val
    return results


def sum_across_procs(x, comm):
    """`x` summed over every rank."""
    comm, _ = _unwrap_comm(comm)
    if _size_rank(comm)[0] == 1:
        return x
    return _allreduce_sum(comm, x)


def sum_arrays(local_array, owners, comm):
    """The sum of the arrays of the ranks in `owners` (the others count as
    zeros), on every rank."""
    comm, _ = _unwrap_comm(comm)
    nprocs, rank = _size_rank(comm)
    if nprocs == 1:
        return local_array
    if rank not in owners:
        local_array = np.zeros_like(local_array)
    return _allreduce_sum(comm, np.asarray(local_array))


def processor_group_size(nprocs, number_of_tasks):
    """The number of processor groups for `number_of_tasks` tasks: the
    smallest multiple of `nprocs` >= tasks when tasks > procs, else the
    smallest divisor-product of `nprocs` >= tasks."""
    from pygsti_tpu_torch.tools.matrixtools import prime_factors
    if number_of_tasks >= nprocs:
        return nprocs * int(np.ceil(1.0 * number_of_tasks / nprocs))
    fctrs = sorted(prime_factors(nprocs))
    if int(np.ceil(number_of_tasks)) in fctrs:
        return int(np.ceil(number_of_tasks))
    i = 1
    while np.prod(fctrs[0:i]) < number_of_tasks:
        i += 1
    return int(np.prod(fctrs[0:i]))


def closest_divisor(a, b):
    """The divisor of `a` closest to `b`."""
    divisors = [d for d in range(1, a + 1) if a % d == 0]
    return min(divisors, key=lambda d: abs(d - b))


def compute_blas_threads(num_ranks, blas_threads_per_rank):
    """Total BLAS threads when launching `num_ranks` ranks with the given
    per-rank thread count."""
    import os
    if blas_threads_per_rank is not None:
        return int(num_ranks) * int(blas_threads_per_rank)
    cpus = os.cpu_count() or 1
    return max(1, cpus // max(1, num_ranks)) * num_ranks


def resolve_mpiexec(mpiexec):
    """Absolute path of an MPI launcher: 'auto' searches PATH for mpiexec,
    mpirun and mpiexec.hydra; otherwise the given name is resolved."""
    import shutil
    if mpiexec == 'auto':
        for candidate in ('mpiexec', 'mpirun', 'mpiexec.hydra'):
            found = shutil.which(candidate)
            if found is not None:
                return found
        raise FileNotFoundError("resolve_mpiexec: could not find an MPI launcher on PATH "
                                "(tried mpiexec, mpirun, mpiexec.hydra)")
    found = shutil.which(mpiexec)
    if found is None:
        raise FileNotFoundError("resolve_mpiexec: launcher %r not found on PATH" % mpiexec)
    return found


RUN_KWARGS_PICKLE_MSG = (
    "write_mpi_runner_artifacts pickles protocol.run keyword arguments "
    "into the (persistent) artifact directory; pickles are neither "
    "portable nor long-lived -- do not archive them.")


def write_mpi_runner_artifacts(protocol_obj, run_kwargs, artifact_dir, artifacts_persistent):
    """Write a protocol run into `artifact_dir` (which holds the data) for
    a launcher: the pickled protocol and run keywords and a runner
    script, which joins
    the process group torchrun describes in its environment (or runs
    alone without one) and writes the results from rank 0.  Returns the
    runner's path."""
    import pathlib
    import pickle
    import warnings
    artifact_dir = pathlib.Path(artifact_dir)
    artifact_dir.mkdir(parents=True, exist_ok=True)
    protocol_path = str(artifact_dir / 'protocol.pkl')
    with open(protocol_path, 'wb') as f:
        pickle.dump(protocol_obj, f)
    if artifacts_persistent:
        warnings.warn(RUN_KWARGS_PICKLE_MSG, UserWarning)
    else:
        run_kwargs.setdefault('disable_checkpointing', True)
    kwargs_path = artifact_dir / 'volatile_run_kwargs.pkl'
    with open(kwargs_path, 'wb') as f:
        pickle.dump(run_kwargs, f)
    runner_path = str(artifact_dir / 'mpi_runner.py')
    runner_script = (
        "import os, pickle\n"
        "import torch.distributed as dist\n"
        "from pygsti_tpu_torch.io.readers import read_data_from_dir\n"
        "if 'WORLD_SIZE' in os.environ:\n"
        "    dist.init_process_group('gloo')\n"
        "data = read_data_from_dir(%r)\n"
        "with open(%r, 'rb') as _f:\n"
        "    protocol = pickle.load(_f)\n"
        "with open(%r, 'rb') as _f:\n"
        "    _kwargs = pickle.load(_f)\n"
        "results = protocol.run(data, **_kwargs)\n"
        "if not dist.is_initialized() or dist.get_rank() == 0:\n"
        "    results.write(%r)\n"
        "if dist.is_initialized():\n"
        "    dist.destroy_process_group()\n"
        % (str(artifact_dir), protocol_path, str(kwargs_path), str(artifact_dir)))
    with open(runner_path, 'w') as f:
        f.write(runner_script)
    return runner_path


def build_slurm_script(*, job_name, nodes, ntasks_per_node, cpus_per_task, runner_path,
                       script_path='submit.sh', time=None, partition=None,
                       output='slurm-%j.out', error='slurm-%j.err', max_host_procs=None):
    """A SLURM sbatch script launching the runner with torchrun on each
    node, with BLAS thread counts matching cpus_per_task."""
    def directive(flag, value):
        return "#SBATCH %s=%s" % (flag, value) if value is not None else "#"

    lines = [
        "#!/bin/bash",
        "#",
        "# SLURM batch script generated by pygsti_tpu_torch",
        "# Protocol: %s" % job_name,
        "# Submit with:  sbatch %s" % script_path,
        "#",
        "#SBATCH --job-name=%s" % job_name,
        "#SBATCH --nodes=%d" % nodes,
        "#SBATCH --ntasks-per-node=1",
        "#SBATCH --cpus-per-task=%d" % (cpus_per_task * ntasks_per_node),
        directive("--time", time),
        directive("--partition", partition),
        "#SBATCH --output=%s" % output,
        "#SBATCH --error=%s" % error,
        "",
        "export OMP_NUM_THREADS=%d" % cpus_per_task,
        "export OPENBLAS_NUM_THREADS=%d" % cpus_per_task,
        "export MKL_NUM_THREADS=%d" % cpus_per_task,
        "export NUMEXPR_NUM_THREADS=%d" % cpus_per_task,
        "",
    ]
    if max_host_procs is not None:
        lines.append("export PYGSTI_MAX_HOST_PROCS=%d" % max_host_procs)
        lines.append("")
    lines.append('MASTER=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1)')
    lines.append("srun python -m torch.distributed.run --nnodes %d --nproc_per_node %d "
                 "--rdzv_backend c10d --rdzv_endpoint $MASTER:29500 %s"
                 % (nodes, ntasks_per_node, runner_path))
    return "\n".join(lines) + "\n"
