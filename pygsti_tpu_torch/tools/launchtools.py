"""Staging a protocol run for torchrun (counterpart of
pygsti_tpu/tools/launchtools.py, whose runner initializes jax.distributed).

``stage_protocol_run`` writes the protocol (pickled), its data and a
``run.py`` into a directory; launch it with

    python -m torch.distributed.run --nproc_per_node N run.py

(or ``python run.py`` alone).  Under torchrun each rank joins the process
group from torchrun's environment (NCCL with one card per rank where there
are cards, else gloo), loads the protocol and data, runs the protocol, and
rank 0 writes the results.  With ``mesh=True`` the protocol's initial model
gets a simulator on a circuit mesh over all ranks, so a GST fit shards its
circuits across them; without it every rank runs the whole protocol.
``build_slurm_script`` launches the runner with torchrun on each node.

The JAX package stages the protocol as JSON, which its GateSetTomography
cannot read back (it has no ``_from_nice_serialization``); the port pickles
it instead.
"""

from __future__ import annotations

import os
import pickle
import stat

RUNNER = '''\
#!/usr/bin/env python
"""Runner of a staged protocol (pygsti_tpu_torch.tools.launchtools):
python -m torch.distributed.run --nproc_per_node N run.py, or alone."""
import os
import pickle
from datetime import timedelta

import torch
import torch.distributed as dist

from pygsti_tpu_torch.protocols.protocol import ProtocolData

here = os.path.dirname(os.path.abspath(__file__))
device = 'cpu'
if 'WORLD_SIZE' in os.environ:
    backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    if backend == 'nccl':
        device = 'cuda:%%d' %% int(os.environ.get('LOCAL_RANK', '0'))
        torch.cuda.set_device(device)
    dist.init_process_group(backend, timeout=timedelta(seconds=1800))
elif torch.cuda.is_available():
    device = 'cuda:0'
with open(os.path.join(here, %(protocol)r), 'rb') as f:
    protocol = pickle.load(f)
if hasattr(protocol, 'device'):
    protocol.device = device
if %(mesh)r:
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.parallel.mesh import circuit_mesh
    model = protocol.initial_model.model
    model.sim = SimpleForwardSimulator(model, device, mesh=circuit_mesh())
data = ProtocolData.from_dir(os.path.join(here, %(data)r))
results = protocol.run(data, **%(run_kwargs)r)
if not dist.is_initialized() or dist.get_rank() == 0:
    os.makedirs(os.path.join(here, %(results)r), exist_ok=True)
    results.write(os.path.join(here, %(results)r))
if dist.is_initialized():
    dist.destroy_process_group()
'''


def write_torchrun_runner_artifacts(workdir, protocol_file='protocol.pkl', data_dir='data',
                                    results_dir='results', mesh=False, run_kwargs=None):
    """Write `run.py`, the runner, into `workdir` (module note); each
    collective there has 30 minutes; `run_kwargs` (literals) go to
    ``protocol.run``."""
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, 'run.py')
    with open(path, 'w') as f:
        f.write(RUNNER % {'protocol': protocol_file, 'mesh': bool(mesh), 'data': data_dir,
                          'results': results_dir, 'run_kwargs': dict(run_kwargs or {})})
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return path


def build_slurm_script(workdir, job_name='pygsti_tpu_torch', partition=None, nodes=1,
                       time_limit='04:00:00', gpus_per_node=1, extra_sbatch_lines=(),
                       python='python'):
    """A SLURM sbatch script that starts torchrun on each node, with
    `gpus_per_node` ranks each, rendezvousing at the first node."""
    lines = ['#!/bin/bash',
             '#SBATCH --job-name=%s' % job_name,
             '#SBATCH --nodes=%d' % nodes,
             '#SBATCH --ntasks-per-node=1',
             '#SBATCH --gpus-per-node=%d' % gpus_per_node,
             '#SBATCH --time=%s' % time_limit]
    if partition:
        lines.append('#SBATCH --partition=%s' % partition)
    lines.extend(extra_sbatch_lines)
    lines.extend([
        '',
        'MASTER=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1)',
        'srun %s -m torch.distributed.run --nnodes %d --nproc_per_node %d '
        '--rdzv_backend c10d --rdzv_endpoint $MASTER:29500 %s'
        % (python, nodes, gpus_per_node, os.path.join(workdir, 'run.py')),
    ])
    path = os.path.join(workdir, 'submit.sh')
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return path


def stage_protocol_run(protocol, data, workdir, slurm=False, mesh=False, run_kwargs=None,
                       **slurm_kwargs):
    """Stage `protocol` and `data` with the runner (and, with `slurm`, the
    SLURM script) in `workdir` for a batch run; returns {'runner': path
    (, 'slurm_script': path)}."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, 'protocol.pkl'), 'wb') as f:
        pickle.dump(protocol, f)
    data.write(os.path.join(workdir, 'data'))
    out = {'runner': write_torchrun_runner_artifacts(workdir, mesh=mesh, run_kwargs=run_kwargs)}
    if slurm:
        out['slurm_script'] = build_slurm_script(workdir, **slurm_kwargs)
    return out
