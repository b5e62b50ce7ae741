"""Serial equals sharded: the port's mesh over torch.distributed on the CPU
(gloo), the contract of the JAX package's tests/test_multidevice.py.

Each test starts its ranks as processes of their own (WORKER below), which
join one gloo process group over a loopback address with a 60 s timeout
and write their results to a file; the test holds them to the port's
serial objective, computed here.  A rank that does not end within its
deadline is killed and the test fails, so a hung collective costs seconds.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as mp
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists
from pygsti_tpu_torch.data.datasetconstruction import simulate_data
from pygsti_tpu_torch.objectivefns.objectivefns import (RawPoissonPicDeltaLogLFunction,
                                                         TimeIndependentMDCObjectiveFunction)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 120

# one rank: argv = rank, world size, port, case, output file
WORKER = r'''
import pickle, sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
port, case, out = sys.argv[3:6]
dist.init_process_group('gloo', init_method='tcp://127.0.0.1:' + port, rank=rank,
                        world_size=world, timeout=timedelta(seconds=60))
import pygsti_tpu_torch.modelpacks.smq1Q_XYI as mp
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists
from pygsti_tpu_torch.data.datasetconstruction import simulate_data
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.layouts.layout import CircuitOutcomeProbabilityLayout
from pygsti_tpu_torch.objectivefns.objectivefns import (RawPoissonPicDeltaLogLFunction,
                                                         TimeIndependentMDCObjectiveFunction,
                                                         choose_jac_mode)
from pygsti_tpu_torch.parallel.mesh import circuit_mesh, grid_mesh
from pygsti_tpu_torch.tools import mpitools, sharedmemtools

target = mp.target_model('full TP')
circuits = list(create_lsgst_circuit_lists(target, mp.prep_fiducials(), mp.meas_fiducials(),
                                           mp.germs(), [1, 2])[-1])
ds = simulate_data(target.copy().depolarize(op_noise=0.02, spam_noise=0.01), circuits, 1000,
                   seed=7, device='cpu')
v = target.to_vector()
res = {}
mesh = circuit_mesh() if case == 'circuits' else grid_mesh(2, 2)
for n in ((64, 63) if case == 'circuits' else (64,)):
    model = target.copy()
    layout = CircuitOutcomeProbabilityLayout(circuits[:n], model, ds, pad_to_multiple=2)
    model.sim = SimpleForwardSimulator(model, 'cpu', mesh=mesh)
    obj = TimeIndependentMDCObjectiveFunction(RawPoissonPicDeltaLogLFunction(), model, ds,
                                              circuits[:n], layout=layout, device='cpu')
    lm = obj.run_device_lm(v, maxiter=3 if case == 'circuits' else 4,
                           solver=None if case == 'circuits' else 'cg')
    res[n] = {'probs': obj.probs(v), 'lsvec': obj.lsvec(v), 'dlsvec': obj.dlsvec(v),
              'jtj_jtf': obj.jtj_jtf(v), 'jac_mode': obj.jac_mode, 'lm': lm[:7],
              'fill': model.sim.bulk_fill_probs(None, layout),
              'n_real': layout.num_real_circuits, 'n_circuits': len(layout.circuits)}
    try:
        choose_jac_mode(layout, 'blocked', mesh)
        res['blocked_refused'] = False
    except ValueError:
        res['blocked_refused'] = True
if case == 'circuits':
    comm = dist.group.WORLD
    loc, owners, loc_comm = mpitools.distribute_indices(list(range(5)), comm)
    ar = np.zeros((5, 3))
    for i in loc:
        ar[i] = i + 1
    mpitools.gather_indices(list(range(5)), [owners[i] for i in range(5)], ar, None, 0, comm)
    slices, loc_slice, sowners, _ = mpitools.distribute_slice(slice(0, 7), comm)
    ar2 = np.zeros(7)
    ar2[loc_slice] = np.arange(7)[loc_slice] * 2.0
    mpitools.gather_slices(slices, sowners, ar2, None, 0, comm)
    _, _, split_comm = mpitools.distribute_indices([0], comm)
    a = np.arange(12.0).reshape(3, 4)
    b = np.arange(20.0).reshape(4, 5)
    rs, cs, tuples = mpitools.distribute_for_dot(a.shape, b.shape, comm)
    sh, handle = sharedmemtools.create_shared_ndarray(None, (2, 2), 'd', zero_out=True)
    res['mpitools'] = {
        'loc': loc, 'gathered': ar, 'slices': ar2,
        'split_size': dist.get_world_size(split_comm),
        'sum': mpitools.sum_across_procs(rank + 1.0, comm),
        'sum_arrays': mpitools.sum_arrays(np.full(3, rank + 1.0), {0}, comm),
        'apply': mpitools.parallel_apply(lambda x: x * x, list(range(5)), comm),
        'dot': mpitools.mpidot(a, b, rs, cs, tuples, comm),
        'shared': (sh.tolist(), handle, sharedmemtools.shared_mem_is_enabled())}
if rank == 0:
    with open(out, 'wb') as f:
        pickle.dump(res, f)
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1')
    env.pop('JAX_PLATFORMS', None)
    return env


def _spawn(world, case, tmp_path):
    """Run WORKER on `world` ranks; rank 0's results, or fail (killing
    every rank) at the deadline."""
    out = str(tmp_path / ('%s.pkl' % case))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, '-c', WORKER, str(r), str(world), port, case,
                               out], env=_env(), cwd=str(tmp_path),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=DEADLINE_S)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    with open(out, 'rb') as f:
        return pickle.load(f)


@pytest.fixture(scope='module')
def serial():
    """The serial objective's values of the workers' cases."""
    target = mp.target_model('full TP')
    circuits = list(create_lsgst_circuit_lists(target, mp.prep_fiducials(), mp.meas_fiducials(),
                                               mp.germs(), [1, 2])[-1])
    ds = simulate_data(target.copy().depolarize(op_noise=0.02, spam_noise=0.01), circuits,
                       1000, seed=7, device='cpu')
    v = target.to_vector()
    out = {}
    for n in (64, 63):
        obj = TimeIndependentMDCObjectiveFunction(RawPoissonPicDeltaLogLFunction(),
                                                  target.copy(), ds, circuits[:n],
                                                  device='cpu')
        out[n] = {'probs': obj.probs(v), 'lsvec': obj.lsvec(v), 'dlsvec': obj.dlsvec(v),
                  'jtj_jtf': obj.jtj_jtf(v), 'lm3': obj.run_device_lm(v, maxiter=3)[:7],
                  'lm4': obj.run_device_lm(v, maxiter=4)[:7]}
    return out


def _hold(sharded, ser, lm, lm_tol):
    """Serial == sharded at the JAX test's tolerances; the padded tail of
    a padded layout contributes nothing."""
    n_el = len(ser['probs'])
    np.testing.assert_allclose(sharded['probs'][:n_el], ser['probs'], atol=1e-14)
    np.testing.assert_allclose(sharded['fill'][:n_el], ser['probs'], atol=1e-14)
    np.testing.assert_allclose(sharded['lsvec'][:n_el], ser['lsvec'], atol=1e-12)
    assert np.all(sharded['lsvec'][n_el:] == 0.0)
    np.testing.assert_allclose(sharded['dlsvec'][:n_el], ser['dlsvec'], rtol=1e-9, atol=1e-9)
    _, jtj_s, jtf_s = ser['jtj_jtf']
    _, jtj_m, jtf_m = sharded['jtj_jtf']
    np.testing.assert_allclose(jtf_m, jtf_s, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(jtj_m, jtj_s, rtol=1e-9, atol=1e-12 * np.max(np.abs(jtj_s)))
    x_s, conv_s, nf_s = lm[0], lm[1], lm[5]
    x_m, conv_m, nf_m = sharded['lm'][0], sharded['lm'][1], sharded['lm'][5]
    assert conv_s and conv_m
    np.testing.assert_allclose(x_m, x_s, rtol=lm_tol[0], atol=lm_tol[1])
    np.testing.assert_allclose(nf_m, nf_s, rtol=lm_tol[2])


def test_serial_eq_sharded_two_ranks_even_and_padded(serial, tmp_path):
    """Two ranks on a 'circuits' mesh, at an even batch (64 circuits) and
    a padded one (63, padded to 64): probabilities, lsvec, dlsvec, J^T J,
    J^T f and 3 LM iterations equal the serial ones; the mesh objective is
    'linearize' and refuses 'blocked'; mpitools and sharedmemtools over
    the same group."""
    res = _spawn(2, 'circuits', tmp_path)
    for n in (64, 63):
        assert res[n]['jac_mode'] == 'linearize'
        assert (res[n]['n_real'], res[n]['n_circuits']) == (n, 64)
        _hold(res[n], serial[n], serial[n]['lm3'], (1e-7, 1e-9, 1e-9))
    assert res['blocked_refused']
    m = res['mpitools']
    assert m['loc'] == [0, 1, 2]
    np.testing.assert_array_equal(m['gathered'], np.arange(1, 6)[:, None] * np.ones((1, 3)))
    np.testing.assert_array_equal(m['slices'], np.arange(7) * 2.0)
    assert m['split_size'] == 2 and m['sum'] == 3.0 and m['apply'] == [0, 1, 4, 9, 16]
    np.testing.assert_array_equal(m['sum_arrays'], np.ones(3))
    np.testing.assert_array_equal(m['dot'], np.arange(12.0).reshape(3, 4)
                                  @ np.arange(20.0).reshape(4, 5))
    assert m['shared'] == ([[0.0, 0.0], [0.0, 0.0]], None, False)


def test_serial_eq_grid_two_by_two_with_cg(serial, tmp_path):
    """Four ranks on a 2 x 2 ('circuits', 'params') grid: the tangents
    split over 'params'; the values equal the serial ones, and 4 LM
    iterations with the CG solve land where the serial Cholesky ones do
    (the JAX test's tolerances)."""
    res = _spawn(4, 'grid', tmp_path)
    assert res[64]['jac_mode'] == 'linearize'
    _hold(res[64], serial[64], serial[64]['lm4'], (1e-6, 1e-8, 1e-8))


def test_mesh_without_a_process_group_raises():
    from pygsti_tpu_torch.parallel.mesh import ResourceAllocation, circuit_mesh
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match='process group'):
        circuit_mesh()
    ra = ResourceAllocation()
    assert (ra.comm, ra.comm_rank, ra.comm_size, ra.is_host_leader()) == (None, 0, 1, True)
    from pygsti_tpu_torch.tools import mpitools
    assert mpitools.mpi4py_comm() is None
    assert mpitools.distribute_indices(list(range(4)), None) == ([0, 1, 2, 3],
                                                                 {i: 0 for i in range(4)}, None)
    assert mpitools.sum_across_procs(2.5, ra) == 2.5


def test_staged_run_under_torchrun_equals_serial(tmp_path):
    """stage_protocol_run's run.py under ``python -m torch.distributed.run
    --nproc_per_node 2`` with a circuit mesh: rank 0's results (a 1-qubit
    GST fit to maxL 2) equal a serial run of the same protocol."""
    import pygsti_tpu_torch.io.readers as readers
    from pygsti_tpu_torch.protocols.gst import (GateSetTomography, GateSetTomographyDesign,
                                                GSTInitialModel)
    from pygsti_tpu_torch.protocols.protocol import ProtocolData
    target = mp.target_model('full TP')
    lists = create_lsgst_circuit_lists(target, mp.prep_fiducials(), mp.meas_fiducials(),
                                       mp.germs(), [1, 2])
    ds = simulate_data(target.copy().depolarize(op_noise=0.02, spam_noise=0.01),
                       list(lists[-1]), 1000, seed=7, device='cpu')
    data = ProtocolData(GateSetTomographyDesign(target, lists), ds)
    gst = GateSetTomography(GSTInitialModel(model=target.copy()), gaugeopt_suite=None,
                            device='cpu')
    staged = gst.run_mpi(data, str(tmp_path / 'run'), mesh=True,
                         run_kwargs={'disable_checkpointing': True})
    assert 'slurm_script' not in staged
    assert 'torch.distributed.run' in open(gst.stage_slurm(
        data, str(tmp_path / 'slurm'), nodes=2, gpus_per_node=4)['slurm_script']).read()
    proc = subprocess.run([sys.executable, '-m', 'torch.distributed.run', '--nnodes', '1',
                           '--nproc_per_node', '2', '--master_addr', '127.0.0.1',
                           '--master_port', str(_free_port()), staged['runner']],
                          env=_env(), cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=DEADLINE_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    est = readers.read_results_from_dir(str(tmp_path / 'run' / 'results'),
                                        'GateSetTomography').estimates['GateSetTomography']
    ref = gst.run(data, disable_checkpointing=True).estimates['GateSetTomography']
    a = est.models['final iteration estimate'].to_vector()
    b = ref.models['final iteration estimate'].to_vector()
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(est.parameters['final_objfn_value'],
                               ref.parameters['final_objfn_value'], rtol=1e-8)
