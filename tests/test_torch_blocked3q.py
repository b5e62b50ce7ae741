"""The blocked Jacobian at 3 qubits (d 64, 8 outcomes) in the port against
the JAX package: the kernel's plain version against the JAX package's
reference at the 3-qubit shapes, and one jtj_jtf and one lsvec of the
534-parameter 3-qubit cloud-noise model, whose op stack no longer fits a
block's shared memory on the card and whose Gram the port takes over the
parameters."""

import numpy as np
import pytest
import torch

from pygsti_tpu.circuits import Circuit as JCircuit
from pygsti_tpu.data.dataset import DataSet as JDataSet
from pygsti_tpu.models import cloudnoisemodel as jcnm
from pygsti_tpu.objectivefns import objectivefns as jof
from pygsti_tpu.ops.pallas_kernels import bwd_jacobian_accumulate_reference
from pygsti_tpu.processors import QubitProcessorSpec as JSpec

from pygsti_tpu_torch.algorithms.randomcircuit import create_random_circuit
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.models import cloudnoisemodel as tcnm
from pygsti_tpu_torch.objectivefns import objectivefns as tof
from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate_plain
from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec as TSpec

GATES = ['Gxpi2', 'Gypi2', 'Gcnot']


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """torch on one thread in this module, beside the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", [(3, 5, 12, 'random'), (4, 3, 12, 'out_of_range')])
def test_plain_version_at_three_qubit_shapes(case):
    """bwd_jacobian_accumulate_plain at d 64, NOUT 8, K1 12 against the JAX
    package's bwd_jacobian_accumulate_reference: 1e-12 relative."""
    B, D, K1, kind = case
    d, nout = 64, 8
    rng = np.random.RandomState(5)
    cols = rng.randint(0, K1, (B, D)).astype(np.int32)
    if kind == 'out_of_range':
        cols[0, 1], cols[2, 0] = -1, K1
    G = rng.randn(K1, d, d) / 8
    E, F = rng.randn(B, nout, d), rng.randn(B, D, d)
    A, Bf = bwd_jacobian_accumulate_plain(torch.as_tensor(cols), *(
        torch.as_tensor(x) for x in (G, E, F)))
    jA, jBf = bwd_jacobian_accumulate_reference(cols, G, E, F)
    jA, jBf = np.asarray(jA), np.asarray(jBf)
    assert A.shape == (B, nout, K1, d, d)
    assert float(np.max(np.abs(A.numpy() - jA))) <= 1e-12 * np.max(np.abs(jA))
    assert float(np.max(np.abs(Bf.numpy() - jBf))) <= 1e-12 * np.max(np.abs(jBf))


@pytest.fixture(scope='module')
def cloud3():
    """The 3-qubit cloud model of 534 parameters in both packages at a
    seeded point, and 10 circuits of depth 1-4 over two random layers of
    the port's create_random_circuit (so that the op stack stays at three
    slots: the JAX package's Gram over 8,768 tensor entries is 615 MB),
    with counts made once by numpy."""
    tspec, jspec = TSpec(3, GATES, geometry='line'), JSpec(3, GATES, geometry='line')
    kw = dict(maxhops=1, max_idle_weight=1, extra_gate_weight=1, gate_type='H+s')
    tm = tcnm.create_cloud_crosstalk_model_from_hops_and_weights(tspec, **kw)
    jm = jcnm.create_cloud_crosstalk_model_from_hops_and_weights(jspec, **kw)
    theta = 0.01 * np.random.RandomState(31).randn(tm.num_params)
    tm.from_vector(theta)
    jm.from_vector(theta)
    layers = create_random_circuit(tspec, 2, rand_state=np.random.RandomState(4)).layertup
    rng = np.random.RandomState(8)
    strs = [Circuit([layers[i] for i in rng.randint(0, 2, rng.randint(1, 5))],
                    (0, 1, 2)).str for _ in range(10)]
    probs = tm.bulk_probabilities([Circuit(s) for s in strs], device='cpu')
    tds, jds = DataSet(), JDataSet()
    for s in strs:
        p = probs[Circuit(s)]
        outcomes = list(p)
        counts = rng.multinomial(1000, np.clip([p[o] for o in outcomes], 0, None)
                                 / sum(max(p[o], 0) for o in outcomes))
        cd = {o[0]: int(c) for o, c in zip(outcomes, counts)}
        tds.add_count_dict(Circuit(s), cd)
        jds.add_count_dict(JCircuit(s), cd)
    return dict(tm=tm, jm=jm, theta=theta, strs=strs, tds=tds, jds=jds)


@pytest.mark.parametrize("name", ['chi2', 'logl'])
def test_blocked_objective_at_three_qubits(cloud3, name):
    """fn, lsvec and jtj_jtf of the 3-qubit cloud model (d 64, 8 outcomes)
    on the blocked path, port (CPU) against the JAX package (CPU): 1e-10
    relative, on the same op stack; the port's Gram goes over the 534
    parameters."""
    tm, jm, theta, strs = cloud3['tm'], cloud3['jm'], cloud3['theta'], cloud3['strs']
    assert tm.num_params == 534 and tm.dim == 64
    tobj = tof.ObjectiveFunctionBuilder(name).build(tm, cloud3['tds'],
                                                    [Circuit(s) for s in strs], device='cpu')
    jobj = jof.TimeIndependentMDCObjectiveFunction(
        jof.ObjectiveFunctionBuilder(name).build_raw(), jm, cloud3['jds'],
        [JCircuit(s) for s in strs])
    assert tobj.jac_mode == 'blocked'
    assert [str(k) for k in tm.op_keys] == [str(k) for k in jm.op_keys]
    K1 = len(tm.op_keys) + 1
    NT = (K1 - 1) * 64 * 64 + 64 + 8 * 64
    assert K1 <= 4 and NT * NT * 8 > tof.JAC_BLOCK_BYTES > 0
    assert abs(tobj.fn(theta) - jobj.fn(theta)) <= 1e-10 * abs(jobj.fn(theta))
    ls, jls = tobj.lsvec(theta), np.asarray(jobj.lsvec(theta))
    assert np.max(np.abs(ls - jls)) <= 1e-10 * np.max(np.abs(jls))
    for a, b in zip(tobj.jtj_jtf(theta), jobj.jtj_jtf(theta)):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(b))
