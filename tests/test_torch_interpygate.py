"""The port's extras/interpygate against the JAX package's: the
InterpolatedDenseOp's dense form and its forward-mode derivative (Tv)
against ``jax.jacfwd``, inside models (tensors, Tv, probabilities), its
serialization and convert.interpolated_model, a 1-qubit interpolated-gate
GST fit in both packages on the same counts, the factory, the physical
process classes and InterpolatedQuantityFactory, with the cases of
tests/test_interpygate.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygsti_tpu.extras import interpygate as ji
from pygsti_tpu.modelpacks import smq1Q_XYI as jmp
from pygsti_tpu.circuits import Circuit as JCircuit

from pygsti_tpu_torch import convert
from pygsti_tpu_torch.extras import interpygate as ti
from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
from pygsti_tpu_torch.circuits import Circuit
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel
from pygsti_tpu_torch.modelpacks import smq1Q_XYI as tmp
from pygsti_tpu_torch.tools.optools import unitary_to_pauligate

SX = np.array([[0, 1], [1, 0]], dtype=complex)
SY = np.array([[0, -1j], [1j, 0]])
SZ = np.diag([1.0, -1.0]).astype(complex)
THETAS = np.linspace(np.pi / 2 - 0.1, np.pi / 2 + 0.1, 11)
PHIS = np.linspace(-0.1, 0.1, 11)


def _ptm(axis, theta, phi, depol=0.01):
    """A rotation by theta about `axis` tilted by phi toward Z, then
    depolarization."""
    h = np.cos(phi) * axis + np.sin(phi) * SZ
    u = np.cos(theta / 2) * np.eye(2) - 1j * np.sin(theta / 2) * h
    return np.diag([1.0] + [1 - depol] * 3) @ np.real(unitary_to_pauligate(u))


def _samples(axis):
    return np.stack([np.stack([_ptm(axis, t, p) for p in PHIS]) for t in THETAS])


@pytest.fixture(scope='module')
def grids():
    rng = np.random.RandomState(7)
    axes = [np.linspace(0, 1, 5), np.sort(rng.uniform(-1, 1, 4)), np.array([0.0, 0.3, 1.0])]
    return axes, rng.randn(5, 4, 3, 4, 4)


POINTS = [[0.31, 0.2, 0.5], [0.25, -0.05, 0.3], [1.7, -3.0, 0.99], [0.5, 0.11, -2.0]]


@pytest.mark.parametrize("point", range(len(POINTS)))
def test_dense_and_tv_match_jax(grids, point):
    """The dense form and d dense / d v within 1e-12 of the JAX package's
    at points inside cells, on an interior node (the cell above it) and
    outside the hull (clipped: no derivative)."""
    axes, samples = grids
    v = POINTS[point]
    j, t = ji.InterpolatedDenseOp(axes, samples, v), ti.InterpolatedDenseOp(axes, samples, v)
    assert np.max(np.abs(t.dense() - np.asarray(j.to_dense()))) < 1e-12
    jj = np.asarray(jax.jacfwd(j.to_dense_jax)(jnp.asarray(v)))
    tj = torch.func.jacfwd(t.to_dense)(torch.tensor(v, dtype=torch.float64)).numpy()
    assert np.max(np.abs(tj - jj)) < 1e-12


def test_derivative_on_the_hull_is_the_first_cells_slope(grids):
    """On the hull's first node the port's derivative is the first cell's
    slope; jnp.clip's derivative there is 1/2, so the JAX package's is half
    of it."""
    axes, samples = grids
    v = [0.0, 0.1, 0.5]
    t = ti.InterpolatedDenseOp(axes, samples, v)
    tj = torch.func.jacfwd(t.to_dense)(torch.tensor(v, dtype=torch.float64)).numpy()
    inside = torch.func.jacfwd(t.to_dense)(torch.tensor([0.1, 0.1, 0.5],
                                                         dtype=torch.float64)).numpy()
    assert np.max(np.abs(tj[..., 0] - inside[..., 0])) < 1e-12
    jj = np.asarray(jax.jacfwd(ji.InterpolatedDenseOp(axes, samples, v).to_dense_jax)(
        jnp.asarray(v)))
    assert np.max(np.abs(jj[..., 0] - 0.5 * tj[..., 0])) < 1e-12


def test_batched_and_float32(grids):
    axes, samples = grids
    t = ti.InterpolatedDenseOp(axes, samples)
    V = torch.tensor(POINTS, dtype=torch.float64)
    batched = torch.vmap(t.to_dense)(V)
    for k, v in enumerate(POINTS):
        assert torch.equal(batched[k], t.to_dense(V[k]))
    f32 = t.to_dense(V[0].float())
    assert f32.dtype == torch.float32
    assert float((f32.double() - batched[0]).abs().max()) < 1e-5
    np.testing.assert_array_equal(t.to_vector(), [0.5, 0.5 * (axes[1][0] + axes[1][-1]), 0.5])


def test_refuses_bad_grids(grids):
    axes, samples = grids
    with pytest.raises(ValueError):
        ti.InterpolatedDenseOp(axes, samples[:4])
    with pytest.raises(ValueError):
        ti.InterpolatedDenseOp([axes[0][::-1]] + axes[1:], samples)


def test_interpolation_accuracy():
    """tests/test_interpygate.py's case: an X rotation sampled at 41 angles
    interpolates within 1e-3, and its derivative is nonzero."""
    thetas = np.linspace(0, np.pi, 41)
    samples = np.stack([_ptm(SX, t, 0.0, 0.0) for t in thetas])
    op = ti.InterpolatedDenseOp([thetas], samples, [np.pi / 3])
    assert np.max(np.abs(op.dense() - _ptm(SX, np.pi / 3, 0.0, 0.0))) < 1e-3
    g = torch.func.jacfwd(op.to_dense)(torch.tensor([1.0], dtype=torch.float64))
    assert float(torch.linalg.norm(g)) > 0.1


def _models(point_x, point_y):
    """smq1Q_XYI 'static' in both packages with Gxpi2:0 and Gypi2:0
    interpolated over (theta, phi) grids at the given points."""
    j, t = jmp.target_model('static'), tmp.target_model('static')
    for name, axis, pt in (('Gxpi2', SX, point_x), ('Gypi2', SY, point_y)):
        s = _samples(axis)
        j.operations[(name, 0)] = ji.InterpolatedDenseOp([THETAS, PHIS], s, pt)
        t.operations[Label(name, 0)] = ti.InterpolatedDenseOp([THETAS, PHIS], s, pt)
    return j, t


CIRCUIT_STRS = ['Gxpi2:0@(0)', 'Gypi2:0Gxpi2:0@(0)', 'Gxpi2:0Gxpi2:0Gypi2:0@(0)',
                'Gypi2:0Gypi2:0Gypi2:0Gxpi2:0@(0)', '{}@(0)']


def test_model_tensors_tv_and_probabilities_match_jax():
    j, t = _models([np.pi / 2 + 0.013, 0.004], [np.pi / 2 - 0.006, -0.017])
    assert t.num_params == j.num_params == 4
    np.testing.assert_array_equal(t.to_vector(), np.asarray(j.to_vector()))
    jp = j.sim.bulk_probs([JCircuit(s) for s in CIRCUIT_STRS])
    tp = SimpleForwardSimulator(t, 'cpu').bulk_probs([Circuit(s) for s in CIRCUIT_STRS])
    for s in CIRCUIT_STRS:
        for o, p in jp[JCircuit(s)].items():
            assert abs(tp[Circuit(s)][o] - p) < 1e-12
    v = torch.as_tensor(t.to_vector(), dtype=torch.float64)
    Tv = t.flat_tensors_jacobian_fn()(v)
    J = torch.func.jacfwd(t.flat_tensors_fn())(v)
    assert float((Tv - J).abs().max()) < 1e-12
    # central differences inside the cell: the interpolation is linear there
    eps = 1e-7
    fd = torch.stack([(t.flat_tensors_fn()(v + eps * e) - t.flat_tensors_fn()(v - eps * e))
                      / (2 * eps) for e in torch.eye(4, dtype=torch.float64)], dim=1)
    assert float((Tv - fd).abs().max()) < 1e-7


def test_serialization_and_convert():
    j, t = _models([np.pi / 2 + 0.002, -0.03], [np.pi / 2 + 0.05, 0.061])
    op = t.operations[Label('Gxpi2', 0)]
    back = NicelySerializable.from_nice_serialization(op.to_nice_serialization())
    assert isinstance(back, ti.InterpolatedDenseOp)
    np.testing.assert_array_equal(back.dense(), op.dense())
    np.testing.assert_array_equal(back.to_vector(), op.to_vector())
    m2 = ExplicitOpModel.from_nice_serialization(t.to_nice_serialization())
    np.testing.assert_array_equal(m2.to_vector(), t.to_vector())
    # the port's model from the JAX model's arrays
    conv = convert.interpolated_model(tmp.target_model('static'), {
        str(lbl): (o.grid_axes, o.samples, np.asarray(o.to_vector()))
        for lbl, o in j.operations.items() if isinstance(o, ji.InterpolatedDenseOp)})
    np.testing.assert_array_equal(conv.to_vector(), np.asarray(j.to_vector()))
    for lbl in (Label('Gxpi2', 0), Label('Gypi2', 0)):
        assert np.max(np.abs(conv.operations[lbl].dense() - t.operations[lbl].dense())) == 0
    with pytest.raises(KeyError):
        convert.interpolated_model(tmp.target_model('static'), {'Gzz:0': (None, None, None)})


def test_no_gauge_transform_as_in_jax():
    j, t = _models([np.pi / 2, 0.0], [np.pi / 2, 0.0])
    s = np.eye(4)
    with pytest.raises(NotImplementedError):
        j.operations[('Gxpi2', 0)].transform_inplace(s, s)
    with pytest.raises(NotImplementedError):
        t.operations[Label('Gxpi2', 0)].transform_inplace(s, s)


def test_factory_matches_jax():
    samples = _samples(SX)
    jf = ji.InterpolatedOpFactory([THETAS, PHIS], samples)
    tf = ti.InterpolatedOpFactory([THETAS, PHIS], samples)
    for args in ((np.pi / 2 + 0.03, 0.01), None):
        a, b = jf.create_op(args), tf.create_op(args)
        assert np.max(np.abs(b.dense() - np.asarray(a.to_dense()))) < 1e-12


def test_physical_processes_and_interpolated_quantity_match_jax():
    class JP(ji.core.PhysicalProcess):
        pass
    with pytest.raises(NotImplementedError):
        ti.core.PhysicalProcess(1, (4, 4)).create_process_matrix([0.0])
    with pytest.raises(NotImplementedError):
        ti.core.PhysicalErrorGenerator(1, (4, 4)).create_errorgen_matrix([0.0])
    _, t = _models([np.pi / 2 + 0.01, 0.02], [np.pi / 2, 0.0])
    op = t.operations[Label('Gxpi2', 0)]
    proc = ti.core.OpPhysicalProcess(op)
    assert proc.num_params == 2 and proc.item_shape == (4, 4)
    np.testing.assert_allclose(proc.create_process_matrix([np.pi / 2 - 0.02, 0.05]),
                               _ptm(SX, np.pi / 2 - 0.02, 0.05), atol=2e-4)

    def fn(a, b=None):
        x = a if b is None else a + 0.5 * b
        return np.array([[np.cos(x), np.sin(x) * x], [x ** 2, 1.0]])
    for ranges in ([(0.0, 1.0, 9)], [(0.0, 1.0, 5), (-1.0, 1.0, 4)]):
        jq = ji.core.InterpolatedQuantityFactory(fn, (2, 2), parameter_ranges=ranges).build()
        tq = ti.core.InterpolatedQuantityFactory(fn, (2, 2), parameter_ranges=ranges).build()
        for v in ([0.37] if len(ranges) == 1 else [0.37, -0.2], [r[0] for r in ranges]):
            np.testing.assert_allclose(tq(v), jq(v), rtol=0, atol=1e-12)
        assert tq.num_params == len(ranges) and tq.qty_shape == (2, 2)
        with pytest.raises(ValueError):
            tq([5.0] * len(ranges))
    with pytest.raises(ValueError):
        ti.core.InterpolatedQuantityFactory(fn, (2, 2))


@pytest.fixture(scope='module')
def interp_fits():
    """A 1-qubit GST fit of the interpolated model (4 physical parameters)
    at maxL [1, 2] in both packages on the same counts, from the grid's
    midpoint, the truth at off-node points, 2,000 shots."""
    from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
    from pygsti_tpu.data import simulate_data as j_simulate
    from pygsti_tpu.protocols.gst import (GateSetTomography as JGST,
                                          GateSetTomographyDesign as JDesign,
                                          GSTInitialModel as JInit)
    from pygsti_tpu.protocols.protocol import ProtocolData as JData
    from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
    from pygsti_tpu_torch.protocols.gst import (GateSetTomography as TGST,
                                                GateSetTomographyDesign as TDesign,
                                                GSTInitialModel as TInit)
    from pygsti_tpu_torch.protocols.protocol import ProtocolData as TData
    truth, _ = _models([np.pi / 2 + 0.012, 0.006], [np.pi / 2 - 0.007, -0.013])
    jm, tm = _models([np.pi / 2, 0.0], [np.pi / 2, 0.0])
    jlists = j_lists(jm, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), [1, 2])
    tlists = t_lists(tm, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), [1, 2])
    jds = j_simulate(truth, list(jlists[-1]), 2000, seed=1234)
    tds = DataSet()
    for a, b in zip(jlists[-1], tlists[-1]):
        tds.add_count_dict(b, dict(jds[a].counts))
    jr = JGST(JInit(model=jm), gaugeopt_suite=None, verbosity=0).run(
        JData(JDesign(jm, jlists), jds), disable_checkpointing=True)
    tr = TGST(TInit(model=tm), gaugeopt_suite=None, verbosity=0, device='cpu').run(
        TData(TDesign(tm, tlists), tds), disable_checkpointing=True)
    return (jr.estimates['GateSetTomography'], tr.estimates['GateSetTomography'],
            list(jlists[-1]), jds, truth)


def test_interpolated_fit_reaches_the_jax_optimum(interp_fits):
    """2*DeltaLogL within 1e-3 (scored by the JAX package's objective), the
    parameters within 1e-5 and near the truth."""
    from pygsti_tpu.objectivefns import objectivefns as jof
    jest, test, jc, jds, truth = interp_fits
    jm, tm = jest.models['final iteration estimate'], test.models['final iteration estimate']
    port_in_jax = jm.copy()
    port_in_jax.from_vector(tm.to_vector())
    assert abs(jof.two_delta_logl(port_in_jax, jds, jc) - jof.two_delta_logl(jm, jds, jc)) < 1e-3
    assert np.max(np.abs(tm.to_vector() - np.asarray(jm.to_vector()))) < 1e-5
    assert np.max(np.abs(tm.to_vector() - np.asarray(truth.to_vector()))) < 0.01
    assert abs(test.misfit_sigma() - jest.misfit_sigma()) < 1e-3
