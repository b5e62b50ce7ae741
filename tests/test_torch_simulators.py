"""The port's simulator base class and the last Jacobian mode against the
JAX package: dprobs and the exact Hessians (hprobs, bulk_hprobs,
bulk_fill_hprobs), the fill signatures, create_forward_simulator,
Model.sim and simulator=, the aliases, TorchForwardSimulator, and the
'prodjac' Jacobian (tests/test_jacmode_consistency.py's setup) with a GST
fit through it."""

import warnings

import numpy as np
import pytest
import torch

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.forwardsims import forwardsim as jfs
from pygsti_tpu.forwardsims.torchfwdsim import TorchForwardSimulator as JTorchSim
from pygsti_tpu.objectivefns import objectivefns as jof
from pygsti_tpu.protocols import gst as jgst
from pygsti_tpu.protocols.protocol import ProtocolData as JProtocolData

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.forwardsims import forwardsim as tfs
from pygsti_tpu_torch.forwardsims.torchfwdsim import StatelessModel, TorchForwardSimulator
from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel
from pygsti_tpu_torch.models.modelconstruction import create_crosstalk_free_model
from pygsti_tpu_torch.objectivefns import objectivefns as tof
from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec
from pygsti_tpu_torch.protocols import gst as tgst
from pygsti_tpu_torch.protocols.protocol import ProtocolData as TProtocolData


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(b)))


@pytest.fixture(scope='module')
def models():
    """A depolarized smq1Q_XYI 'full TP' model in both packages, a port
    simulator of it on the CPU, and a few circuits of the design."""
    jm = jmp.target_model('full TP').depolarize(op_noise=0.03, spam_noise=0.01)
    tm = tmp.target_model('full TP')
    tm.from_vector(jm.to_vector())
    jc = list(j_lists(jm, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), [1, 2])[-1])
    tc = list(t_lists(tm, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), [1, 2])[-1])
    return jm, tm, jc[5:11], tc[5:11], tfs.SimpleForwardSimulator(tm, 'cpu')


def _same_dicts(td, jd, tol):
    assert [str(k) for k in td] == [str(k) for k in jd]
    for a, b in zip(td.values(), jd.values()):
        if isinstance(a, dict):
            _same_dicts(a, b, tol)
        else:
            scale = max(np.max(np.abs(b)), 1e-300)
            assert np.max(np.abs(np.asarray(a) - np.asarray(b))) <= tol * scale


@pytest.fixture(scope='module')
def jax_hessians(models):
    """The JAX package's bulk_fill_hprobs of the circuits, as its hprobs
    and bulk_hprobs dicts (each of the three takes the same
    jax.jacfwd(jax.jacrev) of the probabilities, op by op: seconds each)."""
    jm, tm, jc, tc, sim = models
    jlay = jm.sim.create_layout(jc)
    H = jm.sim.bulk_fill_hprobs(None, jlay)
    return H, {c: {o: H[jlay.element_slices[i].start + k]
                   for k, o in enumerate(jlay.outcomes[i])} for i, c in enumerate(jc)}


@pytest.mark.parametrize("which", ['dprobs', 'bulk_dprobs', 'hprobs', 'bulk_hprobs'])
def test_derivatives_match_jax(models, jax_hessians, which):
    """dprobs, bulk_dprobs and the exact Hessians within 1e-10 of the
    largest entry of the JAX package's."""
    jm, tm, jc, tc, sim = models
    jax_of = {'dprobs': lambda: jm.sim.dprobs(jc[3]), 'bulk_dprobs': lambda: jm.sim.bulk_dprobs(jc),
              'hprobs': lambda: jax_hessians[1][jc[3]], 'bulk_hprobs': lambda: jax_hessians[1]}
    t = getattr(sim, which)(tc if which.startswith('bulk') else tc[3])
    _same_dicts(t, jax_of[which](), 1e-10)


def test_fill_signatures_match_jax(models, jax_hessians):
    """bulk_fill_probs / dprobs / hprobs with and without arrays to fill,
    the extra arrays included; the Hessians symmetric."""
    jm, tm, jc, tc, sim = models
    tlay, jlay = sim.create_layout(tc), jm.sim.create_layout(jc)
    E, P = tlay.num_elements, tm.num_params
    p, dp, pr = np.zeros(E), np.zeros((E, P)), np.zeros(E)
    assert sim.bulk_fill_probs(p, tlay) is not p
    assert _rel(p, jm.sim.bulk_fill_probs(None, jlay)) < 1e-13
    sim.bulk_fill_dprobs(dp, tlay, pr_array_to_fill=pr)
    assert np.array_equal(pr, p)
    assert _rel(dp, jm.sim.bulk_fill_dprobs(None, jlay)) < 1e-10
    H, d1, d2, pr2 = np.zeros((E, P, P)), np.zeros((E, P)), np.zeros((E, P)), np.zeros(E)
    Hr = sim.bulk_fill_hprobs(H, tlay, pr2, d1, d2)
    assert np.array_equal(H, Hr) and np.array_equal(pr2, p)
    assert np.array_equal(d1, dp) and np.array_equal(d2, dp)
    assert _rel(H, jax_hessians[0]) < 1e-10
    assert np.max(np.abs(H - H.transpose(0, 2, 1))) < 1e-13


def test_probs_time_and_clip_as_jax(models):
    """probs(time=...) raises as the JAX package's does; clip_to clips;
    outcomes restricts; bulk_probs takes clip_to."""
    jm, tm, jc, tc, sim = models
    with pytest.raises(NotImplementedError):
        jm.sim.probs(jc[0], time=0.5)
    with pytest.raises(NotImplementedError, match='time'):
        sim.probs(tc[0], time=0.5)
    t, j = sim.probs(tc[0], clip_to=(0.1, 0.5)), jm.sim.probs(jc[0], clip_to=(0.1, 0.5))
    _same_dicts(t, j, 1e-13)
    assert max(t.values()) <= 0.5
    assert list(sim.probs(tc[0], outcomes=['1']).keys()) == [('1',)]
    _same_dicts(sim.bulk_probs(tc, clip_to=(0.2, 0.8)),
                jm.sim.bulk_probs(jc, clip_to=(0.2, 0.8)), 1e-13)


def test_create_forward_simulator_and_model_sim(models):
    """create_forward_simulator by name and by instance; Model.sim, its
    setter and simulator=; a copy gets a fresh simulator of the same type
    and settings; the objective takes the one set, on its own device
    only, and builds the default otherwise."""
    jm, tm, jc, tc, sim = models
    for name in ('auto', 'map', 'matrix', 'dense'):
        assert type(tfs.create_forward_simulator(name, tm)) is tfs.SimpleForwardSimulator
        assert type(jfs.create_forward_simulator(name, jm)) is jfs.SimpleForwardSimulator
    with pytest.raises(ValueError):
        tfs.create_forward_simulator('chp', tm)
    m = tm.copy()
    assert m.user_sim is None and type(m.sim) is tfs.SimpleForwardSimulator
    mine = tfs.MatrixForwardSimulator(None, 'cpu', probs_kernel='fact')
    assert tfs.create_forward_simulator(mine, m) is mine and mine.model is m
    m.sim = mine
    assert m.sim is mine and m.user_sim is mine
    c = m.copy()
    assert type(c.sim) is tfs.MatrixForwardSimulator and c.sim is not mine
    assert c.sim.model is c and c.sim.probs_kernel == 'fact' and c.sim.device == mine.device
    made = ExplicitOpModel(4, 'pp', 'full TP', simulator=mine)
    assert made.sim is mine and mine.model is made
    with pytest.raises(ValueError):
        ExplicitOpModel(4, 'pp', simulator='chp')
    pspec = QubitProcessorSpec(1, ['Gxpi2', 'Gypi2'])
    ln = create_crosstalk_free_model(pspec, simulator=tfs.SimpleForwardSimulator(None, 'cpu'))
    assert ln.sim.model is ln and ln.copy().sim.model is not ln
    ds = DataSet()
    for ckt in tc:
        ds.add_count_dict(ckt, {('0',): 40, ('1',): 60})
    obj = tof.ObjectiveFunctionBuilder('logl').build(c, ds, tc, device='cpu')
    assert obj.sim is c.sim
    assert type(tof.ObjectiveFunctionBuilder('logl').build(tm, ds, tc, device='cpu').sim) \
        is tfs.SimpleForwardSimulator
    with pytest.raises(ValueError, match='simulator runs on'):
        tof.ObjectiveFunctionBuilder('logl').build(c, ds, tc, device='meta')


def test_aliases_and_map_warning(models, monkeypatch):
    """The aliases are SimpleForwardSimulators; MapForwardSimulator warns
    once on max_cache_size/num_atoms; CacheForwardSimulator's layouts
    carry a per-circuit cache; the alias modules re-export them."""
    jm, tm, jc, tc, sim = models
    from pygsti_tpu_torch.forwardsims import distforwardsim, mapforwardsim, matrixforwardsim
    from pygsti_tpu_torch.models import explicitcalc
    from pygsti_tpu_torch.models.nongauge import compute_nongauge_and_gauge_spaces
    assert explicitcalc.compute_nongauge_and_gauge_spaces is compute_nongauge_and_gauge_spaces
    assert mapforwardsim.MapForwardSimulator is tfs.MapForwardSimulator
    assert matrixforwardsim.MatrixForwardSimulator is tfs.MatrixForwardSimulator
    assert distforwardsim.DistributableForwardSimulator is tfs.DistributableForwardSimulator
    for cls in (tfs.MatrixForwardSimulator, tfs.MapForwardSimulator,
                tfs.DistributableForwardSimulator, tfs.CacheForwardSimulator):
        assert issubclass(cls, tfs.SimpleForwardSimulator)
    monkeypatch.setattr(tfs.MapForwardSimulator, '_tuning_warned', False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        tfs.MapForwardSimulator(tm, max_cache_size=10, device='cpu')
        tfs.MapForwardSimulator(tm, num_atoms=2, device='cpu')
    assert len(caught) == 1 and 'ignored' in str(caught[0].message)
    lay = tfs.CacheForwardSimulator(tm, 'cpu').create_layout(tc)
    assert list(lay.cache) == tc
    assert tfs.DistributableForwardSimulator(tm, device='cpu').mesh is None


def test_torch_forward_simulator_matches_jax(models):
    """TorchForwardSimulator's probabilities and autograd Jacobian against
    the JAX package's TorchForwardSimulator within 1e-10."""
    jm, tm, jc, tc, sim = models
    tsim, jsim = TorchForwardSimulator(tm, 'cpu'), JTorchSim(jm)
    tlay, jlay = tsim.create_layout(tc), jsim.create_layout(jc)
    assert _rel(tsim.bulk_fill_probs(None, tlay), jsim.bulk_fill_probs(None, jlay)) < 1e-10
    pr = np.zeros(tlay.num_elements)
    assert _rel(tsim.bulk_fill_dprobs(None, tlay, pr), jsim.bulk_fill_dprobs(None, jlay)) < 1e-10
    slm = StatelessModel(tm, tlay, 'cpu')
    free = slm.get_free_params()
    assert free.requires_grad
    slm.circuit_probs(free).sum().backward()
    assert torch.allclose(free.grad, torch.as_tensor(sim.bulk_fill_dprobs(None, tlay).sum(0)),
                          atol=1e-12)


@pytest.fixture(scope='module')
def jac_setup():
    """tests/test_jacmode_consistency.py's setup (maxL 4, 500 shots, seed
    5) in both packages, on one dataset, at a point off the near-ties."""
    jt, tt = jmp.target_model('full TP'), tmp.target_model('full TP')
    jgen = jt.copy().depolarize(op_noise=0.03, spam_noise=0.01)
    jc = list(j_lists(jt, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), [1, 2, 4])[-1])
    tc = list(t_lists(tt, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), [1, 2, 4])[-1])
    jds = j_simulate(jgen, jc, 500, seed=5)
    tds = DataSet()
    for a, b in zip(jc, tc):
        tds.add_count_dict(b, dict(jds[a].counts))
    v = jgen.to_vector()
    # a point where no frequency lies within 1e-4 of its probability: at
    # a tie the logL's signed square root keeps few digits
    rng = np.random.RandomState(3)
    while True:
        m = tt.copy()
        m.from_vector(v)
        p = tfs.SimpleForwardSimulator(m, 'cpu').bulk_fill_probs(None,
                                                                 m.sim.create_layout(tc))
        freqs = np.concatenate([[tds[c].counts.get(o, 0) / tds[c].total for o in outs]
                                for c, outs in zip(tc, m.sim.create_layout(tc).outcomes)])
        if np.min(np.abs(freqs - p)) > 1e-4:
            break
        v = v + 1e-3 * rng.randn(len(v))
    return jt, tt, jc, tc, jds, tds, v


def test_prodjac_matches_jax_and_blocked(jac_setup, monkeypatch):
    """'prodjac' lsvec, J^T J, J^T f and dlsvec against the JAX package's
    'prodjac' and the port's 'blocked', at the JAX test's tolerances
    relative to the largest entry (1e-9, 1e-8, 1e-10, 1e-7); j_dtype, the
    group size and the chunking change nothing beyond them."""
    jt, tt, jc, tc, jds, tds, v = jac_setup
    monkeypatch.setenv('PYGSTI_TPU_JAC_MODE', 'prodjac')
    jobj = jof.TimeIndependentMDCObjectiveFunction(
        jof.RawPoissonPicDeltaLogLFunction({'min_prob_clip': 1e-4, 'radius': 1e-4}),
        jmp.target_model('full TP'), jds, jc)
    assert jobj._fns['jac_mode'] == 'prodjac'
    monkeypatch.delenv('PYGSTI_TPU_JAC_MODE')
    jres = jobj.jtj_jtf(v) + (jobj.dlsvec(v),)

    def port(mode, **kw):
        obj = tof.ObjectiveFunctionBuilder('logl', jac_mode=mode, **kw).build(
            tt.copy(), tds, tc, device='cpu')
        assert obj.jac_mode == mode
        return obj.jtj_jtf(v) + (obj.dlsvec(v),)

    tols = (1e-9, 1e-8, 1e-10, 1e-7)
    prod, blocked = port('prodjac'), port('blocked')
    for ref in (jres, blocked):
        for a, b, tol in zip(prod, ref, tols):
            assert a.shape == b.shape and _rel(a, b) < tol
    for a, b, tol in zip(port('prodjac', j_dtype='float64', prodjac_group=5, prodjac_chunk=7),
                         prod, tols):
        assert _rel(a, b) < tol


def test_prodjac_gst_fit_reaches_the_jax_optimum(jac_setup, monkeypatch):
    """A smq1Q_XYI GST fit through 'prodjac' (chi2 stages, then logL, no
    gauge optimization) in both packages: the final 2DeltaLogL within 1e-3
    relative, the per-circuit probabilities within 1e-4."""
    jt, tt, jc, tc, jds, tds, v = jac_setup
    jl = j_lists(jt, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), [1, 2, 4])
    tl = t_lists(tt, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), [1, 2, 4])
    monkeypatch.setenv('PYGSTI_TPU_JAC_MODE', 'prodjac')
    jest = jgst.GateSetTomography(jgst.GSTInitialModel(model=jt.copy()), gaugeopt_suite=None,
                                  verbosity=0).run(
        JProtocolData(jgst.GateSetTomographyDesign(jt, jl), jds),
        disable_checkpointing=True).estimates['GateSetTomography']
    monkeypatch.delenv('PYGSTI_TPU_JAC_MODE')
    builders = tgst.GSTObjFnBuilders(
        [tof.ObjectiveFunctionBuilder('chi2', jac_mode='prodjac')],
        [tof.ObjectiveFunctionBuilder('logl', jac_mode='prodjac')])
    test_ = tgst.GateSetTomography(tgst.GSTInitialModel(model=tt.copy()), gaugeopt_suite=None,
                                   objfn_builders=builders, verbosity=0, device='cpu').run(
        TProtocolData(tgst.GateSetTomographyDesign(tt, tl), tds),
        disable_checkpointing=True).estimates['GateSetTomography']
    assert np.isclose(test_.parameters['final_objfn_value'], jest.parameters['final_objfn_value'],
                      rtol=1e-3)
    tfit, jfit = test_.models['final iteration estimate'], jest.models['final iteration estimate']
    tp = tfs.SimpleForwardSimulator(tfit, 'cpu').bulk_fill_probs(None, tfit.sim.create_layout(tc))
    jp = jfit.sim.bulk_fill_probs(None, jfit.sim.create_layout(jc))
    assert np.max(np.abs(tp - jp)) < 1e-4
