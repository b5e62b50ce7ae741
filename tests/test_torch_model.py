"""The port's host layers and model against the JAX package's: circuit lists,
member dense forms, tensors_fn and the parameter conversion."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp1
import pygsti_tpu.modelpacks.smq2Q_XYICNOT as jmp2
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp1
import pygsti_tpu_torch.modelpacks.smq2Q_XYICNOT as tmp2
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.convert import model_from_dense, model_from_vector

PACKS = {'1Q': (jmp1, tmp1), '2Q': (jmp2, tmp2)}


@pytest.mark.parametrize("pack", sorted(PACKS))
def test_circuit_lists_equal(pack):
    """Nested lists at maxL <= 4: the same circuits in the same order,
    with the same strings."""
    jmp, tmp = PACKS[pack]
    jl = j_lists(jmp.target_model('full'), jmp.prep_fiducials(),
                 jmp.meas_fiducials(), jmp.germs(), [1, 2, 4])
    tl = t_lists(tmp.target_model('full'), tmp.prep_fiducials(),
                 tmp.meas_fiducials(), tmp.germs(), [1, 2, 4])
    assert [len(x) for x in jl] == [len(x) for x in tl]
    for a, b in zip(jl, tl):
        assert [c.str for c in a] == [c.str for c in b]
        assert [tuple(str(l) for l in c.layertup) for c in a] == \
            [tuple(str(l) for l in c.layertup) for c in b]
        assert [c.line_labels for c in a] == [c.line_labels for c in b]


@pytest.mark.parametrize("s", ["{}@(0,1)", "Gxpi2:0Gypi2:1@(0,1)",
                               "(Gxpi2:0Gypi2:0)^2@(0)", "[]@(0,1)",
                               "Gcnot:0:1^3Gxpi2:1@(0,1)", "[Gxpi2:0Gypi2:1]"])
def test_parser_round_trip(s):
    """A parsed circuit, its string, and its layers re-parsed agree."""
    c = Circuit(s)
    assert Circuit(c.str) == c
    rebuilt = Circuit(c.layertup, c.line_labels)
    assert rebuilt == c and Circuit(rebuilt.str) == c


def _check_members(jm, tm):
    """Each member's torch to_dense of its own slice equals the JAX
    member's dense form within 1e-14 (the same arithmetic, all exact
    copies or one subtraction)."""
    v = torch.as_tensor(tm.to_vector())
    for jd, td in ((jm.preps, tm.preps), (jm.povms, tm.povms),
                   (jm.operations, tm.operations)):
        assert [str(k) for k in jd.keys()] == [str(k) for k in td.keys()]
        for (_, jobj), (_, tobj) in zip(jd.items(), td.items()):
            assert type(jobj).__name__ == type(tobj).__name__
            dense = tobj.to_dense(v[tobj.gpindices]).numpy()
            assert np.max(np.abs(dense - np.asarray(jobj.to_dense()))) < 1e-14


@pytest.mark.parametrize("pack,gate_type", [(p, g) for p in sorted(PACKS)
                                            for g in ('full', 'full TP')])
def test_member_dense_and_param_order(pack, gate_type):
    jmp, tmp = PACKS[pack]
    jm = jmp.target_model(gate_type).depolarize(op_noise=0.03, spam_noise=0.02)
    tm = tmp.target_model(gate_type).depolarize(op_noise=0.03, spam_noise=0.02)
    assert tm.num_params == jm.num_params
    assert np.max(np.abs(tm.to_vector() - jm.to_vector())) < 1e-14
    _check_members(jm, tm)


@pytest.mark.parametrize("name", ["Gxpi2", "Gypi2", "Gcnot"])
def test_static_standard_op(name):
    """The static ops of a named gate: the same superoperator as the JAX
    package's within 1e-14, and constant under to_dense."""
    from pygsti_tpu.modelmembers.operations import StaticStandardOp as JOp
    from pygsti_tpu_torch.modelmembers.operations import StaticStandardOp as TOp
    op = TOp(name)
    assert op.num_params == 0
    dense = op.to_dense(torch.zeros(0, dtype=torch.float64)).numpy()
    assert np.max(np.abs(dense - JOp(name).to_dense())) < 1e-14


def _tensors(model, theta):
    t = model.tensors_fn()(torch.as_tensor(theta))
    return [x.numpy() for x in (t.ops, t.preps, t.effects)]


@pytest.mark.parametrize("pack,gate_type", [('1Q', 'full TP'), ('2Q', 'full')])
def test_tensors_fn_and_convert(pack, gate_type):
    """tensors_fn at a random theta, and the port's models rebuilt by
    convert.py from the JAX model's vector and from its dense members, all
    within 1e-14 of the JAX package's tensors_fn."""
    jmp, tmp = PACKS[pack]
    jm = jmp.target_model(gate_type)
    rng = np.random.RandomState(7)
    theta = jm.to_vector() + 0.01 * rng.randn(jm.num_params)
    jt = jm.tensors_fn()(theta)
    ref = [np.asarray(x) for x in (jt.ops, jt.preps, jt.effects)]

    from_vec = model_from_vector(tmp.target_model(gate_type), theta)
    jm.from_vector(theta)
    from_dense = model_from_dense(
        {str(k): o.to_dense() for k, o in jm.operations.items()},
        {str(k): p.to_dense() for k, p in jm.preps.items()},
        {str(k): dict(p.items()) for k, p in jm.povms.items()},
        gate_type=gate_type)
    assert np.max(np.abs(from_dense.to_vector() - theta)) < 1e-14
    for model in (from_vec, from_dense):
        for a, b in zip(_tensors(model, model.to_vector()), ref):
            assert a.shape == b.shape
            assert np.max(np.abs(a - b)) < 1e-14


def test_port_imports_no_jax(tmp_path):
    """Every module of the port loads, and a checkpoint the JAX package
    wrote reads back, in a process that ends with neither JAX nor
    pygsti_tpu imported."""
    from pygsti_tpu.protocols.gst import GateSetTomographyCheckpoint as JCheckpoint
    jm = jmp1.target_model('full TP').depolarize(op_noise=0.02)
    path = str(tmp_path / 'jax_iteration_0.json')
    JCheckpoint([jm], 0, jmp1.germs()[:3], None, 'GateSetTomography').write(path)
    code = ("import sys, importlib, json, pkgutil, pygsti_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(pygsti_tpu_torch.__path__,\n"
            "                                                'pygsti_tpu_torch.')]\n"
            "for name in names: importlib.import_module(name)\n"
            "assert 'pygsti_tpu_torch.protocols.gst' in names and len(names) > 80, names\n"
            "for new in ('tools.lindbladtools', 'tools.jamiolkowski', 'baseobjs.errorgenlabel',\n"
            "            'modelmembers.instruments', 'modelpacks.legacy.std1Q_XYI',\n"
            "            'modelpacks.legacy.std2Q_XYZICNOT', 'modelpacks.legacy.std1Q_Cliffords',\n"
            "            'modelpacks.legacy.stdQT_XYIMS', 'models.qutrit', 'baseobjs.qubitgraph',\n"
            "            'processors.processorspec', 'processors.compilationrules',\n"
            "            'algorithms.robust_phase_estimation', 'protocols.rpe',\n"
            "            'modelpacks.smq1Q_Xpi2_rpe', 'modelpacks.smq1Q_Ypi2_rpe',\n"
            "            'extras.rpe.rpeconfig', 'extras.rpe.rpeconfig_gxpi2_gypi2_00',\n"
            "            'extras.rpe.rpeconstruction', 'extras.rpe.rpetools',\n"
            "            'optimize.customlm', 'optimize.simplerlm'):\n"
            "    assert 'pygsti_tpu_torch.' + new in names, new\n"
            "from pygsti_tpu_torch.protocols.gst import GateSetTomographyCheckpoint\n"
            "ck = GateSetTomographyCheckpoint.read(%r)\n"
            "assert type(ck.mdl_list[0]).__module__ == 'pygsti_tpu_torch.models.explicitmodel'\n"
            "print(json.dumps(ck.mdl_list[0].to_vector().tolist()))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pygsti_tpu')]\n"
            "assert not bad, bad\n" % path)
    out = subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                         capture_output=True, text=True).stdout
    assert np.array_equal(np.array(json.loads(out.strip().splitlines()[-1])), jm.to_vector())


def test_implicit_model_modules_import_no_jax():
    """The modules of the implicit-model slice load, and a 2-qubit cloud
    model simulates, in a process that ends with neither JAX nor
    pygsti_tpu imported."""
    new = ('baseobjs.statespace', 'modelmembers.opfactory', 'models.modelnoise',
           'models.stencillabel', 'models.layerrules', 'models.implicitmodel',
           'models.memberdict', 'models.localnoisemodel', 'models.cloudnoisemodel',
           'circuits.cloudcircuitconstruction', 'protocols.modeltest',
           'forwardsims.statevecsim', 'data.freedataset', 'protocols.freeformsim')
    code = ("import sys, importlib\n"
            "for name in %r:\n"
            "    importlib.import_module('pygsti_tpu_torch.' + name)\n"
            "from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec\n"
            "from pygsti_tpu_torch.models.modelconstruction import "
            "create_cloud_crosstalk_model_from_hops_and_weights as cc\n"
            "from pygsti_tpu_torch.circuits.circuit import Circuit\n"
            "m = cc(QubitProcessorSpec(2, ['Gxpi2', 'Gcnot'], geometry='line'), maxhops=1)\n"
            "p = m.probabilities(Circuit('Gxpi2:0Gcnot:0:1@(0,1)'), device='cpu')\n"
            "assert abs(sum(p.values()) - 1) < 1e-12, p\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pygsti_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n" % (new,))
    out = subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                         capture_output=True, text=True).stdout
    assert out.strip().splitlines()[-1] == 'ok'


def test_statistics_modules_import_no_jax():
    """The modules of the error-bar and bad-fit slice load, and a batched
    water-fill runs, in a process that ends with neither JAX nor
    pygsti_tpu imported."""
    new = ('tools.optools', 'tools.sdptools', 'models.nongauge', 'tools.likelihoodfns',
           'tools.chi2fns', 'protocols.confidenceregionfactory', 'protocols.estimate',
           'objectivefns.wildcardbudget', 'optimize.wildcardopt', 'protocols.gst',
           'tools.edesigntools')
    code = ("import sys, importlib\n"
            "for name in %r:\n"
            "    importlib.import_module('pygsti_tpu_torch.' + name)\n"
            "from pygsti_tpu_torch.objectivefns.wildcardbudget import _waterfill\n"
            "p = _waterfill([0.7, 0.3], [0.5, 0.5], 0.1)\n"
            "assert abs(p[0] - 0.6) < 1e-15 and abs(p[1] - 0.4) < 1e-15, p\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pygsti_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n" % (new,))
    out = subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                         capture_output=True, text=True).stdout
    assert out.strip().splitlines()[-1] == 'ok'


def test_selection_modules_import_no_jax():
    """The modules of the design-selection and error-generator-propagation
    slice load, and a 1-qubit germ search and a propagation run, in a
    process that ends with neither JAX nor pygsti_tpu imported."""
    new = ('tools.argchecks', 'algorithms.scoring', 'algorithms.grasp',
           'algorithms.germselection', 'algorithms.fiducialselection',
           'algorithms.fiducialpairreduction', 'algorithms.grammatrix', 'algorithms.contract',
           'algorithms._svdworker', 'circuits.gstcircuits', 'tools.errgenalgebra',
           'errorgenpropagation',
           'errorgenpropagation.errorpropagator', 'tools.errgenproptools',
           'models.modelconstruction')
    code = ("import sys, importlib\n"
            "for name in %r:\n"
            "    importlib.import_module('pygsti_tpu_torch.' + name)\n"
            "from pygsti_tpu_torch.modelpacks import smq1Q_XYI as mp\n"
            "from pygsti_tpu_torch.algorithms.germselection import find_germs\n"
            "from pygsti_tpu_torch.circuits.circuit import Circuit\n"
            "from pygsti_tpu_torch.errorgenpropagation import ErrorGeneratorPropagator as E\n"
            "g = find_germs(mp.target_model('full TP'), seed=1, verbosity=0, device='cpu',\n"
            "               candidate_germ_counts={2: 'all upto'})\n"
            "assert len(g) > 3, g\n"
            "p = E.from_errorgen_dict({'Gxpi2': {('H', 'Z'): 0.01}}, 1, (0,))\n"
            "assert len(p.propagate_errorgens(Circuit('Gxpi2:0Gxpi2:0@(0)'))) == 2\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pygsti_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n" % (new,))
    out = subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                         capture_output=True, text=True).stdout
    assert out.strip().splitlines()[-1] == 'ok'


def test_mirror_and_term_modules_import_no_jax():
    """The modules of the mirror-benchmark and Taylor-term slice load, and
    a mirror design, its MCFE arithmetic, an op-less model, the weak
    simulator and a term-simulator build run, in a process that ends with
    neither JAX, pygsti_tpu nor pandas imported."""
    new = ('protocols.protocol', 'tools.mcfetools', 'processors.random_compilation',
           'protocols.mirror_edesign', 'tools.dataframetools', 'protocols.vbdataframe',
           'protocols.vb', 'protocols.scarab', 'models.oplessmodel',
           'forwardsims.weakforwardsim', 'tools.rbtheory', 'baseobjs.polynomial',
           'baseobjs.opcalc', 'modelmembers.term', 'forwardsims.termforwardsim',
           'tools.errgenpolytools')
    code = ("import sys, importlib\n"
            "import numpy as np\n"
            "for name in %r:\n"
            "    importlib.import_module('pygsti_tpu_torch.' + name)\n"
            "from pygsti_tpu_torch.circuits.circuit import Circuit\n"
            "from pygsti_tpu_torch.baseobjs.label import Label\n"
            "from pygsti_tpu_torch.protocols.mirror_edesign import make_mirror_edesign\n"
            "from pygsti_tpu_torch.protocols.vbdataframe import VBDataFrame\n"
            "from pygsti_tpu_torch.models.oplessmodel import TwirledLayersModel\n"
            "from pygsti_tpu_torch.forwardsims.termforwardsim import TermForwardSimulator\n"
            "from pygsti_tpu_torch.modelpacks import smq1Q_XYI as mp\n"
            "c = Circuit([[Label('Gu3', (0,), args=(0.3, 0.1, -0.4))]], (0,))\n"
            "ed = make_mirror_edesign([c], 2, rand_state=np.random.RandomState(0))\n"
            "assert sorted(ed.keys()) == ['br', 'ref', 'rr']\n"
            "vb = VBDataFrame.from_benchmarking_data([{'Depth': 1, 'Width': 1, 'polarization': 0.9}])\n"
            "assert vb.vb_data()[1, 1] == 0.9\n"
            "m = TwirledLayersModel({'gates': {'Gx': 0.01}, 'readout': {}}, 1)\n"
            "assert 0 < m.probabilities(Circuit([('Gx', 0)], (0,)))[('success',)] < 1\n"
            "sim = TermForwardSimulator(mp.target_model('H+s'), device='cpu')\n"
            "co = sim.bulk_coefficients([Circuit([('Gxpi2', 0)], (0,))])\n"
            "assert abs(float(co.probs(np.zeros(30)).sum()) - 1) < 1e-12\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pygsti_tpu', 'pandas')]\n"
            "assert not bad, bad\n"
            "print('ok')\n" % (new,))
    out = subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                         capture_output=True, text=True).stdout
    assert out.strip().splitlines()[-1] == 'ok'


def test_drift_and_timedep_modules_import_no_jax():
    """The modules of the time-resolved and drift slice load, and a
    time-resolved objective, a stability analysis and a data comparison
    run, in a process that ends with neither JAX nor pygsti_tpu imported."""
    new = ('baseobjs.label', 'modelmembers.operations', 'models.explicitmodel',
           'objectivefns.objectivefns', 'objectivefns.timedep', 'data.datasetconstruction',
           'tools.hypothesis', 'data.hypothesistest', 'data.datacomparator',
           'extras.drift', 'extras.drift.signal', 'extras.drift.probtrajectory',
           'extras.drift.trmodel', 'extras.drift.stabilityanalyzer', 'protocols.stability')
    code = ("import sys, importlib\n"
            "import numpy as np\n"
            "for name in %r:\n"
            "    importlib.import_module('pygsti_tpu_torch.' + name)\n"
            "from pygsti_tpu_torch.baseobjs.label import Label\n"
            "from pygsti_tpu_torch.circuits.circuit import Circuit\n"
            "from pygsti_tpu_torch.data.dataset import DataSet\n"
            "from pygsti_tpu_torch.data.datacomparator import DataComparator\n"
            "from pygsti_tpu_torch.modelmembers import operations as ops\n"
            "from pygsti_tpu_torch.modelpacks import smq1Q_XYI as mp\n"
            "from pygsti_tpu_torch.objectivefns.timedep import TimeDependentPoissonPicLogLFunction\n"
            "from pygsti_tpu_torch.protocols.protocol import ExperimentDesign, ProtocolData\n"
            "from pygsti_tpu_torch.protocols.stability import StabilityAnalysis\n"
            "m = mp.target_model('static')\n"
            "k = Label('Gxpi2', 0)\n"
            "m.operations[k] = ops.LinearTimeDriftOp(ops.StaticArbitraryOp(m.operations[k].dense()),\n"
            "    ops.build_lindblad_errorgen('pp', 'H', dim=4))\n"
            "rng = np.random.RandomState(0)\n"
            "ds = DataSet()\n"
            "for c in (Circuit('Gxpi2:0@(0)'), Circuit('Gypi2:0@(0)')):\n"
            "    ds.add_raw_series_data(c, [('1',) if b else ('0',) for b in rng.rand(200) < 0.5],\n"
            "                           np.arange(200.0))\n"
            "obj = TimeDependentPoissonPicLogLFunction(m, ds, list(ds.keys()), device='cpu')\n"
            "ls, jtj, jtf = obj.jtj_jtf(m.to_vector())\n"
            "assert jtj.shape == (3, 3) and np.isfinite(ls).all(), jtj\n"
            "r = StabilityAnalysis(device='cpu').run(ProtocolData(ExperimentDesign(list(ds.keys())), ds))\n"
            "assert r.stabilityanalyzer._basespectra.shape == (1, 2, 1, 200)\n"
            "comp = DataComparator([ds, ds], device='cpu').run()\n"
            "assert comp.inconsistent_circuits == [] and comp.aggregate_llr == 0\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pygsti_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n" % (new,))
    out = subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                         capture_output=True, text=True).stdout
    assert out.strip().splitlines()[-1] == 'ok'


def _tp_unital(seed, d=4):
    """A real TP, unital d x d matrix near the identity (a TP-constrained,
    unital member's input)."""
    rs = np.random.RandomState(seed)
    m = np.eye(d)
    m[1:, 1:] += 0.05 * rs.randn(d - 1, d - 1)
    return m


@pytest.mark.parametrize("case", ['eig', 'eig-tp', 'linear', 'linear-complex', 'affine'])
def test_new_operations_against_jax(case):
    """EigenvalueParamDenseOp, LinearlyParamArbitraryOp and AffineShiftOp:
    the same parameters and dense matrices as the JAX package's at the
    initial and at a moved vector, to_dense against dense(), and a
    serialization round trip."""
    import jax.numpy as jnp
    import pygsti_tpu.modelmembers.operations as jops
    import pygsti_tpu_torch.modelmembers.operations as tops
    from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
    rs = np.random.RandomState(3)
    if case.startswith('eig'):
        mx = _tp_unital(5) if case == 'eig-tp' else rs.randn(4, 4)
        kw = {'tp_constrained_and_unital': case == 'eig-tp'}
        j, t = jops.EigenvalueParamDenseOp(mx, **kw), tops.EigenvalueParamDenseOp(mx, **kw)
    elif case.startswith('linear'):
        base = rs.randn(3, 3)
        index_map = {0: [(0, 1), (2, 2)], 1: [(1, 0)]}
        left, right = rs.randn(3, 3), rs.randn(3, 3)
        real = case == 'linear'
        j = jops.LinearlyParamArbitraryOp(base, [0.3, -0.2], index_map, left, right, real)
        t = tops.LinearlyParamArbitraryOp(base, [0.3, -0.2], index_map, left, right, real)
    else:
        mx = np.eye(4)
        mx[1:, 0] = [0.1, -0.2, 0.05]
        j, t = jops.AffineShiftOp(mx), tops.AffineShiftOp(mx)
        with pytest.raises(ValueError):
            tops.AffineShiftOp(np.ones((4, 4)))
    v0 = t.to_vector()
    assert np.array_equal(v0, np.asarray(j.to_vector()))
    for v in (v0, v0 + 0.01 * rs.randn(len(v0))):
        a = t.to_dense(torch.as_tensor(v)).numpy()
        b = np.asarray(j.to_dense_jax(jnp.asarray(v)))
        assert a.shape == b.shape and np.max(np.abs(a - b)) < 1e-13
    if case.startswith('eig'):
        assert np.max(np.abs(t.to_dense(torch.as_tensor(v0)).numpy() - mx)) < 1e-12
    t.from_vector(v0 + 0.01)
    back = NicelySerializable.loads(t.dumps())
    assert type(back) is type(t) and np.array_equal(back.to_vector(), t.to_vector())
    assert np.max(np.abs(back.dense() - t.dense())) < 1e-14
    if case == 'affine':
        moved = np.eye(4)
        moved[1:, 0] = 0.3
        t.set_dense(moved)
        assert np.array_equal(t.dense(), moved)


def test_marginalized_povm_against_jax():
    """MarginalizedPOVM of the 2-qubit 'full' target's POVM onto each qubit:
    the JAX package's effects and labels, parameters passed through, and a
    serialization round trip."""
    import jax.numpy as jnp
    import pygsti_tpu.modelmembers.povms as jpv
    import pygsti_tpu_torch.modelmembers.povms as tpv
    from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
    jbase = list(jmp2.target_model('full').povms.values())[0]
    tbase = list(tmp2.target_model('full').povms.values())[0]
    for kept in ((0,), (1,), (1, 0)):
        j = jpv.MarginalizedPOVM(jbase, (0, 1), kept)
        t = tpv.MarginalizedPOVM(tbase, (0, 1), kept)
        assert t.outcome_labels == list(j.outcome_labels) and t.num_params == j.num_params
        v = t.to_vector() + 0.01 * np.random.RandomState(1).randn(t.num_params)
        a = t.to_dense(torch.as_tensor(v)).numpy()
        b = np.asarray(j.to_dense_jax(jnp.asarray(v)))
        assert np.max(np.abs(a - b)) < 1e-14
        back = NicelySerializable.loads(t.dumps())
        assert np.max(np.abs(back.dense() - t.dense())) < 1e-15


def test_new_gauge_groups_against_jax():
    """tests/test_api_surface.py's gauge-group cases: U1, the direct sum of
    U(2) and U(1) (contiguous and interleaved), the op-parameterized group;
    element matrices in torch against the JAX package's elements, and
    their autograd gradients finite."""
    import jax.numpy as jnp
    import pygsti_tpu.models.gaugegroup as jgg
    import pygsti_tpu_torch.models.gaugegroup as tgg
    import pygsti_tpu.modelmembers.operations as jops
    import pygsti_tpu_torch.modelmembers.operations as tops
    from pygsti_tpu.baseobjs.statespace import QubitSpace
    ju, tu = jgg.UnitaryGaugeGroup(QubitSpace(1), 'pp'), tgg.UnitaryGaugeGroup(4, 'pp')
    ue = tu.compute_element(np.array([0.1, -0.2, 0.05, 0.3]))
    assert np.allclose(ue.unitary @ ue.unitary.conj().T, np.eye(2))
    e1 = tgg.U1Group().compute_element([0.4])
    assert np.allclose(e1.transform_matrix, jgg.U1Group().compute_element(0.4).transform_matrix)
    assert np.allclose(e1.transform_matrix @ e1.transform_matrix_inverse, 1)
    assert abs(tgg.U1Group().element_matrix(torch.tensor([0.4], dtype=torch.float64))[0, 0]
               - np.exp(0.4j)) < 1e-15
    for partition in (None, [(0, 2), (1,)]):
        jd = jgg.DirectSumUnitaryGroup((ju, jgg.U1Group()), 'gm', level_partition=partition)
        td = tgg.DirectSumUnitaryGroup((tu, tgg.U1Group()), 'gm', level_partition=partition)
        assert td.num_params == jd.num_params == 5
        v = np.array([0.1, 0.2, -0.1, 0.05, 0.4])
        S = td.element_matrix(torch.as_tensor(v)).numpy()
        jel, tel = jd.compute_element(v), td.compute_element(v)
        assert np.max(np.abs(S - jel.transform_matrix)) < 1e-14
        assert np.max(np.abs(tel.transform_matrix - jel.transform_matrix)) < 1e-14
        assert np.max(np.abs(tel._unitary_total - jel._unitary_total)) < 1e-15
        u = tel._unitary_total
        if partition is None:
            assert abs(u[0, 2]) < 1e-12
        else:
            assert abs(u[0, 1]) < 1e-12 and abs(u[0, 2]) > 1e-6
        x = torch.zeros(5, dtype=torch.float64, requires_grad=True)
        (td.element_matrix(x) ** 2).sum().backward()
        assert torch.all(torch.isfinite(x.grad))
    with pytest.raises(ValueError):
        tgg.DirectSumUnitaryGroup((tu, tgg.U1Group()), 'gm', level_partition=[(0, 1), (1,)])
    mx = _tp_unital(7)
    jg = jgg.OpGaugeGroupWithBasis(jops.FullTPOp(mx), basis='pp')
    tg = tgg.OpGaugeGroupWithBasis(tops.FullTPOp(mx), basis='pp')
    assert tg.num_params == jg.num_params == 12 and np.array_equal(tg.initial_params(),
                                                                   jg.initial_params())
    v = tg.initial_params() + 0.01
    assert np.max(np.abs(tg.element_matrix(torch.as_tensor(v)).numpy()
                         - np.asarray(jg.element_matrix_jax(jnp.asarray(v))))) < 1e-15
    el = tg.compute_element(v)
    assert np.max(np.abs(el.transform_matrix - jg.compute_element(v).transform_matrix)) < 1e-15
    assert el.num_params == 12 and np.array_equal(el.to_vector(), v)


def test_gaugeopt_over_the_new_groups():
    """gaugeopt_to_target differentiates the new groups' element matrices:
    a 3-level target moved by a direct-sum unitary comes back to it."""
    from pygsti_tpu_torch import leakage
    from pygsti_tpu_torch.algorithms.gaugeopt import gaugeopt_to_target
    import pygsti_tpu_torch.models.gaugegroup as tgg
    target = leakage.create_3level_model(tmp1.target_model('full TP'))
    group = tgg.DirectSumUnitaryGroup((tgg.UnitaryGaugeGroup(4, 'pp'), tgg.U1Group()), 'gm')
    moved = target.copy()
    moved.transform_inplace(group.compute_element([0.05, -0.1, 0.08, 0.02, 0.3]))
    assert moved.frobeniusdist(target) > 1e-2
    back = gaugeopt_to_target(moved, target, gauge_group=group, device='cpu')
    assert back.frobeniusdist(target) < 1e-6


@pytest.mark.parametrize("kind", ['explicit', 'perturbed', 'dissimilar', 'fogi'])
def test_modelmember_graph(kind):
    """tests/test_implicit_models.py:179: equal models similar and
    equivalent; a moved parameter similar only; other ops or another
    parameterization neither; the port's answers are the JAX package's."""
    import pygsti_tpu.modelpacks.smq1Q_XY as jxy
    import pygsti_tpu_torch.modelpacks.smq1Q_XY as txy
    pairs = {'explicit': (lambda p: p.target_model('full TP'), lambda p: p.target_model('full TP')),
             'dissimilar': (lambda p: p.target_model('full TP'), lambda p: p.target_model('H+s'))}
    answers = []
    for pkg, xy in ((jmp1, jxy), (tmp1, txy)):
        if kind == 'perturbed':
            m1, m2 = pkg.target_model('full TP'), pkg.target_model('full TP')
            v = np.array(m2.to_vector())
            v[0] += 0.05
            m2.from_vector(v)
        elif kind == 'fogi':
            m1, m2 = pkg.target_model('H+s'), pkg.target_model('H+s')
            m2.setup_fogi(include_spam=True)
        else:
            m1, m2 = (f(pkg) for f in pairs[kind])
        g1, g2 = m1.create_modelmember_graph(), m2.create_modelmember_graph()
        answers.append((g1.is_similar(g2), g1.is_equivalent(g2),
                        g1.is_similar(xy.target_model('full TP').create_modelmember_graph())))
    assert answers[0] == answers[1]
    assert answers[1] == {'explicit': (True, True, False), 'perturbed': (True, False, False),
                          'dissimilar': (False, False, False), 'fogi': (True, True, False)}[kind]


def test_gauge_structure_modules_import_no_jax():
    """The modules of the gauge-structure slice load, and a FOGI setup and
    a LAGO element run, in a process that ends with neither JAX nor
    pygsti_tpu imported."""
    new = ('tools.matrixtools', 'baseobjs.basisconstructors', 'baseobjs.basis',
           'baseobjs.errorgenbasis', 'baseobjs.errorgenspace', 'tools.fogitools',
           'models.fogistore', 'models.modelparaminterposer', 'modelmembers.errorgencontainer',
           'modelmembers.modelmembergraph', 'tools.lindbladtools', 'tools.optools',
           'models.gaugegroup', 'leakage', 'leakage.core', 'leakage.metrics', 'leakage.models',
           'leakage.gaugeopt')
    code = ("import sys, importlib\n"
            "import torch\n"
            "for name in %r:\n"
            "    importlib.import_module('pygsti_tpu_torch.' + name)\n"
            "from pygsti_tpu_torch.modelpacks import smq1Q_XYI as mp\n"
            "from pygsti_tpu_torch import leakage\n"
            "m = mp.target_model('H+s')\n"
            "m.setup_fogi(include_spam=True, reparameterize=True)\n"
            "assert m.num_params == 18, m.num_params\n"
            "g = leakage.DirectSumUnitaryGaugeGroup(9, 'gm')\n"
            "assert g.element_matrix(torch.zeros(5, dtype=torch.float64)).shape == (9, 9)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pygsti_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n" % (new,))
    out = subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                         capture_output=True, text=True).stdout
    assert out.strip().splitlines()[-1] == 'ok'


def test_extras_and_runner_modules_import_no_jax():
    """The runners' and the extras' modules load, and crosstalk
    detection, a device's processor spec from the port's own
    device_data.json and an interpolated gate's Tv run, in a process that
    cannot import networkx and ends with neither JAX nor pygsti_tpu
    imported."""
    new = ('protocols.protocol', 'protocols.treenode', 'extras.devices',
           'extras.devices.devcore', 'extras.devices.experimentaldevice',
           'extras.idletomography', 'extras.idletomography.idtcore',
           'extras.idletomography.idttools', 'extras.idletomography.pauliobjs',
           'extras.idletomography.idtresults', 'extras.crosstalk', 'extras.crosstalk.core',
           'extras.crosstalk.objects', 'extras.crosstalk.pcalg', 'extras.paritybenchmarking',
           'extras.interpygate', 'extras.interpygate.process_tomography', 'extras.lfh',
           'extras.lfh.lfherrorgen', 'extras.lfh.lfhmodel', 'extras.lfh.lfhforwardsims',
           'extras.ibmq')
    code = ("import sys, importlib\n"
            "sys.modules['networkx'] = None\n"
            "import numpy as np, torch\n"
            "for name in %r:\n"
            "    importlib.import_module('pygsti_tpu_torch.' + name)\n"
            "from pygsti_tpu_torch.extras import crosstalk, devices, interpygate\n"
            "rng = np.random.RandomState(0)\n"
            "s = rng.randint(0, 2, (3000, 2)); o = rng.randint(0, 2, (3000, 2))\n"
            "o[:, 0] = rng.rand(3000) < 0.2 + 0.6 * s[:, 1]\n"
            "r = crosstalk.do_basic_crosstalk_detection(np.hstack([o, s]), 2, verbosity=0)\n"
            "assert r.crosstalk_pairs, r.crosstalk_pairs\n"
            "p = devices.create_processor_spec('ibmq_bogota', ('Gxpi2',), qubitsubset=['Q0', 'Q1'])\n"
            "assert p.qubit_graph.edges() == [('Q0', 'Q1')]\n"
            "op = interpygate.InterpolatedDenseOp([np.linspace(0, 1, 3)], rng.randn(3, 4, 4))\n"
            "J = torch.func.jacfwd(op.to_dense)(torch.tensor([0.3], dtype=torch.float64))\n"
            "assert J.shape == (4, 4, 1)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pygsti_tpu')\n"
            "       and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('ok')\n" % (new,))
    out = subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                         capture_output=True, text=True).stdout
    assert out.strip().splitlines()[-1] == 'ok'


def test_report_modules_import_no_jax():
    """The report modules load, and a standard report of a 1-qubit estimate
    (target and a depolarized model, no fit) is written with its error bars
    on the CPU, in a process that ends with neither JAX nor pygsti_tpu
    imported; no string of the report's code names the JAX package as a
    module to import."""
    import pathlib
    import re
    new = ('report', 'report.colormaps', 'report.driftreport', 'report.factory',
           'report.fogidiagram', 'report.idtreport', 'report.modelfunction',
           'report.reportableqty', 'report.reportables', 'report.vbplot', 'report.workspace',
           'report.workspaceplots')
    code = ("import sys, importlib, os, tempfile\n"
            "for name in %r:\n"
            "    importlib.import_module('pygsti_tpu_torch.' + name)\n"
            "import torch\n"
            "torch.set_num_threads(1)\n"
            "from pygsti_tpu_torch.modelpacks import smq1Q_XYI as mp\n"
            "from pygsti_tpu_torch.protocols.gst import StandardGSTDesign, ModelEstimateResults\n"
            "from pygsti_tpu_torch.protocols.estimate import Estimate\n"
            "from pygsti_tpu_torch.protocols.protocol import Protocol, ProtocolData\n"
            "from pygsti_tpu_torch.data.datasetconstruction import simulate_data\n"
            "from pygsti_tpu_torch.report import construct_standard_report\n"
            "d = StandardGSTDesign(mp.target_model('full TP'), mp.prep_fiducials(),\n"
            "                      mp.meas_fiducials(), mp.germs(), [1])\n"
            "m = mp.target_model('full TP').depolarize(op_noise=0.02, spam_noise=0.01)\n"
            "ds = simulate_data(m, d.all_circuits_needing_data, 1000, seed=1, device='cpu')\n"
            "r = ModelEstimateResults(ProtocolData(d, ds), Protocol('GST'))\n"
            "r.add_estimate(Estimate(r, {'target': mp.target_model('full TP'),\n"
            "    'final iteration estimate': m}, {'final_objfn_value': 30.0,\n"
            "    'final_dof': 20}, device='cpu'), 'GST')\n"
            "path = os.path.join(tempfile.mkdtemp(), 'r.html')\n"
            "construct_standard_report(r, confidence_level=95).write_html(path)\n"
            "assert '&plusmn;' in open(path).read()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pygsti_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n" % (new,))
    out = subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                         capture_output=True, text=True).stdout
    assert out.strip().splitlines()[-1] == 'ok'
    root = pathlib.Path(__file__).resolve().parents[1] / 'pygsti_tpu_torch' / 'report'
    for path in sorted(root.glob('*.py')):
        named = re.findall(r"""(?:['"]|import |from )pygsti_tpu(?:\.|['"\s])""", path.read_text())
        assert not named, (path.name, named)
