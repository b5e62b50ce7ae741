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
