"""Instruments (mid-circuit measurements) in the port against the JAX
package on the same inputs: probabilities, the TPInstrument's TP sum, Tv,
layout row expansion, the blocked objective, simulated data, a 1-qubit GST
fit with checkpoints, and the three faults of the JAX package around
instruments (checkpoints lose them, gauge optimization and LGST cannot
handle them)."""

import numpy as np
import pytest
import torch

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp1
import pygsti_tpu.modelpacks.smq2Q_XYICNOT as jmp2
from pygsti_tpu.baseobjs.label import Label as JLabel
from pygsti_tpu.circuits import Circuit as JCircuit
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.modelmembers import instruments as jinst
from pygsti_tpu.modelmembers.operations import StaticArbitraryOp as JStatic
from pygsti_tpu.objectivefns import objectivefns as jof
from pygsti_tpu.tools.basistools import change_basis

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp1
import pygsti_tpu_torch.modelpacks.smq2Q_XYICNOT as tmp2
from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.convert import instrument_from_dense, model_from_vector
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.data.datasetconstruction import simulate_data as t_simulate
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.modelmembers.instruments import Instrument, TPInstrument
from pygsti_tpu_torch.objectivefns import objectivefns as tof


def z_members(nq, depol=0.0):
    """{'p0', 'p1'}: rho -> (P_k x I) rho (P_k x I), a Z measurement of the
    first qubit, in the pp basis; with `depol` each member is left-multiplied
    by the depolarization diag(1, 1 - depol, ...), so the sum stays TP."""
    out = {}
    for k in (0, 1):
        P = np.kron(np.diag([1.0 - k, float(k)]), np.eye(2 ** (nq - 1)))
        mx = np.real(change_basis(np.kron(P, P.conj()), 'std', 'pp'))
        out['p%d' % k] = np.diag([1.0] + [1.0 - depol] * (mx.shape[0] - 1)) @ mx
    return out


def _jax_instrument(kind, members):
    if kind == 'TP':
        return jinst.TPInstrument(members)
    return jinst.Instrument({k: JStatic(v) for k, v in members.items()})


def models(nq, kind='TP', gate_type='full TP', depol=0.0):
    """(JAX model, port model) of the modelpack's target (depolarized by
    `depol`, its instrument too) with the instrument 'Iz' on qubit 0, the
    port's holding the JAX package's parameter vector."""
    jmp, tmp = (jmp1, tmp1) if nq == 1 else (jmp2, tmp2)
    jm, tm = jmp.target_model(gate_type), tmp.target_model(gate_type)
    if depol:
        jm, tm = jm.depolarize(op_noise=depol, spam_noise=depol), \
            tm.depolarize(op_noise=depol, spam_noise=depol)
    members = z_members(nq, depol)
    jm.instruments[JLabel('Iz', 0)] = _jax_instrument(kind, members)
    jm._mark_for_rebuild()
    tm.instruments[Label('Iz', 0)] = instrument_from_dense(kind, members)
    return jm, model_from_vector(tm, jm.to_vector())


def instrument_circuits(nq, n=None):
    """prep fiducial . Iz:0 . meas fiducial and the same with Iz:0 twice,
    over the modelpack's fiducial pairs (in both packages)."""
    jmp, tmp = (jmp1, tmp1) if nq == 1 else (jmp2, tmp2)
    out = []
    for mp, circ, lbl in ((jmp, JCircuit, JLabel), (tmp, Circuit, Label)):
        iz = circ([lbl('Iz', 0)], line_labels=mp.prep_fiducials()[0].line_labels)
        cs = [p + iz * k + m for k in (1, 2) for p in mp.prep_fiducials()
              for m in mp.meas_fiducials()]
        out.append(cs[:n])
    return out


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("text", ['Gxpi2:0Iz:0Gypi2:0@(0)', 'IzGxpi2:0Iz@(0)',
                                  '(Gxpi2:0Iz:0)^2Gypi2:0@(0)', '[Gxpi2:0Iz:1]Iz_a:0@(0,1)'])
def test_instrument_labels_parse_as_in_the_jax_package(text):
    """Instrument labels (I[a-z0-9_]*, with or without state-space labels)
    parse to the JAX package's layers."""
    from pygsti_tpu.circuits.circuitparser import parse_circuit_str as j_parse
    from pygsti_tpu_torch.circuits.circuitparser import parse_circuit_str as t_parse
    jl, tl = j_parse(text), t_parse(text)
    assert [str(l) for l in tl[0]] == [str(l) for l in jl[0]] and tl[1:] == jl[1:]
    assert Circuit(text).str == JCircuit(text).str


def test_mid_circuit_measurement_probabilities():
    """The JAX package's instrument cases: a Z measurement between two
    X(pi/2) gives 1/4 per outcome pair, and probabilities sum to one."""
    m = tmp1.target_model('full TP')
    m.instruments[Label('Iz')] = Instrument(
        {'0': z_members(1)['p0'], '1': z_members(1)['p1']})
    p = m.probabilities(Circuit([('Gxpi2', 0), 'Iz', ('Gxpi2', 0)], (0,)), device='cpu')
    assert sorted(p.keys()) == [('0', '0'), ('0', '1'), ('1', '0'), ('1', '1')]
    assert all(abs(x - 0.25) < 1e-10 for x in p.values())
    p = m.probabilities(Circuit([('Gxpi2', 0), 'Iz', ('Gypi2', 0)], (0,)), device='cpu')
    assert abs(sum(p.values()) - 1) < 1e-10
    assert list(m.probabilities(Circuit([('Gxpi2', 0), 'Iz'], (0,)), outcomes=[('0', '1')],
                                device='cpu').keys()) == [('0', '1')]


@pytest.mark.parametrize("nq,kind,gate_type", [(1, 'TP', 'full TP'), (1, 'static', 'full'),
                                               (2, 'TP', 'full'), (2, 'static', 'full TP')])
def test_probabilities_match_the_jax_package(nq, kind, gate_type):
    """Outcome probabilities of instrument circuits (one and two
    measurements) and of plain ones in both packages: within 1e-10."""
    jm, tm = models(nq, kind, gate_type, depol=0.02)
    jc, tc = instrument_circuits(nq, 40)
    jmp = jmp1 if nq == 1 else jmp2
    jc = jc + list(jmp.germs()[:5])
    tc = tc + list((tmp1 if nq == 1 else tmp2).germs()[:5])
    jp = jm.sim.bulk_probs(jc)
    tp = SimpleForwardSimulator(tm, 'cpu').bulk_probs(tc)
    for a, b in zip(jc, tc):
        assert list(jp[a].keys()) == list(tp[b].keys())
        assert max(abs(jp[a][o] - tp[b][o]) for o in jp[a]) < 1e-10
        assert abs(sum(tp[b].values()) - 1) < 1e-10
    assert len(tp[tc[0]]) == 2 * 2 ** nq and len(tp[tc[-1]]) == 2 ** nq


def test_tp_instrument_sum_stays_tp_off_the_manifold():
    """The members of a TPInstrument sum to a TP map at any parameters, and
    its dense stack is the JAX package's at the same parameters (1e-12)."""
    members = z_members(1)
    t, j = TPInstrument(members), jinst.TPInstrument(members)
    v = t.to_vector()
    assert np.array_equal(v, j.to_vector())
    for shift in (0.0, 0.07):
        d = t.to_dense(torch.as_tensor(v + shift)).numpy()
        assert np.allclose(d.sum(axis=0)[0], [1, 0, 0, 0], atol=1e-12)
        assert np.max(np.abs(d - np.asarray(j.to_dense_jax(v + shift)))) < 1e-12
    assert np.allclose(t['p1'].dense(), members['p1'])


@pytest.mark.parametrize("nq,kind", [(1, 'TP'), (2, 'TP'), (2, 'full')])
def test_tv_of_an_instrument_model_matches_jacfwd(nq, kind):
    """Tv taken block by block, an instrument one block over all its member
    slots, against plain jacfwd over every parameter: within 1e-12."""
    _, tm = models(nq, 'TP', 'full', depol=0.02)
    if kind == 'full':
        tm.instruments[Label('Iz', 0)] = instrument_from_dense('full', z_members(nq, 0.02))
    v = torch.as_tensor(tm.to_vector() + 0.01 * np.random.RandomState(0).randn(tm.num_params))
    Tv = tm.flat_tensors_jacobian_fn()(v)
    ref = torch.func.jacfwd(tm.flat_tensors_fn())(v)
    assert Tv.shape == ref.shape == ((len(tm.op_keys)) * tm.dim ** 2 + tm.dim * (1 + 2 ** nq),
                                     tm.num_params)
    assert float((Tv - ref).abs().max()) < 1e-12


def test_layout_rows_match_the_jax_package():
    """A circuit with one instrument gives two rows, with two four; the
    index arrays, element maps and outcomes are the JAX package's."""
    jm, tm = models(2, 'TP', 'full')
    jc, tc = instrument_circuits(2)
    jc = jc[::17] + list(jmp2.germs()[:3])
    tc = tc[::17] + list(tmp2.germs()[:3])
    jl = jm.sim.create_layout(jc)
    tl = SimpleForwardSimulator(tm, 'cpu').create_layout(tc)
    for name in ('op_indices', 'depths', 'prep_index', 'elem_circuit', 'elem_effect',
                 'elem_to_circuit'):
        assert np.array_equal(getattr(tl, name), getattr(jl, name)), name
    assert tl.outcomes == jl.outcomes and tl.element_slices == jl.element_slices
    assert tl.num_rows == jl.num_rows > len(tc)
    assert tm.op_keys[-2:] == [('INSTRUMENT', Label('Iz', 0), 'p0'),
                               ('INSTRUMENT', Label('Iz', 0), 'p1')]
    assert np.bincount(tl.row_circuit).tolist() == [
        2 ** sum(l == Label('Iz', 0) for l in c.layertup) for c in tc]


@pytest.fixture(scope='module')
def design_1q():
    """smq1Q_XYI 'full TP' with a TPInstrument 'Iz:0': the instrument
    circuits first, then the nested lists of maxL 1, 2; data from the
    depolarized target, the JAX package's counts in both packages."""
    jt, tt = models(1, 'TP', 'full TP')
    jgen, _ = models(1, 'TP', 'full TP', depol=0.03)
    jx, tx = instrument_circuits(1)
    jl = [jx + list(l) for l in j_lists(jt, jmp1.prep_fiducials(), jmp1.meas_fiducials(),
                                       jmp1.germs(), [1, 2])]
    tl = [tx + list(l) for l in t_lists(tt, tmp1.prep_fiducials(), tmp1.meas_fiducials(),
                                       tmp1.germs(), [1, 2])]
    jds = j_simulate(jgen, jl[-1], 1000, seed=1)
    tds = DataSet()
    for a, b in zip(jl[-1], tl[-1]):
        tds.add_count_dict(b, dict(jds[a].counts))
    return jt, tt, jl, tl, jds, tds, jgen


@pytest.mark.parametrize("objective", ["chi2", "logl"])
def test_blocked_objective_matches_the_jax_package(design_1q, objective):
    """Both packages take the blocked Jacobian on an instrument layout (its
    rows are uniform), and agree on fn, lsvec, J^T J, J^T f and dlsvec
    within 1e-9 relative."""
    jt, tt, jl, tl, jds, tds, jgen = design_1q
    theta = jgen.to_vector() + 1e-3 * np.random.RandomState(2).randn(jt.num_params)
    jobj = jof.ObjectiveFunctionBuilder(objective).build(jt, jds, jl[-1])
    tobj = tof.ObjectiveFunctionBuilder(objective).build(tt, tds, tl[-1], device='cpu')
    assert tobj.jac_mode == jobj._fns['jac_mode'] == 'blocked'
    assert np.isclose(tobj.fn(theta), jobj.fn(theta), rtol=1e-9, atol=0)
    for a, b in zip(tobj.jtj_jtf(theta) + (tobj.dlsvec(theta),),
                    jobj.jtj_jtf(theta) + (jobj.dlsvec(theta),)):
        assert a.shape == b.shape and _rel(a, b) < 1e-9
    # the forward-mode Jacobian agrees on the same layout
    fwd = tof.ObjectiveFunctionBuilder(objective, jac_mode='linearize').build(
        tt, tds, tl[-1], device='cpu')
    for a, b in zip(fwd.jtj_jtf(theta), jobj.jtj_jtf(theta)):
        assert _rel(a, b) < 1e-9


def test_simulated_data_and_logl_match_the_jax_package(design_1q):
    """simulate_data draws one multinomial per circuit over all of its rows'
    outcomes: the same keys and totals as the JAX package, the same counts
    for most circuits (numpy's binomial ties, test_torch_objective.py), the
    same degrees of freedom; two_delta_logl on the same counts within
    1e-10."""
    jt, tt, jl, tl, jds, tds, jgen = design_1q
    tgen = model_from_vector(tt, jgen.to_vector())
    sim = t_simulate(tgen, tl[-1], 1000, seed=1, device='cpu')
    same = [dict(jds[a].counts) == dict(sim[b].counts) for a, b in zip(jl[-1], tl[-1])]
    assert sum(same) >= 0.95 * len(same)
    assert all(list(jds[a].counts.keys()) == list(sim[b].counts.keys())
               and sim[b].total == 1000 for a, b in zip(jl[-1], tl[-1]))
    assert sim.degrees_of_freedom() == jds.degrees_of_freedom()
    assert len(sim[tl[-1][0]].counts) == 4
    assert np.isclose(tof.two_delta_logl(tgen, tds, tl[-1], device='cpu'),
                      jof.two_delta_logl(jgen, jds, jl[-1]), rtol=1e-10, atol=0)


@pytest.fixture(scope='module')
def fits_1q(design_1q, tmp_path_factory):
    """GateSetTomography.run from the target, gaugeopt_suite=None, in both
    packages, with checkpoints."""
    from pygsti_tpu.protocols import gst as jgst
    from pygsti_tpu.protocols.protocol import ProtocolData as JData
    from pygsti_tpu_torch.protocols import gst as tgst
    from pygsti_tpu_torch.protocols.protocol import ProtocolData as TData
    jt, tt, jl, tl, jds, tds, _ = design_1q
    d = tmp_path_factory.mktemp('ck')
    jres = jgst.GateSetTomography(jgst.GSTInitialModel(target_model=jt, starting_point='target'),
                                  gaugeopt_suite=None, verbosity=0).run(
        JData(jgst.GateSetTomographyDesign(jt, jl), jds), checkpoint_path=str(d / 'jax'))
    tres = tgst.GateSetTomography(tgst.GSTInitialModel(target_model=tt, starting_point='target'),
                                  gaugeopt_suite=None, verbosity=0, device='cpu').run(
        TData(tgst.GateSetTomographyDesign(tt, tl), tds), checkpoint_path=str(d / 'torch'))
    return jres, tres, d, len(jl)


def test_gst_fit_reaches_the_jax_optimum(fits_1q):
    """Every stage's objective value of the instrument fit: within 1e-3
    relative of the JAX package's on the same counts; the fitted
    instrument's members still sum to a TP map."""
    jres, tres = fits_1q[:2]
    jv = jres.estimates['GateSetTomography'].parameters['raw_objective_values']
    tv = tres.estimates['GateSetTomography'].parameters['raw_objective_values']
    assert [len(s) for s in tv] == [len(s) for s in jv]
    for a, b in zip(sum(tv, []), sum(jv, [])):
        assert abs(a - b) <= 1e-3 * abs(b)
    fitted = tres.estimates['GateSetTomography'].models['final iteration estimate']
    inst = fitted.instruments[Label('Iz', 0)].dense()
    assert np.max(np.abs(inst.sum(axis=0)[0] - np.eye(4)[0])) < 1e-12


def test_checkpoints_keep_the_instrument_where_the_jax_package_loses_it(fits_1q):
    """The port's last checkpoint reads back to the final model, instrument
    included; the JAX package's reads back without its instrument (it
    writes none), in its own reader and in the port's."""
    from pygsti_tpu.protocols.gst import GateSetTomographyCheckpoint as JCk
    from pygsti_tpu_torch.protocols.gst import GateSetTomographyCheckpoint as TCk
    jres, tres, d, n = fits_1q
    final = tres.estimates['GateSetTomography'].models['final iteration estimate']
    back = TCk.read(str(d / ('torch_iteration_%d.json' % (n - 1)))).mdl_list[-1]
    assert list(back.instruments.keys()) == [Label('Iz', 0)]
    assert isinstance(back.instruments[Label('Iz', 0)], TPInstrument)
    assert np.array_equal(back.to_vector(), final.to_vector())
    jpath = str(d / ('jax_iteration_%d.json' % (n - 1)))
    jfinal = jres.estimates['GateSetTomography'].models['final iteration estimate']
    jback = JCk.read(jpath).mdl_list[-1]
    assert len(jback.instruments) == 0 and jback.num_params == jfinal.num_params - 28
    assert len(TCk.read(jpath).mdl_list[-1].instruments) == 0


@pytest.mark.parametrize("kind", ['TP', 'static', 'full'])
def test_instruments_serialize(kind):
    """An instrument and a model holding it read back to the same
    parameters, bit for bit."""
    inst = instrument_from_dense(kind, z_members(2, 0.03))
    if inst.num_params:
        inst.from_vector(inst.to_vector() + 1e-3 * np.random.RandomState(4).randn(
            inst.num_params))
    back = NicelySerializable.loads(inst.dumps())
    assert type(back) is type(inst) and back.member_labels == inst.member_labels
    assert np.array_equal(back.to_vector(), inst.to_vector())
    assert np.array_equal(back.dense(), inst.dense())
    _, tm = models(2, kind if kind != 'full' else 'TP', 'full', depol=0.01)
    tm.instruments[Label('Iz', 0)] = inst
    mback = NicelySerializable.loads(tm.dumps())
    assert mback.op_keys == tm.op_keys
    assert np.array_equal(mback.to_vector(), tm.to_vector())


def test_gauge_optimization_raises_in_both_packages(design_1q):
    """An instrument has no gauge transform: gaugeopt_to_target fails with
    the same error in both packages, and GateSetTomography runs such a
    model with gaugeopt_suite=None."""
    from pygsti_tpu.algorithms.gaugeopt import gaugeopt_to_target as j_go
    from pygsti_tpu_torch.algorithms.gaugeopt import gaugeopt_to_target as t_go
    jt, tt, _, _, _, _, jgen = design_1q
    tgen = model_from_vector(tt, jgen.to_vector())
    with pytest.raises(NotImplementedError, match='TPInstrument does not support gauge'):
        j_go(jgen, jt, maxiter=5)
    with pytest.raises(NotImplementedError, match='TPInstrument does not support gauge'):
        t_go(tgen, tt, maxiter=5, device='cpu')
    with pytest.raises(NotImplementedError, match='Instrument does not support gauge'):
        Instrument(z_members(1)).transform_inplace(np.eye(4), np.eye(4))


def test_lgst_start_carries_the_target_instrument(design_1q):
    """"LGST-if-possible" on a target with an instrument: the JAX package's
    run_lgst estimates the operations and carries the target's instrument
    over unchanged (neither dropped nor re-wrapped); the port's start is
    the same model (1e-8)."""
    from pygsti_tpu.protocols import gst as jgst
    from pygsti_tpu_torch.protocols import gst as tgst
    jt, tt, jl, tl, jds, tds, _ = design_1q
    jd = jgst.StandardGSTDesign(jt, jmp1.prep_fiducials(), jmp1.meas_fiducials(),
                                jmp1.germs(), [1])
    td = tgst.StandardGSTDesign(tt, tmp1.prep_fiducials(), tmp1.meas_fiducials(),
                                tmp1.germs(), [1])
    jm = jgst.GSTInitialModel(starting_point='LGST-if-possible').retrieve_model(jd, None, jds)
    tm = tgst.GSTInitialModel(starting_point='LGST-if-possible').retrieve_model(td, None, tds)
    assert np.array_equal(jm.instruments[JLabel('Iz', 0)].to_vector(),
                          jt.instruments[JLabel('Iz', 0)].to_vector())
    assert np.max(np.abs(tm.to_vector() - jm.to_vector())) < 1e-8
    assert tm.frobeniusdist(tt) > 1e-3
