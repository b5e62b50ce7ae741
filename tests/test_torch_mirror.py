"""Mirror-circuit benchmarks in the port against the JAX package: the
combined, simultaneous and freeform designs and their serialization,
random compilation and the mirror designs at a shared RandomState, the
MCFE arithmetic and a 2-qubit MCFE run on the same counts, volumetric
benchmarks (the periodic mirror design, summary statistics, the VB table)
and the gate dependence of error maps.  Tolerances are stated per test."""

import json

import numpy as np
import pytest
import torch

from pygsti_tpu.baseobjs.label import Label as JLabel
from pygsti_tpu.circuits.circuit import Circuit as JCircuit
from pygsti_tpu.data.dataset import DataSet as JDataSet
from pygsti_tpu.data.datasetconstruction import simulate_data as jsimulate
from pygsti_tpu.models.modelconstruction import create_crosstalk_free_model as jctf
from pygsti_tpu.modelpacks import smq1Q_XYI as jxyi
from pygsti_tpu.processors import random_compilation as jrc
from pygsti_tpu.processors.processorspec import QubitProcessorSpec as JQPS
from pygsti_tpu.protocols import mirror_edesign as jme
from pygsti_tpu.protocols import protocol as jproto
from pygsti_tpu.protocols import scarab as jscarab
from pygsti_tpu.protocols import vb as jvb
from pygsti_tpu.protocols import vbdataframe as jvbdf
from pygsti_tpu.tools import dataframetools as jdft
from pygsti_tpu.tools import mcfetools as jmcfe
from pygsti_tpu.tools import rbtheory as jth

from pygsti_tpu_torch.baseobjs.label import Label as TLabel
from pygsti_tpu_torch.circuits.circuit import Circuit as TCircuit
from pygsti_tpu_torch.data.dataset import DataSet as TDataSet
from pygsti_tpu_torch.data.datasetconstruction import simulate_data as tsimulate
from pygsti_tpu_torch.models.modelconstruction import create_crosstalk_free_model as tctf
from pygsti_tpu_torch.modelpacks import smq1Q_XYI as txyi
from pygsti_tpu_torch.processors import random_compilation as trc
from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec as TQPS
from pygsti_tpu_torch.protocols import mirror_edesign as tme
from pygsti_tpu_torch.protocols import protocol as tproto
from pygsti_tpu_torch.protocols import scarab as tscarab
from pygsti_tpu_torch.protocols import vb as tvb
from pygsti_tpu_torch.protocols import vbdataframe as tvbdf
from pygsti_tpu_torch.tools import dataframetools as tdft
from pygsti_tpu_torch.tools import mcfetools as tmcfe
from pygsti_tpu_torch.tools import rbtheory as tth

ANGLE_TOL = 1e-12


def u3f(args):
    return trc.u3_unitary(*(float(a) for a in args))


def u3cx_circuit(pkg, seed=0, n=2, depth=2):
    """A u3-cx circuit from RandomState(seed): Haar-random U3s on every
    qubit, then CNOTs on alternating neighbour pairs, `depth` times."""
    Label, Circuit, me = (JLabel, JCircuit, jme) if pkg == 'jax' else (TLabel, TCircuit, tme)
    rng = np.random.RandomState(seed)
    layers = []
    for d in range(depth):
        layers.append([me.haar_random_u3(q, rng) for q in range(n)])
        layers.append([Label('Gcnot', (q, q + 1)) for q in range(d % 2, n - 1, 2)] or [])
    return Circuit([l for l in layers if l], tuple(range(n)))


def same_circuit(a, b, tol=ANGLE_TOL):
    """Layer by layer the same gates on the same qubits, U3 angles within
    `tol`."""
    if a.line_labels != b.line_labels or a.depth != b.depth:
        return False
    for la, lb in zip(a.layertup, b.layertup):
        ca = la.components if not la.is_simple else (la,)
        cb = lb.components if not lb.is_simple else (lb,)
        if len(ca) != len(cb):
            return False
        for ga, gb in zip(ca, cb):
            if ga.name != gb.name or tuple(ga.sslbls) != tuple(gb.sslbls):
                return False
            aa, ab = getattr(ga, 'args', None) or (), getattr(gb, 'args', None) or ()
            if len(aa) != len(ab) or any(abs(float(x) - float(y)) > tol for x, y in zip(aa, ab)):
                return False
    return True


# -- designs -----------------------------------------------------------------

def test_combined_and_freeform_designs_round_trip():
    """A combined design of freeform designs (with aux info) and a
    simultaneous design write their children and aux info and read back as
    what they were; the simultaneous design's circuits are the JAX
    package's."""
    c1, c2 = u3cx_circuit('torch', 1), u3cx_circuit('torch', 2)
    ff = tproto.FreeformDesign({c1: [{'idealout': '01', 'id': 0}], c2: [{'idealout': '10', 'id': 1}]})
    cd = tproto.CombinedExperimentDesign({'a': ff, 'b': tproto.FreeformDesign([c2])})
    back = tproto.ExperimentDesign.loads(cd.dumps())
    assert type(back) is tproto.CombinedExperimentDesign and back.keys() == ['a', 'b']
    assert type(back['a']) is tproto.FreeformDesign
    assert [v for v in back['a'].aux_info.values()] == [v for v in ff.aux_info.values()]
    assert [c.str for c in back.all_circuits_needing_data] == \
        [c.str for c in cd.all_circuits_needing_data]
    assert list(back['b'].aux_info.values()) == [None]

    jd = [jproto.ExperimentDesign([JCircuit([('Gx', 0)], (0,)), JCircuit([('Gy', 0)], (0,))], (0,)),
          jproto.ExperimentDesign([JCircuit([('Gy', 1), ('Gx', 1)], (1,))], (1,))]
    td = [tproto.ExperimentDesign([TCircuit([('Gx', 0)], (0,)), TCircuit([('Gy', 0)], (0,))], (0,)),
          tproto.ExperimentDesign([TCircuit([('Gy', 1), ('Gx', 1)], (1,))], (1,))]
    js, ts = jproto.SimultaneousExperimentDesign(jd), tproto.SimultaneousExperimentDesign(td)
    assert [c.str for c in ts.all_circuits_needing_data] == \
        [c.str for c in js.all_circuits_needing_data]
    assert ts.keys() == js.keys()
    back = tproto.ExperimentDesign.loads(ts.dumps())
    assert type(back) is tproto.SimultaneousExperimentDesign
    assert [c.str for c in back.all_circuits_needing_data] == \
        [c.str for c in ts.all_circuits_needing_data]


def test_jax_combined_designs_do_not_read_back():
    """The JAX package's combined, simultaneous and freeform designs write
    a state that its own reader refuses (TypeError) and drop the freeform
    aux info; the port reads that state (aux info None)."""
    c = JCircuit([('Gx', 0)], (0,))
    for design in (jproto.FreeformDesign({c: 'aux'}),
                   jproto.CombinedExperimentDesign({'x': jproto.FreeformDesign([c])}),
                   jproto.SimultaneousExperimentDesign([jproto.ExperimentDesign([c], (0,))])):
        state = design.to_nice_serialization()
        with pytest.raises(TypeError):
            jproto.ExperimentDesign.from_nice_serialization(state)
        port = tproto.ExperimentDesign.from_nice_serialization(json.loads(json.dumps(state)))
        assert type(port).__name__ == type(design).__name__
        assert [x.str for x in port.all_circuits_needing_data] == \
            [x.str for x in design.all_circuits_needing_data]
    assert 'aux_info' not in jproto.FreeformDesign({c: 'aux'}).to_nice_serialization()


# -- random compilation --------------------------------------------------------

@pytest.mark.parametrize('seed', [0, 1, 2])
def test_random_compilation_at_a_shared_random_state(seed):
    """pauli_randomize_circuit, randomize_central_pauli and RandomCompilation
    from RandomState(seed): circuit for circuit, U3 angles within 1e-12,
    bitstrings and target Paulis equal."""
    jc, tc = u3cx_circuit('jax', seed, 3, 3), u3cx_circuit('torch', seed, 3, 3)
    assert same_circuit(jc, tc, 0.0)
    for fn in ('pauli_randomize_circuit', 'randomize_central_pauli'):
        a = getattr(jrc, fn)(jc, np.random.RandomState(seed + 10), return_bs=True,
                             return_target_pauli=True)
        b = getattr(trc, fn)(tc, np.random.RandomState(seed + 10), return_bs=True,
                             return_target_pauli=True)
        assert same_circuit(a[0], b[0]) and a[1] == b[1] and np.array_equal(a[2], b[2])
    for strategy in ('pauli_rc', 'central_pauli'):
        a = jrc.RandomCompilation(strategy, True, rand_state=np.random.RandomState(seed)).compile(jc)
        b = trc.RandomCompilation(strategy, True, rand_state=np.random.RandomState(seed)).compile(tc)
        assert same_circuit(a[0], b[0]) and a[1] == b[1]
    for args in ((0.3, 0.1, -0.4), (np.pi, 0.0, 0.2), (0.0, 1.1, -2.0)):
        ja = jrc.u3_angles_from_unitary(jrc.u3_unitary(*args))
        ta = trc.u3_angles_from_unitary(trc.u3_unitary(*args))
        assert np.allclose(ja, ta, atol=ANGLE_TOL, rtol=0)
        assert np.allclose(jrc.inverse_u3(args), trc.inverse_u3(args), atol=ANGLE_TOL, rtol=0)


@pytest.mark.parametrize('strategy', ['pauli_rc', 'central_pauli'])
def test_mirror_edesign_at_a_shared_random_state(strategy):
    """make_mirror_edesign: the same families, circuits (angles within
    1e-12) and aux info, with its init layers and inverses."""
    jcs = [u3cx_circuit('jax', s, 2, 2) for s in (3, 4)]
    tcs = [u3cx_circuit('torch', s, 2, 2) for s in (3, 4)]
    a = jme.make_mirror_edesign(jcs, 3, strategy, rand_state=np.random.RandomState(5))
    b = tme.make_mirror_edesign(tcs, 3, strategy, rand_state=np.random.RandomState(5))
    assert a.keys() == b.keys()
    for key in a.keys():
        ja, ta = list(a[key].aux_info.items()), list(b[key].aux_info.items())
        assert len(ja) == len(ta)
        for (jc, jaux), (tc, taux) in zip(ja, ta):
            assert same_circuit(jc, tc) and jaux == taux
    assert same_circuit(jme.compute_inverse(jcs[0]), tme.compute_inverse(tcs[0]))
    assert same_circuit(jme.init_layer((0, 1), rand_state=np.random.RandomState(1)),
                        tme.init_layer((0, 1), rand_state=np.random.RandomState(1)))


# -- MCFE ------------------------------------------------------------------------

def test_mcfetools_values():
    """Every mcfetools function on the same inputs within 1e-12; the
    bootstrap from a shared RandomState."""
    rng = np.random.RandomState(0)
    for n in (1, 2, 4):
        for x in rng.uniform(0.05, 1.0, 5):
            for fn in ('success_probability_to_polarization', 'polarization_to_success_probability',
                       'polarization_to_fidelity', 'fidelity_to_polarization'):
                assert abs(getattr(jmcfe, fn)(x, n) - getattr(tmcfe, fn)(x, n)) < 1e-12
        hd = rng.randint(0, 50, n + 1).astype(float)
        assert abs(jmcfe.adjusted_success_probability(hd)
                   - tmcfe.adjusted_success_probability(hd)) < 1e-12
        assert abs(jmcfe.effective_polarization(hd) - tmcfe.effective_polarization(hd)) < 1e-12
        a, b, c = (rng.uniform(0.3, 1.0, 8) for _ in range(3))
        assert abs(jmcfe.rc_predicted_process_fidelity(a, b, c, n)
                   - tmcfe.rc_predicted_process_fidelity(a, b, c, n)) < 1e-12
        assert abs(jmcfe.predicted_process_fidelity_for_central_pauli_mcs(a, c, n)
                   - tmcfe.predicted_process_fidelity_for_central_pauli_mcs(a, c, n)) < 1e-12
        ja = jmcfe.rc_bootstrap_predicted_pfid(a, b, c, n, 20, np.random.RandomState(3))
        ta = tmcfe.rc_bootstrap_predicted_pfid(a, b, c, n, 20, np.random.RandomState(3))
        assert np.abs(ja - ta).max() < 1e-12
    assert np.isnan(tmcfe.rc_predicted_process_fidelity([0.5], [0.5], [-0.1], 2))
    assert tmcfe.rc_predicted_process_fidelity([0.5], [-0.5], [0.5], 2) == 0.0
    jds, tds = JDataSet(), TDataSet()
    jc, tc = JCircuit([('Gx', 0), ('Gx', 1)], (0, 1)), TCircuit([('Gx', 0), ('Gx', 1)], (0, 1))
    counts = {('00',): 5, ('01',): 7, ('11',): 20}
    jds.add_count_dict(jc, counts)
    tds.add_count_dict(tc, counts)
    assert np.array_equal(jmcfe.hamming_distance_counts(jds[jc], jc, '11'),
                          tmcfe.hamming_distance_counts(tds[tc], tc, '11'))


def _same_counts(jcircs, tcircs, jmodel, seed):
    """The JAX package's simulated counts, copied into a port DataSet."""
    jds = jsimulate(jmodel, jcircs, 2000, seed=seed)
    tds = TDataSet()
    for jc, tc in zip(jcircs, tcircs):
        tds.add_count_dict(tc, dict(jds[jc].counts))
    return jds, tds


def _u3_specs(n):
    jp = JQPS(n, ['Gu3', 'Gcnot'], geometry='line', nonstd_gate_unitaries={'Gu3': u3f})
    tp = TQPS(n, ['Gu3', 'Gcnot'], geometry='line', nonstd_gate_unitaries={'Gu3': u3f})
    return jp, tp


def test_mcfe_end_to_end_on_the_same_counts():
    """The 2-qubit MCFE case of the JAX package's tests: both packages'
    mirror designs and calculate_mirror_benchmark_results on the same
    counts; process fidelity and its bootstrap std within 1e-10; the port's
    own simulated data on the CPU near the same estimate."""
    jp, tp = _u3_specs(2)
    jmdl = jctf(jp, depolarization_strengths={'Gu3': 0.003, 'Gcnot': 0.02})
    jt = [JCircuit(
        [[JLabel('Gu3', (0,), args=(0.3, 0.1, -0.4)), JLabel('Gu3', (1,), args=(1.2, 0.5, 0.7))],
         [JLabel('Gcnot', (0, 1))]], (0, 1))]
    tt = [TCircuit([[TLabel('Gu3', (0,), args=(0.3, 0.1, -0.4)),
                     TLabel('Gu3', (1,), args=(1.2, 0.5, 0.7))], [TLabel('Gcnot', (0, 1))]], (0, 1))]
    jed = jscarab.mirror_benchmark(jt, num_mcs_per_circ=6, rand_state=np.random.RandomState(0))
    ted = tscarab.mirror_benchmark(tt, num_mcs_per_circ=6, rand_state=np.random.RandomState(0))
    jcs, tcs = jed.all_circuits_needing_data, ted.all_circuits_needing_data
    assert len(jcs) == len(tcs) == 18 and all(same_circuit(a, b) for a, b in zip(jcs, tcs))
    jds, tds = _same_counts(jcs, tcs, jmdl, 3)
    a = jscarab.calculate_mirror_benchmark_results(
        jt, jproto.ProtocolData(jed, jds), num_bootstraps=10, rand_state=np.random.RandomState(1))
    b = tscarab.calculate_mirror_benchmark_results(
        tt, tproto.ProtocolData(ted, tds), num_bootstraps=10, rand_state=np.random.RandomState(1))
    for col in ('process_fidelity', 'process_fidelity_std', 'polarization'):
        assert abs(a.dataframe[col].iloc[0] - b.table[col][0]) < 1e-10, col
    assert a.dataframe['total_counts'].iloc[0] == b.table['total_counts'][0]
    assert 0.9 < b.table['process_fidelity'][0] <= 1.0
    # the port's own data, simulated on the CPU
    tmdl = tctf(tp, depolarization_strengths={'Gu3': 0.003, 'Gcnot': 0.02})
    own = tsimulate(tmdl, tcs, 2000, seed=3, device='cpu')
    for tc, jc in zip(tcs, jcs):
        assert dict(own[tc].counts) == dict(jds[jc].counts)
    # the VB table's pandas frame where pandas is installed
    pd = pytest.importorskip('pandas')
    assert isinstance(b.dataframe, pd.DataFrame) and list(b.dataframe.columns) == b.table.columns


# -- volumetric benchmarks -------------------------------------------------------

VB_GATES = ['Gxpi2', 'Gypi2', 'Gxpi', 'Gzpi', 'Gypi', 'Gcnot']


def test_periodic_mirror_design_and_summary_statistics():
    """PeriodicMirrorCircuitDesign at seed 4 equal (circuits, ideal
    outcomes); ByDepthSummaryStatistics on the same counts equal (every
    statistic within 1e-12); the summary table equal to the JAX package's
    frame."""
    jp, tp = JQPS(2, VB_GATES, geometry='line'), TQPS(2, VB_GATES, geometry='line')
    jg = JCircuit([[('Gxpi2', 0), ('Gypi2', 1)], [('Gcnot', 0, 1)]], (0, 1))
    tg = TCircuit([[('Gxpi2', 0), ('Gypi2', 1)], [('Gcnot', 0, 1)]], (0, 1))
    jd = jvb.PeriodicMirrorCircuitDesign(jp, [0, 4, 8], 3, jg, seed=4)
    td = tvb.PeriodicMirrorCircuitDesign(tp, [0, 4, 8], 3, tg, seed=4)
    assert [c.str for c in jd.all_circuits_needing_data] == \
        [c.str for c in td.all_circuits_needing_data]
    assert [[tuple(i) for i in l] for l in jd.idealout_lists] == \
        [[tuple(i) for i in l] for l in td.idealout_lists]
    jm = jctf(jp, depolarization_strengths={'Gxpi2': 0.01, 'Gypi2': 0.01, 'Gcnot': 0.03})
    jds, tds = _same_counts(jd.all_circuits_needing_data, td.all_circuits_needing_data, jm, 2)
    # the JAX package's statistics refuse its own periodic design: they run
    # there on a BenchmarkingDesign of the same lists
    from pygsti_tpu.protocols.rb import BenchmarkingDesign as JBD
    jbd = JBD(jd.depths, jd.circuit_lists, jd.idealout_lists, jd.qubit_labels)
    a = jvb.ByDepthSummaryStatistics().run(jproto.ProtocolData(jbd, jds))
    b = tvb.ByDepthSummaryStatistics().run(tproto.ProtocolData(td, tds))
    for key, by_depth in a.statistics.items():
        for depth, vals in by_depth.items():
            assert np.allclose(np.asarray(vals, float), np.asarray(b.statistics[key][depth], float),
                               atol=1e-12, rtol=0), (key, depth)
    table = b.to_table()
    frame = a.to_dataframe()
    for col in frame.columns:
        assert np.allclose(frame[col].to_numpy(float), np.asarray(table[col], float),
                           atol=1e-12, rtol=0)


def _vb_rows(seed):
    rng = np.random.RandomState(seed)
    rows = []
    for d in [2, 4, 8]:
        for w in [1, 2, 3]:
            for _ in range(5):
                sp = max(0, 1.0 - 0.04 * d * w + rng.randn() * 0.02)
                rows.append({'Depth': d, 'Width': w, 'polarization': sp,
                             'total_counts': 100, 'Pass': int(rng.randint(2))})
    return rows


def test_jax_summary_statistics_refuse_the_periodic_mirror_design():
    """The JAX package's SummaryStatistics asserts a BenchmarkingDesign, which
    its PeriodicMirrorCircuitDesign is not; the port's take any design with
    ideal outcomes by depth."""
    jp, tp = JQPS(1, VB_GATES[:-1]), TQPS(1, VB_GATES[:-1])
    jd = jvb.PeriodicMirrorCircuitDesign(jp, [0, 2], 2, JCircuit([('Gxpi2', 0)], (0,)), seed=1)
    td = tvb.PeriodicMirrorCircuitDesign(tp, [0, 2], 2, TCircuit([('Gxpi2', 0)], (0,)), seed=1)
    jm = jctf(jp, depolarization_strengths={'Gxpi2': 0.01})
    jds, tds = _same_counts(jd.all_circuits_needing_data, td.all_circuits_needing_data, jm, 1)
    with pytest.raises(AssertionError):
        jvb.ByDepthSummaryStatistics().run(jproto.ProtocolData(jd, jds))
    res = tvb.ByDepthSummaryStatistics().run(tproto.ProtocolData(td, tds))
    assert sorted(res.statistics['polarization'].keys()) == [0, 2]


@pytest.mark.parametrize('seed', [0, 1])
def test_vbdataframe_on_the_same_rows(seed):
    """VBDataFrame.vb_data (every statistic), capability_regions (both
    monotonic settings), select_column_value and filter_data equal; the
    port's table needs no pandas."""
    import pandas as pd
    rows = _vb_rows(seed)
    a = jvbdf.VBDataFrame(pd.DataFrame(rows))
    b = tvbdf.VBDataFrame.from_benchmarking_data(rows)
    for stat in ('mean', 'max', 'min', 'monotonic_min', 'monotonic_max', 'min_w_nan'):
        va, vb = a.vb_data(statistic=stat), b.vb_data(statistic=stat)
        assert va.keys() == vb.keys() and all(abs(va[k] - vb[k]) < 1e-12 for k in va), stat
    for thr in (0.3, 0.7):
        for mono in (True, False):
            assert a.capability_regions(threshold=thr, monotonic=mono) == \
                b.capability_regions(threshold=thr, monotonic=mono)
    sa, sb = a.select_column_value('Pass', 1), b.select_column_value('Pass', 1)
    assert sa.vb_data() == pytest.approx(sb.vb_data(), abs=1e-12)
    for indep in (True, False):
        fa, fb = a.filter_data('Pass', indep_x=indep), b.filter_data('Pass', indep_x=indep)
        assert np.allclose(fa.dataframe['polarization'].to_numpy(), fb.table['polarization'],
                           atol=0, rtol=0)
    for args in ((None, None, True), ('Width', 'polarization', False), (None, None, ['Pass'])):
        ja = jdft._process_dataframe(pd.DataFrame(rows), *args)
        ta = tdft._process_dataframe(tdft.ColumnTable.from_rows(rows), *args)
        assert [str(c) for c in ja.columns] == [str(c) for c in ta.columns]
        for c in ja.columns:
            assert np.allclose(ja[c].to_numpy(float), np.asarray(ta[c], float), atol=1e-12,
                               equal_nan=True)
    from_frame = tvbdf.VBDataFrame(pd.DataFrame(rows))
    assert from_frame.vb_data() == b.vb_data() and from_frame.table.columns == b.table.columns
    assert jvbdf.classify_circuit_shape([0.9] * 5 + [0.1] * 5, [500] * 10, 0.5) == \
        tvbdf.classify_circuit_shape([0.9] * 5 + [0.1] * 5, [500] * 10, 0.5) == 1


@pytest.mark.parametrize('norm', ['diamond', '1to1', 'fro'])
def test_gate_dependence_of_errormaps(norm):
    """rbtheory.gate_dependence_of_errormaps within 1e-9 on a model whose
    gates are depolarized by different amounts and rotated."""
    jt, tt = jxyi.target_model('static'), txyi.target_model('static')
    jm = jxyi.target_model('full TP').depolarize(op_noise=0.02).rotate(max_rotate=0.05, seed=4)
    tm = txyi.target_model('full TP')
    tm.from_vector(jm.to_vector())
    a = jth.gate_dependence_of_errormaps(jm, jt, norm=norm)
    b = tth.gate_dependence_of_errormaps(tm, tt, norm=norm)
    assert a > 1e-4 and abs(a - b) < 1e-9


def test_port_tables_need_no_pandas(monkeypatch):
    """With pandas unimportable the VB table, its summaries and the MCFE
    results work; ``.dataframe`` raises ImportError naming the table."""
    import sys
    monkeypatch.setitem(sys.modules, 'pandas', None)
    b = tvbdf.VBDataFrame.from_benchmarking_data(_vb_rows(0))
    assert len(b.vb_data()) == 9 and len(b.capability_regions(threshold=0.5)) == 9
    with pytest.raises(ImportError, match='ColumnTable'):
        b.dataframe
    t = tdft._process_dataframe(b.table, 'Width', 'polarization', ['Pass'])
    assert len(t) == 3 and t.columns == ['Depth', 'total_counts', 1, 2, 3]


@pytest.mark.parametrize('fn', ['create_mirror_rb_circuit', 'create_direct_rb_circuit',
                                'create_clifford_rb_circuit'])
def test_jax_rb_samplers_fail_on_a_qubit_subset(fn):
    """The JAX package's RB samplers read a circuit on a subset of the
    pspec's qubits through all of the pspec's qubits and raise; the port's
    give circuits on the subset whose ideal outcome the stabilizer
    simulator gives probability 1 (at full width they are the JAX
    package's: tests/test_torch_rb.py)."""
    from pygsti_tpu.algorithms import randomcircuit as jrcirc
    from pygsti_tpu_torch.algorithms import randomcircuit as trcirc
    from pygsti_tpu_torch.forwardsims.stabilizersim import StabilizerForwardSimulator
    jp, tp = JQPS(4, VB_GATES, geometry='line'), TQPS(4, VB_GATES, geometry='line')
    with pytest.raises((ValueError, AssertionError)):
        getattr(jrcirc, fn)(jp, None, 4, (0, 1), rand_state=np.random.RandomState(0))
    for qs in ((0,), (1, 2), (0, 1, 2, 3)):
        c, ideal = getattr(trcirc, fn)(tp, None, 4, qs, rand_state=np.random.RandomState(0))
        assert c.line_labels == qs and len(ideal) == len(qs)
        assert StabilizerForwardSimulator(tp).probability(c, ''.join(map(str, ideal))) == 1.0
