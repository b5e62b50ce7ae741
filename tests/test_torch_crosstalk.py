"""The port's extras/crosstalk against the JAX package's: the G^2 test
(within 1e-10), the PC skeleton and separation sets (equal edge sets to the
JAX package's networkx graphs), the CPDAG, do_basic_crosstalk_detection on
matrix, tuple and DataSet input (crosstalk matrices equal, TVDs within
1e-8), the pairwise detector, the data conversions and the experiment
design; the JAX package's faults of ROADMAP.md section 3 (an edge deleted
by conflicting v-structures; a design whose settings cannot show
crosstalk) and the results' plot.  Cases from tests/test_extras.py."""

import itertools
import sys

import numpy as np
import pytest

from pygsti_tpu.extras import crosstalk as jct
from pygsti_tpu.extras.crosstalk import pcalg as jpc
from pygsti_tpu.baseobjs.label import Label as JLabel
from pygsti_tpu.circuits.circuit import Circuit as JCircuit
from pygsti_tpu.data.dataset import DataSet as JDataSet

from pygsti_tpu_torch.extras import crosstalk as tct
from pygsti_tpu_torch.extras.crosstalk import pcalg as tpc
from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.data.dataset import DataSet


def _make_tuples(coupling, n_samples, seed=0):
    """tests/test_extras.py's data: 2 regions; region 0's outcome depends on
    region 1's setting iff coupling > 0."""
    rng = np.random.RandomState(seed)
    tuples = []
    for _ in range(n_samples):
        s0, s1 = rng.randint(2), rng.randint(2)
        o0 = int(rng.rand() < 0.2 + coupling * s1)
        o1 = int(rng.rand() < 0.5)
        tuples.append(((s0, s1), (o0, o1)))
    return tuples


def _three_region_matrix(seed=7, n=6000):
    rng = np.random.RandomState(seed)
    s = rng.randint(0, 2, size=(n, 3))
    o = rng.randint(0, 2, size=(n, 3))
    o[:, 1] = (rng.rand(n) < (0.15 + 0.6 * s[:, 2])).astype(int)
    return np.hstack([o, s])


def _chain_data(seed=0, n=5000):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 2, n)
    z = (x + (rng.rand(n) < 0.1)).astype(int) % 2
    y = (z + (rng.rand(n) < 0.1)).astype(int) % 2
    w = rng.randint(0, 3, n)
    return np.stack([x, y, z, w], axis=1)


def test_g_square_matches_jax():
    data = _chain_data()
    for x, y in itertools.permutations(range(4), 2):
        for k in range(3):
            for s in itertools.combinations([c for c in range(4) if c not in (x, y)], k):
                assert abs(tpc.g_square_dis(data, x, y, s) - jpc.g_square_dis(data, x, y, s)) \
                    < 1e-10
    assert tpc.g_square_dis(data, 0, 1, ()) < 0.01 and tpc.g_square_dis(data, 0, 1, (2,)) > 0.01
    assert tpc.g_square_dis(data[:30], 0, 3, (1, 2)) == 1.0     # too few samples


@pytest.mark.parametrize("case", ['chain', 'three regions', 'two regions'])
def test_skeleton_and_cpdag_match_jax(case):
    if case == 'chain':
        data, ignore = _chain_data(), None
    elif case == 'three regions':
        data, ignore = _three_region_matrix(), [(4, 3), (5, 3), (5, 4)]
    else:
        data = jct.tuples_to_data_matrix(_make_tuples(0.5, 4000), 2)[0]
        ignore = [(3, 2)]
    ts, tsep = tpc.estimate_skeleton(tpc.g_square_dis, data, 0.05, ignore)
    js, jsep = jpc.estimate_skeleton(jpc.g_square_dis, data, 0.05, ignore)
    assert ts.edges() == sorted(js.edges())
    assert tsep == jsep
    tg, jg = tpc.estimate_cpdag(ts, tsep), jpc.estimate_cpdag(js, jsep)
    assert tg.edges() == list(jg.edges())
    assert ts.nodes() == list(js.nodes())


def test_cpdag_keeps_an_edge_of_conflicting_v_structures():
    """ROADMAP.md section 3: a -> c <- b and c -> d <- e orient c - d both
    ways; the JAX package removes both directions and loses the adjacency,
    the port keeps it, oriented by the first v-structure."""
    skel = tpc.Skeleton(5)
    import networkx as nx
    jskel = nx.complete_graph(5)
    keep = {(0, 2), (1, 2), (2, 3), (3, 4)}
    for i, j in itertools.combinations(range(5), 2):
        if (i, j) not in keep:
            skel.remove_edge(i, j)
            jskel.remove_edge(i, j)
    sep = [[set() for _ in range(5)] for _ in range(5)]
    t, j = tpc.estimate_cpdag(skel, sep), jpc.estimate_cpdag(jskel, sep)
    assert (2, 3) not in j.edges() and (3, 2) not in j.edges()
    assert (2, 3) in t.edges() or (3, 2) in t.edges()
    assert {(0, 2), (1, 2), (4, 3)} <= set(t.edges())


@pytest.mark.parametrize("case", ['tuples', 'matrix', 'dataset', 'null'])
def test_basic_detection_matches_jax(case):
    """Crosstalk matrix, edge flags and TVD weights within 1e-8 of the JAX
    package's (tests/test_extras.py's inputs)."""
    kw = dict(verbosity=0)
    if case in ('tuples', 'null'):
        args = (_make_tuples(0.5 if case == 'tuples' else 0.0, 4000), 2)
        jargs = args
    elif case == 'matrix':
        args = jargs = (_three_region_matrix(), 3)
        kw['settings'] = [1, 1, 1]
    else:
        tds, jds = DataSet(), JDataSet()
        for i, g0 in enumerate(('Gxpi2', 'Gypi2')):
            p1 = 0.2 if g0 == 'Gxpi2' else 0.8
            counts = {b0 + b1: int(round(4000 * 0.5 * (p1 if b1 == '1' else 1 - p1)))
                      for b0, b1 in itertools.product('01', '01')}
            aux = {'settings': {(0,): i, (1,): 0}}
            tds.add_count_dict(Circuit([Label(g0, 0), Label('Gxpi2', 1)], (0, 1)), counts,
                               aux=aux)
            jds.add_count_dict(JCircuit([JLabel(g0, 0), JLabel('Gxpi2', 1)], (0, 1)), counts,
                               aux=aux)
        args, jargs = (tds, 2), (jds, 2)
        kw['settings'] = [1, 1]
        np.testing.assert_array_equal(tct.form_ct_data_matrix(tds, 2, [1, 1]),
                                      jct.form_ct_data_matrix(jds, 2, [1, 1]))
    t = tct.do_basic_crosstalk_detection(*args, **kw)
    j = jct.do_basic_crosstalk_detection(*jargs, **kw)
    np.testing.assert_array_equal(t.cmatrix, j.cmatrix)
    np.testing.assert_array_equal(t.is_edge_ct, j.is_edge_ct)
    assert t.graph.edges() == list(j.graph.edges())
    assert sorted(t.max_tvds) == sorted(j.max_tvds)
    for k in t.max_tvds:
        assert abs(t.max_tvds[k] - j.max_tvds[k]) < 1e-8
        assert abs(t.median_tvds[k] - j.median_tvds[k]) < 1e-8
        np.testing.assert_allclose(t.edge_tvds[k], j.edge_tvds[k], rtol=0, atol=1e-8)
    assert t.crosstalk_pairs == j.crosstalk_pairs
    assert t.node_labels == j.node_labels and str(t) == str(j)
    assert t.show_crosstalk_table() == j.show_crosstalk_table()
    if case == 'null':
        assert not t.any_crosstalk_detect()
    else:
        assert t.any_crosstalk_detect()
    with pytest.raises(ValueError):
        tct.do_basic_crosstalk_detection(_three_region_matrix(), 3, settings=[1, 1], verbosity=0)


@pytest.mark.parametrize("coupling", [0.0, 0.5])
def test_pairwise_detection_matches_jax(coupling):
    tuples = _make_tuples(coupling, 500)
    t = tct.do_pairwise_crosstalk_detection(tuples, 2)
    j = jct.do_pairwise_crosstalk_detection(tuples, 2)
    assert sorted(t.pvalues) == sorted(j.pvalues)
    for k in t.pvalues:
        assert abs(t.pvalues[k] - j.pvalues[k]) < 1e-10
        assert abs(t.effect_sizes[k] - j.effect_sizes[k]) < 1e-10
    assert t.crosstalk_pairs == j.crosstalk_pairs and str(t) == str(j)
    np.testing.assert_allclose(t.crosstalk_matrix(), j.crosstalk_matrix(), rtol=0, atol=1e-10)
    assert t.crosstalk_detected == (coupling > 0)


def test_dataset_tuples_match_jax():
    rng = np.random.RandomState(4)
    tds, jds = DataSet(), JDataSet()
    for g0 in ('Gxpi2', 'Gypi2'):
        for rep in range(2):
            counts = {b0 + b1: int(rng.randint(100, 2000)) for b0, b1 in
                      itertools.product('01', '01')}
            tds.add_count_dict(Circuit([Label(g0, 0), Label('Gxpi2', 1)] * (rep + 1), (0, 1)),
                               counts)
            jds.add_count_dict(JCircuit([JLabel(g0, 0), JLabel('Gxpi2', 1)] * (rep + 1), (0, 1)),
                               counts)
    assert tct.form_ct_data_tuples(tds, [(0,), (1,)]) == jct.form_ct_data_tuples(jds, [(0,), (1,)])
    t = tct.do_crosstalk_detection_on_dataset(tds, [(0,), (1,)])
    j = jct.do_crosstalk_detection_on_dataset(jds, [(0,), (1,)])
    assert t.pvalues == pytest.approx(j.pvalues, abs=1e-10)


def test_experiment_matches_jax_and_numbers_settings_across_lengths():
    """With the JAX package's population (max(4, circuits per length)) the
    circuits are the JAX package's; each setting is 1 + the population
    index + the population size times the length's index, where the JAX
    package's starts again at 1 for each length."""
    qubits, lengths, cpl = ['Q0', 'Q1', 'Q2'], [2, 4, 3], 6
    jc, js = jct.crosstalk_detection_experiment(qubits, lengths, cpl, seed=3)
    tc, ts = tct.crosstalk_detection_experiment(qubits, lengths, cpl, seed=3,
                                                circuit_population_sz=max(4, cpl))
    assert [c.str for c in tc] == [c.str for c in jc]
    for k, (a, b) in enumerate(zip(ts, js)):
        li = k // cpl
        assert a == tuple(0 if s == 0 else s + max(4, cpl) * li for s in b)
    dc, dset = tct.crosstalk_detection_experiment(qubits, lengths, cpl, seed=3)
    assert len(dc) == len(lengths) * cpl
    assert {s for st in dset for s in st} <= set(range(1 + 3 * len(lengths)))
    assert all(c.line_labels == tuple(qubits) for c in dc)


@pytest.fixture(scope='module')
def four_qubit_data():
    """The crosstalk part of chip_smoke.py's phase 33 on the CPU:
    ibmq_bogota's first 4 qubits, a cloud-crosstalk model whose Gxpi2 on Q1
    carries an 'XX' Hamiltonian error of 0.05 on Q1 and Q2, and the same
    model without it; 200 circuits per length 10, 20, 40 at 100 shots."""
    from pygsti_tpu_torch.extras import devices
    from pygsti_tpu_torch.models.modelconstruction import create_cloud_crosstalk_model
    from pygsti_tpu_torch.protocols.protocol import DataCountsSimulator, ExperimentDesign
    qubits = ('Q0', 'Q1', 'Q2', 'Q3')
    pspec = devices.create_processor_spec('ibmq_bogota', ('Gxpi2', 'Gypi2'),
                                          qubitsubset=list(qubits))
    ct = create_cloud_crosstalk_model(pspec, lindblad_error_coeffs={
        'Gxpi2': {('H', 'XX:@0,Q2'): 0.05}})
    for key, member in ct.operation_blks['cloudnoise'].items():
        if key != ('Gxpi2', ('Q1',)):
            member.from_vector(np.zeros(member.num_params))
    ct._mark_for_rebuild()
    out = {}
    for design_kind, kw in (('port', {}), ('jax', {'circuit_population_sz': 200})):
        circuits, settings = tct.crosstalk_detection_experiment(pspec, (10, 20, 40), 200,
                                                                seed=7, **kw)
        if design_kind == 'jax':      # the JAX package's settings
            settings = [tuple(0 if s == 0 else 1 + (s - 1) % 200 for s in st)
                        for st in settings]
        by = {}
        for c, s in zip(circuits, settings):
            by.setdefault(c, s)
        design = ExperimentDesign(list(by), qubits)
        for tag, m in (('crosstalk', ct), ('null', create_cloud_crosstalk_model(pspec))):
            ds = DataCountsSimulator(m, 100, seed=8, device='cpu').run(design).dataset
            for c in ds.keys():
                ds.auxInfo[c]['settings'] = {(r,): s for r, s in enumerate(by[c])}
            out[design_kind, tag] = ds
    return out


def test_four_qubit_design_finds_the_planted_edge(four_qubit_data):
    t = {tag: tct.do_basic_crosstalk_detection(four_qubit_data['port', tag], 4, verbosity=0)
         for tag in ('crosstalk', 'null')}
    assert {(1, 2), (2, 1)} & set(t['crosstalk'].crosstalk_pairs)
    assert t['null'].crosstalk_pairs == []


def test_jax_design_flags_pairs_without_crosstalk(four_qubit_data):
    """ROADMAP.md section 3: the JAX package's design (200 sequences per
    length, settings that start again per length) through the JAX package's
    detection flags region pairs that carry no crosstalk."""
    flagged = set()
    for tag in ('crosstalk', 'null'):
        jds = JDataSet()
        ds = four_qubit_data['jax', tag]
        for c in ds.keys():
            jds.add_count_dict(JCircuit(c.str), {o[0]: n for o, n in ds[c].counts.items()},
                               aux=ds.auxInfo[c])
        flagged |= set(jct.do_basic_crosstalk_detection(jds, 4, verbosity=0).crosstalk_pairs)
    assert flagged - {(1, 2), (2, 1)}


def test_plot_needs_networkx_and_matplotlib(monkeypatch, tmp_path):
    import matplotlib
    matplotlib.use('Agg')
    res = tct.do_basic_crosstalk_detection(_make_tuples(0.5, 4000), 2, verbosity=0)
    fig = res.plot_crosstalk_graph(str(tmp_path / 'g.png'))
    assert fig is not None and (tmp_path / 'g.png').exists()
    monkeypatch.setitem(sys.modules, 'networkx', None)
    with pytest.raises(ImportError, match="networkx and matplotlib"):
        res.plot_crosstalk_graph()
