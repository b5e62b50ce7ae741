"""The port's text formats, JSON codec and storage against the JAX
package's: the parser grammar case by case, the writers byte for byte,
each package reading the other's files, and the decisions the port takes
where the JAX package is at fault (faults (a), (b), (c), (f) and (g) of
ROADMAP.md section 3).  Counts are exact; dense model matrices agree within
1e-15."""

import collections
import json
import os
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

from pygsti_tpu.circuits.circuit import Circuit as JCircuit
from pygsti_tpu.data.dataset import DataSet as JDataSet
from pygsti_tpu.data.multidataset import MultiDataSet as JMultiDataSet
from pygsti_tpu.io import readers as jreaders, stdinput as jstdinput, writers as jwriters
from pygsti_tpu.serialization import jsoncodec as jcodec
import pygsti_tpu.modelpacks.smq1Q_XYI as jmp

from pygsti_tpu_torch.circuits.circuit import Circuit as TCircuit
from pygsti_tpu_torch.data.dataset import DataSet as TDataSet
from pygsti_tpu_torch.data.multidataset import MultiDataSet as TMultiDataSet
from pygsti_tpu_torch.io import readers as treaders, stdinput as tstdinput, writers as twriters
from pygsti_tpu_torch.io import metadir, mongodb
from pygsti_tpu_torch.baseobjs.mongoserializable import _MockCollection
from pygsti_tpu_torch.serialization import jsoncodec as tcodec
import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp

PKGS = {
    'jax': SimpleNamespace(Circuit=JCircuit, DataSet=JDataSet, MultiDataSet=JMultiDataSet,
                           Parser=jstdinput.StdInputParser, stdinput=jstdinput,
                           readers=jreaders, writers=jwriters, mp=jmp),
    'port': SimpleNamespace(Circuit=TCircuit, DataSet=TDataSet, MultiDataSet=TMultiDataSet,
                            Parser=tstdinput.StdInputParser, stdinput=tstdinput,
                            readers=treaders, writers=twriters, mp=tmp),
}


def summary(ds):
    """(outcome labels, per row: circuit string, counts, times, reps,
    outcome series) of either package's DataSet."""
    rows = []
    for c in ds.keys():
        r = ds[c]
        rows.append((c.str, [(tuple(k), v) for k, v in r.counts.items()],
                     None if r.time is None else [float(t) for t in r.time],
                     None if r.reps is None else [float(x) for x in r.reps],
                     None if r.outcome_series is None else [tuple(o) for o in r.outcome_series]))
    return [tuple(o) for o in ds.outcome_labels], rows


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return fn()


# -- grammar: the cases of tests/test_io_grammar.py::TestParserGrammar, and a
# -- few more, through both parsers -------------------------------------------

def _write(tmp_path, name, text):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return str(path)


def _g_adjacent(pkg, tmp_path):
    c = pkg.Circuit('GxGxGy@(Q0)')
    return c.str, [str(l) for l in c.layertup]


def _g_fixed_column_dataline(pkg, tmp_path):
    c, counts = pkg.Parser().parse_dataline('GxGy@(Q0) 90 10', expected_counts=2)
    return c.str, counts


def _g_dataline_sentinels(pkg, tmp_path):
    p = pkg.Parser()
    return [p.parse_dataline('Gx@(Q0) -- 10', expected_counts=2)[1],
            p.parse_dataline('Gx@(Q0) BAD')[1]]


def _g_outcome_count_dataline(pkg, tmp_path):
    return pkg.Parser().parse_dataline('Gx@(Q0) 0:90 1:10')[1]


def _g_datafile_with_times_blocks(pkg, tmp_path):
    path = _write(tmp_path, 'tds.txt', "## Outcomes = 0, 1\n{}@(Q0)\ntimes: 0.0 1.0 2.0\n"
                  "outcomes: 0 0 1\nrepetitions: 10 20 5\n\nGx@(Q0)\ntimes: 0.0 1.0\n"
                  "outcomes: 1 0\nrepetitions: 7 3\n")
    return summary(pkg.Parser().parse_datafile(path))


def _g_multidatafile(pkg, tmp_path):
    path = _write(tmp_path, 'mds.txt', "## Columns = DS0 0 count, DS0 1 count, DS1 0 count, "
                  "DS1 count total\n{}@(Q0) 80 20 30 100\nGx@(Q0) 50 50 60 100\n")
    mds = pkg.Parser().parse_multidatafile(path)
    return [(k, summary(mds[k])) for k in mds.keys()]


def _g_frequency_columns(pkg, tmp_path):
    path = _write(tmp_path, 'fds.txt', "## Columns = DSa 1 frequency, DSa count total\n"
                  "{}@(Q0) 0.25 200\n")
    mds = pkg.Parser().parse_multidatafile(path)
    return [(k, summary(mds[k])) for k in mds.keys()]


def _g_tddatafile(pkg, tmp_path):
    path = _write(tmp_path, 'td.txt', "# explicit timestamped format\n0.0 Gx@(Q0) 1\n"
                  "1.5 Gx@(Q0) 0\n0.7 {}@(Q0) 0\n")
    return summary(pkg.Parser().parse_tddatafile(path))


def _g_lookup_beside_the_file(pkg, tmp_path):
    """A Lookup file named relative to the data file's folder, read from
    another working directory, which the parser leaves as it was."""
    _write(tmp_path, 'sub/dict.txt', "# the lookup\nF1 Gx\nF2 GxGy\n")
    path = _write(tmp_path, 'sub/data.txt', "## Lookup = dict.txt\n## Columns = 0 count, "
                  "1 count\nS<F1>  10  90\nS<F2>  40  60\nGy  1  2\n")
    cwd = os.getcwd()
    ds = pkg.Parser().parse_datafile(path)
    assert os.getcwd() == cwd
    return summary(ds)


def _g_sentinels_zero_lines_and_comments(pkg, tmp_path):
    path = _write(tmp_path, 'z.txt', "# a comment line\n## Columns = 1 count, 0 count\n"
                  "{}  5  95  # trailing comment\nGx  --  40\nGy  BAD  BAD\nGxGx  0  0\n"
                  "GyGy  0  100\n")
    return [summary(_quiet(lambda: pkg.Parser().parse_datafile(path, **kw)))
            for kw in ({}, {'record_zero_counts': False})]


def _g_outcome_pairs_and_std_qubits(pkg, tmp_path):
    path = _write(tmp_path, 'p.txt', "## StdOutcomeQubits = 2\nGx:0@(0,1)  00:90 11:10\n"
                  "Gy:1@(0,1)  01:3 10:0\n")
    return [summary(_quiet(lambda: pkg.Parser().parse_datafile(path, **kw)))
            for kw in ({}, {'record_zero_counts': False})]


def _g_series_with_aux_and_no_reps(pkg, tmp_path):
    path = _write(tmp_path, 'a.txt', "## Outcomes = 0, 1\nGx\ntimes: 0 0.5 1\n"
                  "outcomes: 1 1 0\naux: {'run': 3}\n\nGy\ntimes: 2 3\noutcomes: 0 1\n")
    return summary(pkg.Parser().parse_datafile(path))


def _g_string_and_dict_files(pkg, tmp_path):
    path = _write(tmp_path, 's.txt', "# circuits\nGxGy\n\n{}@(0)\n(Gx)^2Gy@(0)\n")
    dpath = _write(tmp_path, 'd.txt', "A GxGy\nB (Gx)^3\n")
    p = pkg.Parser()
    return ([c.str for c in p.parse_stringfile(path)], p.parse_dictfile(dpath),
            [c.str for c in pkg.readers.read_circuit_list(path)])


def _g_multidatafile_missing_and_implied(pkg, tmp_path):
    path = _write(tmp_path, 'm2.txt', "## Columns = A 1 count, A count total, B 0 count, "
                  "B 1 count\n{}  30  100  --  7\nGx  0  0  0  0\nGy  10  50  5  5\n")
    mds = pkg.Parser().parse_multidatafile(path)
    return [(k, summary(mds[k])) for k in mds.keys()]


GRAMMAR = {f.__name__[3:]: f for f in (
    _g_adjacent, _g_fixed_column_dataline, _g_dataline_sentinels, _g_outcome_count_dataline,
    _g_datafile_with_times_blocks, _g_multidatafile, _g_frequency_columns, _g_tddatafile,
    _g_lookup_beside_the_file, _g_sentinels_zero_lines_and_comments,
    _g_outcome_pairs_and_std_qubits, _g_series_with_aux_and_no_reps, _g_string_and_dict_files,
    _g_multidatafile_missing_and_implied)}


@pytest.mark.parametrize('case', sorted(GRAMMAR))
def test_parser_grammar_matches_jax(case, tmp_path):
    """The same text through both parsers: the same circuits, counts,
    times, repetitions, series and outcome labels (exactly)."""
    got = {name: GRAMMAR[case](pkg, tmp_path / name) for name, pkg in PKGS.items()}
    assert got['port'] == got['jax']


# -- the writers byte for byte, and each package reading the other's files ---

def _circuits(pkg, strs):
    return [pkg.Circuit(s) for s in strs]


DATASETS = {
    'static_1q': (['{}@(0)', 'Gxpi2:0@(0)', 'Gxpi2:0Gypi2:0@(0)', '(Gxpi2:0)^4@(0)'],
                  [{'0': 95, '1': 5}, {'0': 52, '1': 48}, {'1': 3, '0': 97}, {'0': 1000}]),
    'zero_counts_2q': (['{}@(0,1)', 'Gxpi2:0@(0,1)', 'Gcnot:0:1Gxpi2:1@(0,1)'],
                       [{'00': 990, '01': 0, '10': 10, '11': 0},
                        {'00': 480, '01': 0, '10': 520, '11': 0},
                        {'00': 0, '01': 250, '10': 250, '11': 500}]),
}


def _build(pkg, kind):
    if kind == 'time_stamped':
        ds = pkg.DataSet(outcome_labels=['0', '1'])
        for s, ols, ts, reps in (('Gxpi2:0@(0)', ['0', '1', '0'], [0.0, 0.0, 1.25], [3, 2, 5]),
                                 ('Gypi2:0@(0)', ['1', '0', '1'], [0.5, 0.5, 2.0], [1, 4, 1])):
            ds.add_raw_series_data(pkg.Circuit(s), ols, ts, reps)
        return ds
    if kind == 'multi':
        mds = pkg.MultiDataSet()
        for name, shift in (('day1', 0), ('day2', 7)):
            ds = pkg.DataSet()
            for c, counts in zip(_circuits(pkg, DATASETS['static_1q'][0]),
                                 DATASETS['static_1q'][1]):
                ds.add_count_dict(c, {k: v + shift for k, v in counts.items()})
            mds.add_dataset(name, ds)
        return mds
    strs, counts = DATASETS[kind]
    ds = pkg.DataSet()
    for c, cd in zip(_circuits(pkg, strs), counts):
        ds.add_count_dict(c, cd)
    return ds


def _write_ds(pkg, kind, obj, path):
    if kind == 'multi':
        pkg.writers.write_multidataset(path, obj)
    else:
        pkg.writers.write_dataset(path, obj)


def _read_ds(pkg, kind, path):
    if kind == 'multi':
        mds = pkg.readers.read_multidataset(path, record_zero_counts=True)
        return [(k, summary(mds[k])) for k in mds.keys()]
    return summary(pkg.readers.read_dataset(path, record_zero_counts=True))


@pytest.mark.parametrize('kind', ['static_1q', 'zero_counts_2q', 'time_stamped', 'multi'])
def test_dataset_files_byte_for_byte(kind, tmp_path):
    """The same count dicts in both packages write the same bytes, and
    each package reads either file to the same dataset."""
    objs = {name: _build(pkg, kind) for name, pkg in PKGS.items()}
    paths = {name: str(tmp_path / ('%s.txt' % name)) for name in PKGS}
    for name, pkg in PKGS.items():
        _write_ds(pkg, kind, objs[name], paths[name])
    with open(paths['jax'], 'rb') as f, open(paths['port'], 'rb') as g:
        assert f.read() == g.read()
    reads = {(reader, writer): _read_ds(PKGS[reader], kind, paths[writer])
             for reader in PKGS for writer in PKGS}
    assert len({json.dumps(v) for v in reads.values()}) == 1
    if kind != 'multi':
        nonzero = [sorted((o, n) for o, n in counts if n) for _, counts, *_ in
                   reads[('port', 'port')][1]]
        assert nonzero == [sorted((o, n) for o, n in counts if n)
                           for _, counts, *_ in summary(objs['port'])[1]]


def test_default_read_drops_zero_counts(tmp_path):
    """read_dataset's default (record_zero_counts=False, as in the JAX
    package and pyGSTi) drops the zero columns: fewer degrees of freedom."""
    path = str(tmp_path / 'z.txt')
    twriters.write_dataset(path, _build(PKGS['port'], 'zero_counts_2q'))
    dof = {}
    for name, pkg in PKGS.items():
        dense = pkg.readers.read_dataset(path, record_zero_counts=True)
        sparse = pkg.readers.read_dataset(path)
        dof[name] = (dense.degrees_of_freedom(), sparse.degrees_of_freedom(), summary(sparse))
    assert dof['port'] == dof['jax']
    assert dof['port'][:2] == (9, 4)


def test_circuit_lists_and_strings_byte_for_byte(tmp_path):
    strs = ['{}@(0)', 'Gxpi2:0@(0)', '(Gxpi2:0Gypi2:0)^2@(0)', 'Gypi2:0Gypi2:0Gypi2:0@(0)']
    out = {}
    for name, pkg in PKGS.items():
        cs = _circuits(pkg, strs)
        pkg.writers.write_circuit_list(str(tmp_path / ('%s.txt' % name)), cs, header="list")
        obj = {'lists': [cs[:2], tuple(cs[2:])], cs[0]: 'first', 'n': 4}
        pkg.writers.write_circuit_strings(str(tmp_path / ('%s.json' % name)), obj)
        out[name] = [(tmp_path / ('%s.%s' % (name, ext))).read_bytes() for ext in ('txt', 'json')]
    assert out['port'] == out['jax']
    for reader in PKGS.values():
        for writer in PKGS:
            back = reader.readers.read_circuit_list(str(tmp_path / ('%s.txt' % writer)))
            assert [c.str for c in back] == strs
            obj = reader.readers.read_circuit_strings(str(tmp_path / ('%s.json' % writer)))
            assert [[c.str for c in l] for l in obj['lists']] == [strs[:2], strs[2:]]
            assert [(k.str if isinstance(k, reader.Circuit) else k) for k in obj] == \
                ['lists', strs[0], 'n']


@pytest.mark.parametrize('gate_type', ['full TP', 'full'])
def test_model_files_byte_for_byte(gate_type, tmp_path):
    """write_model writes the same bytes in both packages; parse_model of
    either file gives each package the same dense members (1e-15)."""
    jm, tm = jmp.target_model(gate_type), tmp.target_model(gate_type)
    theta = jm.to_vector() + 0.01 * np.random.RandomState(5).randn(jm.num_params)
    jm.from_vector(theta)
    tm.from_vector(theta)
    jwriters.write_model(jm, str(tmp_path / 'jax.txt'), title='model')
    twriters.write_model(tm, str(tmp_path / 'port.txt'), title='model')
    assert (tmp_path / 'jax.txt').read_bytes() == (tmp_path / 'port.txt').read_bytes()
    for writer in PKGS:
        path = str(tmp_path / ('%s.txt' % writer))
        jback, tback = jstdinput.parse_model(path), tstdinput.parse_model(path)
        assert tback.default_gate_type == jback.default_gate_type == gate_type
        for lbl in jback.operations:
            assert np.max(np.abs(tback.operations[lbl].dense()
                                 - np.asarray(jback.operations[lbl].to_dense()))) < 1e-15
        for lbl in jback.preps:
            assert np.max(np.abs(tback.preps[lbl].dense()
                                 - np.asarray(jback.preps[lbl].to_dense()))) < 1e-15
        for lbl in jback.povms:
            assert np.max(np.abs(tback.povms[lbl].dense()
                                 - np.asarray(jback.povms[lbl].to_dense()))) < 1e-15
        # '%16.8g': eight significant digits
        assert np.max(np.abs(tback.operations[('Gxpi2', 0)].dense()
                             - tm.operations[('Gxpi2', 0)].dense())) < 1e-7


# -- the JSON codec -------------------------------------------------------------

def test_jsoncodec_round_trips_across_packages():
    """Arrays, tuples, dict keys of any type, complex numbers and a model's
    nice state: each package decodes the other's encoding."""
    obj = {('a', 1): [np.arange(6.0).reshape(2, 3), (1, 'x')], 'c': 1 + 2j,
           'i': np.array([1, 2], dtype=np.int32), 'f': np.float64(0.5)}
    for enc in (jcodec, tcodec):
        back = tcodec.loads(enc.dumps(obj))
        assert set(back) == set(obj)
        assert np.array_equal(back[('a', 1)][0], obj[('a', 1)][0])
        assert back[('a', 1)][1] == (1, 'x') and back['c'] == 1 + 2j
        assert back['i'].dtype == np.int32 and back['f'] == 0.5
    from pygsti_tpu.protocols.gst import StandardGSTDesign as JSD
    jm = jmp.target_model('full TP').depolarize(op_noise=0.03)
    jd = JSD(jm, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), [1, 2])
    td = tcodec.loads(jcodec.dumps(jd))
    assert type(td).__module__ == 'pygsti_tpu_torch.protocols.gst'
    assert [c.str for c in td.all_circuits_needing_data] == \
        [c.str for c in jd.all_circuits_needing_data]
    assert np.array_equal(td.target_model.to_vector(), np.asarray(jm.to_vector()))
    tm = td.target_model
    assert np.array_equal(tcodec.loads(tcodec.dumps(tm)).to_vector(), tm.to_vector())


def test_fault_c_jsoncodec_keeps_complex_dtype():
    """Fault (c): the JAX package decodes a complex64 array as complex128;
    the port keeps complex64 (and complex128 stays complex128)."""
    a = (np.arange(4) + 1j * np.arange(4)).astype(np.complex64)
    assert jcodec.loads(jcodec.dumps(a)).dtype == np.complex128
    for enc in (jcodec, tcodec):
        back = tcodec.loads(enc.dumps(a))
        assert back.dtype == np.complex64 and np.array_equal(back, a)
    assert tcodec.loads(tcodec.dumps(a.astype(np.complex128))).dtype == np.complex128


# -- the dataset's own faults --------------------------------------------------

def test_fault_a_copy_keeps_the_outcome_series():
    """Fault (a): the JAX package's DataSet.copy drops the outcome series,
    so degrees_of_freedom(aggregate_times=False) of its copy raises
    TypeError; the port's copy (and truncate) keep the series."""
    jds, tds = _build(PKGS['jax'], 'time_stamped'), _build(PKGS['port'], 'time_stamped')
    tds.comment = 'run 7'
    with pytest.raises(TypeError):
        jds.copy().degrees_of_freedom(aggregate_times=False)
    want = jds.degrees_of_freedom(aggregate_times=False)
    for other in (tds.copy(), tds.truncate(tds.keys())):
        assert other.degrees_of_freedom(aggregate_times=False) == want == 2
        assert summary(other) == summary(tds) and other.comment == 'run 7'
        c = TCircuit('Gxpi2:0@(0)')
        assert other[c].timeseries_for_outcomes == jds[JCircuit('Gxpi2:0@(0)')] \
            .timeseries_for_outcomes
    assert tds.copy()._series is not tds._series


def test_fault_b_serialization_keeps_time_series(tmp_path):
    """Fault (b): through ProtocolData.write the JAX package keeps only
    labels and counts of a time-stamped dataset; the port also writes
    times, repetitions, series, comment and aux, as extra keys the JAX
    reader ignores.  A static dataset's state is the JAX package's, key for
    key."""
    from pygsti_tpu.protocols.protocol import (ExperimentDesign as JED,
                                               ProtocolData as JPD)
    from pygsti_tpu_torch.protocols.protocol import (ExperimentDesign as TED,
                                                     ProtocolData as TPD)
    jds, tds = _build(PKGS['jax'], 'time_stamped'), _build(PKGS['port'], 'time_stamped')
    for ds in (jds, tds):
        ds.comment = 'lab notes'
        ds.auxInfo[ds.keys()[0]].update({'run': 3})
    JPD(JED(jds.keys()), jds).write(str(tmp_path / 'jax'))
    TPD(TED(tds.keys()), tds).write(str(tmp_path / 'port'))
    jback = JPD.from_dir(str(tmp_path / 'jax')).dataset
    assert not jback.has_timestamps
    tback = TPD.from_dir(str(tmp_path / 'port')).dataset
    assert tback.has_timestamps and summary(tback) == summary(tds)
    assert tback.comment == 'lab notes' and tback.auxInfo[tback.keys()[0]] == {'run': 3}
    jread = JPD.from_dir(str(tmp_path / 'port')).dataset     # the JAX reader, the port's file
    assert [r[:2] for r in summary(jread)[1]] == [r[:2] for r in summary(tds)[1]]
    static = {name: _build(pkg, 'zero_counts_2q') for name, pkg in PKGS.items()}
    assert static['port'].to_nice_serialization() == static['jax'].to_nice_serialization()


def test_fault_f_parse_model_is_defined_once():
    """Fault (f): the JAX package's stdinput defines parse_model twice; the
    first calls readers.load_model, which does not exist, and is shadowed
    by the second.  The port keeps only the second."""
    import inspect
    assert inspect.getsource(jstdinput).count('\ndef parse_model(') == 2
    assert not hasattr(jreaders, 'load_model')
    assert inspect.getsource(tstdinput).count('\ndef parse_model(') == 1


def test_dataset_api_matches_jax():
    """Constructor labels first, then labels first seen; rows, fractions,
    aux, truncate with a missing circuit, process_circuits, __str__."""
    out = {}
    for name, pkg in PKGS.items():
        ds = pkg.DataSet(outcome_labels=['1'], circuits=[pkg.Circuit('Gx')], comment='c')
        ds.add_count_dict(pkg.Circuit('Gx'), {'0': 3, '1': 1}, aux={'k': 1})
        ds.add_count_dict(pkg.Circuit('Gy'), {'2': 0, '0': 5}, record_zero_counts=False)
        ds.add_count_dict(pkg.Circuit('Gy'), {'0': 5}, update_ol=False)
        row = ds[pkg.Circuit('Gx')]
        trunc = ds.truncate([pkg.Circuit('Gy'), pkg.Circuit('Gz')], missing_action='ignore')
        with pytest.raises(KeyError):
            ds.truncate([pkg.Circuit('Gz')])
        proc = ds.process_circuits(lambda c: pkg.Circuit('Gq'), aggregate=True)
        out[name] = (ds.outcome_labels, summary(ds), dict(row.fractions), row.total,
                     row.outcomes, '1' in row, dict(ds.auxInfo[pkg.Circuit('Gx')]),
                     summary(trunc), summary(proc), str(ds), ds.degrees_of_freedom())
    assert out['port'] == out['jax']


def test_simulate_data_with_times_matches_jax():
    """simulate_data(times=...): one independent draw per timestamp, in
    the JAX package's draw order, with and without zero counts."""
    from pygsti_tpu.data import simulate_data as jsim
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data as tsim
    jm = jmp.target_model('full TP').depolarize(op_noise=0.05)
    tm = tmp.target_model('full TP').depolarize(op_noise=0.05)
    strs = ['{}@(0)', 'Gxpi2:0@(0)', 'Gxpi2:0Gxpi2:0@(0)']
    for kw in ({}, {'record_zero_counts': False}, {'sample_error': 'round'}):
        jds = jsim(jm, _circuits(PKGS['jax'], strs), 20, seed=3, times=[0, 1.5, 3], **kw)
        tds = tsim(tm, _circuits(PKGS['port'], strs), 20, seed=3, times=[0, 1.5, 3],
                   device='cpu', **kw)
        assert summary(tds) == summary(jds) and tds.has_timestamps


# -- directories: the JAX package's results read into the port; the port's
# -- own round trip; modules outside both packages refused -------------------

@pytest.fixture(scope='module')
def gst_dirs(tmp_path_factory):
    """A 1-qubit GateSetTomography run of each package on the same counts,
    each written to its own results directory."""
    from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
    from pygsti_tpu.data import simulate_data as jsim
    from pygsti_tpu.protocols import gst as jgst
    from pygsti_tpu.protocols.protocol import ProtocolData as JPD
    from pygsti_tpu_torch.protocols import gst as tgst
    from pygsti_tpu_torch.protocols.protocol import ProtocolData as TPD
    root = tmp_path_factory.mktemp('results')
    jt, tt = jmp.target_model('full TP'), tmp.target_model('full TP')
    args = (jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), [1, 2])
    targs = (tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), [1, 2])
    jl = j_lists(jt, *args)
    jds = jsim(jmp.target_model('full TP').depolarize(op_noise=0.05, spam_noise=0.02),
               list(jl[-1]), 1000, seed=11)
    tds = TDataSet()
    for c in jds.keys():
        tds.add_count_dict(TCircuit(c.str), dict(jds[c].counts))
    jres = jgst.GateSetTomography(verbosity=0).run(
        JPD(jgst.StandardGSTDesign(jt, *args), jds), disable_checkpointing=True)
    jres.write(str(root / 'jax'))
    tres = tgst.GateSetTomography(verbosity=0, device='cpu').run(
        TPD(tgst.StandardGSTDesign(tt, *targs), tds), disable_checkpointing=True)
    tres.write(str(root / 'port'))
    return dict(root=root, jres=jres, tres=tres)


def _dense_members(model, jax):
    out = {}
    for kind in ('preps', 'povms', 'operations'):
        for lbl, m in getattr(model, kind).items():
            out[(kind, str(lbl))] = np.asarray(m.to_dense() if jax else m.dense())
    return out


def test_port_reads_the_jax_results_directory(gst_dirs):
    """The directory the JAX package wrote, read by the port's
    read_results_from_dir with and without a protocol name: the models'
    members (1e-15), misfit_sigma, the dataset and the design equal the
    JAX package's."""
    jres = gst_dirs['jres']
    jest = jres.estimates['GateSetTomography']
    path = str(gst_dirs['root'] / 'jax')
    for back in (treaders.read_results_from_dir(path, 'GateSetTomography'),
                 treaders.read_results_from_dir(path).for_protocol['GateSetTomography']):
        est = back.estimates['GateSetTomography']
        assert list(est.models) == list(jest.models)
        for k, jm in jest.models.items():
            assert type(est.models[k]).__module__.startswith('pygsti_tpu_torch.')
            jd, td = _dense_members(jm, True), _dense_members(est.models[k], False)
            assert td.keys() == jd.keys()
            assert max(float(np.max(np.abs(td[x] - jd[x]))) for x in jd) < 1e-15
        assert est.misfit_sigma() == jest.misfit_sigma()
        assert list(est.goparameters) == list(jest.goparameters)
        assert summary(back.dataset) == summary(jres.dataset)
        assert type(back.data.edesign).__name__ == 'StandardGSTDesign'
        assert [[c.str for c in cl] for cl in back.data.edesign.circuit_lists] == \
            [[c.str for c in cl] for cl in jres.data.edesign.circuit_lists]
        assert {k: [c.str for c in v] for k, v in back.circuit_lists.items()} == \
            {k: [c.str for c in v] for k, v in jres.circuit_lists.items()}


def test_port_results_directory_round_trips(gst_dirs):
    """The port's own write and read: parameter vectors bit for bit,
    misfit_sigma, dataset and design; read_data_from_dir,
    read_edesign_from_dir, and read_results_from_dir without a name."""
    tres = gst_dirs['tres']
    est = tres.estimates['GateSetTomography']
    path = str(gst_dirs['root'] / 'port')
    back = treaders.read_results_from_dir(path, 'GateSetTomography')
    best = back.estimates['GateSetTomography']
    for k, m in est.models.items():
        assert np.array_equal(best.models[k].to_vector(), m.to_vector())
    assert best.misfit_sigma() == est.misfit_sigma()
    assert best.parameters['final_dof'] == est.parameters['final_dof']
    assert summary(treaders.read_data_from_dir(path).dataset) == summary(tres.dataset)
    ed = treaders.read_edesign_from_dir(path)
    assert [c.str for c in ed.all_circuits_needing_data] == \
        [c.str for c in tres.data.edesign.all_circuits_needing_data]
    assert ed.germs == tres.data.edesign.germs
    rdir = treaders.read_results_from_dir(path)
    assert np.array_equal(rdir.for_protocol['GateSetTomography'].estimates[
        'GateSetTomography'].models['stdgaugeopt'].to_vector(), est.models['stdgaugeopt']
        .to_vector())
    assert json.load(open(os.path.join(path, 'results', 'GateSetTomography.json')))[
        'results_type'] == 'pygsti_tpu_torch.protocols.gst.ModelEstimateResults'


def test_fault_g_results_dir_without_a_name(gst_dirs):
    """Fault (g): the JAX package's read_results_from_dir without a name
    calls ProtocolResultsDir.from_dir, which its class lacks; the port
    reads every protocol's results by name."""
    with pytest.raises(AttributeError):
        jreaders.read_results_from_dir(str(gst_dirs['root'] / 'jax'))
    rdir = treaders.read_results_from_dir(str(gst_dirs['root'] / 'jax'))
    assert list(rdir.for_protocol) == ['GateSetTomography'] and list(rdir.keys()) == []


def test_modules_outside_the_packages_are_refused(tmp_path):
    """A meta.json, a nice state or a results_type naming a module outside
    both packages is refused, not imported."""
    d = tmp_path / 'meta'
    d.mkdir()
    (d / 'meta.json').write_text(json.dumps({'type': 'subprocess.Popen'}))
    with pytest.raises(ValueError, match='Refusing'):
        treaders.read_protocol_from_dir(str(d))
    with pytest.raises(ValueError, match='Refusing'):
        tcodec.loads(json.dumps({'__nice__': {'module': 'os', 'class': 'system'}}))
    r = tmp_path / 'res'
    from pygsti_tpu_torch.protocols.protocol import ExperimentDesign, ProtocolData
    ProtocolData(ExperimentDesign([TCircuit('Gx')]), _build(PKGS['port'], 'static_1q')) \
        .write(str(r))
    (r / 'results').mkdir()
    (r / 'results' / 'p.json').write_text(json.dumps({'protocol_name': 'p',
                                                       'results_type': 'os.path.join'}))
    with pytest.raises(ValueError, match='Refusing'):
        treaders.read_results_from_dir(str(r), 'p')


def test_empty_protocol_data_and_fake_data(tmp_path):
    """write_empty_protocol_data writes the same template as the JAX
    package's; fill_in_empty_dataset_with_fake_data draws the JAX
    package's counts from the same seed (either argument order), and
    read_data_from_dir reads them back with the design."""
    from pygsti_tpu.protocols.gst import StandardGSTDesign as JSD
    from pygsti_tpu_torch.protocols.gst import StandardGSTDesign as TSD
    args = [(pkg.mp.target_model('full TP'), pkg.mp.prep_fiducials(), pkg.mp.meas_fiducials(),
             pkg.mp.germs(), [1]) for pkg in (PKGS['jax'], PKGS['port'])]
    jwriters.write_empty_protocol_data(str(tmp_path / 'jax'), JSD(*args[0]))
    twriters.write_empty_protocol_data(str(tmp_path / 'port'), TSD(*args[1]))
    tmpl = [(tmp_path / n / 'data' / 'dataset.txt').read_bytes() for n in ('jax', 'port')]
    assert tmpl[0] == tmpl[1]
    with pytest.raises(ValueError, match='clobber'):
        twriters.write_empty_protocol_data(str(tmp_path / 'port'), TSD(*args[1]))
    jgen = jmp.target_model('full TP').depolarize(op_noise=0.02)
    tgen = tmp.target_model('full TP').depolarize(op_noise=0.02)
    jds = jwriters.fill_in_empty_dataset_with_fake_data(
        str(tmp_path / 'jax' / 'data' / 'dataset.txt'), jgen, 100, seed=9)
    tds = twriters.fill_in_empty_dataset_with_fake_data(
        tgen, str(tmp_path / 'port' / 'data' / 'dataset.txt'), 100, seed=9, device='cpu')
    assert summary(tds) == summary(jds)
    filled = [(tmp_path / n / 'data' / 'dataset.txt').read_bytes() for n in ('jax', 'port')]
    assert filled[0] == filled[1]
    data = treaders.read_data_from_dir(str(tmp_path / 'port'))
    assert [c.str for c in data.dataset.keys()] == \
        [c.str for c in data.edesign.all_circuits_needing_data]
    assert all(data.dataset[c].total == 100 for c in data.dataset.keys())


def test_create_edesign_from_dir_of_circuit_files(tmp_path):
    (tmp_path / 'edesign').mkdir()
    twriters.write_circuit_list(str(tmp_path / 'edesign' / 'circuits0.txt'),
                                [TCircuit('Gx'), TCircuit('Gy')])
    twriters.write_circuit_list(str(tmp_path / 'edesign' / 'circuits1.txt'), [TCircuit('GxGy')])
    ed = treaders.create_edesign_from_dir(str(tmp_path))
    jed = jreaders.create_edesign_from_dir(str(tmp_path))
    assert [c.str for c in ed.all_circuits_needing_data] == \
        [c.str for c in jed.all_circuits_needing_data] == ['Gx', 'Gy', 'GxGy']


# -- meta.json directories and MongoDB over the mock --------------------------

def test_meta_based_dirs(tmp_path):
    """write_obj_to_meta_based_dir / load_meta_based_dir round trip; the
    JAX package's meta.json names its own class, which the port reads as
    its own; write_dict_to_json_or_pkl_files picks .json or .pkl."""
    from pygsti_tpu.io import metadir as jmetadir
    from pygsti_tpu_torch.protocols.protocol import ExperimentDesign
    obj = SimpleNamespace(a=np.arange(3.0), b=('x', 2), skip=1)
    metadir.write_obj_to_meta_based_dir(obj, str(tmp_path / 'o'), None,
                                        omit_attributes=('skip',), additional_meta={'v': 1})
    back = metadir.load_meta_based_dir(str(tmp_path / 'o'))
    assert set(back) == {'a', 'b', 'v'} and np.array_equal(back['a'], obj.a)
    assert back['b'] == ('x', 2)
    assert jmetadir.load_meta_based_dir(str(tmp_path / 'o'))['b'] == ('x', 2)
    from pygsti_tpu.protocols.protocol import ExperimentDesign as JED
    jed = JED([JCircuit('Gx'), JCircuit('GxGy')])
    jed.write(str(tmp_path / 'ed'))
    jmetadir.write_meta_based_dir(str(tmp_path / 'ed'), {}, init_meta={
        'type': 'pygsti_tpu.protocols.protocol.ExperimentDesign'})
    ed = treaders.read_protocol_from_dir(str(tmp_path / 'ed'))
    assert isinstance(ed, ExperimentDesign)
    assert [c.str for c in ed.all_circuits_needing_data] == ['Gx', 'GxGy']
    metadir.write_dict_to_json_or_pkl_files({'j': [1, 2], 'p': {1, 2}}, str(tmp_path / 'd'))
    assert sorted(os.listdir(tmp_path / 'd')) == ['j.json', 'p.pkl']


def test_mongodb_over_the_mock_collection():
    """Objects and dicts to documents of the mock database and back; the
    readers and removers by collection."""
    db = collections.defaultdict(_MockCollection)
    tm = tmp.target_model('full TP').depolarize(op_noise=0.01)
    mongodb.write_obj_to_mongodb_auxtree(tm, db['pygsti_protocol_data'], 'm1')
    with pytest.raises(ValueError, match='exists'):
        mongodb.write_obj_to_mongodb_auxtree(tm, db['pygsti_protocol_data'], 'm1')
    back = treaders.read_data_from_mongodb(db, 'm1')
    assert np.array_equal(back.to_vector(), tm.to_vector())
    treaders.remove_data_from_mongodb(db, 'm1')
    with pytest.raises(KeyError):
        treaders.read_data_from_mongodb(db, 'm1')
    d = {'x': np.arange(3), 'y': ('a', 1)}
    mongodb.write_dict_to_mongodb(d, db, 'dicts', 'p1')
    mongodb.write_dict_to_mongodb({'x': np.zeros(2)}, db, 'dicts', 'p1', overwrite_existing=True)
    got = mongodb.read_dict_from_mongodb(db, 'dicts', 'p1')
    assert np.array_equal(got['x'], np.zeros(2)) and got['y'] == ('a', 1)
    mongodb.remove_dict_from_mongodb(db, 'dicts', 'p1')
    assert mongodb.read_dict_from_mongodb(db, 'dicts', 'p1') == {}
    ops = []
    mongodb.add_dict_to_mongodb_write_ops({'k': 1}, ops, db, 'c', 'p')
    doc = mongodb.add_obj_auxtree_write_ops_and_update_doc(
        SimpleNamespace(a=1, b=2), {}, ops, db, 'c', 'id', omit_attributes=('b',))
    assert len(ops) == 2 and mongodb.read_auxtree_from_mongodb_doc(db, doc) == {'a': 1}
    mongodb.create_mongodb_indices_for_pygsti_collections(db)
