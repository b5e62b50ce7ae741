"""The port's dataset comparison, hypothesis tests and dataset transforms
against the JAX package's, on the CPU at float64: DataComparator's LLRs,
p-values, flags, aggregate N_sigma and largest significant TVD on the data
of tests/test_misc_algorithms.py (1e-12), HypothesisTest on every case of
tests/test_hypothesistest.py, tools/hypothesis.py, and
aggregate_dataset_outcomes, filter_dataset and
trim_to_constant_numtimesteps row for row."""

import numpy as np
import pytest

from pygsti_tpu.circuits import Circuit as JCircuit
from pygsti_tpu.data import DataSet as JDataSet, simulate_data as jsimulate
from pygsti_tpu.data import datasetconstruction as jdc
from pygsti_tpu.data.datacomparator import DataComparator as JComparator
from pygsti_tpu.data.hypothesistest import HypothesisTest as JTest
from pygsti_tpu.data.multidataset import MultiDataSet as JMultiDataSet
from pygsti_tpu.tools import hypothesis as jhyp

from pygsti_tpu_torch.circuits.circuit import Circuit as TCircuit
from pygsti_tpu_torch.data import datasetconstruction as tdc
from pygsti_tpu_torch.data.datacomparator import DataComparator as TComparator
from pygsti_tpu_torch.data.dataset import DataSet as TDataSet
from pygsti_tpu_torch.data.hypothesistest import HypothesisTest as TTest
from pygsti_tpu_torch.data.multidataset import MultiDataSet as TMultiDataSet
from pygsti_tpu_torch.tools import hypothesis as thyp


def make_datasets(p, seed, n=1000, circuits=10, outcomes=('0', '1')):
    """tests/test_misc_algorithms.py's data in both packages (three or
    more outcomes: a multinomial row)."""
    rng = np.random.RandomState(seed)
    jd, td = JDataSet(), TDataSet()
    for i in range(circuits):
        layers = [('Gxpi2', 0)] * (i + 1)
        if len(outcomes) == 2:
            n0 = rng.binomial(n, p)
            counts = {'0': n0, '1': n - n0}
        else:
            q = np.full(len(outcomes), (1 - p) / (len(outcomes) - 1))
            q[0] = p
            counts = dict(zip(outcomes, (int(x) for x in rng.multinomial(n, q))))
        jd.add_count_dict(JCircuit(layers, (0,)), counts)
        td.add_count_dict(TCircuit(layers, (0,)), counts)
    return jd, td


@pytest.mark.parametrize('case', ['consistent', 'inconsistent', 'three datasets',
                                  'four outcomes', 'multidataset'])
def test_data_comparator_matches_jax(case):
    """Per circuit LLR, dof and p-value, the flags, the aggregate LLR,
    p-value and N_sigma, and get_maximum_sstvd: 1e-12."""
    specs = {'consistent': [(0.5, 1), (0.5, 2)], 'inconsistent': [(0.5, 3), (0.65, 4)],
             'three datasets': [(0.5, 5), (0.5, 6), (0.7, 7)],
             'four outcomes': [(0.4, 8), (0.55, 9)], 'multidataset': [(0.5, 10), (0.62, 11)]}[case]
    outs = ('00', '01', '10', '11') if case == 'four outcomes' else ('0', '1')
    pairs = [make_datasets(p, s, outcomes=outs) for p, s in specs]
    jds, tds = [p[0] for p in pairs], [p[1] for p in pairs]
    if case == 'multidataset':
        jm, tm = JMultiDataSet(), TMultiDataSet()
        for k, (a, b) in enumerate(zip(jds, tds)):
            jm.add_dataset('ds%d' % k, a)
            tm.add_dataset('ds%d' % k, b)
        jds, tds = jm, tm
    a = JComparator(jds).run()
    b = TComparator(tds, device='cpu').run()
    la, lb = np.array(list(a.llrs.values())), np.array(list(b.llrs.values()))
    assert np.max(np.abs(la - lb)) <= 1e-12 * max(1.0, np.abs(la).max())
    assert list(a.dof.values()) == list(b.dof.values())
    pa, pb = np.array(list(a.pVals.values())), np.array(list(b.pVals.values()))
    assert np.max(np.abs(pa - pb)) <= 1e-12
    assert [str(c) for c in b.inconsistent_circuits] == [str(c) for c in a.inconsistent_circuits]
    for x, y in ((a.aggregate_llr, b.aggregate_llr), (a.aggregate_nsigma, b.aggregate_nsigma),
                 (a.aggregate_pvalue, b.aggregate_pvalue),
                 (a.get_maximum_sstvd(), b.get_maximum_sstvd())):
        assert abs(x - y) <= 1e-12 * max(1.0, abs(x))
    assert str(b) == str(a)
    if case == 'consistent':
        assert not b.inconsistent_circuits and abs(b.aggregate_nsigma) < 3
    if case == 'inconsistent':
        assert len(b.inconsistent_circuits) > 5 and b.aggregate_nsigma > 10
        assert b.get_maximum_sstvd() > 0.05


HYPOTHESIS_CASES = {
    'holm stepdown': (['a', 'b', 'c'], {}, {'a': 0.001, 'b': 0.03, 'c': 0.8}),
    'holm cascade': (['a', 'b', 'c'], {}, {'a': 0.001, 'b': 0.02, 'c': 0.04}),
    'no rejections': (['a', 'b'], {}, {'a': 0.5, 'b': 0.9}),
    'nested': (['a', ('x1', 'x2', 'x3')], {}, {'a': 0.5, 'x1': 1e-6, 'x2': 0.5, 'x3': 0.9}),
    'nested bonferroni': (['a', ('x1', 'x2', 'x3')], {'local_corrections': 'Bonferroni'},
                          {'a': 1e-4, 'x1': 1e-3, 'x2': 0.011, 'x3': 0.9}),
    'nested holm cascade': (['a', ('x1', 'x2')], {}, {'a': 0.9, 'x1': 0.004, 'x2': 0.02}),
    'weighting': (['a', 'b'], {'weighting': {'a': 3.0, 'b': 1.0}}, {'a': 0.03, 'b': 0.03}),
}


@pytest.mark.parametrize('case', sorted(HYPOTHESIS_CASES))
def test_hypothesis_test_matches_jax(case):
    """Rejections and pseudo-thresholds equal, on the cases of
    tests/test_hypothesistest.py and three more nested ones."""
    hyps, kwargs, pvals = HYPOTHESIS_CASES[case]
    out = []
    for cls in (JTest, TTest):
        ht = cls(hyps, significance=0.05, **kwargs)
        ht.add_pvalues(pvals)
        out.append((ht.run(), ht.pvalue_pseudothreshold))
    assert out[0][0] == out[1][0]
    assert out[0][1].keys() == out[1][1].keys()
    assert all(abs(out[0][1][k] - out[1][1][k]) < 1e-15 for k in out[0][1])
    expected = {'holm stepdown': {'a': True, 'b': False, 'c': False},
                'holm cascade': {'a': True, 'b': True, 'c': True},
                'weighting': {'a': True, 'b': True}}
    if case in expected:
        assert out[1][0] == expected[case]


def test_hypothesis_corrections_match_jax():
    assert thyp.bonferroni_correction(0.05, 7) == jhyp.bonferroni_correction(0.05, 7)
    assert thyp.sidak_correction(0.05, 7) == jhyp.sidak_correction(0.05, 7)
    for nested in ('bonferroni', 'sidak'):
        assert np.array_equal(
            thyp.generalized_bonferroni_correction(0.05, [0.25, 0.75], [3, 10], nested),
            jhyp.generalized_bonferroni_correction(0.05, [0.25, 0.75], [3, 10], nested))
    assert np.array_equal(thyp.generalized_bonferroni_correction(0.05, [0.5, 0.5]),
                          jhyp.generalized_bonferroni_correction(0.05, [0.5, 0.5]))
    with pytest.raises(ValueError):
        thyp.generalized_bonferroni_correction(0.05, [0.5, 0.6])


# -- the dataset transforms ------------------------------------------------------

def rows(ds):
    return [(c.str, tuple(c.line_labels), sorted((k, v) for k, v in ds[c].counts.items()))
            for c in ds.keys()]


@pytest.fixture(scope='module')
def two_qubit_data():
    """tests/test_hypothesistest.py's 2-qubit data, drawn once by the JAX
    package and copied count for count into the port's DataSet."""
    from pygsti_tpu.modelpacks import smq2Q_XYICNOT as jmp2
    mdl = jmp2.target_model('full TP').depolarize(op_noise=0.02)
    circs = [JCircuit([('Gxpi2', 0)], line_labels=(0, 1)),
             JCircuit([('Gypi2', 1)], line_labels=(0, 1)),
             JCircuit([('Gxpi2', 0), ('Gcnot', 0, 1)], line_labels=(0, 1)),
             JCircuit([('Gcnot', 0, 1)], line_labels=(0, 1)),
             JCircuit([('Gypi2', 0), ('Gxpi2', 0)], line_labels=(0, 1))]
    jd = jsimulate(mdl, circs, 2000, seed=5)
    td = TDataSet()
    for c in jd.keys():
        td.add_count_dict(TCircuit(c.str), dict(jd[c].counts))
    return jd, td


@pytest.mark.parametrize('record_zero_counts', [True, False])
def test_aggregate_dataset_outcomes_matches_jax(two_qubit_data, record_zero_counts):
    jd, td = two_qubit_data
    merge = {'0': ['00', '01'], '1': ['10', '11'], '2': [('02',)]}
    a = jdc.aggregate_dataset_outcomes(jd, merge, record_zero_counts)
    b = tdc.aggregate_dataset_outcomes(td, merge, record_zero_counts)
    assert rows(a) == rows(b) and list(a.outcome_labels) == list(b.outcome_labels)
    c0 = list(td.keys())[0]
    assert b[c0].counts[('0',)] == td[c0].counts.get(('00',), 0) + td[c0].counts.get(('01',), 0)
    assert b[c0].total == td[c0].total


@pytest.mark.parametrize('kwargs', [{'sectors_to_keep': [0]}, {'sectors_to_keep': [1]},
                                    {'sectors_to_keep': [0], 'new_sectors': ['Q']},
                                    {'sectors_to_keep': [0], 'filtercircuits': False},
                                    {'sectors_to_keep': [0, 1], 'sindices_to_keep': [1, 0]}])
def test_filter_dataset_matches_jax(two_qubit_data, kwargs):
    """The kept circuits, their lines and the marginalized counts, in
    order; the CNOT circuits leave a 1-qubit filter."""
    jd, td = two_qubit_data
    a, b = jdc.filter_dataset(jd, **kwargs), tdc.filter_dataset(td, **kwargs)
    assert rows(a) == rows(b)
    assert list(a.outcome_labels) == list(b.outcome_labels)
    if kwargs == {'sectors_to_keep': [0]}:
        assert len(b) == 2
    assert tdc._marginalize_outcome(('0110',), [0, 3]) == jdc._marginalize_outcome(('0110',),
                                                                                  [0, 3])


def test_trim_to_constant_numtimesteps_matches_jax():
    """The JAX package's case (one repetition per shot) row for row; with
    repetitions above 1 the port keeps them (the JAX package's rows then
    count each outcome once: ROADMAP.md section 3)."""
    out = []
    for DS, C, dc in ((JDataSet, JCircuit, jdc), (TDataSet, TCircuit, tdc)):
        ds = DS(outcome_labels=['0', '1'])
        ds.add_raw_series_data(C([('Gxpi2', 0)], line_labels=(0,)), ['0', '1', '0', '1'],
                               [0.0, 1.0, 2.0, 3.0])
        ds.add_raw_series_data(C([('Gypi2', 0)], line_labels=(0,)), ['1', '0'], [0.0, 1.0])
        ds.add_raw_series_data(C([('Gypi2', 0)] * 2, line_labels=(0,)), ['1', '0', '1'],
                               [0.0, 0.0, 1.5])
        t = dc.trim_to_constant_numtimesteps(ds)
        out.append((rows(t), [(list(t[c].time), [tuple(o) for o in t[c].outcome_series])
                              for c in t.keys()]))
    assert out[0] == out[1]
    ds = TDataSet()
    c = TCircuit([('Gxpi2', 0)], line_labels=(0,))
    ds.add_raw_series_data(c, ['0', '1', '0'], [0.0, 0.0, 1.0], [30, 70, 50])
    ds.add_raw_series_data(TCircuit([('Gypi2', 0)], line_labels=(0,)), ['1'], [0.0], [9])
    t = tdc.trim_to_constant_numtimesteps(ds)
    assert dict(t[c].counts) == {('0',): 30, ('1',): 70} and list(t[c].reps) == [30, 70]
    with pytest.raises(ValueError):
        d2 = TDataSet()
        d2.add_count_dict(c, {'0': 1})
        tdc.trim_to_constant_numtimesteps(d2)
