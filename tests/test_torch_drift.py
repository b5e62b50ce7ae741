"""The port's drift detection against the JAX package's, on the CPU at
float64: extras/drift/signal.py function by function on the cases of
tests/test_drift_signal_parity.py with the JAX package as the oracle
(1e-12), the batched DCT and Lomb-Scargle spectra against the per-stream
ones (1e-12), every case of tests/test_drift_depth.py (test condensing,
corrections, detections, thresholds, p-values, filter and mle estimates,
TVD bounds, frequency pointers) held against the JAX package, the
probability trajectories and time-resolved models, and StabilityAnalysis
on the data of tests/test_protocols_misc.py."""

import numpy as np
import pytest

from pygsti_tpu.circuits.circuit import Circuit as JCircuit
from pygsti_tpu.data.dataset import DataSet as JDataSet
from pygsti_tpu.data.multidataset import MultiDataSet as JMultiDataSet
from pygsti_tpu.extras.drift import probtrajectory as jpt, signal as jsig
from pygsti_tpu.extras.drift import stabilityanalyzer as jsa, trmodel as jtr
from pygsti_tpu.protocols.protocol import ExperimentDesign as JDesign, ProtocolData as JData
from pygsti_tpu.protocols.stability import StabilityAnalysis as JStability

from pygsti_tpu_torch.circuits.circuit import Circuit as TCircuit
from pygsti_tpu_torch.data.dataset import DataSet as TDataSet
from pygsti_tpu_torch.data.multidataset import MultiDataSet as TMultiDataSet
from pygsti_tpu_torch.extras.drift import probtrajectory as tpt, signal as tsig
from pygsti_tpu_torch.extras.drift import stabilityanalyzer as tsa, trmodel as ttr
from pygsti_tpu_torch.protocols.protocol import ExperimentDesign as TDesign, ProtocolData as TData
from pygsti_tpu_torch.protocols.stability import StabilityAnalysis as TStability

TOL = 1e-12


def close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.max(np.abs(a - b), initial=0.0) <= tol * max(
        1.0, np.max(np.abs(b), initial=0.0))


@pytest.fixture(scope='module')
def clickstream():
    rng = np.random.RandomState(7)
    return (rng.rand(128) < 0.42).astype(float)


# -- signal.py against the JAX package ---------------------------------------

def _signal_cases(x):
    p0 = np.full(len(x), 0.45)
    times = np.arange(len(x), dtype=float)
    jittered = np.cumsum(0.5 + np.random.RandomState(3).rand(len(x)))
    return {
        'standardizer': lambda s: s.standardizer(x),
        'standardizer_null': lambda s: s.standardizer(x, p0),
        'unstandardizer': lambda s: s.unstandardizer(s.standardizer(x, p0), p0),
        'dct': lambda s: s.dct(x),
        'dct_null_idct': lambda s: s.idct(s.dct(x, p0), p0),
        'dft': lambda s: s.dft(x),
        'idft': lambda s: s.idft(s.dft(x, p0), p0),
        'spectrum_dct': lambda s: np.concatenate(s.spectrum(x, times=times, transform='dct')),
        'spectrum_dft': lambda s: s.spectrum(x, transform='dft', returnfrequencies=False)[1],
        'spectrum_lsp': lambda s: np.concatenate(s.spectrum(x, times=jittered,
                                                            transform='lsp')[::2]),
        'bartlett': lambda s: s.bartlett_spectrum(x, 4),
        'thresholds': lambda s: [s.power_significance_threshold(0.05, 100, 1),
                                 s.power_significance_threshold(0.01, 7, 2),
                                 s.power_to_pvalue(8.3, 1), s.maxpower_pvalue(11.0, 128, 1)],
        'quasithreshold': lambda s: s.power_significance_quasithreshold(0.05, 20, 2),
        'frequencies': lambda s: np.concatenate([
            s.frequencies_from_timestep(0.1, 64),
            s.fourier_frequencies_from_times(np.cumsum(np.full(32, 2.5)) + 10)]),
        'amplitudes': lambda s: np.concatenate(list(s.amplitudes_at_frequencies(
            [1, 3, 5], {'0': x, '1': 1.0 - x}, transform='dct').values())),
        'dct_amplitudes': lambda s: s.dct_amplitudes_at_frequencies([0, 2, 7], x),
        'filters': lambda s: np.concatenate([s.lowpass_filter(x, max_freq=10),
                                             s.moving_average(x, width=11)]),
        'renormalizers': lambda s: np.concatenate([
            s.renormalizer(np.linspace(-0.4, 1.3, 50), method=m) for m in ('logistic', 'sharp')]
            + [[s.sparsity(np.array([0.5, 0.25, 0.25]))]]),
        'dct_power_spectrum': lambda s: s.dct_power_spectrum(x),
        'lsp_power_spectrum': lambda s: s.lsp_power_spectrum(
            x, jittered, s.frequencies_from_timestep(1.0, len(x))[1:]),
        'sparse_signal': lambda s: s.sparse_signal_from_modes([1, 4], [0.1, -0.05], 40, 0.3),
        'basis_functions': lambda s: np.concatenate([
            s.dct_basis_function(3, 50, np.arange(50)), s.dct_basisfunction(3, times, 2.0, 64.0)]),
    }


@pytest.mark.parametrize('case', sorted(_signal_cases(np.zeros(4))))
def test_signal_matches_jax(case, clickstream):
    fn = _signal_cases(clickstream)[case]
    assert close(fn(tsig), fn(jsig))


@pytest.mark.parametrize('kind', ['flat', 'gaussian'])
def test_generated_signals_match_jax(kind):
    """Both draw from numpy's global RandomState."""
    out = []
    for s in (jsig, tsig):
        np.random.seed(11)
        out.append(s.generate_flat_signal(1.5, 4, 100, base=0.5, method='sharp')
                   if kind == 'flat' else
                   s.generate_gaussian_signal(1.0, 10, 3, 100, base=0.5, method='sharp'))
    assert close(out[1], out[0])


def test_compute_auto_frequencies():
    """The JAX package's reads attributes no DataSet has (AttributeError);
    the port's uses the mean step between a row's distinct times."""
    jd, td = make_drifting_datasets(n_circuits=2, T=50, timestep=0.5)
    with pytest.raises(AttributeError):
        jsig.compute_auto_frequencies(jd)
    freqs, pointers = tsig.compute_auto_frequencies(td)
    assert pointers == {} and close(freqs[0], jsig.frequencies_from_timestep(0.5, 50))


@pytest.mark.parametrize('shape', [(5, 3, 64), (7, 1000), (2, 2, 2, 17)])
def test_batched_dct_spectra_match_per_stream(shape):
    x = (np.random.RandomState(sum(shape)).rand(*shape) < 0.4).astype(float)
    P = tsig.dct_power_spectra(x, 'cpu').numpy()
    Q = np.apply_along_axis(jsig.dct_power_spectrum, -1, x)
    assert P.shape == Q.shape and np.max(np.abs(P - Q)) < TOL


def test_batched_lsp_spectra_match_per_stream():
    rng = np.random.RandomState(4)
    N, T = 6, 90
    x = (rng.rand(N, T) < 0.55).astype(float)
    times = np.cumsum(0.2 + rng.rand(N, T), axis=1)
    freqs = np.stack([jsig.frequencies_from_timestep((t[-1] - t[0]) / (T - 1), T)[1:]
                      for t in times])
    P = tsig.lsp_power_spectra(x, times, freqs, 'cpu', chunk_bytes=T * T * 8 * 4 * 2).numpy()
    Q = np.stack([jsig.lsp_power_spectrum(x[i], times[i], freqs[i]) for i in range(N)])
    assert np.max(np.abs(P - Q)) < TOL * max(1.0, np.abs(Q).max())


# -- the analyzer: the cases of tests/test_drift_depth.py --------------------

def make_drifting_datasets(n_circuits=4, T=500, f_drift=6, amp=0.2, drifting=(0,), seed=11,
                           timestep=1.0, jitter=0.0):
    """tests/test_drift_depth.py's dataset in both packages (`jitter`
    moves each timestamp by up to that much: unequal spacing)."""
    rng = np.random.RandomState(seed)
    jd, td = JDataSet(), TDataSet()
    t = np.arange(T)
    for i in range(n_circuits):
        p = np.full(T, 0.5)
        if i in drifting:
            p = 0.5 + amp * np.cos(np.pi * f_drift * (t + 0.5) / T)
        bits = rng.binomial(1, p)
        times = (timestep * t + jitter * rng.rand(T)).tolist()
        labels = ['1' if b else '0' for b in bits]
        jd.add_raw_series_data(JCircuit([('Gxpi2', 0)] * (i + 1), (0,)), labels, times)
        td.add_raw_series_data(TCircuit([('Gxpi2', 0)] * (i + 1), (0,)), labels, times)
    return jd, td


def analyzers(jd, td, **kwargs):
    a = jsa.StabilityAnalyzer(jd, **kwargs)
    b = tsa.StabilityAnalyzer(td, device='cpu', **kwargs)
    a.compute_spectra()
    b.compute_spectra()
    assert close(b._basespectra, a._basespectra)
    assert b._shape == a._shape and b._condshape == a._condshape
    assert b._freqpointers == a._freqpointers
    return a, b


def same_detection(a, b, key=None):
    key = key or a._def_detection
    assert b._condtests[key] == a._condtests[key]
    assert b._driftfreqinds[key] == a._driftfreqinds[key]
    assert b._driftdetected_class[key] == a._driftdetected_class[key]
    for test, th in a._power_sigthreshold[key].items():
        tt = b._power_sigthreshold[key][test]
        if isinstance(th, dict):
            assert th.keys() == tt.keys() and all(close(tt[k], th[k]) for k in th)
        else:
            assert close(tt, th)
    assert [str(c) for c in b.unstable_circuits_list] == [str(c) for c in a.unstable_circuits_list]
    assert {str(k): v for k, v in b.drift_frequencies.items()} == \
        {str(k): v for k, v in a.drift_frequencies.items()}


@pytest.mark.parametrize('shape', [(1, 5, 2), (2, 5, 2), (1, 1, 2), (1, 5, 4), (3, 1, 2)])
def test_test_specification_matches_jax(shape):
    for tests in [((), ('dataset',), ('dataset', 'circuit')),
                  (('circuit',), ('circuit', 'outcome')), (('dataset', 'circuit', 'outcome'),)]:
        w = {t: 1.0 / len(tests) for t in tests}
        assert tsa.condense_tests(shape, tests) == jsa.condense_tests(shape, tests)
        assert tsa.condense_tests(shape, tests, w) == jsa.condense_tests(shape, tests, w)
        assert tsa.compute_auto_betweenclass_weighting(tests) == \
            jsa.compute_auto_betweenclass_weighting(tests)
    for ids in (False, True):
        assert tsa.compute_auto_tests(shape, ids) == jsa.compute_auto_tests(shape, ids)
    assert tsa.compute_valid_tests() == jsa.compute_valid_tests()
    assert tsa.compute_valid_inclass_corrections() == jsa.compute_valid_inclass_corrections()


@pytest.mark.parametrize('partial', [None, {'circuit': 'Benjamini-Hochberg'},
                                     {'spectrum': 'Benjamini-Hochberg'},
                                     {'dataset': 'Bonferroni', 'outcome': 'Benjamini-Hochberg'}])
def test_populate_inclass_correction_matches_jax(partial):
    assert tsa.populate_inclass_correction(dict(partial) if partial else None) == \
        jsa.populate_inclass_correction(dict(partial) if partial else None)
    with pytest.raises(AssertionError):
        tsa.populate_inclass_correction({'dataset': 'Benjamini-Hochberg',
                                         'spectrum': 'Bonferroni'})
    assert tsa.compute_auto_estimator('dct') == 'filter' and \
        tsa.compute_auto_estimator('lsp') == 'mle'


@pytest.mark.parametrize('drifting,jitter', [((0, 1), 0.0), ((0,), 0.0), ((0,), 0.3), ((), 0.0)])
def test_bonferroni_detection_matches_jax(drifting, jitter):
    """Detections, thresholds, legacy views, p-values and powers equal
    (jitter 0.3: unequal spacing, the Lomb-Scargle spectra)."""
    jd, td = make_drifting_datasets(drifting=drifting, jitter=jitter)
    a, b = analyzers(jd, td)
    a.run_instability_detection()
    b.run_instability_detection()
    same_detection(a, b)
    assert b.instability_detected == a.instability_detected
    if not jitter:
        assert b.instability_detected == bool(drifting)
    cj, ct = list(jd.keys()), list(td.keys())
    for i in range(len(cj)):
        assert close(b.maximum_power_pvalue({'circuit': ct[i]}),
                     a.maximum_power_pvalue({'circuit': cj[i]}))
        assert close(b.maximum_power({'circuit': ct[i]}), a.maximum_power({'circuit': cj[i]}))
        assert close(b.power_spectrum((ct[i],)), a.power_spectrum((cj[i],)))
        assert b.instability_indices({'circuit': ct[i]}) == \
            a.instability_indices({'circuit': cj[i]})
        assert close(b.instability_frequencies({'circuit': ct[i]}),
                     a.instability_frequencies({'circuit': cj[i]}))
        assert close(b.drift_frequencies_hz(ct[i]), a.drift_frequencies_hz(cj[i]))
    assert close(b.global_spectrum, a.global_spectrum)
    assert close(b.power_threshold(('circuit',)), a.power_threshold(('circuit',)))
    assert close(b.pvalue_threshold(('circuit',)), a.pvalue_threshold(('circuit',)))


def test_benjamini_hochberg_detector_matches_jax():
    jd, td = make_drifting_datasets(drifting=(0,))
    a, b = analyzers(jd, td)
    for an in (a, b):
        an.run_instability_detection(inclass_correction={'spectrum': 'Benjamini-Hochberg'},
                                     saveas='bh')
        an.run_instability_detection(saveas='bonf', default=False)
    same_detection(a, b, 'bh')
    same_detection(a, b, 'bonf')
    c0 = list(td.keys())[0]
    assert 6 in b.instability_indices({'circuit': c0}, detectorkey='bh')
    pa, pb = a.pvalue_threshold(('circuit',), 'bh'), b.pvalue_threshold(('circuit',), 'bh')
    assert pa.keys() == pb.keys() and all(close(pb[k], pa[k]) for k in pa)


def test_named_detectors_and_thresholds_match_jax():
    jd, td = make_drifting_datasets()
    a, b = analyzers(jd, td)
    for an in (a, b):
        an.run_instability_detection(saveas='a')
        an.run_instability_detection(significance=0.01, saveas='b', default=False)
    assert b._def_detection == a._def_detection == 'a'
    for key in ('a', 'b'):
        same_detection(a, b, key)
        assert close(b.statistical_significance(key), a.statistical_significance(key))
        assert close(b.power_threshold(('circuit',), key), a.power_threshold(('circuit',), key))
        assert close(b.pvalue_threshold(('circuit',), key),
                     a.pvalue_threshold(('circuit',), key))
        assert b.instability_detected_in(key) == a.instability_detected_in(key)
        assert b.instability_detected_in(key, ('circuit',)) == \
            a.instability_detected_in(key, ('circuit',))


@pytest.mark.parametrize('estimator', ['filter', 'mle'])
def test_characterization_and_tvd_bounds_match_jax(estimator):
    """The filter estimate's amplitudes (1e-12) and the mle estimate's
    (Nelder-Mead from them on the same clickstreams, 1e-9), trajectories,
    TVD bounds and the unstable_circuits forms."""
    jd, td = make_drifting_datasets(drifting=(0,), amp=0.25)
    a, b = analyzers(jd, td)
    for an in (a, b):
        an.run_instability_detection()
        an.run_instability_characterization(estimator=estimator)
    tol = TOL if estimator == 'filter' else 1e-9
    times = np.arange(500, dtype=float)
    for cj, ct in zip(jd.keys(), td.keys()):
        pa = a.probability_trajectory_model(cj, estimator=estimator)
        pb = b.probability_trajectory_model(ct, estimator=estimator)
        assert type(pb).__name__ == type(pa).__name__ and pb.hyperparameters == pa.hyperparameters
        assert all(close(pb.parameters[o], pa.parameters[o], tol) for o in pa.parameters)
        assert all(close(b.probability_trajectory(ct, times, estimator=estimator)[o],
                         a.probability_trajectory(cj, times, estimator=estimator)[o], tol)
                   for o in pa.outcomes)
        assert close(b.maximum_tvd_bound(ct, estimator=estimator),
                     a.maximum_tvd_bound(cj, estimator=estimator), tol)
    assert close(b.maxmax_tvd_bound(estimator=estimator), a.maxmax_tvd_bound(estimator=estimator),
                 tol)
    ua, ub = a.unstable_circuits(getmaxtvd=True), b.unstable_circuits(getmaxtvd=True)
    assert [str(c) for c in ub] == [str(c) for c in ua]
    for (cj, (fa, ta)), (ct, (fb, tb)) in zip(ua.items(), ub.items()):
        assert close(fb, fa) and close(tb, ta, tol)
    assert {str(k): v for k, v in b.unstable_circuits(freqindices=True).items()} == \
        {str(k): v for k, v in a.unstable_circuits(freqindices=True).items()}


def test_characterization_of_chosen_circuits():
    """`circuits=` (the port's keyword) characterizes those circuits only,
    with the same estimates as a run over all of them."""
    _, td = make_drifting_datasets(drifting=(0, 2), amp=0.25)
    full = tsa.StabilityAnalyzer(td, device='cpu')
    part = tsa.StabilityAnalyzer(td, device='cpu')
    for an in (full, part):
        an.compute_spectra()
        an.run_instability_detection()
    full.run_instability_characterization(estimator='mle')
    c2 = list(td.keys())[2]
    part.run_instability_characterization(estimator='mle', circuits=[c2])
    assert list(part._probtrajectories) == [(0, 2)]
    assert part.probability_trajectory_model(c2).parameters == \
        full.probability_trajectory_model(c2).parameters


def test_analyzer_aux_surface_matches_jax():
    """dof_reduction, same_frequencies, averaging_allowed and frequency
    pointers on equal and on differing timesteps."""
    rng = np.random.RandomState(1)
    T = 64
    ols1 = [(str(rng.randint(2)),) for _ in range(T)]
    ols2 = [(str(rng.randint(2)),) for _ in range(T)]
    out = []
    for DS, C, sa in ((JDataSet, JCircuit, jsa), (TDataSet, TCircuit, tsa)):
        ds = DS()
        ds.add_raw_series_data(C('Gxpi2:0@(0)'), ols1, np.arange(T, dtype=float))
        ds.add_raw_series_data(C('Gypi2:0@(0)'), ols2, 2.5 * np.arange(T, dtype=float))
        an = sa.StabilityAnalyzer(ds) if sa is jsa else sa.StabilityAnalyzer(ds, device='cpu')
        an.compute_spectra()
        c1 = list(ds.keys())[0]
        out.append((an._freqpointers, an.same_frequencies(), an.same_frequencies({'circuit': c1}),
                    an.averaging_allowed(), an.averaging_allowed(checklevel=0),
                    [an.dof_reduction(x) for x in ('dataset', 'circuit', 'outcome')],
                    an.num_degrees_of_freedom(('circuit',)), an.num_spectra(('circuit',))))
        out[-1] += (an._basespectra,)
    assert out[0][:-1] == out[1][:-1] and close(out[1][-1], out[0][-1])


def test_multidataset_analyzer_matches_jax():
    """Two datasets: the 'dataset' axis in the auto tests, detection and
    characterization against the JAX package."""
    jd1, td1 = make_drifting_datasets(n_circuits=3, T=200, drifting=(0,), seed=3)
    jd2, td2 = make_drifting_datasets(n_circuits=3, T=200, drifting=(), seed=4)
    jm, tm = JMultiDataSet(), TMultiDataSet()
    jm.add_dataset('A', jd1)
    jm.add_dataset('B', jd2)
    tm.add_dataset('A', td1)
    tm.add_dataset('B', td2)
    a, b = analyzers(jm, tm)
    for an in (a, b):
        an.run_instability_detection()
        an.run_instability_characterization()
    same_detection(a, b)
    assert close(b.power_spectrum({'dataset': 'A'}), a.power_spectrum({'dataset': 'A'}))
    for dskey in ('A', 'B'):
        for cj, ct in zip(jd1.keys(), td1.keys()):
            assert close(b.maximum_tvd_bound(ct, dskey), a.maximum_tvd_bound(cj, dskey))


def test_clickstream_analysis_matches_jax():
    """tests/test_protocols_misc.py's clickstream: analyze_clickstream and
    estimate_probability_trajectory, and the per-stream trajectories."""
    rng = np.random.RandomState(1)
    T = 1000
    t = np.arange(T)
    bits = rng.binomial(1, 0.5 + 0.4 * np.cos(2 * np.pi * 5 * t / T))
    da, ma, sa_ = jsa.StabilityAnalyzer.analyze_clickstream(bits)
    db, mb, sb = tsa.StabilityAnalyzer.analyze_clickstream(bits)
    assert da == db and ma == mb and close(sb, sa_)
    assert close(tsa.StabilityAnalyzer.estimate_probability_trajectory(bits, mb),
                 jsa.StabilityAnalyzer.estimate_probability_trajectory(bits, ma))


def test_stability_protocol_matches_jax():
    """StabilityAnalysis().run on tests/test_protocols_misc.py's data."""
    rng = np.random.RandomState(2)
    T = 500
    t = np.arange(T)
    bits = rng.binomial(1, 0.5 + 0.35 * np.cos(2 * np.pi * 3 * t / T))
    bits2 = rng.binomial(1, 0.3, T)
    res = []
    for DS, C, Design, Data, Proto in ((JDataSet, JCircuit, JDesign, JData, JStability),
                                       (TDataSet, TCircuit, TDesign, TData, TStability)):
        ds = DS()
        ds.add_raw_series_data(C('Gxpi2:0@(0)'), ['1' if b else '0' for b in bits], t.tolist())
        ds.add_raw_series_data(C('Gypi2:0@(0)'), ['1' if b else '0' for b in bits2], t.tolist())
        proto = Proto() if Proto is JStability else Proto(device='cpu')
        res.append(proto.run(Data(Design(list(ds.keys())), ds)))
    a, b = res
    assert b.instability_detected and a.instability_detected
    assert [str(c) for c in b.unstable_circuits] == [str(c) for c in a.unstable_circuits] \
        == ['Gxpi2:0@(0)']
    assert sorted(str(k) for k in b.probability_trajectories) == \
        sorted(str(k) for k in a.probability_trajectories)
    for (ka, va), (kb, vb) in zip(sorted(a.probability_trajectories.items(), key=str),
                                  sorted(b.probability_trajectories.items(), key=str)):
        assert close(vb, va)
    assert str(b) == str(a)


# -- probability trajectories, time-resolved models --------------------------

def test_probability_trajectories_match_jax():
    """_xlogp_rectified (below, inside and above the band), the
    trajectories' probabilities, negloglikelihood, amplitude_compression
    and maxlikelihood on the same clickstreams."""
    x = np.array([0.0, 1.0, 3.0, 1.0, 2.0])
    p = np.array([-0.2, 1e-5, 0.3, 1 - 1e-8, 0.9])
    # the JAX package's form raises where some points are below the band
    # and some not; per point, it holds
    with pytest.raises(ValueError):
        jpt._xlogp_rectified(x, p)
    assert close(tpt._xlogp_rectified(x, p), [float(np.ravel(jpt._xlogp_rectified(a, b))[0])
                                                for a, b in zip(x, p)])
    assert close(tpt._xlogp_rectified(x, p[2:3]), jpt._xlogp_rectified(x, p[2:3]))
    outs = [('0',), ('1',)]
    rng = np.random.RandomState(8)
    T = 300
    times = np.arange(T, dtype=float)
    bits = rng.binomial(1, 0.5 + 0.15 * np.cos(np.pi * 4 * (times + 0.5) / T)).astype(float)
    streams = {('0',): 1 - bits, ('1',): bits}
    res = []
    for m in (jpt, tpt):
        tr = m.CosineProbTrajectory(outs, [0, 4], {('0',): [0.5, 0.45]}, 0.0, 1.0, T)
        comp, was = m.amplitude_compression(tr, times)
        const = m.ConstantProbTrajectory(outs, {('0',): 0.4})
        # the likelihoods on a trajectory whose trial steps stay inside the
        # band (the JAX package's objective raises outside it, see above)
        inside = m.CosineProbTrajectory(outs, [0, 4], {('0',): [0.5, 0.1]}, 0.0, 1.0, T)
        mle = m.maxlikelihood(inside, streams, times, verbosity=0)
        res.append((tr.probabilities(times)[('1',)], comp.parameters[('0',)], float(was),
                    m.negloglikelihood(inside, streams, times),
                    const.probabilities(times[:5])[('1',)],
                    mle.parameters[('0',)], tr.parameters_as_vector()))
    for u, v in zip(res[1], res[0]):
        assert close(u, v, 1e-9)


def test_time_resolved_model_matches_jax():
    """A Ramsey-like TimeResolvedModel subclass: negloglikelihood on the
    same data and the maximum-likelihood parameters in both packages."""
    T = 120
    times = np.arange(T, dtype=float)
    rng = np.random.RandomState(5)
    bits = rng.binomial(1, 0.5 + 0.3 * np.sin(0.1 * times))
    out = []
    for tr, DS, C in ((jtr, JDataSet, JCircuit), (ttr, TDataSet, TCircuit)):
        class Ramsey(tr.TimeResolvedModel):
            def probabilities(self, circuit, times):
                p1 = 0.5 + self.parameters[0] * np.sin(self.parameters[1] * np.asarray(times))
                return {('1',): p1, ('0',): 1 - p1}
        ds = DS()
        ds.add_raw_series_data(C('Gxpi2:0@(0)'), ['1' if b else '0' for b in bits], times)
        m = Ramsey(None, [0.2, 0.11])
        fit = tr.maxlikelihood(m, ds, verbosity=0)
        out.append((tr.negloglikelihood(m, ds), np.asarray(fit.parameters)))
    assert close(out[1][0], out[0][0]) and close(out[1][1], out[0][1], 1e-9)


def test_outcome_average_is_pearson_weighted():
    """Four outcomes (ROADMAP.md section 3): the port's per-circuit
    spectrum is sum_i c_i^2 / p_i / (n - 1) over all n raw streams' DCT
    modes c_i (1e-12), chi2_3 / 3 under a constant distribution; the JAX
    package averages the 3 independent streams' standardized powers as if
    independent.  On static data whose circuits split between two
    outcomes, those streams mirror each other: the JAX analyzer flags
    circuits of static data, the port's flags none."""
    from scipy.fft import dct
    rng = np.random.RandomState(21)
    T, n_circ = 500, 400
    outcomes = [('00',), ('01',), ('10',), ('11',)]
    jd, td = JDataSet(), TDataSet()
    for i in range(n_circ):
        p = np.array([0.49, 0.49, 0.01, 0.01])[rng.permutation(4)]
        labels = [outcomes[k] for k in rng.choice(4, size=T, p=p)]
        jd.add_raw_series_data(JCircuit([('Gxpi2', 0)] * (i + 1), (0,)), labels, np.arange(T))
        td.add_raw_series_data(TCircuit([('Gxpi2', 0)] * (i + 1), (0,)), labels, np.arange(T))
    a, b = analyzers(jd, td)
    a.run_instability_detection()
    b.run_instability_detection()
    assert len(a.unstable_circuits_list) >= 2 and len(b.unstable_circuits_list) == 0
    ours = b._averaged_spectra(('circuit',))
    for j, c in enumerate(list(td.keys())[:20]):
        streams = b._timeinfo[('ds0', c)][1]
        pearson = sum(dct(x - x.mean(), norm='ortho') ** 2 / x.mean()
                      for x in streams.values()) / 3
        assert close(ours[j, 1:], pearson[1:])
    # the per-outcome spectra and their thresholds stay the JAX package's
    assert close(b.power_threshold(('circuit',)), a.power_threshold(('circuit',)))
