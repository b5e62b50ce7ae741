"""Drift detection and probability-trajectory estimation (counterpart of
pygsti_tpu/extras/drift/stabilityanalyzer.py).

The JAX package's multi-test, multi-resolution workflow, with its
semantics:

* per-(dataset, circuit, outcome) clickstream power spectra held as one
  4-D array [n_ds, n_circ, n_out - 1, T] (DCT for equally spaced data,
  Lomb-Scargle otherwise), filled by one batched call per transform on
  `device` (``signal.dct_power_spectra``, ``signal.lsp_power_spectra``);
  the clickstreams are built with numpy from each row's arrays,
* power-averaged spectra over any subset of the (dataset, circuit,
  outcome) axes,
* instability detection for sets of test classes with a between-class
  significance weighting and per-class corrections mixing Bonferroni and
  Benjamini-Hochberg, stored under named detector keys,
* instability characterization: per-circuit probability-trajectory model
  selection from the detection results, with 'filter' (DCT filtering and
  amplitude compression) and 'mle' estimators, and TVD bounds.

The degrees-of-freedom rule is the JAX package's: n outcomes give n - 1
degrees of freedom per mode, and no axis reduces them.  Averaging over
outcomes takes all n streams in the Pearson form (compute_spectra), where
the JAX package averages the n - 1 independent streams as if they were
independent: the same for two outcomes, and no false alarms from the
streams' correlation above two (ROADMAP.md section 3).
"""

from __future__ import annotations

import itertools as _itertools
import time

import numpy as np
import torch

from pygsti_tpu_torch.extras.drift import signal as _sig
from pygsti_tpu_torch.extras.drift import probtrajectory as _ptraj


# ---------------------------------------------------------------------------
# test-specification machinery (reference: stabilityanalyzer.py:23-230)

_AXISLABELS = ('dataset', 'circuit', 'outcome')


def compute_valid_tests():
    """All valid test classes: tuples containing a subset of 'dataset',
    'circuit', 'outcome' (reference: compute_valid_tests)."""
    return [(), ('dataset',), ('dataset', 'circuit'),
            ('dataset', 'circuit', 'outcome'), ('circuit',),
            ('circuit', 'outcome'), ('outcome',), ('dataset', 'outcome')]


def check_valid_tests(tests):
    valid = compute_valid_tests()
    for test in tests:
        assert test in valid, \
            "This is an invalid set of tests for drift detection!"


def compute_auto_tests(shape, ids=False):
    """Default test classes for data of the given (n_datasets, n_circuits,
    n_outcomes) shape (reference: compute_auto_tests)."""
    if ids:
        auto_tests = ((), ('dataset',), ('dataset', 'circuit'))
    else:
        auto_tests = (('dataset',), ('dataset', 'circuit'))
    condensed, _ = condense_tests(shape, auto_tests, None)
    return tuple(condensed)


def condense_tests(shape, tests, weightings=None):
    """Remove axes that are trivial given the data shape, merging duplicate
    tests and summing their significance weightings (reference:
    condense_tests)."""
    trivialshape = {'dataset': 1, 'circuit': 1, 'outcome': 2}
    condtests = []
    condweightings = {} if weightings is not None else None
    for test in tests:
        condtest = tuple(a for i, a in enumerate(_AXISLABELS)
                         if a in test and shape[i] > trivialshape[a])
        if condtest not in condtests:
            condtests.append(condtest)
            if weightings is not None:
                condweightings[condtest] = weightings[test]
        elif weightings is not None:
            condweightings[condtest] += weightings[test]
    return condtests, condweightings


def compute_valid_inclass_corrections():
    """All valid inclass_correction dicts: Bonferroni at the top switching
    to Benjamini-Hochberg at some level (reference:
    compute_valid_inclass_corrections)."""
    out = []
    levels = ('dataset', 'circuit', 'outcome', 'spectrum')
    for switch in range(4):
        out.append({lvl: ('Bonferroni' if i < switch else 'Benjamini-Hochberg')
                    for i, lvl in enumerate(levels)})
    out.append({lvl: 'Bonferroni' for lvl in levels})
    return out


def populate_inclass_correction(inclass_correction=None):
    """Fill an incomplete inclass_correction with auto values: Bonferroni
    above the first specified non-Bonferroni level, that correction below
    (reference: populate_inclass_correction)."""
    if inclass_correction is None:
        inclass_correction = {}
    inclass_correction = dict(inclass_correction)
    autocorrection = 'Bonferroni'
    for key in ('dataset', 'circuit', 'outcome', 'spectrum'):
        if key not in inclass_correction:
            inclass_correction[key] = autocorrection
        autocorrection = inclass_correction[key]
    assert inclass_correction in compute_valid_inclass_corrections(), \
        "This is an invalid inclass correction!"
    return inclass_correction


def compute_auto_betweenclass_weighting(tests, betweenclass_weighting=True):
    """Equal Bonferroni split of significance across test classes, or no
    correction (reference: compute_auto_betweenclass_weighting)."""
    if betweenclass_weighting:
        return {test: 1.0 / len(tests) for test in tests}
    return {test: 1.0 for test in tests}


def compute_auto_estimator(transform):
    """Default probability-trajectory estimator for a transform
    (reference: compute_auto_estimator)."""
    if transform == 'dct':
        return 'filter'
    if transform == 'lsp':
        return 'mle'
    raise ValueError(
        "No auto estimation method available for %s transform!" % transform)


def _clickstreams(row):
    """({outcome: 0/1 array}, shot times): a time-series row's per-shot
    clickstreams (repetitions expanded), ordered by timestamp, built with
    numpy from the row's arrays; (None, None) without series data."""
    series = row.outcome_series
    if series is None or row.time is None or len(series) == 0:
        return None, None
    times = np.asarray(row.time, dtype=float)
    reps = np.asarray(row.reps if row.reps is not None else np.ones(len(series)), dtype=int)
    order = np.argsort(times, kind='stable')
    outcomes = sorted(set(series))
    code = {o: k for k, o in enumerate(outcomes)}
    idx = np.fromiter((code[s] for s in series), dtype=np.int64, count=len(series))
    shots = np.repeat(idx[order], reps[order])
    streams = {o: (shots == k).astype(float) for k, o in enumerate(outcomes)}
    return streams, np.repeat(times[order], reps[order])


class StabilityAnalyzer(object):
    """Analyze time-series data for drift (reference:
    stabilityanalyzer.StabilityAnalyzer:232).

    Accepts a DataSet or a MultiDataSet; per-(dataset, circuit, outcome)
    clickstream spectra are stored as one [n_ds, n_circ, n_out, T] array.
    The last outcome of each circuit is dropped from the testing array (its
    clickstream is the complement of the others, so for 2-outcome data it
    has an identical spectrum and would double-count correlated tests;
    matching the reference's degrees-of-freedom adjustment in spirit).
    """

    def __init__(self, ds, transform='auto', significance=0.05, tests='auto',
                 constnumtimes='auto', ids=False, device="cuda"):
        from pygsti_tpu_torch.data.multidataset import MultiDataSet
        self.device = torch.device(device)
        # host seconds of the last call of each step (the spectra's ends in a
        # read from the device)
        self.seconds = {}
        if isinstance(ds, MultiDataSet):
            self.data = {k: ds[k] for k in ds.keys()}
        else:
            self.data = {'ds0': ds}
        self.dataset = ds if not isinstance(ds, MultiDataSet) \
            else ds[list(ds.keys())[0]]
        self.transform = transform
        self.significance = significance
        self.ids = ids
        self._requested_tests = tests
        self.constnumtimes = constnumtimes

        # spectra state
        self._basespectra = None     # [n_ds, n_circ, n_out_indep, T]
        self._dskeys = list(self.data.keys())
        self._circuits = None        # circuits with series data
        self._outcomes = None        # full outcome list (incl. dependent last)
        self._shape = None           # (n_ds, n_circ, n_out_indep, T)
        self.spectra = {}            # legacy dict view: (circuit, outcome) ->
        #                              spectrum (first dataset)
        self.circuit_spectra = {}    # legacy: circuit -> outcome-avg spectrum
        self.global_spectrum = None  # legacy: circuit-averaged spectrum
        self.frequencies = {}        # circuit -> mode frequencies in Hz
        self._timeinfo = {}          # (dskey, circuit) -> (times, streams)

        # detection state (per detector key)
        self._driftdetectors = []
        self._def_detection = None
        self._tests = {}
        self._condtests = {}
        self._test_significance = {}
        self._inclass_correction = {}
        self._power_sigthreshold = {}
        self._driftfreqinds = {}
        self._driftdetected_global = {}
        self._driftdetected_class = {}

        # characterization state
        self._probtrajectories = {}
        self._def_probtrajectories = None

        # legacy flat results
        self.drift_frequencies = {}
        self.instability_detected = False
        self.unstable_circuits_list = []
        self._analyzed = False

    # -- spectra ---------------------------------------------------------------
    def compute_spectra(self):
        """Compute the [n_ds, n_circ, n_out, T] base power spectra plus the
        legacy per-circuit/global averaged views (reference:
        compute_spectra:474)."""
        t0 = time.perf_counter()
        ds0 = self.data[self._dskeys[0]]
        # compute clickstreams once (they expand every (outcome, rep) into
        # per-shot arrays -- the dominant preprocessing cost) and reuse them
        # for both the circuit filter and the _timeinfo cache
        streams0 = {c: _clickstreams(ds0[c]) for c in ds0.keys()}
        circuits = [c for c in ds0.keys() if streams0[c][0] is not None]
        self._circuits = circuits
        if not circuits:
            self._analyzed = True
            return self.spectra
        outcomes = sorted({o for c in circuits
                           for o in set(ds0[c].outcome_series or [])})
        self._outcomes = outcomes
        n_out_indep = max(len(outcomes) - 1, 1)

        # common number of times: 'auto' truncates to the min stream length
        lengths = []
        for dskey in self._dskeys:
            for c in circuits:
                if dskey == self._dskeys[0]:
                    streams, times = streams0[c]
                else:
                    streams, times = _clickstreams(self.data[dskey][c])
                self._timeinfo[(dskey, c)] = (times, streams)
                lengths.append(len(times))
        T = min(lengths) if self.constnumtimes == 'auto' \
            else int(self.constnumtimes)
        t1 = time.perf_counter()
        self.seconds['clickstreams'] = t1 - t0

        n_ds, n_circ = len(self._dskeys), len(circuits)
        indep = outcomes[:-1] if len(outcomes) > 1 else outcomes
        # every outcome's stream, truncated to T, and the transform of its
        # row; constant streams keep a zero spectrum
        X = np.zeros((n_ds, n_circ, len(outcomes), T))
        use_lsp = np.zeros((n_ds, n_circ), dtype=bool)
        lsp_times = np.zeros((n_ds, n_circ, T))
        lsp_freqs = np.zeros((n_ds, n_circ, max(T - 1, 0)))
        for i, dskey in enumerate(self._dskeys):
            for j, c in enumerate(circuits):
                times, streams = self._timeinfo[(dskey, c)]
                times = times[:T]
                equal_spaced = len(times) < 2 or np.allclose(
                    np.diff(times), times[1] - times[0], atol=1e-9)
                transform = self.transform
                if transform == 'auto':
                    transform = 'dct' if equal_spaced else 'lsp'
                for k, o in enumerate(outcomes):
                    if o in streams:
                        X[i, j, k] = streams[o][:T]
                if transform != 'dct':
                    use_lsp[i, j] = True
                    lsp_times[i, j] = times
                    dt = max((times[-1] - times[0]) / max(T - 1, 1), 1e-12)
                    lsp_freqs[i, j] = _sig.frequencies_from_timestep(dt, T)[1:]
                if i == 0 and len(times) >= 2:
                    dt = (times[-1] - times[0]) / max(len(times) - 1, 1)
                    self.frequencies[c] = _sig.frequencies_from_timestep(dt, T)
        varying = X.std(axis=-1) > 0
        dct_sel = varying & ~use_lsp[:, :, None]
        lsp_sel = varying & use_lsp[:, :, None]
        spectra = torch.zeros(X.shape, dtype=torch.float64, device=self.device)
        if dct_sel.any():
            sel = torch.as_tensor(dct_sel, device=self.device)
            spectra[sel] = _sig.dct_power_spectra(X[dct_sel], self.device)
        if lsp_sel.any() and T > 1:
            i, j, _ = np.nonzero(lsp_sel)
            sel = torch.as_tensor(lsp_sel, device=self.device)
            spectra[sel, 1:] = _sig.lsp_power_spectra(X[lsp_sel], lsp_times[i, j],
                                                      lsp_freqs[i, j], self.device)
        # the outcome average: sum_i (1 - p_i) s_i / (n - 1) over all n
        # streams, p_i a stream's mean, s_i its standardized power, which is
        # the Pearson form sum_i c_i^2 / p_i of the raw streams' modes and
        # chi2_{n-1} / (n - 1) under a constant distribution.  The JAX
        # package averages the n - 1 independent streams' powers as if they
        # were independent; they are not (one outcome's clicks are the
        # others' misses), and at 2 qubits that flags circuits of static
        # data (ROADMAP.md section 3).  For two outcomes both are the one
        # stream's power.
        if len(outcomes) > 1:
            pbar = torch.clamp(torch.as_tensor(X.mean(axis=-1), device=self.device),
                               1e-12, 1 - 1e-12)
            averaged = ((1 - pbar)[..., None] * spectra).sum(dim=2) / (len(outcomes) - 1)
        else:
            averaged = spectra[:, :, 0]
        base = spectra[:, :, :n_out_indep].cpu().numpy()
        self._outcome_averaged = averaged.cpu().numpy()
        self.seconds['spectra'] = time.perf_counter() - t1
        self._basespectra = base
        self._shape = (n_ds, n_circ, n_out_indep, T)
        # dof bookkeeping for averaged spectra (reference: _dofreduction,
        # stabilityanalyzer.py:602).  The reference keeps all outcome
        # streams and loses one dof averaging over the (dependent) outcome
        # axis; our base spectra EXCLUDE the dependent outcome stream, so
        # no reduction applies on any axis.
        self._dofreduction = {'dataset': 0, 'circuit': 0, 'outcome': 0}
        # frequency pointers: circuit index -> frequency-set id (reference:
        # _freqpointers); circuits sharing the default timestep share
        # pointer 0
        self._freqpointers = {}
        dts = {}
        for j, c in enumerate(circuits):
            times, _ = self._timeinfo[(self._dskeys[0], c)]
            dt = round(float((times[min(T, len(times)) - 1] - times[0])
                             / max(min(T, len(times)) - 1, 1)), 12) \
                if len(times) >= 2 else 0.0
            ptr = dts.setdefault(dt, len(dts))
            if ptr != 0:
                self._freqpointers[j] = ptr
        # shape for test condensing uses the FULL outcome count (the
        # reference's trivial-axis rule compares against 2 outcomes)
        self._condshape = (n_ds, n_circ, len(outcomes))

        # legacy dict views (first dataset)
        for j, c in enumerate(circuits):
            for k, o in enumerate(indep):
                if base[0, j, k].any():
                    self.spectra[(c, o)] = base[0, j, k]
            self.circuit_spectra[c] = self._outcome_averaged[0, j]
        self.global_spectrum = self._outcome_averaged[0].mean(axis=0)
        self._analyzed = True
        return self.spectra

    # -- averaged spectra / dof ------------------------------------------------
    def dof_reduction(self, axislabel):
        """Chi2-dof reduction when averaging spectra along `axislabel`
        (reference: dof_reduction:602).  Zero on every axis here: the base
        spectra exclude the dependent outcome stream."""
        return self._dofreduction[axislabel]

    def _check_dofreduction_set(self, axislabel):
        return self._dofreduction.get(axislabel, None) is not None

    def same_frequencies(self, dictlabel=None):
        """Whether all base spectra selected by `dictlabel` share one
        frequency set (reference: same_frequencies:674)."""
        if not self._freqpointers:
            return True
        dictlabel = dictlabel or {}
        if 'circuit' in dictlabel:
            circ_indices = [self._index('circuit', dictlabel['circuit'])]
        else:
            circ_indices = range(self._shape[1])
        ptrs = {self._freqpointers.get(j, 0) for j in circ_indices}
        return len(ptrs) == 1

    def averaging_allowed(self, dictlabel=None, checklevel=2):
        """Whether the base spectra selected by `dictlabel` may be averaged
        into one spectrum for hypothesis testing (reference:
        averaging_allowed:723): checklevel 0 = always, 1 = shared
        frequencies, 2+ = also a computable dof."""
        if checklevel == 0:
            return True
        if not self.same_frequencies(dictlabel):
            return False
        if checklevel >= 2:
            dictlabel = dictlabel or {}
            for a in _AXISLABELS:
                if a not in dictlabel and not self._check_dofreduction_set(a):
                    return False
        return True

    def num_degrees_of_freedom(self, test):
        """Null chi^2 dof of a power in the `test`-averaged spectra = the
        number of base spectra averaged together (reference:
        num_degrees_of_freedom:628)."""
        dof = 1
        for i, a in enumerate(_AXISLABELS):
            if a not in test:
                dof *= self._shape[i]
        return dof

    def num_spectra(self, test):
        """Number of spectra the `test` class tests (reference:
        num_spectra:659)."""
        n = 1
        for i, a in enumerate(_AXISLABELS):
            if a in test:
                n *= self._shape[i]
        return n

    def _averaged_spectra(self, test):
        """Spectra array for a test class: the spectra power-averaged over
        every axis NOT in the test (over outcomes by the Pearson form of
        compute_spectra)."""
        if 'outcome' in test:
            axes = tuple(i for i, a in enumerate(_AXISLABELS) if a not in test)
            return np.mean(self._basespectra, axis=axes)
        axes = tuple(i for i, a in enumerate(_AXISLABELS[:2]) if a not in test)
        return np.mean(self._outcome_averaged, axis=axes) if axes else self._outcome_averaged

    def power_spectrum(self, dictlabel=None):
        """Spectrum for a dict/tuple label.  Accepts the reference's dict
        form ({'dataset': key, 'circuit': c, 'outcome': o}) or the legacy
        tuple form ((circuit, outcome), (circuit,) or ())."""
        if isinstance(dictlabel, dict):
            test = tuple(a for a in _AXISLABELS if a in dictlabel)
            spectra = self._averaged_spectra(test)
            idx = tuple(self._index(a, dictlabel[a]) for a in test)
            return spectra[idx]
        key = dictlabel if dictlabel is not None else ()
        if key == ():
            return self.global_spectrum
        if len(key) == 1:
            return self.circuit_spectra.get(key[0])
        return self.spectra.get(tuple(key))

    def maximum_power(self, dictlabel=None):
        """Max power in a spectrum (reference: maximum_power:900)."""
        spec = self.power_spectrum(dictlabel if dictlabel is not None else {})
        return float(np.max(spec[1:])) if spec is not None else 0.0

    def maximum_power_pvalue(self, dictlabel=None):
        """p-value of the max power (reference: maximum_power_pvalue:928)."""
        if isinstance(dictlabel, dict):
            test = tuple(a for a in _AXISLABELS if a in dictlabel)
        else:
            test = dictlabel if dictlabel is not None else ()
        dof = self.num_degrees_of_freedom(test)
        spec = self.power_spectrum(dictlabel if dictlabel is not None else {})
        return float(_sig.maxpower_pvalue(np.max(spec[1:]), len(spec) - 1,
                                          dof))

    def _index(self, axislabel, key):
        if axislabel == 'dataset':
            return self._dskeys.index(key)
        if axislabel == 'circuit':
            return self._circuits.index(key)
        indep = self._outcomes[:-1] if len(self._outcomes) > 1 \
            else self._outcomes
        return indep.index(key)

    # -- detection ---------------------------------------------------------------
    def run_instability_detection(self, significance=None, tests=None,
                                  inclass_correction=None,
                                  betweenclass_weighting='auto',
                                  saveas='detection', default=True,
                                  verbosity=0):
        """Multi-class drift tests with between-class significance
        weighting and per-class Bonferroni / Benjamini-Hochberg corrections
        (reference: run_instability_detection:960).

        Results are stored under the `saveas` detector key; legacy flat
        attributes (drift_frequencies, unstable_circuits,
        instability_detected) reflect the default detector.
        """
        if not self._analyzed:
            self.compute_spectra()
        if self._basespectra is None or not self._circuits:
            self.instability_detected = False
            return {}
        t0 = time.perf_counter()
        significance = significance if significance is not None \
            else self.significance
        if tests is None:
            tests = self._requested_tests
        if tests == 'auto':
            tests = compute_auto_tests(self._condshape, ids=self.ids)
        tests = tuple(tuple(t) for t in tests)
        check_valid_tests(tests)
        inclass_correction = populate_inclass_correction(inclass_correction)
        if betweenclass_weighting == 'auto' or isinstance(
                betweenclass_weighting, bool):
            betweenclass_weighting = compute_auto_betweenclass_weighting(
                tests, betweenclass_weighting is not False)
        condtests, condweighting = condense_tests(self._condshape, tests,
                                                  betweenclass_weighting)
        test_significance = {t: significance * condweighting[t]
                             for t in condtests}

        if default or self._def_detection is None:
            self._def_detection = saveas
        if saveas not in self._driftdetectors:
            self._driftdetectors.append(saveas)
        self._tests[saveas] = tests
        self._condtests[saveas] = condtests
        self._test_significance[saveas] = test_significance
        self._inclass_correction[saveas] = inclass_correction

        T = self._shape[3]
        freqstest = np.arange(1, T)  # skip the DC mode
        sigthreshold = {}
        driftfreqinds = {}
        detected_global = False
        detected_class = {}

        for test in condtests:
            sig = test_significance[test]
            dof = self.num_degrees_of_freedom(test)
            numspectra = self.num_spectra(test)
            numtests = len(freqstest) * numspectra
            detected_class[test] = False
            driftfreqinds[test] = {}
            spectra = self._averaged_spectra(test)

            corrections = [inclass_correction[a] for a in test] \
                + [inclass_correction['spectrum']]
            if all(c == 'Bonferroni' for c in corrections):
                thresh = _sig.power_significance_threshold(sig, numtests, dof)
                sigthreshold[test] = thresh
                for indices in np.ndindex(spectra.shape[:-1]):
                    above = spectra[indices][freqstest] > thresh
                    inds = tuple(freqstest[above])
                    if inds:
                        driftfreqinds[test][indices] = inds
            else:
                assert inclass_correction['spectrum'] == \
                    'Benjamini-Hochberg', \
                    "If not Bonferroni, only Benjamini-Hochberg is allowed!"
                # outer Bonferroni iteration over axes with a Bonferroni
                # correction; nested BH over the rest + the spectrum level
                numBon = 1
                iterBon, iterBH = [], []
                for a in test:
                    n_axis = self._shape[_AXISLABELS.index(a)]
                    if inclass_correction[a] == 'Bonferroni':
                        numBon *= n_axis
                        iterBon.append(range(n_axis))
                    else:
                        iterBH.append(range(n_axis))
                iterBH.append(freqstest)
                numBH = numtests // max(numBon, 1)
                localsig = sig / max(numBon, 1)
                quasi = _sig.power_significance_quasithreshold(
                    localsig, numBH, dof)
                sigthreshold[test] = {}
                for indices in _itertools.product(*iterBon):
                    sub = spectra[indices]
                    powerindices = list(_itertools.product(*iterBH))
                    powers = np.array(
                        [sub[tuple(pi[:-1]) + (pi[-1],)]
                         for pi in powerindices])
                    order = np.argsort(powers, kind='stable')
                    powers_sorted = powers[order]
                    exceed = powers_sorted > quasi
                    if exceed.any():
                        threshind = int(np.argmax(exceed))
                        for oi in order[threshind:]:
                            pi = powerindices[oi]
                            spectraindex = tuple(indices) + tuple(pi[:-1])
                            driftfreqinds[test].setdefault(spectraindex, ())
                            driftfreqinds[test][spectraindex] += (pi[-1],)
                        sigthreshold[test][indices] = quasi[threshind]
                    else:
                        sigthreshold[test][indices] = quasi[-1]

            if driftfreqinds[test]:
                detected_class[test] = True
                detected_global = True
            if verbosity > 0:
                print("  - test %s: %s (threshold %s)"
                      % (test, "drift DETECTED" if detected_class[test]
                         else "no drift", sigthreshold[test]))

        self._power_sigthreshold[saveas] = sigthreshold
        self._driftfreqinds[saveas] = driftfreqinds
        self._driftdetected_global[saveas] = detected_global
        self._driftdetected_class[saveas] = detected_class

        if saveas == self._def_detection:
            self._update_legacy_results(saveas)
        self.seconds['detection'] = time.perf_counter() - t0
        return self.drift_frequencies

    def _update_legacy_results(self, detectorkey):
        """Refresh the flat legacy attributes from a detector's results."""
        results = {}
        unstable = set()
        indep = self._outcomes[:-1] if len(self._outcomes) > 1 \
            else self._outcomes
        for test, perspec in self._driftfreqinds[detectorkey].items():
            for indices, modes in perspec.items():
                key = []
                for a, idx in zip(test, indices):
                    if a == 'dataset':
                        key.append(self._dskeys[idx])
                    elif a == 'circuit':
                        key.append(self._circuits[idx])
                        unstable.add(self._circuits[idx])
                    else:
                        key.append(indep[idx])
                # legacy keys: drop the dataset component for
                # single-dataset data
                if 'dataset' in test and len(self._dskeys) == 1:
                    key = key[1:]
                # a circuit-condensed test on single-circuit data IS the
                # per-circuit test: attribute its detections to the circuit
                if 'circuit' not in test and len(self._circuits) == 1:
                    key = [self._circuits[0]] + key
                    unstable.add(self._circuits[0])
                results[tuple(key)] = sorted(set(
                    list(results.get(tuple(key), [])) + list(modes)))
        self.drift_frequencies = results
        self.unstable_circuits_list = sorted(unstable, key=str)
        self.instability_detected = self._driftdetected_global[detectorkey]

    # -- detection accessors (reference: :1319-1700) ---------------------------
    def unstable_circuits(self, getmaxtvd=False, detectorkey=None,
                          freqindices=False):
        """Dict of circuits found unstable -> their significant drift
        frequencies in Hz (or frequency indices with `freqindices=True`);
        with `getmaxtvd=True` values are `(freqs, max_tvd_bound)` tuples
        (reference: unstable_circuits:1357)."""
        detectorkey = detectorkey or self._def_detection
        out = {}
        for c in self.unstable_circuits_list:
            if freqindices:
                freqs = self.instability_indices({'circuit': c}, detectorkey)
                # fall back to the legacy per-key record when the per-circuit
                # condensed test wasn't implemented directly
                if not freqs:
                    freqs = tuple(self.drift_frequencies.get((c,), ()))
            else:
                freqs = self.instability_frequencies({'circuit': c},
                                                     detectorkey)
                if not freqs:
                    inds = self.drift_frequencies.get((c,), ())
                    fr = self.frequencies.get(c)
                    freqs = [float(fr[i]) for i in inds
                             if fr is not None and i < len(fr)]
            if getmaxtvd:
                out[c] = (freqs, self.maximum_tvd_bound(c))
            else:
                out[c] = freqs
        return out

    def statistical_significance(self, detectorkey=None):
        detectorkey = detectorkey or self._def_detection
        return sum(self._test_significance[detectorkey].values())

    def _equivalent_implemented_test(self, test, detectorkey=None):
        """The condensed test equivalent to `test` given the data shape, if
        it was implemented (reference: _equivalent_implemented_test)."""
        detectorkey = detectorkey or self._def_detection
        cond, _ = condense_tests(self._condshape, (test,), None)
        cond = cond[0]
        if cond in self._condtests[detectorkey]:
            return cond
        return None

    def instability_indices(self, dictlabel=None, detectorkey=None):
        """Significant frequency indices for a spectrum label (dict form,
        reference: instability_indices:1492)."""
        detectorkey = detectorkey or self._def_detection
        if detectorkey is None:
            return ()
        dictlabel = dictlabel or {}
        test = self._equivalent_implemented_test(
            tuple(a for a in _AXISLABELS if a in dictlabel), detectorkey)
        if test is None:
            return ()
        indices = tuple(self._index(a, dictlabel[a]) for a in test)
        return tuple(sorted(
            self._driftfreqinds[detectorkey][test].get(indices, ())))

    def instability_frequencies(self, dictlabel=None, detectorkey=None):
        """Significant drift frequencies in Hz (reference:
        instability_frequencies:1537)."""
        inds = self.instability_indices(dictlabel, detectorkey)
        circuit = (dictlabel or {}).get('circuit')
        freqs = self.frequencies.get(circuit) if circuit is not None else None
        if freqs is None and self.frequencies:
            freqs = next(iter(self.frequencies.values()))
        if freqs is None:
            return []
        return [float(freqs[i]) for i in inds if i < len(freqs)]

    def power_threshold(self, test, detectorkey=None):
        detectorkey = detectorkey or self._def_detection
        return self._power_sigthreshold[detectorkey][tuple(test)]

    def pvalue_threshold(self, test, detectorkey=None):
        """The power threshold converted to a p-value (reference:
        pvalue_threshold:1632)."""
        thresh = self.power_threshold(test, detectorkey)
        dof = self.num_degrees_of_freedom(tuple(test))
        if isinstance(thresh, dict):
            return {k: float(_sig.power_to_pvalue(v, dof))
                    for k, v in thresh.items()}
        return float(_sig.power_to_pvalue(thresh, dof))

    def instability_detected_in(self, detectorkey=None, test=None):
        """Whether drift was detected (globally or by one test class)
        (reference: instability_detected:1671)."""
        detectorkey = detectorkey or self._def_detection
        if test is not None:
            return self._driftdetected_class[detectorkey].get(
                tuple(test), False)
        return self._driftdetected_global[detectorkey]

    # -- characterization (reference: :1702-2007) ------------------------------
    def run_instability_characterization(self, estimator='auto',
                                         modelselector=(None, None),
                                         default=True, verbosity=0, circuits=None):
        """Estimate a probability-trajectory model for every circuit (or
        for `circuits` only), with DCT-model selection from the detection
        results."""
        t0 = time.perf_counter()
        if estimator == 'auto':
            transform = self.transform if self.transform != 'auto' else 'dct'
            estimator = compute_auto_estimator(transform)
        assert estimator in ('filter', 'mle'), \
            "estimator must be 'filter' or 'mle'"
        detectorkey = modelselector[0] or self._def_detection
        assert detectorkey is not None, \
            "Run .run_instability_detection() before characterization!"
        test = modelselector[1]
        if test is None:
            test = self._equivalent_implemented_test(('dataset', 'circuit'),
                                                     detectorkey)
            assert test is not None, \
                "No implemented test is equivalent to ('dataset', 'circuit')!"
        if self._def_probtrajectories is None or default:
            self._def_probtrajectories = (detectorkey, test, estimator)

        outcomes = self._outcomes
        chosen = set(self._circuits if circuits is None else circuits)
        for i, dskey in enumerate(self._dskeys):
            for j, circuit in enumerate(self._circuits):
                if circuit not in chosen:
                    continue
                key = (i, j)
                self._probtrajectories.setdefault(key, {})
                row = self.data[dskey][circuit]
                counts = row.counts
                total = max(row.total, 1)
                means = {o: counts.get(o, 0) / total
                         for o in (outcomes[:-1] if len(outcomes) > 1
                                   else outcomes)}
                nullptraj = _ptraj.ConstantProbTrajectory(outcomes, means)
                self._probtrajectories[key]['null'] = nullptraj

                dictlabel = {}
                if 'dataset' in test:
                    dictlabel['dataset'] = dskey
                if 'circuit' in test:
                    dictlabel['circuit'] = circuit
                freqs = [0] + list(
                    self.instability_indices(dictlabel, detectorkey))
                times, streams = self._timeinfo[(dskey, circuit)]
                T = self._shape[3]
                times = times[:T]
                if len(freqs) > 1:
                    parameters = {
                        o: _sig.dct_amplitudes_at_frequencies(
                            freqs, streams.get(o, np.zeros(T))[:T])
                        for o in outcomes[:-1]}
                    starttime = times[0]
                    timestep = float(np.mean(np.diff(times))) \
                        if len(times) > 1 else 1.0
                    ptraj = _ptraj.CosineProbTrajectory(
                        outcomes, freqs, parameters, starttime=starttime,
                        timestep=timestep, numtimes=len(times))
                    ptraj, _ = _ptraj.amplitude_compression(ptraj, times)
                    self._probtrajectories[key][
                        (detectorkey, test, 'filter')] = ptraj
                    if estimator == 'mle':
                        clickstreams = {o: streams.get(o, np.zeros(T))[:T]
                                        for o in outcomes}
                        mle = _ptraj.maxlikelihood(ptraj, clickstreams,
                                                   times,
                                                   verbosity=verbosity - 1)
                        self._probtrajectories[key][
                            (detectorkey, test, 'mle')] = mle
                else:
                    self._probtrajectories[key][
                        (detectorkey, test, 'filter')] = nullptraj
                    self._probtrajectories[key][
                        (detectorkey, test, 'mle')] = nullptraj
        self.seconds['characterization'] = time.perf_counter() - t0

    def probability_trajectory_model(self, circuit, dskey=None,
                                     estimatekey=None, estimator=None):
        """The estimated ProbTrajectory for a circuit (reference:
        probability_trajectory_model:1846)."""
        dskey = dskey or self._dskeys[0]
        i = self._dskeys.index(dskey)
        j = self._circuits.index(circuit)
        estimatekey = estimatekey or self._def_probtrajectories
        assert estimatekey is not None, \
            "Run .run_instability_characterization() first!"
        if estimator is not None:
            estimatekey = (estimatekey[0], estimatekey[1], estimator)
        ptrajs = self._probtrajectories[(i, j)]
        return ptrajs.get(tuple(estimatekey), ptrajs['null'])

    def probability_trajectory(self, circuit, times, dskey=None,
                               estimatekey=None, estimator=None):
        """{outcome: p(t)} at the given times (reference:
        probability_trajectory:1903)."""
        ptraj = self.probability_trajectory_model(circuit, dskey,
                                                  estimatekey, estimator)
        return ptraj.probabilities(times)

    def maximum_tvd_bound(self, circuit, dskey=None, estimatekey=None,
                          estimator=None):
        """Half the summed absolute non-constant amplitudes: an upper bound
        on max_t TVD(p(t), p_mean) (reference: maximum_tvd_bound:1946)."""
        ptraj = self.probability_trajectory_model(circuit, dskey,
                                                  estimatekey, estimator)
        params = ptraj.parameters
        final_amps = np.zeros(len(ptraj.hyperparameters))
        summed = 0.0
        for o in params:
            final_amps = final_amps + np.asarray(params[o])
            summed += float(np.sum(np.abs(params[o][1:])))
        summed += float(np.sum(np.abs(final_amps[1:])))
        return 0.5 * summed

    def maxmax_tvd_bound(self, dskey=None, estimatekey=None, estimator=None):
        """maximum_tvd_bound maximized over circuits (reference:
        maxmax_tvd_bound:1990)."""
        return max(self.maximum_tvd_bound(c, dskey, estimatekey, estimator)
                   for c in self._circuits)

    # -- legacy accessors --------------------------------------------------------
    def drift_frequencies_hz(self, circuit):
        """Significant drift frequencies of a circuit in Hz."""
        modes = self.drift_frequencies.get((circuit,), []) or \
            [m for key, ms in self.drift_frequencies.items()
             if len(key) >= 1 and key[0] == circuit for m in ms]
        freqs = self.frequencies.get(circuit)
        if freqs is None:
            return []
        return [float(freqs[m]) for m in sorted(set(modes))
                if m < len(freqs)]

    def probability_trajectories(self, circuit, significance=None):
        """{outcome: p(t) array} DCT-model trajectory estimates for one
        circuit (reference: probtrajectory.py DCT-model estimation)."""
        dskey = self._dskeys[0]
        times, streams = self._timeinfo.get((dskey, circuit), (None, None))
        if streams is None:
            row = self.data[dskey][circuit]
            streams, times = _clickstreams(row)
            if streams is None:
                return {}
        outcomes = sorted(streams)
        indep = outcomes[:-1] if len(outcomes) > 1 else outcomes
        out = {}
        for o in indep:
            out[o] = self.estimate_probability_trajectory(
                streams[o], significance=significance or self.significance)
        return out

    @staticmethod
    def analyze_clickstream(bits, significance=0.05):
        """Analyze one 0/1 clickstream: returns (drift_detected,
        significant_mode_indices, spectrum)."""
        bits = np.asarray(bits)
        spectrum = _sig.dct_power_spectrum(bits)
        T = len(spectrum)
        thresh = _sig.power_significance_threshold(significance, T - 1)
        sig_modes = [k for k in range(1, T) if spectrum[k] > thresh]
        return (len(sig_modes) > 0), sig_modes, spectrum

    @staticmethod
    def estimate_probability_trajectory(bits, mode_indices=None,
                                        significance=0.05):
        """Estimate p(t) from a clickstream by keeping significant DCT
        modes (reference: probtrajectory.py DCT-model estimation)."""
        bits = np.asarray(bits, dtype=float)
        T = len(bits)
        pmean = np.mean(bits)
        if mode_indices is None:
            _, mode_indices, _ = StabilityAnalyzer.analyze_clickstream(
                bits, significance)
        from scipy.fft import dct as _dct
        z = bits - pmean
        modes = _dct(z, norm='ortho')
        traj = np.full(T, pmean)
        t = np.arange(T)
        for k in mode_indices:
            traj = traj + modes[k] * _sig.dct_basis_function(k, T, t)
        return np.clip(traj, 0, 1)
