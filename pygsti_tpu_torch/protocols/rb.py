"""Randomized benchmarking protocols (reference: pygsti/protocols/rb.py)."""

from __future__ import annotations

import collections

import numpy as np

from pygsti_tpu_torch.baseobjs.verbosityprinter import VerbosityPrinter
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.protocols.protocol import ExperimentDesign, Protocol, ProtocolResults
from pygsti_tpu_torch.algorithms import randomcircuit as _rc
from pygsti_tpu_torch.algorithms import rbfit as _rbfit
from pygsti_tpu_torch.algorithms.compilers import CompilationRules


class BenchmarkingDesign(ExperimentDesign):
    """Design with per-circuit ideal outcomes (reference: vb.py:122)."""

    def __init__(self, depths, circuit_lists, idealout_lists, qubit_labels=None):
        self.depths = list(depths)
        self.circuit_lists = circuit_lists
        self.idealout_lists = idealout_lists
        all_circuits = [c for cl in circuit_lists for c in cl]
        super().__init__(all_circuits, qubit_labels)


class CliffordRBDesign(BenchmarkingDesign):
    """Clifford RB experiment design (reference: rb.py:24)."""

    def __init__(self, pspec, clifford_compilations=None, depths=(0, 1, 2, 4),
                 circuits_per_depth=10, qubit_labels=None, randomizeout=False,
                 citerations=20, seed=None, verbosity=0, interleaved_circuit=None):
        qubit_labels = tuple(qubit_labels) if qubit_labels is not None \
            else tuple(pspec.qubit_labels)
        rng = np.random.RandomState(seed)
        rules = clifford_compilations if isinstance(clifford_compilations, CompilationRules) \
            else CompilationRules(pspec)
        circuit_lists, idealout_lists = [], []
        for d in depths:
            circs, ideals = [], []
            for _ in range(circuits_per_depth):
                c, ideal = _rc.create_clifford_rb_circuit(
                    pspec, rules, d, qubit_labels, randomizeout, citerations,
                    rand_state=rng, interleaved_circuit=interleaved_circuit)
                circs.append(c)
                ideals.append(ideal)
            circuit_lists.append(circs)
            idealout_lists.append(ideals)
        super().__init__(list(depths), circuit_lists, idealout_lists, qubit_labels)
        self.circuits_per_depth = circuits_per_depth
        self.randomizeout = randomizeout
        self.interleaved_circuit = interleaved_circuit


class DirectRBDesign(BenchmarkingDesign):
    """Direct RB experiment design (reference: rb.py:388)."""

    def __init__(self, pspec, clifford_compilations=None, depths=(0, 2, 4, 8),
                 circuits_per_depth=10, qubit_labels=None, sampler='edgegrab',
                 samplerargs=None, randomizeout=False, seed=None, verbosity=0):
        qubit_labels = tuple(qubit_labels) if qubit_labels is not None \
            else tuple(pspec.qubit_labels)
        rng = np.random.RandomState(seed)
        rules = clifford_compilations if isinstance(clifford_compilations, CompilationRules) \
            else CompilationRules(pspec)
        circuit_lists, idealout_lists = [], []
        for d in depths:
            circs, ideals = [], []
            for _ in range(circuits_per_depth):
                c, ideal = _rc.create_direct_rb_circuit(
                    pspec, rules, d, qubit_labels, sampler, samplerargs,
                    randomizeout=randomizeout, rand_state=rng)
                circs.append(c)
                ideals.append(ideal)
            circuit_lists.append(circs)
            idealout_lists.append(ideals)
        super().__init__(list(depths), circuit_lists, idealout_lists, qubit_labels)
        self.circuits_per_depth = circuits_per_depth
        self.randomizeout = randomizeout


class MirrorRBDesign(BenchmarkingDesign):
    """Mirror RB experiment design (reference: rb.py:734)."""

    def __init__(self, pspec, depths=(0, 2, 4, 8), circuits_per_depth=10,
                 qubit_labels=None, sampler='edgegrab', samplerargs=None,
                 localclifford=True, paulirandomize=True, seed=None, verbosity=0):
        qubit_labels = tuple(qubit_labels) if qubit_labels is not None \
            else tuple(pspec.qubit_labels)
        rng = np.random.RandomState(seed)
        circuit_lists, idealout_lists = [], []
        for d in depths:
            circs, ideals = [], []
            for _ in range(circuits_per_depth):
                c, ideal = _rc.create_mirror_rb_circuit(
                    pspec, None, d, qubit_labels, sampler, samplerargs,
                    localclifford, paulirandomize, rand_state=rng)
                circs.append(c)
                ideals.append(ideal)
            circuit_lists.append(circs)
            idealout_lists.append(ideals)
        super().__init__(list(depths), circuit_lists, idealout_lists, qubit_labels)
        self.circuits_per_depth = circuits_per_depth


class RandomizedBenchmarking(Protocol):
    """Fit RB data to A + B p^m (reference: rb.py:1335)."""

    def __init__(self, datatype='success_probabilities', defaultfit='full',
                 asymptote='std', rtype='EI', seed=(0.8, 0.95), bootstrap_samples=200,
                 depths='all', square_mean_root=False, verbosity=1, name=None):
        super().__init__(name)
        self.datatype = datatype
        self.defaultfit = defaultfit
        self.asymptote = asymptote
        self.rtype = rtype
        self.bootstrap_samples = bootstrap_samples
        self.depths = depths
        self.verbosity = verbosity

    def run(self, data, memlimit=None, comm=None):
        design = data.edesign
        ds = data.dataset
        n = len(design.qubit_labels) if design.qubit_labels else \
            len(design.circuit_lists[0][0].line_labels)
        asymptote = 1.0 / 2 ** n if self.asymptote == 'std' else self.asymptote

        if self.datatype == 'energies':
            asymptote = 0.0 if self.asymptote == 'std' else self.asymptote

        depths, asps = [], []
        success_probs_by_depth = {}
        for d, circs, ideals in zip(design.depths, design.circuit_lists,
                                    design.idealout_lists):
            sps = []
            for c, ideal in zip(circs, ideals):
                row = ds[c]
                total = row.total
                if self.datatype == 'energies':
                    meas, sign = ideal
                    sps.append(_pauli_energy(dict(row.counts), meas, sign, n))
                else:
                    ideal_str = "".join(str(b) for b in ideal)
                    cnt = row.counts.get((ideal_str,), 0)
                    sps.append(cnt / total if total > 0 else np.nan)
            sps = [s for s in sps if not np.isnan(s)]
            if sps:
                depths.append(d)
                asps.append(np.mean(sps))
                success_probs_by_depth[d] = sps

        fit_full = _rbfit.std_least_squares_fit(depths, asps, n, asymptote=None,
                                                ftype='full', rtype=self.rtype)
        fit_fa = _rbfit.std_least_squares_fit(depths, asps, n, asymptote=asymptote,
                                              ftype='FA', rtype=self.rtype)

        # bootstrap error bars
        bootstraps_full = []
        if self.bootstrap_samples > 0:
            rng = np.random.RandomState(0)
            for _ in range(self.bootstrap_samples):
                bs_asps = []
                for d in depths:
                    sps = success_probs_by_depth[d]
                    resampled = [sps[rng.randint(len(sps))] for _ in sps]
                    bs_asps.append(np.mean(resampled))
                bf = _rbfit.std_least_squares_fit(depths, bs_asps, n, asymptote=None,
                                                  ftype='full', rtype=self.rtype)
                if bf['success']:
                    bootstraps_full.append(bf['estimates']['r'])

        return RandomizedBenchmarkingResults(
            data, self, {'full': fit_full, 'A-fixed': fit_fa},
            depths, asps, success_probs_by_depth,
            bootstraps={'full': bootstraps_full}, rtype=self.rtype)


class RandomizedBenchmarkingResults(ProtocolResults):
    """RB fit results (reference: rb.py:1536)."""

    def __init__(self, data, protocol_instance, fits, depths, asps,
                 success_probs_by_depth, bootstraps=None, rtype='EI'):
        super().__init__(data, protocol_instance)
        self.fits = fits
        self.depths = depths
        self.asps = asps
        self.success_probs_by_depth = success_probs_by_depth
        self.bootstraps = bootstraps or {}
        self.rtype = rtype

    @property
    def r(self):
        """The RB error rate (from the 'full' fit)."""
        return self.fits['full']['estimates']['r']

    @property
    def r_std(self):
        bs = self.bootstraps.get('full')
        return float(np.std(bs)) if bs else None

    def __str__(self):
        s = "RB results: r = %.3e" % self.r
        if self.r_std is not None:
            s += " +/- %.1e" % self.r_std
        s += " (p=%.5f)" % self.fits['full']['estimates']['p']
        return s


class InterleavedRBDesign(ExperimentDesign):
    """Interleaved RB: paired standard ('crb') + interleaved ('icrb')
    Clifford RB designs (reference: rb.py:1158)."""

    def __init__(self, pspec, interleaved_circuit, depths, circuits_per_depth,
                 qubit_labels=None, randomizeout=False, citerations=20,
                 seed=None):
        crb = CliffordRBDesign(pspec, None, depths, circuits_per_depth,
                               qubit_labels, randomizeout, citerations,
                               seed=seed)
        # same seed as 'crb': identical random Cliffords in both
        # sub-experiments, so the p_icrb/p_crb ratio isolates the
        # interleaved gate's error (variance reduction)
        icrb = CliffordRBDesign(pspec, None, depths, circuits_per_depth,
                                qubit_labels, randomizeout, citerations,
                                seed=seed,
                                interleaved_circuit=interleaved_circuit)
        children = {'crb': crb, 'icrb': icrb}
        super().__init__(None, qubit_labels, children)
        self.interleaved_circuit = interleaved_circuit
        self.depths = list(depths)


class BinaryRBDesign(BenchmarkingDesign):
    """Binary RB (BiRB) experiment design (reference: rb.py:1024).

    idealouts are (meas_pauli_string, sign) pairs; the fitted statistic is
    the (sign-corrected) expectation of the measured Z-type Pauli, analyzed
    with datatype='energies'.
    """

    def __init__(self, pspec, clifford_compilations=None, depths=(0, 2, 4),
                 circuits_per_depth=10, qubit_labels=None,
                 layer_sampling='mixed1q2q', sampler='edgegrab',
                 samplerargs=None, addlocal=False, lsargs=None, seed=None,
                 verbosity=0):
        qubit_labels = tuple(qubit_labels) if qubit_labels is not None \
            else tuple(pspec.qubit_labels)
        seed0 = seed if seed is not None else np.random.RandomState().randint(2 ** 20)
        circuit_lists, idealout_lists = [], []
        k = 0
        for d in depths:
            circs, ideals = [], []
            for _ in range(circuits_per_depth):
                c, meas, sign = _rc.create_binary_rb_circuit(
                    pspec, clifford_compilations, d, qubit_labels,
                    layer_sampling, sampler, samplerargs, addlocal, lsargs,
                    seed=seed0 + k)
                k += 1
                circs.append(c)
                ideals.append((meas, sign))
            circuit_lists.append(circs)
            idealout_lists.append(ideals)
        super().__init__(list(depths), circuit_lists, idealout_lists,
                         qubit_labels)
        self.circuits_per_depth = circuits_per_depth
        self.layer_sampling = layer_sampling


def _pauli_energy(counts, meas, sign, n):
    """Sign-corrected expectation of the Z-type Pauli `meas` from counts."""
    support = [i for i, ch in enumerate(meas) if ch == 'Z']
    total = sum(counts.values())
    if total == 0:
        return np.nan
    e = 0.0
    for outcome, cnt in counts.items():
        bits = outcome[-1] if isinstance(outcome, tuple) else outcome
        par = (-1) ** sum(int(bits[i]) for i in support)
        e += par * cnt
    return sign * e / total


class InterleavedRandomizedBenchmarking(Protocol):
    """Interleaved RB analysis: runs standard RB on the 'crb' and 'icrb'
    sub-experiments and reports the IRB number with Magesan-style bounds
    (reference: rb.py:1685)."""

    def __init__(self, defaultfit='full', asymptote='std', rtype='EI',
                 seed=(0.8, 0.95), bootstrap_samples=200, depths='all',
                 name=None):
        super().__init__(name)
        self.defaultfit = defaultfit
        self.asymptote = asymptote
        self.rtype = rtype
        self.seed = seed
        self.bootstrap_samples = bootstrap_samples
        self.depths = depths

    def run(self, data, memlimit=None, comm=None):
        design = data.edesign
        assert isinstance(design, InterleavedRBDesign), \
            "This protocol requires an InterleavedRBDesign"
        rb = RandomizedBenchmarking('success_probabilities', self.defaultfit,
                                    self.asymptote, self.rtype, self.seed,
                                    self.bootstrap_samples, self.depths)
        crb_results = rb.run(data['crb'])
        icrb_results = rb.run(data['icrb'])

        nq = len(design.qubit_labels) if design.qubit_labels else 1
        dim = 2 ** nq
        if self.rtype == 'EI':
            pref = (dim ** 2 - 1) / dim ** 2
        elif self.rtype == 'AGI':
            pref = (dim - 1) / dim
        else:
            raise ValueError("rtype must be 'EI' or 'AGI'")

        irb_numbers, irb_bounds = {}, {}
        for key in crb_results.fits:
            p_c = crb_results.fits[key]['estimates']['p']
            p_i = icrb_results.fits[key]['estimates']['p']
            irb_numbers[key] = pref * (1 - p_i / p_c)
            b1 = pref * (abs(p_c - p_i / p_c) + (1 - p_c))
            b2 = (2 * (dim ** 2 - 1) * (1 - p_c)) / (p_c * dim ** 2) \
                + (4 * np.sqrt(1 - p_c) * np.sqrt(dim ** 2 - 1)) / p_c
            if self.rtype == 'EI':
                b2 *= dim / (dim + 1)  # AGI -> EI units
            irb_bounds[key] = min(b1, b2)

        return InterleavedRandomizedBenchmarkingResults(
            data, self, crb_results, icrb_results, irb_numbers, irb_bounds)


class InterleavedRandomizedBenchmarkingResults(ProtocolResults):
    """IRB results: per-fit interleaved gate error estimates + bounds
    (reference: rb.py:1807)."""

    def __init__(self, data, protocol_instance, crb_results, icrb_results,
                 irb_numbers, irb_bounds):
        super().__init__(data, protocol_instance)
        self.crb_results = crb_results
        self.icrb_results = icrb_results
        self.irb_numbers = irb_numbers
        self.irb_bounds = irb_bounds

    def __str__(self):
        return "Interleaved RB: " + ", ".join(
            "%s: %.3e (bound %.2e)" % (k, v, self.irb_bounds[k])
            for k, v in self.irb_numbers.items())


# reference shorthand aliases (reference: rb.py:1826-1827)
RB = RandomizedBenchmarking
RBResults = RandomizedBenchmarkingResults
