"""Volumetric-benchmark designs and summary statistics (counterpart of
pygsti_tpu/protocols/vb.py).  Host numpy: the designs draw from a numpy
RandomState in the JAX package's order, and the statistics are a few
numbers per circuit; the data they read are simulated on the card
(data/datasetconstruction.simulate_data).  Results are held in a
ColumnTable; ``to_dataframe()`` is its pandas frame where pandas is
installed."""

from __future__ import annotations

import collections

import numpy as np

from pygsti_tpu_torch.protocols.protocol import ExperimentDesign, Protocol, ProtocolResults
from pygsti_tpu_torch.protocols.rb import BenchmarkingDesign


class ByDepthDesign(ExperimentDesign):
    """Circuits organized by depth (reference: vb.py:22)."""

    def __init__(self, depths, circuit_lists, qubit_labels=None, remove_duplicates=True):
        self.depths = list(depths)
        self.circuit_lists = circuit_lists
        all_circuits = [c for cl in circuit_lists for c in cl]
        super().__init__(all_circuits, qubit_labels)


def hamming_distance_counts(counts_dict, ideal_bits):
    """Histogram of Hamming distances of observed outcomes from the ideal."""
    n = len(ideal_bits)
    out = np.zeros(n + 1)
    ideal = "".join(str(b) for b in ideal_bits)
    for outcome, cnt in counts_dict.items():
        bits = outcome[0] if isinstance(outcome, tuple) else outcome
        hd = sum(1 for a, b in zip(bits, ideal) if a != b)
        out[hd] += cnt
    return out


def polarization(success_prob, n):
    """Success probability -> polarization: (p - 1/2^n) / (1 - 1/2^n)."""
    base = 1.0 / 2 ** n
    return (success_prob - base) / (1 - base)


class SummaryStatistics(Protocol):
    """Compute per-circuit success probabilities / Hamming distributions
    (reference: vb.py:544)."""

    summary_statistics = ('success_counts', 'total_counts', 'hamming_distance_counts',
                          'success_probabilities', 'polarization',
                          'adjusted_success_probabilities')

    def __init__(self, name=None):
        super().__init__(name)

    def _compute_summary(self, data):
        design = data.edesign
        ds = data.dataset
        # any design with ideal outcomes by depth: a BenchmarkingDesign or a
        # PeriodicMirrorCircuitDesign (the JAX package refuses the latter)
        assert isinstance(design, BenchmarkingDesign) or hasattr(design, 'idealout_lists'), \
            "SummaryStatistics requires a design with ideal outcomes (idealout_lists)"
        n = len(design.qubit_labels) if design.qubit_labels else \
            len(design.circuit_lists[0][0].line_labels)

        stats = {k: collections.OrderedDict() for k in
                 ('success_counts', 'total_counts', 'success_probabilities',
                  'polarization', 'hamming_distance_counts',
                  'adjusted_success_probabilities')}
        for depth, circs, ideals in zip(design.depths, design.circuit_lists,
                                        design.idealout_lists):
            for key in stats:
                stats[key][depth] = []
            for c, ideal in zip(circs, ideals):
                row = ds[c]
                total = row.total
                ideal_str = "".join(str(b) for b in ideal)
                sc = row.counts.get((ideal_str,), 0)
                sp = sc / total if total > 0 else np.nan
                hdc = hamming_distance_counts(row.counts, ideal)
                # adjusted SP: sum_k (-1/2)^k h_k / N (reference: vb.py asps)
                asp = float(np.sum([(-0.5) ** k * hdc[k] for k in range(len(hdc))]) / total) \
                    if total > 0 else np.nan
                stats['success_counts'][depth].append(sc)
                stats['total_counts'][depth].append(total)
                stats['success_probabilities'][depth].append(sp)
                stats['polarization'][depth].append(polarization(sp, n))
                stats['hamming_distance_counts'][depth].append(hdc.tolist())
                stats['adjusted_success_probabilities'][depth].append(asp)
        return stats


class ByDepthSummaryStatistics(SummaryStatistics):
    """SummaryStatistics run and packaged per-depth (reference: vb.py:959)."""

    def __init__(self, depths='all', statistics_to_compute=('polarization',),
                 names_to_compute=None, name=None):
        super().__init__(name)
        self.depths = depths
        self.statistics_to_compute = statistics_to_compute

    def run(self, data, memlimit=None, comm=None):
        stats = self._compute_summary(data)
        return SummaryStatisticsResults(data, self, stats)


class SummaryStatisticsResults(ProtocolResults):
    def __init__(self, data, protocol_instance, statistics):
        super().__init__(data, protocol_instance)
        self.statistics = statistics

    def to_table(self):
        """One row per circuit: Depth, CircuitIndex, SuccessProbability,
        Polarization, as a ColumnTable."""
        from pygsti_tpu_torch.tools.dataframetools import ColumnTable
        rows = []
        sp = self.statistics['success_probabilities']
        for depth, vals in sp.items():
            for i, v in enumerate(vals):
                rows.append({'Depth': depth, 'CircuitIndex': i,
                             'SuccessProbability': v,
                             'Polarization': self.statistics['polarization'][depth][i]})
        return ColumnTable.from_rows(rows)

    def to_dataframe(self):
        """to_table() as a pandas frame (ImportError without pandas)."""
        return self.to_table().to_dataframe()


class PeriodicMirrorCircuitDesign(ByDepthDesign):
    """Periodic mirror-circuit benchmarking design: the core layers cycle
    through a fixed 'germ' layer sequence instead of being random, with
    random 1Q-Clifford caps and Pauli randomization as in mirror RB
    (reference: vb.py:328 PeriodicMirrorCircuitDesign)."""

    def __init__(self, pspec, depths, circuits_per_depth, germ_circuit,
                 qubit_labels=None, localclifford=True, paulirandomize=True,
                 seed=None):
        from pygsti_tpu_torch.algorithms import randomcircuit as _rc
        qubit_labels = tuple(qubit_labels) if qubit_labels is not None \
            else tuple(pspec.qubit_labels)
        rng = np.random.RandomState(seed)
        fixed_layers = [germ_circuit.layertup[i]
                        for i in range(germ_circuit.depth)]
        circuit_lists, idealout_lists = [], []
        for d in depths:
            circs, ideals = [], []
            for _ in range(circuits_per_depth):
                c, ideal = _rc.create_mirror_rb_circuit(
                    pspec, None, d, qubit_labels,
                    localclifford=localclifford, paulirandomize=paulirandomize,
                    rand_state=rng, fixed_layers=fixed_layers)
                circs.append(c)
                ideals.append(ideal)
            circuit_lists.append(circs)
            idealout_lists.append(ideals)
        all_circs = [c for cl in circuit_lists for c in cl]
        ExperimentDesign.__init__(self, all_circs, qubit_labels)
        self.depths = list(depths)
        self.circuit_lists = circuit_lists
        self.idealout_lists = idealout_lists
        self.circuits_per_depth = circuits_per_depth
        self.germ_circuit = germ_circuit
