"""Volumetric-benchmarking analysis (counterpart of
pygsti_tpu/protocols/vbdataframe.py; arXiv:2008.11294).

Aggregates per-circuit benchmarking metrics (success probability,
polarization) on a (depth, width) grid and computes capability regions.
The data lie in a ColumnTable (tools/dataframetools.py), so no pandas is
needed; ``VBDataFrame.dataframe`` gives the pandas frame where pandas is
installed.  Host numpy: a few numbers per circuit.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import chi2 as _chi2

from pygsti_tpu_torch.tools.dataframetools import ColumnTable


def _calculate_summary_statistic(x, statistic, lower_cutoff=None):
    """statistic(x), floored at lower_cutoff (reference: vbdataframe.py:41)."""
    x = np.asarray(list(x), float)
    if len(x) == 0 or np.all(np.isnan(x)):
        return np.nan
    if statistic == 'mean':
        v = np.nanmean(x)
    elif statistic in ('max', 'monotonic_max'):
        v = np.nanmax(x)
    elif statistic in ('min', 'monotonic_min'):
        v = np.nanmin(x)
    elif statistic == 'min_w_nan':
        v = np.min(x)
    else:
        raise ValueError("%s is an unknown statistic!" % statistic)
    return v if lower_cutoff is None else max(v, lower_cutoff)


def classify_circuit_shape(success_probabilities, total_counts, threshold,
                           significance=0.05):
    """Capability-region classification: 2=success, 1=indeterminate, 0=fail
    via Benjamini-Hochberg LLR hypothesis tests (reference:
    vbdataframe.py:60; arXiv:2008.11294 Supplement 8.B.5)."""

    def p_val(p, total, direction):
        p = max(p, 1e-10)
        if direction == 'above' and p >= threshold:
            return 1
        if direction == 'below' and p <= threshold:
            return 1
        s = p * total
        llr = -2 * s * (np.log(threshold) - np.log(p))
        llr += -2 * (total - s) * (np.log(1 - threshold) - np.log(1 - p))
        return 1 - _chi2.cdf(llr, 1)

    pvals_above = sorted(p_val(p, c, 'above')
                         for p, c in zip(success_probabilities, total_counts)
                         if c > 0)
    pvals_below = sorted(p_val(p, c, 'below')
                         for p, c in zip(success_probabilities, total_counts)
                         if c > 0)
    m = len(pvals_above)
    if m == 0:
        return 0
    reject_all_above = any(p < significance * (k + 1) / m
                           for k, p in enumerate(pvals_above))
    reject_all_below = any(p < significance * (k + 1) / m
                           for k, p in enumerate(pvals_below))
    if reject_all_below and not reject_all_above:
        return 2
    if reject_all_above and not reject_all_below:
        return 0
    if reject_all_above and reject_all_below:
        return 1
    below_score = threshold - np.nanmin(success_probabilities)
    above_score = np.nanmax(success_probabilities) - threshold
    return 2 if above_score > below_score else 0


class VBDataFrame(object):
    """Volumetric benchmarking data with (x, y)-grid summaries (reference:
    vbdataframe.py:161).  `table` is a ColumnTable (a pandas frame is read
    into one)."""

    def __init__(self, table, x_axis='Depth', y_axis='Width', x_values=None,
                 y_values=None, edesign=None):
        self.table = table if isinstance(table, ColumnTable) else ColumnTable.from_dataframe(table)
        self.x_axis = x_axis
        self.y_axis = y_axis
        self.edesign = edesign
        self.x_values = sorted(set(self.table[x_axis])) if x_values is None \
            else list(x_values)
        self.y_values = sorted(set(self.table[y_axis])) if y_values is None \
            else list(y_values)

    @property
    def dataframe(self):
        """The table as a pandas frame (ImportError without pandas)."""
        return self.table.to_dataframe()

    @classmethod
    def from_benchmarking_data(cls, data_by_circuit, x_axis='Depth',
                               y_axis='Width'):
        """Build from a list of per-circuit dicts with at least the x/y axis
        columns and metric columns."""
        return cls(ColumnTable.from_rows(data_by_circuit), x_axis, y_axis)

    def _like(self, table):
        return VBDataFrame(table, self.x_axis, self.y_axis, self.x_values,
                           self.y_values, self.edesign)

    def select_column_value(self, column_label, column_value):
        """New VBDataFrame restricted to rows where column == value
        (reference: vbdataframe.py:388)."""
        return self._like(self.table.rows(self.table[column_label] == column_value))

    def filter_data(self, column_label, metric='polarization', statistic='mean',
                    indep_x=True, threshold=1 / np.e, verbosity=0):
        """Keep, for each x (or globally), the column value whose aggregated
        metric is best (reference: vbdataframe.py:411, simplified scoring:
        larger summed aggregate wins)."""
        t = self.table
        values = sorted(set(t[column_label]))
        if indep_x:
            keep = []
            for x in self.x_values:
                best_val, best_score = None, -np.inf
                for v in values:
                    sub = t.rows((t[self.x_axis] == x) & (t[column_label] == v))
                    if len(sub) == 0:
                        continue
                    score = _calculate_summary_statistic(sub[metric], statistic)
                    if not np.isnan(score) and score > best_score:
                        best_val, best_score = v, score
                if best_val is not None:
                    keep.append(t.rows((t[self.x_axis] == x) & (t[column_label] == best_val)))
            return self._like(ColumnTable.concat(keep, like=t))
        best_val, best_score = None, -np.inf
        for v in values:
            score = _calculate_summary_statistic(t.rows(t[column_label] == v)[metric], statistic)
            if not np.isnan(score) and score > best_score:
                best_val, best_score = v, score
        return self._like(t.rows(t[column_label] == best_val))

    def vb_data(self, metric='polarization', statistic='mean', lower_cutoff=0.,
                no_data_action='discard'):
        """{(x, y): aggregated metric} (reference: vbdataframe.py:528)."""
        assert no_data_action in ('discard', 'nan', 'min')
        vb = {}
        t = self.table
        xs, ys = t[self.x_axis], t[self.y_axis]
        for x in self.x_values:
            for y in self.y_values:
                if statistic == 'monotonic_min':
                    mask = (xs <= x) & (ys <= y)
                elif statistic == 'monotonic_max':
                    mask = (xs >= x) & (ys >= y)
                else:
                    mask = (xs == x) & (ys == y)
                vals = np.asarray(t[metric][mask], float)
                if len(vals) == 0 or np.all(np.isnan(vals)):
                    if no_data_action == 'min':
                        vb[x, y] = lower_cutoff
                    elif no_data_action == 'nan':
                        vb[x, y] = np.nan
                else:
                    vb[x, y] = _calculate_summary_statistic(
                        vals, statistic, lower_cutoff=lower_cutoff)
        return vb

    def capability_regions(self, metric='polarization', threshold=1 / np.e,
                           significance=0.05, monotonic=True, nan_data_action='discard'):
        """{(x, y): 0|1|2} capability classification
        (reference: vbdataframe.py:594)."""
        regions = {}
        t = self.table
        for x in self.x_values:
            for y in self.y_values:
                sub = t.rows((t[self.x_axis] == x) & (t[self.y_axis] == y))
                if len(sub) == 0:
                    continue
                sps = list(sub[metric])
                totals = list(sub['total_counts']) if 'total_counts' in sub \
                    else [1000] * len(sps)
                regions[x, y] = classify_circuit_shape(sps, totals, threshold,
                                                       significance)
        if monotonic:
            # capability cannot increase with larger x (depth) or y (width)
            for (x, y) in sorted(regions.keys()):
                for (x2, y2), v2 in regions.items():
                    if x2 >= x and y2 >= y and (x2, y2) != (x, y):
                        regions[x2, y2] = min(regions[x2, y2], regions[x, y])
        return regions
