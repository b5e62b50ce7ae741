"""Multiple-hypothesis testing with family-wise error control (counterpart
of pygsti_tpu/data/hypothesistest.py).

Weighted Holm step-down over a list of hypotheses, where a tuple element
is a nested set that shares one significance budget: its representative
p-value is the Bonferroni-corrected least of its members', and once it is
rejected its budget is spent on the members by Holm's or Bonferroni's
procedure.  Host Python: a test holds a handful of p-values.
"""

from __future__ import annotations


class HypothesisTest(object):
    """Null hypotheses and a correction procedure: ``add_pvalues`` then
    ``run``, which fills ``hypothesis_rejected`` and
    ``pvalue_pseudothreshold``.  `weighting` 'equal' or {hypothesis:
    weight} (normalized); `local_corrections` 'Holms' or 'Bonferroni' within
    a nested set."""

    def __init__(self, hypotheses, significance=0.05, weighting='equal',
                 passing_graph='Holms', local_corrections='Holms'):
        self.hypotheses = list(hypotheses)
        self.significance = significance
        self.passing_graph = passing_graph
        self.local_corrections = local_corrections
        self.nested_hypotheses = {h: isinstance(h, tuple) for h in self.hypotheses}
        if weighting == 'equal':
            self.weighting = {h: 1.0 / len(self.hypotheses) for h in self.hypotheses}
        else:
            total = sum(weighting[h] for h in self.hypotheses)
            self.weighting = {h: weighting[h] / total for h in self.hypotheses}
        self.pvalues = None
        self.hypothesis_rejected = None
        self.pvalue_pseudothreshold = None

    def add_pvalues(self, pvalues):
        """{hypothesis: p} over every non-nested hypothesis and every
        member of a nested set."""
        self.pvalues = dict(pvalues)

    def _holm_within(self, labels, budget):
        """Unweighted Holm step-down within `labels` on `budget`: (rejected,
        {label: its largest threshold})."""
        rejected = set()
        thresholds = {l: 0.0 for l in labels}
        remaining = list(labels)
        while remaining:
            local = budget / len(remaining)
            progressed = False
            for l in list(remaining):
                thresholds[l] = max(thresholds[l], local)
                if self.pvalues[l] <= local:
                    rejected.add(l)
                    remaining.remove(l)
                    progressed = True
            if not progressed:
                break
        return rejected, thresholds

    def _bonferroni_within(self, labels, budget):
        thr = budget / len(labels)
        return {l for l in labels if self.pvalues[l] <= thr}, {l: thr for l in labels}

    def run(self):
        """Fill and return ``hypothesis_rejected`` ({hypothesis or nested
        member: bool})."""
        if self.pvalues is None:
            raise ValueError("add_pvalues first")
        self.hypothesis_rejected = {}
        self.pvalue_pseudothreshold = {}

        def top_pvalue(h):
            if self.nested_hypotheses[h]:
                return min(1.0, min(self.pvalues[m] for m in h) * len(h))
            return self.pvalues[h]

        remaining = list(self.hypotheses)
        budgets = {h: self.significance * self.weighting[h] for h in self.hypotheses}
        rejected_top = set()
        while remaining:
            total_w = sum(self.weighting[h] for h in remaining)
            progressed = False
            for h in list(remaining):
                local = self.significance * self.weighting[h] / total_w
                self.pvalue_pseudothreshold[h] = max(self.pvalue_pseudothreshold.get(h, 0.0),
                                                     local)
                if top_pvalue(h) <= local:
                    rejected_top.add(h)
                    remaining.remove(h)
                    budgets[h] = local
                    progressed = True
            if not progressed:
                break

        for h in self.hypotheses:
            if not self.nested_hypotheses[h]:
                self.hypothesis_rejected[h] = h in rejected_top
                continue
            members = list(h)
            if h not in rejected_top:
                rej, thr = set(), {m: 0.0 for m in members}
            elif self.local_corrections == 'Bonferroni':
                rej, thr = self._bonferroni_within(members, budgets[h])
            else:
                rej, thr = self._holm_within(members, budgets[h])
            for m in members:
                self.hypothesis_rejected[m] = m in rej
                self.pvalue_pseudothreshold[m] = thr[m]
        return self.hypothesis_rejected
