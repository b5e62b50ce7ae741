"""Dataset consistency tests by log-likelihood ratios (counterpart of
pygsti_tpu/data/datacomparator.py).

Every circuit's counts in S datasets form one row of a [C, S, O] tensor
(O the most outcomes any circuit has, zero-padded); the per-circuit
statistic 2 (logL of separate distributions - logL of one pooled
distribution) is computed for all circuits at once on `device`.  The
p-values, the Bonferroni flags, the aggregate N_sigma and the largest
statistically significant TVD follow the JAX package.
"""

from __future__ import annotations

import collections

import numpy as np
import scipy.stats as stats
import torch

from pygsti_tpu_torch import DTYPE


def llr_statistics(counts, n_outcomes):
    """(2 LLR [C], dof [C]) of counts [C, S, O] (zero-padded) whose circuit
    c has n_outcomes[c] outcomes: asymptotically chi2 with (S - 1)(n - 1)
    degrees of freedom (at least 1)."""
    totals = counts.sum(dim=2, keepdim=True)                       # [C, S, 1]
    grand = counts.sum(dim=(1, 2))                                 # [C]
    pooled = counts.sum(dim=1) / torch.clamp(grand, min=1e-300)[:, None]   # [C, O]
    one = torch.ones((), dtype=counts.dtype, device=counts.device)
    p_sep = torch.where(totals > 0, counts / torch.where(totals > 0, totals, one), 0.0)
    observed = counts > 0
    ll_sep = torch.where(observed, counts * torch.log(torch.where(p_sep > 0, p_sep, one)),
                         0.0).sum(dim=(1, 2))
    ll_pool = torch.where(observed, counts * torch.log(
        torch.where(pooled > 0, pooled, one))[:, None, :], 0.0).sum(dim=(1, 2))
    dof = np.maximum((counts.shape[1] - 1) * (np.asarray(n_outcomes) - 1), 1)
    return 2 * (ll_sep - ll_pool), dof


class DataComparator(object):
    """Compare datasets (a list or a MultiDataSet) circuit by circuit for
    consistency: ``run`` fills ``llrs``, ``pVals`` and ``dof`` per circuit,
    ``inconsistent_circuits`` (Bonferroni over the circuits) and the
    aggregate test's ``aggregate_llr``, ``aggregate_pvalue`` and
    ``aggregate_nsigma``.  `circuits` 'all' takes the first dataset's
    circuits present in every dataset.  `op_exclusions`, `op_inclusions`,
    `ds_names` and `allow_bad_circuits` are accepted and not used, as in
    the JAX package."""

    def __init__(self, dataset_list_or_multidataset, circuits='all', op_exclusions=None,
                 op_inclusions=None, ds_names=None, allow_bad_circuits=False, device="cuda"):
        from pygsti_tpu_torch.data.multidataset import MultiDataSet
        if isinstance(dataset_list_or_multidataset, MultiDataSet):
            mds = dataset_list_or_multidataset
            self.datasets = [mds[k] for k in mds.keys()]
        else:
            self.datasets = list(dataset_list_or_multidataset)
        if circuits == 'all':
            circuits = [c for c in self.datasets[0].keys()
                        if all(c in ds for ds in self.datasets)]
        self.circuits = list(circuits)
        self.device = torch.device(device)
        self.llrs = collections.OrderedDict()
        self.pVals = collections.OrderedDict()
        self.dof = collections.OrderedDict()
        self._tested = False

    def _count_tensor(self):
        """(counts [C, S, O] on the device, outcomes per circuit [C])."""
        rows = [[ds[c].counts for ds in self.datasets] for c in self.circuits]
        outcomes = [sorted({o for r in rs for o in r}) for rs in rows]
        n_out = np.array([len(o) for o in outcomes], dtype=np.int64)
        mat = np.zeros((len(rows), len(self.datasets), max(n_out.max(initial=0), 1)))
        for i, (rs, outs) in enumerate(zip(rows, outcomes)):
            for s, r in enumerate(rs):
                mat[i, s, :len(outs)] = [r.get(o, 0) for o in outs]
        return torch.as_tensor(mat, dtype=DTYPE, device=self.device), n_out

    def run(self, significance=0.05, per_circuit_correction='Bonferroni', verbosity=1):
        """Run the consistency tests; returns self."""
        self._counts, n_out = self._count_tensor()
        llr, dof = llr_statistics(self._counts, n_out)
        llr = llr.cpu().numpy()
        pvals = stats.chi2.sf(llr, dof)
        for c, l, k, p in zip(self.circuits, llr, dof, pvals):
            self.llrs[c] = float(l)
            self.dof[c] = int(k)
            self.pVals[c] = float(p)
        self.significance = significance
        threshold = significance / max(len(self.circuits), 1)
        self.inconsistent_circuits = [c for c, p in self.pVals.items() if p < threshold]
        self._flagged = np.array([p < threshold for p in pvals], dtype=bool)
        total_llr = sum(self.llrs.values())
        total_dof = sum(self.dof.values())
        self.aggregate_llr = total_llr
        self.aggregate_pvalue = stats.chi2.sf(total_llr, max(total_dof, 1))
        self.aggregate_nsigma = (total_llr - total_dof) / np.sqrt(2 * max(total_dof, 1))
        self._tested = True
        return self

    def get_maximum_sstvd(self):
        """The largest TVD between two datasets' frequencies over the
        inconsistent circuits (0 when there are none)."""
        if not self._tested:
            raise ValueError("run the comparison first")
        if not self._flagged.any():
            return 0.0
        m = self._counts[torch.as_tensor(self._flagged, device=self.device)]   # [F, S, O]
        f = m / m.sum(dim=2, keepdim=True)
        tvd = 0.5 * (f[:, :, None, :] - f[:, None, :, :]).abs().sum(dim=3)    # [F, S, S]
        return float(tvd.max())

    def __str__(self):
        if not self._tested:
            return "DataComparator (not yet run)"
        return ("DataComparator: %d/%d circuits inconsistent at %g significance; "
                "aggregate Nsigma = %.2f" % (len(self.inconsistent_circuits),
                                             len(self.circuits), self.significance,
                                             self.aggregate_nsigma))
