"""MultiDataSet: several datasets over one circuit index (counterpart of
pygsti_tpu/data/multidataset.py); ``io.read_multidataset`` returns one."""

from __future__ import annotations

import collections

from pygsti_tpu_torch.data.dataset import DataSet


class MultiDataSet(object):
    """An ordered dict of named DataSets over a common set of circuits."""

    def __init__(self, outcome_labels=None):
        self._datasets = collections.OrderedDict()
        self._outcome_labels = outcome_labels

    def add_dataset(self, name, dataset):
        if self._datasets:
            first = next(iter(self._datasets.values()))
            if set(first.keys()) != set(dataset.keys()):
                raise ValueError("All datasets in a MultiDataSet must share circuits")
        self._datasets[name] = dataset

    def __getitem__(self, name):
        return self._datasets[name]

    def __setitem__(self, name, ds):
        self.add_dataset(name, ds)

    def __contains__(self, name):
        return name in self._datasets

    def __len__(self):
        return len(self._datasets)

    def keys(self):
        return list(self._datasets.keys())

    def items(self):
        return self._datasets.items()

    def datasets_aggregate(self):
        """One DataSet of the counts summed over the member datasets."""
        out = DataSet()
        for ds in self._datasets.values():
            for c in ds:
                out.add_count_dict(c, dict(ds[c].counts))
        return out
