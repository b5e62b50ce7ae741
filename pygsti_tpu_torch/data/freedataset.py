"""FreeformDataSet: circuits -> arbitrary per-circuit data dicts
(counterpart of pygsti_tpu/data/freedataset.py), host Python."""

from __future__ import annotations

import collections

from pygsti_tpu_torch.circuits.circuit import Circuit


class FreeformDataSet(object):
    """An association between Circuits and arbitrary (free-form) data."""

    def __init__(self, circuits=None, circuit_indices=None):
        if circuit_indices is not None:
            self._cirIndex = collections.OrderedDict(
                (c if isinstance(c, Circuit) else Circuit(c), i)
                for c, i in circuit_indices.items())
        elif circuits is not None:
            self._cirIndex = collections.OrderedDict(
                (c if isinstance(c, Circuit) else Circuit(c), i)
                for i, c in enumerate(circuits))
        else:
            self._cirIndex = collections.OrderedDict()
        self._info = [dict() for _ in range(len(self._cirIndex))]

    @property
    def circuits(self):
        return list(self._cirIndex.keys())

    def __len__(self):
        return len(self._cirIndex)

    def __contains__(self, circuit):
        return circuit in self._cirIndex

    def __iter__(self):
        return iter(self._cirIndex)

    def __getitem__(self, circuit):
        return self._info[self._cirIndex[circuit if isinstance(circuit, Circuit)
                                         else Circuit(circuit)]]

    def __setitem__(self, circuit, info_dict):
        if circuit not in self._cirIndex:
            self._cirIndex[circuit if isinstance(circuit, Circuit)
                           else Circuit(circuit)] = len(self._info)
            self._info.append(dict(info_dict))
        else:
            self._info[self._cirIndex[circuit]] = dict(info_dict)

    def items(self):
        for c, i in self._cirIndex.items():
            yield c, self._info[i]

    def to_dataframe(self, pivot_valuename=None, pivot_value="Value",
                     drop_columns=False):
        """All per-circuit info as a pandas DataFrame."""
        import pandas as pd
        rows = []
        for c, info in self.items():
            row = {'Circuit': c.str}
            row.update(info)
            rows.append(row)
        return pd.DataFrame(rows)

    def copy(self):
        out = FreeformDataSet(circuit_indices=self._cirIndex)
        out._info = [dict(d) for d in self._info]
        return out
