"""Outcome-count datasets (counterpart of pygsti_tpu/data/dataset.py,
without time series): circuits -> outcome -> count, kept on the host."""

from __future__ import annotations

import collections

from pygsti_tpu_torch.baseobjs.outcomelabeldict import OutcomeLabelDict
from pygsti_tpu_torch.circuits.circuit import Circuit


class _DataSetRow(object):
    """View of one circuit's counts."""

    __slots__ = ('counts',)

    def __init__(self, counts):
        self.counts = counts

    @property
    def total(self):
        return float(sum(self.counts.values()))

    def __getitem__(self, outcome):
        return self.counts[outcome]

    def items(self):
        return self.counts.items()


class DataSet(object):
    """Map from circuits to outcome counts."""

    def __init__(self):
        self._rows = collections.OrderedDict()   # Circuit -> OutcomeLabelDict

    @staticmethod
    def _cast_circuit(c):
        return c if isinstance(c, Circuit) else Circuit(c)

    def add_count_dict(self, circuit, count_dict, record_zero_counts=True):
        """Add counts to a circuit's row.  A zero count is recorded unless
        `record_zero_counts` is False and the row lacks that outcome: the
        recorded outcomes set the circuit's degrees of freedom."""
        circuit = self._cast_circuit(circuit)
        row = self._rows.setdefault(circuit, OutcomeLabelDict())
        for outcome, cnt in count_dict.items():
            ol = OutcomeLabelDict.to_outcome(outcome)
            if cnt == 0 and not record_zero_counts and ol not in row:
                continue
            row[ol] = row.get(ol, 0) + cnt

    def __getitem__(self, circuit):
        return _DataSetRow(self._rows[self._cast_circuit(circuit)])

    def __contains__(self, circuit):
        return self._cast_circuit(circuit) in self._rows

    def __len__(self):
        return len(self._rows)

    def __iter__(self):
        return iter(self._rows)

    def keys(self):
        return list(self._rows.keys())

    @property
    def outcome_labels(self):
        """Every outcome label recorded, in first-seen order."""
        return list(dict.fromkeys(ol for row in self._rows.values() for ol in row))

    def degrees_of_freedom(self, circuits=None):
        """Sum over circuits of (number of recorded outcomes - 1)."""
        circuits = circuits if circuits is not None else self.keys()
        dof = 0
        for c in circuits:
            row = self._rows.get(self._cast_circuit(c))
            if row is not None:
                dof += max(len(row) - 1, 0)
        return dof
