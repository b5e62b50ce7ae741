"""Outcome-count datasets (counterpart of pygsti_tpu/data/dataset.py).

A DataSet maps circuits to outcome -> count rows, kept on the host, with
optional time series (timestamps, repetitions and the raw outcome
sequence), per-circuit auxiliary data and a comment.  The fit reads counts
through the layouts; this container only stores them.

Two decisions differ from the JAX package: ``copy`` and ``truncate`` keep
the outcome series (the JAX package's copy drops it, so
``degrees_of_freedom(aggregate_times=False)`` of a copy raises there), and
the nice serialization also writes the times, repetitions, series, comment
and aux data when a dataset has them, as extra keys that the JAX package's
reader ignores; a static dataset's state is the JAX package's, key for key.
"""

from __future__ import annotations

import collections

import numpy as np

from pygsti_tpu_torch.baseobjs.outcomelabeldict import OutcomeLabelDict
from pygsti_tpu_torch.circuits.circuit import Circuit


class _DataSetRow(object):
    """View of one circuit's data."""

    __slots__ = ('counts', '_timestamps', '_reps', '_series')

    def __init__(self, counts, timestamps=None, reps=None, series=None):
        self.counts = counts
        self._timestamps = timestamps
        self._reps = reps
        self._series = series

    @property
    def total(self):
        return float(sum(self.counts.values()))

    @property
    def fractions(self):
        t = self.total
        out = OutcomeLabelDict()
        for k, v in self.counts.items():
            out[k] = v / t if t > 0 else 0.0
        return out

    @property
    def outcomes(self):
        return list(self.counts.keys())

    @property
    def time(self):
        return self._timestamps

    @property
    def reps(self):
        return self._reps

    @property
    def outcome_series(self):
        """The raw time-ordered outcome sequence (None without time series)."""
        return self._series

    @property
    def timeseries_for_outcomes(self):
        """(times, {outcome: repetitions per time}): the row as one click
        stream per outcome over its distinct collection times."""
        if self._series is None or self._timestamps is None:
            raise ValueError("Row has no time-series data")
        reps = self._reps if self._reps is not None else [1] * len(self._timestamps)
        times = []
        series = {o: [] for o in self.counts}
        last_t = None
        for t, ol, rep in zip(self._timestamps, self._series, reps):
            ol = OutcomeLabelDict.to_outcome(ol)
            if t != last_t:
                times.append(t)
                last_t = t
                for o in series:
                    series[o].append(rep if o == ol else 0)
            else:
                series[ol][-1] += rep
        return times, series

    def __getitem__(self, outcome):
        return self.counts[OutcomeLabelDict.to_outcome(outcome)]

    def __contains__(self, outcome):
        return OutcomeLabelDict.to_outcome(outcome) in self.counts

    def __iter__(self):
        return iter(self.counts)

    def items(self):
        return self.counts.items()

    def __repr__(self):
        return "DataSetRow(%s)" % dict(self.counts)


class DataSet(object):
    """Map from circuits to outcome counts.  `outcome_labels` starts the
    dataset's label list; labels first seen in added data follow, in that
    order (the column order of ``io.write_dataset``)."""

    def __init__(self, outcome_labels=None, circuits=None, comment=None):
        self._rows = collections.OrderedDict()   # Circuit -> OutcomeLabelDict
        self._times = {}
        self._reps = {}
        self._series = {}    # Circuit -> list of outcome tuples, in time order
        self.auxInfo = collections.defaultdict(dict)
        self._outcome_labels = [OutcomeLabelDict.to_outcome(o) for o in outcome_labels] \
            if outcome_labels is not None else []
        self.comment = comment
        if circuits is not None:
            for c in circuits:
                self._rows[self._cast_circuit(c)] = OutcomeLabelDict()

    @staticmethod
    def _cast_circuit(c):
        return c if isinstance(c, Circuit) else Circuit(c)

    # -- write ----------------------------------------------------------------
    def add_count_dict(self, circuit, count_dict, record_zero_counts=True, aux=None,
                       update_ol=True):
        """Add counts to a circuit's row.  A zero count is recorded unless
        `record_zero_counts` is False and the row lacks that outcome: the
        recorded outcomes set the circuit's degrees of freedom."""
        circuit = self._cast_circuit(circuit)
        row = self._rows.get(circuit)
        if row is None:
            row = OutcomeLabelDict()
            self._rows[circuit] = row
        for outcome, cnt in count_dict.items():
            ol = OutcomeLabelDict.to_outcome(outcome)
            if cnt == 0 and not record_zero_counts and ol not in row:
                continue
            row[ol] = row.get(ol, 0) + cnt
            if update_ol and ol not in self._outcome_labels:
                self._outcome_labels.append(ol)
        if aux:
            self.auxInfo[circuit].update(aux)

    def add_raw_series_data(self, circuit, outcome_label_list, time_stamp_list,
                            rep_count_list=None, aux=None):
        """Set a circuit's row from its outcome sequence, one outcome per
        timestamp with its repetitions (1 each by default)."""
        circuit = self._cast_circuit(circuit)
        counts = OutcomeLabelDict()
        reps = rep_count_list if rep_count_list is not None else [1] * len(outcome_label_list)
        for ol, rep in zip(outcome_label_list, reps):
            ol = OutcomeLabelDict.to_outcome(ol)
            counts[ol] = counts.get(ol, 0) + rep
            if ol not in self._outcome_labels:
                self._outcome_labels.append(ol)
        self._rows[circuit] = counts
        self._times[circuit] = np.asarray(time_stamp_list)
        self._reps[circuit] = np.asarray(reps)
        self._series[circuit] = [OutcomeLabelDict.to_outcome(ol) for ol in outcome_label_list]
        if aux:
            self.auxInfo[circuit].update(aux)

    # -- read -----------------------------------------------------------------
    def __getitem__(self, circuit):
        circuit = self._cast_circuit(circuit)
        return _DataSetRow(self._rows[circuit], self._times.get(circuit),
                           self._reps.get(circuit), self._series.get(circuit))

    def __contains__(self, circuit):
        return self._cast_circuit(circuit) in self._rows

    def __len__(self):
        return len(self._rows)

    def __iter__(self):
        return iter(self._rows)

    def keys(self):
        return list(self._rows.keys())

    def items(self):
        return [(c, self[c]) for c in self._rows]

    @property
    def outcome_labels(self):
        return list(self._outcome_labels)

    @property
    def has_timestamps(self):
        return len(self._times) > 0

    def degrees_of_freedom(self, circuits=None, aggregate_times=True):
        """Sum over circuits of (number of recorded outcomes - 1).  With
        ``aggregate_times=False`` a time-series row counts (outcomes seen at
        t - 1) for each of its distinct timestamps t instead."""
        circuits = circuits if circuits is not None else self.keys()
        dof = 0
        for c in circuits:
            circ = self._cast_circuit(c)
            row = self._rows.get(circ)
            if row is None:
                continue
            times = self._times.get(circ)
            if not aggregate_times and times is not None:
                per_t = {}
                for ol, t in zip(self._series[circ], times):
                    per_t.setdefault(float(t), set()).add(ol)
                dof += sum(max(len(ols) - 1, 0) for ols in per_t.values())
            else:
                dof += max(len(row) - 1, 0)
        return dof

    # -- transforms -----------------------------------------------------------
    def _copy_row_into(self, out, src, dst):
        out._rows[dst] = self._rows[src].copy()
        for mine, theirs in ((self._times, out._times), (self._reps, out._reps),
                             (self._series, out._series)):
            if src in mine:
                theirs[dst] = mine[src].copy()
        if self.auxInfo.get(src):
            out.auxInfo[dst] = dict(self.auxInfo[src])

    def copy(self):
        """A deep copy: counts, time series, aux data and comment."""
        out = DataSet(outcome_labels=self._outcome_labels, comment=self.comment)
        for c in self._rows:
            self._copy_row_into(out, c, c)
        return out

    def copy_nonstatic(self):
        return self.copy()

    def done_adding_data(self):
        return self

    def truncate(self, circuits, missing_action='raise'):
        """The rows of `circuits`, in that order, with their time series; a
        circuit missing from the dataset raises KeyError unless
        `missing_action` is not 'raise', when it is left out."""
        out = DataSet(outcome_labels=self._outcome_labels, comment=self.comment)
        for c in circuits:
            cc = self._cast_circuit(c)
            if cc in self._rows:
                self._copy_row_into(out, cc, cc)
            elif missing_action == 'raise':
                raise KeyError("Circuit %s missing from dataset" % cc)
        return out

    def process_circuits(self, processor_fn, aggregate=False):
        """A static dataset keyed by processor_fn(circuit); a circuit mapped
        to None is dropped, and with `aggregate` the counts of circuits
        mapped to one circuit are summed (the JAX package's behaviour: the
        time series are not carried over)."""
        out = DataSet(outcome_labels=self._outcome_labels)
        for c, row in self._rows.items():
            newc = processor_fn(c)
            if newc is None:
                continue
            if aggregate and newc in out._rows:
                for k, v in row.items():
                    out._rows[newc][k] = out._rows[newc].get(k, 0) + v
            else:
                out._rows[newc] = row.copy()
        return out

    def aggregate_std_nqubit_outcomes(self):
        return self

    def __str__(self):
        lines = ["Dataset with %d circuits:" % len(self._rows)]
        for c, row in list(self._rows.items())[:20]:
            lines.append("  %s : %s" % (c.str, dict(row)))
        if len(self._rows) > 20:
            lines.append("  ...")
        return "\n".join(lines)

    # -- serialization --------------------------------------------------------
    def to_nice_serialization(self):
        state = {
            'outcome_labels': [list(o) for o in self._outcome_labels],
            'rows': [[c.str, [[list(k), v] for k, v in row.items()]]
                     for c, row in self._rows.items()],
        }
        if self._times:
            series = [c for c in self._rows if c in self._times]
            state['times'] = [[c.str, self._times[c].tolist()] for c in series]
            state['reps'] = [[c.str, self._reps[c].tolist()] for c in series]
            state['series'] = [[c.str, [list(o) for o in self._series[c]]] for c in series]
        if self.comment is not None:
            state['comment'] = self.comment
        aux = [[c.str, dict(self.auxInfo[c])] for c in self._rows if self.auxInfo.get(c)]
        if aux:
            state['aux'] = aux
        return state

    @classmethod
    def from_nice_serialization(cls, state):
        ds = cls(outcome_labels=[tuple(o) for o in state['outcome_labels']],
                 comment=state.get('comment'))
        for cstr, row in state['rows']:
            ds.add_count_dict(Circuit(cstr), {tuple(k): v for k, v in row})
        reps = dict(state.get('reps', ()))
        series = dict(state.get('series', ()))
        for cstr, times in state.get('times', ()):
            ds.add_raw_series_data(Circuit(cstr), [tuple(o) for o in series[cstr]], times,
                                   reps[cstr])
        for cstr, aux in state.get('aux', ()):
            ds.auxInfo[Circuit(cstr)].update(aux)
        return ds
