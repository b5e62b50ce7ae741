"""The standard text formats in (counterpart of pygsti_tpu/io/stdinput.py).

The dataset-file grammar:

* preamble directives ``## Key = value``: Columns, Outcomes,
  StdOutcomeQubits, Lookup
* fixed-column count lines, with ``--`` (no data) and ``BAD`` (a known-bad
  line) sentinels
* ``circuit  0:95 1:5`` lines of outcome:count pairs when there is no
  Columns directive
* time-series blocks: a bare circuit line followed by ``times:``,
  ``outcomes:``, ``repetitions:`` and ``aux:`` lines, ended by a blank line
* multi-dataset files with ``<ds> <outcome> count``, ``<ds> <outcome>
  frequency`` and ``<ds> count total`` columns
* circuit-string files and Lookup dictionary files

Circuits are parsed by the port's own circuits/circuitparser.py.  A Lookup
file named by a data file is opened by its path joined to the data file's
folder; the JAX package changes the process's working directory to that
folder instead, which reads the same file.
"""

from __future__ import annotations

import ast
import collections
import os
import re
import warnings

import numpy as np

from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.data.multidataset import MultiDataSet

_SERIES_PREFIXES = ('times:', 'outcomes:', 'repetitions:', 'aux:')


def _str_to_outcome(x):
    """Outcome labels are tuples; ':' separates register parts."""
    return tuple(x.strip().split(":"))


def _parse_comment(comment, filename, i_line, warn_list):
    comment = comment.strip()
    if len(comment) == 0:
        return {}
    try:
        if comment.startswith("{") and comment.endswith("}"):
            return ast.literal_eval(comment)
        return ast.literal_eval("{ " + comment + " }")
    except Exception:
        warn_list.append("%s Line %d: Could not parse comment '%s'"
                         % (filename, i_line, comment))
        return {}


class StdInputParser(object):
    """Parser of the text formats."""

    def parse_circuit(self, s, lookup=None, create_subcircuits=True, line_labels=None):
        """A Circuit from its string; ``S<name>`` names a `lookup` entry.
        `create_subcircuits` is accepted for the JAX package's signature:
        exponents always expand."""
        lookup = lookup or {}
        m = re.match(r'S<([a-zA-Z0-9_]+)>', s.strip())
        if m:
            return Circuit(lookup[m.group(1)])
        c = Circuit(s)
        if line_labels is not None and '@' not in s:
            c = Circuit(c.layertup, tuple(line_labels))
        return c

    def parse_dataline(self, s, lookup=None, expected_counts=-1, create_subcircuits=True,
                       line_labels=None):
        """(circuit, counts) of one data line.  With expected_counts -1 the
        count tokens are '<outcome>:<count>' pairs (or 'BAD'); otherwise
        plain column values with the '--' and 'BAD' sentinels."""
        parts = s.split()
        circuit_str = parts[0]
        counts = []
        if expected_counts == -1:
            if len(parts) == 1:
                pass
            elif parts[1] == "BAD":
                counts.append("BAD")
            else:
                for p in parts[1:]:
                    t = p.split(':')
                    counts.append((tuple(t[0:-1]), float(t[-1])))
        else:
            for p in parts[1:]:
                counts.append(p if p in ('--', 'BAD') else float(p))
            if len(counts) > expected_counts >= 0:
                counts = counts[0:expected_counts]
            if len(counts) != expected_counts:
                raise ValueError("Found %d count columns when %d were expected"
                                 % (len(counts), expected_counts))
        return self.parse_circuit(circuit_str, lookup, create_subcircuits,
                                  line_labels=line_labels), counts

    def parse_dictline(self, s):
        """(label, layer tuple, circuit string) of a Lookup-file line."""
        m = re.match(r'\s*([a-zA-Z0-9_]+)\s+', s)
        if not m:
            raise ValueError("'%s' is not a valid dictline" % s)
        cstr = s[m.end():].strip()
        return m.group(1), Circuit(cstr).layertup, cstr

    def parse_stringfile(self, filename, line_labels="auto", num_lines=None,
                         create_subcircuits=True):
        """The circuits of a file, one per line; '#' starts a comment line."""
        out = []
        lbls = None if line_labels == "auto" else line_labels
        with open(filename) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith('#'):
                    out.append(Circuit(line, lbls))
        return out

    def parse_dictfile(self, filename):
        """{label: circuit string} of a Lookup file."""
        lookup = {}
        with open(filename) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith('#'):
                    label, _, cstr = self.parse_dictline(line)
                    lookup[label] = cstr
        return lookup

    @staticmethod
    def _parse_preamble(filename):
        directives, comments = {}, []
        with open(filename) as f:
            for line in f:
                line = line.strip()
                if len(line) == 0 or line[0] != '#':
                    break
                if line.startswith("## "):
                    parts = line[len("## "):].split("=")
                    if len(parts) == 2:
                        directives[parts[0].strip()] = parts[1].strip()
                else:
                    comments.append(line[1:].strip())
        return directives, comments

    def _lookup(self, filename, directives):
        if 'Lookup' not in directives:
            return {}
        return self.parse_dictfile(os.path.join(os.path.dirname(filename),
                                                directives['Lookup']))

    # -- dataset files --------------------------------------------------------
    def parse_datafile(self, filename, show_progress=False, collision_action="aggregate",
                       record_zero_counts=True, ignore_zero_count_lines=True,
                       with_times="auto"):
        """A DataSet from a dataset file.  Repeated circuits aggregate;
        collision_action 'keepseparate' raises NotImplementedError, as in
        the JAX package.  `show_progress` draws nothing."""
        if collision_action not in ('aggregate', 'keepseparate'):
            raise ValueError("Invalid collision_action %r" % (collision_action,))
        if collision_action == 'keepseparate':
            raise NotImplementedError(
                "collision_action='keepseparate' (occurrence-tagged repeated circuits) "
                "is not supported")
        directives, comments = self._parse_preamble(filename)
        lookup = self._lookup(filename, directives)

        outcome_labels = None
        fixed_cols = None
        n_data_cols = -1
        if 'Columns' in directives:
            col_labels = [l.strip() for l in directives['Columns'].split(",")]
            fixed_cols = []
            for cl in col_labels:
                if not cl.endswith(' count'):
                    raise ValueError("Invalid count column name %r "
                                     "(only '<outcome> count' columns supported)" % cl)
                ol = _str_to_outcome(cl[:-len(' count')])
                if ol not in fixed_cols:
                    fixed_cols.append(ol)
            n_data_cols = len(col_labels)
            outcome_labels = sorted(fixed_cols)
        if 'Outcomes' in directives:
            outcome_labels = [tuple(l.strip().split(':'))
                              for l in directives['Outcomes'].split(",")]
        if 'StdOutcomeQubits' in directives:
            nq = int(directives['StdOutcomeQubits'])
            outcome_labels = [(format(i, '0%db' % nq),) for i in range(2 ** nq)]

        ds = DataSet(outcome_labels=outcome_labels, comment="\n".join(comments) or None)
        warn_list = []
        looking_for = "circuit_line"
        current = {}
        last_circuit = None

        def flush_series():
            ds.add_raw_series_data(current['circuit'],
                                   [_str_to_outcome(o) for o in current.get('outcomes', [])],
                                   current.get('times', []), current.get('repetitions', None),
                                   aux=current.get('aux'))
            current.clear()

        with open(filename) as f:
            for i_line, line in enumerate(f):
                line = line.strip()
                if '#' in line and not line.startswith('##'):
                    idx = line.index('#')
                    dataline, comment = line[:idx], line[idx + 1:]
                elif line.startswith('#'):
                    continue
                else:
                    dataline, comment = line, ""

                if looking_for == "circuit_data_or_line":
                    if len(dataline) == 0 or dataline.split()[0] in _SERIES_PREFIXES:
                        looking_for = "circuit_data"
                    else:
                        looking_for = "circuit_line"
                        if ignore_zero_count_lines is False and last_circuit is not None:
                            ds.add_count_dict(last_circuit, {},
                                              record_zero_counts=record_zero_counts)

                if looking_for == "circuit_line":
                    if len(dataline) == 0:
                        continue
                    circuit, values = self.parse_dataline(dataline, lookup, n_data_cols)
                    _parse_comment(comment, filename, i_line, warn_list)
                    if with_times is True and len(values) > 0:
                        raise ValueError("%s Line %d: Circuit line cannot contain count "
                                         "information when with_times=True"
                                         % (filename, i_line))
                    if with_times is False or len(values) > 0:
                        if 'BAD' in values:
                            count_items = []
                        elif fixed_cols is not None:
                            count_items = [(ol, v) for ol, v in zip(fixed_cols, values)
                                           if v != '--']
                        else:
                            count_items = list(values)
                        vals = [v for _, v in count_items]
                        if vals and all(abs(v) < 1e-9 for v in vals) and ignore_zero_count_lines:
                            s = circuit.str if len(circuit.str) < 40 else circuit.str[:37] + "..."
                            warn_list.append("Dataline for circuit '%s' has zero counts and "
                                             "will be ignored" % s)
                            continue
                        ds.add_count_dict(
                            circuit, {ol: (int(v) if float(v).is_integer() else v)
                                      for ol, v in count_items},
                            record_zero_counts=record_zero_counts)
                    else:
                        current.clear()
                        current['circuit'] = circuit
                        last_circuit = circuit
                        looking_for = "circuit_data" if with_times is True \
                            else "circuit_data_or_line"

                elif looking_for == "circuit_data":
                    if len(line) == 0:
                        flush_series()
                        looking_for = "circuit_line"
                    else:
                        parts = dataline.split()
                        if parts[0] == 'times:':
                            current['times'] = [float(x) for x in parts[1:]]
                        elif parts[0] == 'outcomes:':
                            current['outcomes'] = parts[1:]
                        elif parts[0] == 'repetitions:':
                            try:
                                current['repetitions'] = [int(x) for x in parts[1:]]
                            except ValueError:
                                current['repetitions'] = [float(x) for x in parts[1:]]
                        elif parts[0] == 'aux:':
                            current['aux'] = _parse_comment(" ".join(parts[1:]), filename,
                                                            i_line, warn_list)
                        else:
                            raise ValueError("Invalid circuit data-line prefix: '%s'"
                                             % parts[0])

        if looking_for in ("circuit_data", "circuit_data_or_line") and current:
            flush_series()
        if warn_list:
            warnings.warn("\n".join(warn_list))
        return ds

    def _extract_labels_from_multi_data_col_labels(self, col_labels):
        ds_outcome_labels = collections.OrderedDict()
        count_cols, freq_cols, implied_counts_1q = [], [], []
        for i, cl in enumerate(col_labels):
            words = cl.split()
            if len(words) < 3:
                continue
            if words[-1] == 'count':
                if len(words) > 3:
                    warnings.warn("Column label '%s' has more words than expected (3)" % cl)
                ol = _str_to_outcome(words[-2])
                ds_lbl = words[-3]
                ds_outcome_labels.setdefault(ds_lbl, []).append(ol)
                count_cols.append((ds_lbl, ol, i))
            elif words[-1] == 'frequency':
                ol = _str_to_outcome(words[-2])
                ds_lbl = words[-3]
                if '%s count total' % ds_lbl not in col_labels:
                    raise ValueError("Frequency columns specified without count total for "
                                     "dataset '%s'" % ds_lbl)
                i_total = col_labels.index('%s count total' % ds_lbl)
                ds_outcome_labels.setdefault(ds_lbl, []).append(ol)
                freq_cols.append((ds_lbl, ol, i, i_total))

        for ds_lbl, ols in ds_outcome_labels.items():
            if '%s count total' % ds_lbl in col_labels:
                i_total = col_labels.index('%s count total' % ds_lbl)
                if ('1',) in ols and ('0',) not in ols:
                    ols.append(('0',))
                    implied_counts_1q.append((ds_lbl, ('0',), i_total))
                if ('0',) in ols and ('1',) not in ols:
                    ols.append(('1',))
                    implied_counts_1q.append((ds_lbl, ('1',), i_total))
        return ds_outcome_labels, (count_cols, freq_cols, implied_counts_1q)

    def parse_multidatafile(self, filename, show_progress=False, collision_action="aggregate",
                            record_zero_counts=True, ignore_zero_count_lines=True):
        """A MultiDataSet from a multi-dataset file."""
        directives, _ = self._parse_preamble(filename)
        lookup = self._lookup(filename, directives)
        if 'Columns' in directives:
            col_labels = [l.strip() for l in directives['Columns'].split(",")]
        else:
            col_labels = ['dataset1 1 count', 'dataset1 count total']
        ds_outcome_labels, (count_cols, freq_cols, implied_1q) = \
            self._extract_labels_from_multi_data_col_labels(col_labels)
        n_data_cols = len(col_labels)
        datasets = collections.OrderedDict((lbl, DataSet(outcome_labels=ols))
                                           for lbl, ols in ds_outcome_labels.items())
        with open(filename) as f:
            for line in f:
                line = line.strip()
                if '#' in line:
                    line = line[:line.index('#')].strip()
                if len(line) == 0:
                    continue
                circuit, values = self.parse_dataline(line, lookup, n_data_cols)
                if 'BAD' in values:
                    continue
                count_dicts = {lbl: {} for lbl in ds_outcome_labels}
                for ds_lbl, ol, i in count_cols:
                    if values[i] == '--':
                        continue
                    if 0 < values[i] < 1:
                        raise ValueError("Count column (%d) contains value(s) between 0 and 1 "
                                         "- could this be a frequency?" % i)
                    count_dicts[ds_lbl][ol] = values[i]
                for ds_lbl, ol, i, i_tot in freq_cols:
                    if values[i] == '--':
                        continue
                    if values[i] < 0 or values[i] > 1.0:
                        raise ValueError("Frequency column (%d) contains value(s) outside "
                                         "[0,1]" % i)
                    count_dicts[ds_lbl][ol] = values[i] * values[i_tot]
                for ds_lbl, ol, i_tot in implied_1q:
                    if values[i_tot] == '--':
                        raise ValueError("Missing total (== '--')!")
                    other = ('1',) if ol == ('0',) else ('0',)
                    count_dicts[ds_lbl][ol] = values[i_tot] - count_dicts[ds_lbl][other]
                all_zero = all(all(abs(v) < 1e-9 for v in cd.values()) or not cd
                               for cd in count_dicts.values())
                if all_zero and ignore_zero_count_lines:
                    continue
                for ds_lbl, cd in count_dicts.items():
                    datasets[ds_lbl].add_count_dict(circuit, cd,
                                                    record_zero_counts=record_zero_counts)
        mds = MultiDataSet()
        for lbl, ds in datasets.items():
            mds.add_dataset(lbl, ds)
        return mds

    def parse_tddatafile(self, filename, show_progress=False, record_zero_counts=True,
                         create_subcircuits=True):
        """A time-series DataSet from a file of 'timestamp circuit outcome'
        lines; each circuit's outcomes are sorted by time."""
        directives, _ = self._parse_preamble(filename)
        lookup = self._lookup(filename, directives)
        raw = collections.OrderedDict()   # circuit -> (times, outcomes)
        with open(filename) as f:
            for line in f:
                line = line.strip()
                if len(line) == 0 or line.startswith('#'):
                    continue
                parts = line.split()
                if len(parts) < 3:
                    raise ValueError("Invalid timestamped data line: %r" % line)
                times, outs = raw.setdefault(self.parse_circuit(parts[1], lookup), ([], []))
                times.append(float(parts[0]))
                outs.append(_str_to_outcome(parts[2]))
        ds = DataSet()
        for circuit, (times, outs) in raw.items():
            order = np.argsort(times)
            ds.add_raw_series_data(circuit, [outs[i] for i in order], [times[i] for i in order])
        return ds


def _parse_model_text(filename):
    """The blocks of a text model file: (preps, povms, gates, basis name,
    basis dimension, gauge group, whether a block is TP)."""
    preps, povms, gates = {}, {}, {}
    basis_name, basis_dim, gaugegroup = 'pp', None, None
    tp = False
    cur = {'kind': None, 'label': None, 'povm': None, 'rows': [], 'mx': False}

    def finish():
        if cur['kind'] is not None and cur['rows']:
            rows = cur['rows']
            arr = np.array(rows[0]) if len(rows) == 1 else np.array(rows)
            if cur['kind'] == 'prep':
                preps[cur['label']] = arr
            elif cur['kind'] == 'effect':
                povms[cur['povm']][cur['label']] = arr
            else:
                gates[cur['label']] = arr
        cur.update(kind=None, rows=[], mx=False)

    def start(kind, s):
        finish()
        cur.update(kind=kind, label=s.split(':', 1)[1].strip())

    with open(str(filename)) as f:
        for raw in f:
            s = raw.strip()
            if not s or s.startswith('#'):
                finish()
                continue
            up = s.upper()
            if up.startswith(('PREP:', 'TP-PREP:', 'STATIC-PREP:')):
                start('prep', s)
                tp = tp or up.startswith('TP-')
            elif up.startswith(('POVM:', 'TP-POVM:')):
                finish()
                tp = tp or up.startswith('TP-')
                cur['povm'] = s.split(':', 1)[1].strip()
                povms[cur['povm']] = {}
            elif up.startswith('EFFECT:'):
                start('effect', s)
            elif up.startswith('END'):
                finish()
            elif up.startswith(('GATE:', 'TP-GATE:', 'CPTP-GATE:', 'STATIC-GATE:')):
                start('gate', s)
                tp = tp or up.startswith('TP-')
            elif up.startswith(('STATESPACE:', 'BASIS:', 'GAUGEGROUP:')):
                finish()
                if up.startswith('BASIS:'):
                    parts = s.split(':', 1)[1].split()
                    basis_name = parts[0]
                    if len(parts) > 1:
                        basis_dim = int(parts[1].rstrip(','))
                elif up.startswith('GAUGEGROUP:'):
                    gaugegroup = s.split(':', 1)[1].strip()
            elif s in ('LiouvilleVec', 'LiouvilleMx', 'PauliVec', 'PauliMx'):
                cur['mx'] = True
            elif cur['mx']:
                cur['rows'].append([float(x) for x in s.split()])
    finish()
    return preps, povms, gates, basis_name, basis_dim, gaugegroup, tp


def _gate_label(s):
    from pygsti_tpu_torch.baseobjs.label import Label
    s = s.strip()
    if s in ('[]', '{}', ''):
        return Label(())
    parts = s.split(':')
    if len(parts) == 1:
        return Label(s)

    def to_int(x):
        try:
            return int(x)
        except ValueError:
            return x
    return Label(parts[0], tuple(to_int(p) for p in parts[1:]))


def parse_model(filename):
    """An ExplicitOpModel from a text model file (io.write_model's format):
    'full TP' members when a block is TP or the gauge group is 'TP', else
    'full'.  The JAX package defines this function twice; its first
    definition is shadowed by the second, whose behaviour this is."""
    from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel
    preps, povms, gates, basis_name, basis_dim, gaugegroup, tp = _parse_model_text(filename)
    if basis_dim is None:
        some = next(iter(gates.values()), None)
        if some is None:
            some = next(iter(preps.values()))
        basis_dim = np.asarray(some).shape[-1]
    gate_type = 'full TP' if (tp or gaugegroup == 'TP') else 'full'
    mdl = ExplicitOpModel(basis_dim, basis_name, default_gate_type=gate_type)
    for lbl, vec in preps.items():
        mdl.preps[lbl] = np.asarray(vec).reshape(-1)
    for plbl, effects in povms.items():
        mdl.povms[plbl] = {elbl: np.asarray(v).reshape(-1) for elbl, v in effects.items()}
    for lbl, mx in gates.items():
        mdl.operations[_gate_label(lbl)] = np.asarray(mx)
    return mdl
