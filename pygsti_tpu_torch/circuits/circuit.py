"""Circuits: immutable sequences of layer labels (counterpart of
pygsti_tpu/circuits/circuit.py).

String syntax: ``Gxpi2:0Gypi2:0@(0)`` (labels plus line labels),
``[Gxpi2:0Gypi2:1]`` (a parallel layer), ``[]`` (global idle),
``(Gxpi2:0Gypi2:0)^2`` (repetition) and ``{}`` (the empty circuit).

The editing methods return new circuits.  CompressedCircuit stores a long
circuit with its periodic runs factored out; SeparatePOVMCircuit holds a
circuit without its POVM beside the POVM and effect labels.
"""

from __future__ import annotations

from pygsti_tpu_torch.baseobjs.label import Label, LabelTupTup


def _no_lines(line_labels):
    return line_labels in (('*',), ())


def _to_layer_label(layer):
    return layer if isinstance(layer, LabelTupTup) else Label(layer)


def _simple_components(layer):
    """The simple labels of one layer label."""
    return (layer,) if layer.is_simple else tuple(layer.components)


class Circuit(object):
    """An immutable circuit: ordered tuple of layer labels + line labels."""

    __slots__ = ('_layers', '_line_labels', '_str', '_hash')

    def __init__(self, layer_labels=(), line_labels=None, stringrep=None):
        if isinstance(layer_labels, Circuit):
            layers = layer_labels._layers
            if line_labels is None:
                line_labels = layer_labels._line_labels
        elif isinstance(layer_labels, str):
            from pygsti_tpu_torch.circuits.circuitparser import parse_circuit_str
            layers, parsed_lls = parse_circuit_str(layer_labels)
            if line_labels is None:
                line_labels = parsed_lls
            if stringrep is None:
                stringrep = layer_labels
        else:
            layers = tuple(l if isinstance(l, LabelTupTup) else Label(l)
                           for l in layer_labels)

        if line_labels is None:
            seen = []
            for l in layers:
                for s in (l.sslbls or ()):
                    if s not in seen:
                        seen.append(s)
            line_labels = tuple(seen) if seen else ('*',)
        elif isinstance(line_labels, (int, str)) and line_labels != '*':
            line_labels = (line_labels,)
        else:
            line_labels = tuple(line_labels)

        self._layers = layers
        self._line_labels = line_labels
        self._str = stringrep
        self._hash = hash((layers, line_labels))

    @property
    def layertup(self):
        return self._layers

    @property
    def tup(self):
        if _no_lines(self._line_labels):
            return self._layers
        return self._layers + ('@',) + self._line_labels

    @property
    def line_labels(self):
        return self._line_labels

    @property
    def num_lines(self):
        return len(self._line_labels)

    @property
    def depth(self):
        return len(self._layers)

    @property
    def str(self):
        if self._str is None:
            s = "".join(str(l) for l in self._layers) if self._layers else "{}"
            if not _no_lines(self._line_labels):
                s += "@(" + ",".join(str(x) for x in self._line_labels) + ")"
            self._str = s
        return self._str

    def __len__(self):
        return len(self._layers)

    def __iter__(self):
        return iter(self._layers)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Circuit(self._layers[idx], self._line_labels)
        return self._layers[idx]

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        if isinstance(other, Circuit):
            return self.tup == other.tup
        if isinstance(other, tuple):
            return self.tup == other or self._layers == other
        if isinstance(other, str):
            return self.str == other
        return NotImplemented

    def _bare_str(self):
        s = self.str
        at = s.rfind('@')
        s = s[:at] if at >= 0 else s
        return '' if s == '{}' else s

    def _with_lines(self, bare, lls):
        if bare == '':
            bare = '{}'
        if not _no_lines(lls):
            bare += '@(' + ','.join(str(x) for x in lls) + ')'
        return bare

    def __add__(self, other):
        if not isinstance(other, Circuit):
            return NotImplemented
        if self._line_labels == ('*',):
            lls = other.line_labels
        elif other.line_labels == ('*',):
            lls = self._line_labels
        else:
            lls = list(self._line_labels)
            lls.extend(x for x in other.line_labels if x not in lls)
            lls = tuple(lls)
        sr = self._with_lines(self._bare_str() + other._bare_str(), lls)
        return Circuit(self._layers + other._layers, lls, stringrep=sr)

    def repeat(self, ntimes):
        if int(ntimes) != ntimes or ntimes < 0:
            raise ValueError("repeat count must be a non-negative integer")
        ntimes = int(ntimes)
        bare = self._bare_str()
        if ntimes == 0 or bare == '':
            sr = ''
        elif ntimes == 1:
            sr = bare
        elif len(self._layers) == 1 and not isinstance(self._layers[0], LabelTupTup):
            sr = '%s^%d' % (bare, ntimes)
        else:
            sr = '(%s)^%d' % (bare, ntimes)
        return Circuit(self._layers * ntimes, self._line_labels,
                       stringrep=self._with_lines(sr, self._line_labels))

    __mul__ = repeat

    def replace_layers_with_aliases(self, alias_dict):
        """This circuit with each layer found in `alias_dict` (keyed by
        label or by bare gate name) replaced by the layers of the Circuit
        it maps to."""
        if not alias_dict:
            return self
        layers = []
        for layer in self._layers:
            repl = alias_dict.get(layer)
            if repl is None and getattr(layer, 'name', None) is not None:
                repl = alias_dict.get(layer.name)
            layers.extend(repl.layertup if repl is not None else (layer,))
        return Circuit(tuple(layers), self._line_labels)

    @property
    def num_gates(self):
        """The number of gates, idles left out."""
        return sum(1 for layer in self._layers for c in _simple_components(layer) if len(c) > 0)

    def num_nq_gates(self, nq):
        """The number of gates that act on exactly `nq` lines."""
        return sum(1 for layer in self._layers for c in _simple_components(layer)
                   if c.sslbls is not None and len(c.sslbls) == nq)

    @property
    def num_multiq_gates(self):
        """The number of gates on two lines or more."""
        return sum(1 for layer in self._layers for c in _simple_components(layer)
                   if c.sslbls is not None and len(c.sslbls) >= 2)

    def two_q_gate_count(self):
        """The number of two-qubit gates: the Clifford compilers' cost."""
        return self.num_nq_gates(2)

    def append_circuit(self, other):
        """This circuit followed by `other`."""
        return self + other

    def prefix_circuit(self, other):
        """`other` followed by this circuit."""
        return other + self

    def insert_layer(self, layer_lbl, j):
        """This circuit with `layer_lbl` inserted at layer index j."""
        return Circuit(self._layers[:j] + (_to_layer_label(layer_lbl),) + self._layers[j:],
                       self._line_labels)

    def delete_layers(self, layers_to_delete):
        """This circuit without the layers at the given indices."""
        if isinstance(layers_to_delete, int):
            layers_to_delete = (layers_to_delete,)
        drop = set(layers_to_delete)
        return Circuit(tuple(l for i, l in enumerate(self._layers) if i not in drop),
                       self._line_labels)

    def delete_idle_layers(self):
        """This circuit without its empty (global idle) layers."""
        return Circuit(tuple(l for l in self._layers if len(l) > 0), self._line_labels)

    def replace_gatename(self, old_gatename, new_gatename):
        """This circuit with every gate named `old_gatename` renamed, on the
        same lines."""
        def repl(layer):
            new = tuple(Label(new_gatename, c.sslbls) if c.name == old_gatename else c
                        for c in _simple_components(layer))
            return new[0] if len(new) == 1 else LabelTupTup.init(new)
        return Circuit(tuple(repl(l) for l in self._layers), self._line_labels)

    def replace_layer(self, old_layer, new_layer):
        """This circuit with every layer equal to `old_layer` replaced."""
        old, new = _to_layer_label(old_layer), _to_layer_label(new_layer)
        return Circuit(tuple(new if l == old else l for l in self._layers), self._line_labels)

    def layer(self, j):
        """The j-th layer label."""
        return self._layers[j]

    layer_label = layer

    def idling_lines(self):
        """The line labels that no gate acts on."""
        used = set()
        for layer in self._layers:
            for c in _simple_components(layer):
                used.update(c.sslbls or ())
        return tuple(ll for ll in self._line_labels if ll not in used)

    def delete_idling_lines(self):
        """This circuit without its idling lines."""
        idle = set(self.idling_lines())
        keep = tuple(ll for ll in self._line_labels if ll not in idle)
        return Circuit(self._layers, keep if keep else None)

    def reorder_lines(self, order):
        """This circuit with its line labels in `order` (the gates name their
        lines, so they stay as they are)."""
        if set(order) != set(self._line_labels):
            raise ValueError("%s is no reordering of the lines %s" % (order, self._line_labels))
        return Circuit(self._layers, tuple(order))

    def parallelize(self):
        """This circuit in as few layers as possible: each gate moves to the
        earliest layer after the last one that uses any of its lines."""
        new_layers, busy = [], []      # simple labels, and their lines, per layer
        for layer in self._layers:
            for c in _simple_components(layer):
                if len(c) == 0:
                    continue
                lines = set(c.sslbls or self._line_labels)
                pos = len(new_layers)
                while pos > 0 and not (busy[pos - 1] & lines):
                    pos -= 1
                if pos == len(new_layers):
                    new_layers.append([c])
                    busy.append(set(lines))
                else:
                    new_layers[pos].append(c)
                    busy[pos].update(lines)
        return Circuit(tuple(lay[0] if len(lay) == 1 else LabelTupTup.init(tuple(lay))
                             for lay in new_layers), self._line_labels)

    def convert_to_openqasm(self, num_qubits=None, standard_gates_version='u3'):
        """OpenQASM 2.0 text of this circuit, through the standard gate
        names' OpenQASM table; an empty layer adds nothing."""
        from pygsti_tpu_torch.tools.internalgates import standard_gatenames_openqasm_conversions
        names, param_fns = standard_gatenames_openqasm_conversions(standard_gates_version)
        lls = [ll for ll in self._line_labels if ll != '*']
        if num_qubits is None:
            num_qubits = len(lls) if lls else 1
        qindex = {ll: i for i, ll in enumerate(lls)}
        lines = ['OPENQASM 2.0;', 'include "qelib1.inc";',
                 'qreg q[%d];' % num_qubits, 'creg cr[%d];' % num_qubits]
        for layer in self._layers:
            for c in _simple_components(layer):
                if len(c) == 0:
                    continue
                qs = ', '.join('q[%d]' % qindex.get(s, s) for s in (c.sslbls or ()))
                if c.name in param_fns and getattr(c, 'args', None):
                    lines.append('%s %s;' % (param_fns[c.name](c.args), qs))
                elif c.name in names:
                    lines.extend('%s %s;' % (g, qs) for g in names[c.name])
                else:
                    raise ValueError("No OpenQASM conversion for gate %r" % c.name)
        lines.append('measure q -> cr;')
        return '\n'.join(lines)

    def map_state_space_labels(self, mapper):
        """This circuit with every state-space label s of its layers and
        lines replaced by mapper[s] (or mapper(s) for a function)."""
        m = mapper.__getitem__ if hasattr(mapper, '__getitem__') else mapper
        lls = self._line_labels if self._line_labels == ('*',) \
            else tuple(m(x) for x in self._line_labels)
        return Circuit(tuple(l.map_state_space_labels(mapper) for l in self._layers), lls)

    def __str__(self):
        return self.str

    def __repr__(self):
        return "Circuit(%s)" % self.str


def validate_line_labels(linelabels):
    """Check that each line label round-trips through the circuit parser,
    so that circuits on these lines can be written and read back; raises
    ValueError for one that does not."""
    from pygsti_tpu_torch.io.stdinput import StdInputParser
    parser = StdInputParser()
    for line_lbl in linelabels:
        if line_lbl == '*':
            continue
        test_str = 'Gi:%s' % line_lbl
        try:
            ok = str(parser.parse_circuit(test_str).layertup[0]) == test_str
        except Exception:
            ok = False
        if not ok:
            raise ValueError("Line label %r could not round-trip through the circuit parser."
                             % (line_lbl,))


class CompressedCircuit(object):
    """A circuit with the periodic runs of its layers factored out, for
    storing long circuit lists; ``expand()`` gives the circuit back."""

    def __init__(self, circuit, min_len_to_compress=20, max_period_to_look_for=20):
        self._line_labels = circuit.line_labels
        self._str = circuit.str
        self._tup = CompressedCircuit.compress_op_label_tuple(
            circuit.layertup, min_len_to_compress, max_period_to_look_for)

    @staticmethod
    def compress_op_label_tuple(tup, min_len_to_compress=20, max_period=20):
        """`tup` with each run of a repeated block that saves more than two
        layers replaced by ('*REP*', block, reps), greedily from the left."""
        tup = tuple(tup)
        if len(tup) < min_len_to_compress:
            return tup
        out, i, n = [], 0, len(tup)
        while i < n:
            best = None  # (layers saved, period, reps)
            for p in range(1, min(max_period, (n - i) // 2) + 1):
                block = tup[i:i + p]
                reps = 1
                while tup[i + reps * p:i + (reps + 1) * p] == block:
                    reps += 1
                if reps > 1 and (best is None or p * (reps - 1) > best[0]):
                    best = (p * (reps - 1), p, reps)
            if best is not None and best[0] > 2:
                _, p, reps = best
                out.append(('*REP*', tup[i:i + p], reps))
                i += p * reps
            else:
                out.append(tup[i])
                i += 1
        return tuple(out)

    @staticmethod
    def expand_op_label_tuple(compressed_tup):
        """The inverse of compress_op_label_tuple."""
        out = []
        for item in compressed_tup:
            if isinstance(item, tuple) and len(item) == 3 and item[0] == '*REP*':
                out.extend(item[1] * item[2])
            else:
                out.append(item)
        return tuple(out)

    def expand(self):
        """The circuit this one compresses."""
        return Circuit(CompressedCircuit.expand_op_label_tuple(self._tup), self._line_labels)


class SeparatePOVMCircuit(object):
    """A circuit without its POVM, held beside the POVM label and the
    effect labels."""

    def __init__(self, circuit_without_povm, povm_label, effect_labels):
        self.circuit_without_povm = circuit_without_povm
        self._povm_label = povm_label
        self._effect_labels = tuple(effect_labels)
        self._full_effect_labels = tuple("%s_%s" % (povm_label, el)
                                         for el in self._effect_labels)

    @property
    def povm_label(self):
        return self._povm_label

    @property
    def effect_labels(self):
        return self._effect_labels

    @property
    def full_effect_labels(self):
        return self._full_effect_labels

    def __len__(self):
        return len(self.circuit_without_povm)

    def __str__(self):
        return "%s POVM=%s" % (self.circuit_without_povm.str, self._povm_label)
