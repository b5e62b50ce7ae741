"""Circuits: immutable sequences of layer labels (counterpart of
pygsti_tpu/circuits/circuit.py, trimmed to what the GST fit uses).

String syntax: ``Gxpi2:0Gypi2:0@(0)`` (labels plus line labels),
``[Gxpi2:0Gypi2:1]`` (a parallel layer), ``[]`` (global idle),
``(Gxpi2:0Gypi2:0)^2`` (repetition) and ``{}`` (the empty circuit).
"""

from __future__ import annotations

from pygsti_tpu_torch.baseobjs.label import Label, LabelTupTup


def _no_lines(line_labels):
    return line_labels in (('*',), ())


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

    def num_nq_gates(self, nq):
        """The number of gates that act on exactly `nq` lines."""
        return sum(1 for layer in self._layers
                   for c in ((layer,) if layer.is_simple else layer.components)
                   if c.sslbls is not None and len(c.sslbls) == nq)

    def two_q_gate_count(self):
        """The number of two-qubit gates: the Clifford compilers' cost."""
        return self.num_nq_gates(2)

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
