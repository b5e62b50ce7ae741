"""Parser for pyGSTi circuit-string syntax (counterpart of
pygsti_tpu/circuits/circuitparser.py, pure-Python parser only).

  circuit   := '{}' [lineslbls] | seq [lineslbls]
  lineslbls := '@(' lbl (',' lbl)* ')' | '@*'
  seq       := item+
  item      := '(' seq ')' ['^' int] | '[' layer ']' ['^' int]
             | simple ['^' int] | '{}'
  layer     := simple*                (possibly empty => global idle '[]')
  simple    := name (';' arg)* (':' sslbl)* ['!' time]
  name      := G[a-z0-9_]+ | rho[a-z0-9_]* | M[a-z0-9_]* | I[a-z0-9_]*
  sslbl     := int | ident

Labels with arguments (``name;arg:q``) parse to LabelTupWithArgs; the
arguments stay strings, as in the JAX package.
"""

from __future__ import annotations

import functools
import re

from pygsti_tpu_torch.baseobjs.label import Label, LabelTupTup

_NAME_RE = re.compile(r'[a-zA-Z_][a-zA-Z0-9_]*')
# an upper-case letter terminates a name, so adjacent labels need no separator
_GATE_NAME_RE = re.compile(r'G[a-z0-9_]+|rho[a-z0-9_]*|M[a-z0-9_]*|I[a-z0-9_]*')
_INT_RE = re.compile(r'[0-9]+')
_SSLBL_RE = re.compile(r'[a-zA-Z_][a-z0-9_]*')
_TIME_RE = re.compile(r'[-+0-9.eE]+')
_ARG_RE = re.compile(r'[-+0-9.eE]+|[a-zA-Z_][a-zA-Z0-9_]*')


class _Parser:
    def __init__(self, s):
        self.s = s
        self.i = 0
        self.n = len(s)

    def peek(self):
        return self.s[self.i] if self.i < self.n else ''

    def error(self, msg):
        raise ValueError("Circuit parse error at pos %d of %r: %s"
                         % (self.i, self.s, msg))

    def parse_int(self):
        m = _INT_RE.match(self.s, self.i)
        if not m:
            self.error("expected integer")
        self.i = m.end()
        return int(m.group())

    def parse_name(self):
        m = _GATE_NAME_RE.match(self.s, self.i) or _NAME_RE.match(self.s, self.i)
        if not m:
            self.error("expected name")
        self.i = m.end()
        return m.group()

    def parse_sslbl(self):
        m = _INT_RE.match(self.s, self.i)
        if m:
            self.i = m.end()
            return int(m.group())
        m = _SSLBL_RE.match(self.s, self.i)
        if m:
            self.i = m.end()
            return m.group()
        self.error("expected state-space label")

    def parse_simple(self):
        name = self.parse_name()
        args = []
        while self.peek() == ';':
            self.i += 1
            m = _ARG_RE.match(self.s, self.i)
            if not m:
                self.error("expected label argument")
            args.append(m.group())
            self.i = m.end()
        sslbls = []
        while self.peek() == ':':
            self.i += 1
            sslbls.append(self.parse_sslbl())
        if self.peek() == '!':  # time suffix: parsed and ignored
            self.i += 1
            m = _TIME_RE.match(self.s, self.i)
            if not m:
                self.error("expected time")
            self.i = m.end()
        if args:
            return Label(name, tuple(sslbls), args=tuple(args))
        return Label(name, tuple(sslbls)) if sslbls else Label(name)

    def parse_item(self):
        """Returns a list of layer labels."""
        c = self.peek()
        if c == '{':
            if self.s[self.i:self.i + 2] != '{}':
                self.error("expected '{}'")
            self.i += 2
            return []
        if c == '(':
            self.i += 1
            layers = self.parse_seq(stop=')')
            if self.peek() != ')':
                self.error("expected ')'")
            self.i += 1
            return layers * self.parse_reps()
        if c == '[':
            self.i += 1
            comps = []
            while self.peek() not in (']', ''):
                comps.append(self.parse_simple())
            if self.peek() != ']':
                self.error("expected ']'")
            self.i += 1
            layer = comps[0] if len(comps) == 1 else LabelTupTup.init(tuple(comps))
            return [layer] * self.parse_reps()
        lbl = self.parse_simple()
        return [lbl] * self.parse_reps()

    def parse_reps(self):
        if self.peek() == '^':
            self.i += 1
            return self.parse_int()
        return 1

    def parse_seq(self, stop=None):
        layers = []
        while True:
            c = self.peek()
            if c == '' or c == '@' or (stop and c == stop):
                break
            layers.extend(self.parse_item())
        return layers

    def parse_line_labels(self):
        self.i += 1  # '@'
        if self.peek() == '*':
            self.i += 1
            return ('*',)
        if self.peek() != '(':
            self.error("expected '(' after '@'")
        self.i += 1
        lbls = []
        while self.peek() != ')':
            if self.peek() == '':
                self.error("expected ')'")
            lbls.append(self.parse_sslbl())
            if self.peek() == ',':
                self.i += 1
        self.i += 1
        return tuple(lbls)


@functools.lru_cache(maxsize=262144)
def parse_circuit_str(s):
    """Parse a circuit string -> (tuple_of_layer_labels, line_labels_or_None).
    Memoized: circuit strings repeat heavily, and the result is immutable."""
    s = s.strip()
    p = _Parser(s)
    layers = p.parse_seq()
    line_labels = p.parse_line_labels() if p.peek() == '@' else None
    if p.i != p.n:
        p.error("trailing characters")
    return tuple(layers), line_labels


def parse_label_str(s):
    """Parse a single label string like 'Gxpi2:0', '[]' or 'rho0'."""
    layers, _ = parse_circuit_str(s)
    if len(layers) != 1:
        raise ValueError("Expected a single label, got %d layers from %r"
                         % (len(layers), s))
    return layers[0]
