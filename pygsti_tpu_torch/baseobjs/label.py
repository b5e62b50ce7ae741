"""Circuit-layer labels (counterpart of pygsti_tpu/baseobjs/label.py).

* ``LabelTup``    -- a gate name plus the qubits it acts on, e.g.
                     ``Label('Gxpi2', 0)`` <-> ``"Gxpi2:0"``.
* ``LabelStr``    -- a bare name, e.g. ``Label('rho0')``.
* ``LabelTupTup`` -- a layer of parallel simple labels; ``Label(())`` is the
                     empty layer (global idle), printed ``"[]"``.
* ``LabelTupWithArgs`` -- a simple label with arguments, e.g.
                     ``Label('Gzr', (0,), args=('0.5',))`` <-> ``"Gzr;0.5:0"``:
                     the operation an op factory makes for those arguments.
* ``LabelTupWithTime`` / ``LabelTupTupWithTime`` -- a simple label or a layer
                     with a start time, stored as ``('@TIME', name, time,
                     sslbls)`` and ``(('@TTIME', time), *components)``: the
                     JAX package's tuples, so the two packages' labels hash
                     and compare alike.  ``Label(..., time=t)`` takes the
                     time and ignores it, as the JAX package's factory does.
* ``LabelTupTupWithArgs`` -- a layer with arguments of its own.
* ``CircuitLabel`` -- a named, repeatable sub-circuit as one layer label.

Labels are immutable, hashable, compare equal to the equivalent plain tuple
or string, and serve as dict keys in models.
"""

from __future__ import annotations


class Label(object):
    """Factory: dispatches to LabelTup / LabelStr / LabelTupTup."""

    def __new__(cls, name, state_space_labels=None, time=None, args=None):
        if isinstance(name, (LabelTup, LabelStr, LabelTupTup)):
            return name
        if args:
            if isinstance(state_space_labels, (int, str)):
                state_space_labels = (state_space_labels,)
            return LabelTupWithArgs.init(name, tuple(state_space_labels or ()), args)
        if state_space_labels is not None:
            if isinstance(state_space_labels, (int, str)):
                state_space_labels = (state_space_labels,)
            return LabelTup.init(name, tuple(state_space_labels))
        if isinstance(name, str):
            return LabelStr(name)
        if isinstance(name, (tuple, list)):
            if len(name) == 0:
                return LabelTupTup.init(())
            if isinstance(name[0], str):
                return LabelTup.init(name[0], tuple(name[1:]))
            return LabelTupTup.init(tuple(Label(sub) for sub in name))
        raise ValueError("Cannot create Label from %r" % (name,))


_label_intern = {}


class LabelTup(tuple):
    """A simple label: (name, *state_space_labels); interned."""

    __slots__ = ()

    @classmethod
    def init(cls, name, sslbls):
        if len(sslbls) == 0:
            return LabelStr(name)
        key = (name,) + tuple(sslbls)
        cached = _label_intern.get(key)
        if cached is None:
            cached = tuple.__new__(cls, key)
            _label_intern[key] = cached
        return cached

    def __new__(cls, tup):
        return tuple.__new__(cls, tup)

    @property
    def name(self):
        return self[0]

    @property
    def sslbls(self):
        return tuple(self[1:])

    @property
    def components(self):
        return (self,)

    @property
    def is_simple(self):
        return True

    def map_state_space_labels(self, mapper):
        """This label with each state-space label s replaced by mapper[s]
        (or mapper(s) when `mapper` is a function)."""
        m = mapper.__getitem__ if hasattr(mapper, '__getitem__') else mapper
        return LabelTup.init(self.name, tuple(m(s) for s in self.sslbls))

    def __str__(self):
        return self.name + ":" + ":".join(str(s) for s in self.sslbls)

    def __repr__(self):
        return "Label(%s)" % str(tuple(self))

    def __reduce__(self):
        return (LabelTup, (tuple(self),))


class LabelTupWithArgs(LabelTup):
    """A simple label with extra (non-state-space) arguments, stored as
    ('@ARGS', name, args, sslbls)."""

    __slots__ = ()

    @classmethod
    def init(cls, name, sslbls, args):
        return tuple.__new__(cls, ('@ARGS', name, tuple(args), tuple(sslbls)))

    @property
    def name(self):
        return self[1]

    @property
    def args(self):
        return self[2]

    @property
    def sslbls(self):
        return self[3]

    def map_state_space_labels(self, mapper):
        m = mapper.__getitem__ if hasattr(mapper, '__getitem__') else mapper
        return LabelTupWithArgs.init(self.name, tuple(m(s) for s in self.sslbls), self.args)

    def __str__(self):
        s = self.name + ";" + ";".join(str(a) for a in self.args)
        return s + "".join(":" + str(x) for x in self.sslbls)

    def __repr__(self):
        return "Label(%s, args=%s)" % (str((self.name,) + self.sslbls), self.args)

    def __reduce__(self):
        return (LabelTupWithArgs.init, (self.name, self.sslbls, self.args))


class LabelStr(str):
    """A label that is just a name (no state-space labels), e.g. 'rho0'."""

    __slots__ = ()

    @property
    def name(self):
        return str(self)

    @property
    def sslbls(self):
        return None

    @property
    def components(self):
        return (self,)

    @property
    def is_simple(self):
        return True

    def map_state_space_labels(self, mapper):
        return self

    def __repr__(self):
        return "Label('%s')" % str(self)

    def __reduce__(self):
        return (LabelStr, (str(self),))


class LabelTupTup(tuple):
    """A layer label: a tuple of parallel simple labels."""

    __slots__ = ()

    @classmethod
    def init(cls, component_labels):
        return tuple.__new__(cls, tuple(component_labels))

    def __new__(cls, tup):
        return tuple.__new__(cls, tup)

    @property
    def name(self):
        return "COMPOUND"

    @property
    def sslbls(self):
        if len(self) == 0:
            return None
        s = []
        for comp in self:
            if comp.sslbls is None:
                return None
            s.extend(comp.sslbls)
        return tuple(s)

    @property
    def components(self):
        return tuple(self)

    @property
    def is_simple(self):
        return False

    def map_state_space_labels(self, mapper):
        return LabelTupTup.init(tuple(c.map_state_space_labels(mapper) for c in self))

    def __str__(self):
        return "[" + "".join(str(c) for c in self) + "]"

    def __repr__(self):
        return "Label(%s)" % str(self)

    def __reduce__(self):
        return (LabelTupTup, (tuple(self),))


class LabelTupWithTime(LabelTup):
    """A simple label with a (relative) start time, stored as
    ('@TIME', name, time, sslbls)."""

    __slots__ = ()

    @classmethod
    def init(cls, name, sslbls, time=0.0):
        return tuple.__new__(cls, ('@TIME', name, float(time), tuple(sslbls)))

    @property
    def name(self):
        return self[1]

    @property
    def time(self):
        return self[2]

    @property
    def sslbls(self):
        return self[3]

    @property
    def args(self):
        return ()

    def map_state_space_labels(self, mapper):
        m = mapper.__getitem__ if hasattr(mapper, '__getitem__') else mapper
        return LabelTupWithTime.init(self.name, tuple(m(s) for s in self.sslbls), self.time)

    def __str__(self):
        s = self.name + "".join(":" + str(x) for x in self.sslbls)
        if self.time != 0.0:
            s += "!%g" % self.time
        return s

    def __repr__(self):
        return "Label(%s, time=%g)" % (str((self.name,) + self.sslbls), self.time)

    def __reduce__(self):
        return (LabelTupWithTime.init, (self.name, self.sslbls, self.time))


class LabelTupTupWithTime(LabelTupTup):
    """A layer label with a start time, stored as
    (('@TTIME', time), *components)."""

    __slots__ = ()

    @classmethod
    def init(cls, component_labels, time=0.0):
        return tuple.__new__(cls, (('@TTIME', float(time)),) + tuple(component_labels))

    @property
    def time(self):
        return self[0][1]

    @property
    def components(self):
        return tuple(self[1:])

    @property
    def sslbls(self):
        s = []
        for comp in self.components:
            if comp.sslbls is None:
                return None
            s.extend(comp.sslbls)
        return tuple(s) if s else None

    def map_state_space_labels(self, mapper):
        return LabelTupTupWithTime.init(
            tuple(c.map_state_space_labels(mapper) for c in self.components), self.time)

    def __str__(self):
        return "[" + "".join(str(c) for c in self.components) + "]"

    def __reduce__(self):
        return (LabelTupTupWithTime.init, (self.components, self.time))


class LabelTupTupWithArgs(LabelTupTup):
    """A layer label that carries arguments of its own, beside any of its
    components', stored as (('@LARGS', *args), *components)."""

    __slots__ = ()

    @classmethod
    def init(cls, component_labels, args):
        return tuple.__new__(cls, (('@LARGS',) + tuple(args),) + tuple(component_labels))

    @property
    def args(self):
        return tuple(self[0][1:])

    @property
    def components(self):
        return tuple(self[1:])

    @property
    def sslbls(self):
        s = []
        for comp in self.components:
            if comp.sslbls is None:
                return None
            s.extend(comp.sslbls)
        return tuple(s) if s else None

    def map_state_space_labels(self, mapper):
        return LabelTupTupWithArgs.init(
            tuple(c.map_state_space_labels(mapper) for c in self.components), self.args)

    def __str__(self):
        return "[" + "".join(str(c) for c in self.components) + ";" + \
            ";".join(str(a) for a in self.args) + "]"

    def __reduce__(self):
        return (LabelTupTupWithArgs.init, (self.components, self.args))


class CircuitLabel(tuple):
    """A sub-circuit as one (repeatable) layer label: a name, the lines it
    acts on, a repetition count and its layers, stored as (name, sslbls,
    reps, *layers).  Its string is ``name(layers)^reps``, which the parser
    reads as the JAX package's does: the name as a label of its own, then
    the expanded layers."""

    __slots__ = ()

    def __new__(cls, name, tup_of_layers, state_space_labels, reps=1, time=None):
        sslbls = tuple(state_space_labels) if state_space_labels is not None else None
        return tuple.__new__(cls, (str(name), sslbls, int(reps)) + tuple(tup_of_layers))

    @property
    def name(self):
        return self[0]

    @property
    def sslbls(self):
        return self[1]

    @property
    def reps(self):
        return self[2]

    @property
    def components(self):
        return self[3:]

    @property
    def args(self):
        return ()

    @property
    def time(self):
        return 0.0

    @property
    def qubits(self):
        return self.sslbls

    @property
    def is_simple(self):
        return True

    @property
    def depth(self):
        return sum(getattr(layer, 'depth', 1) for layer in self.components) * self.reps

    def expand_subcircuits(self):
        """The tuple of layer labels this label stands for."""
        return self.components * self.reps

    def map_state_space_labels(self, mapper):
        m = mapper.__getitem__ if hasattr(mapper, '__getitem__') else mapper
        return CircuitLabel(self.name,
                            tuple(c.map_state_space_labels(mapper) for c in self.components),
                            tuple(m(x) for x in self.sslbls) if self.sslbls else None,
                            self.reps)

    def __str__(self):
        s = self.name + "(" + "".join(str(c) for c in self.components) + ")"
        return s + ("^%d" % self.reps if self.reps != 1 else "")

    def __repr__(self):
        return "CircuitLabel(%r, %s, %s, %d)" % (self.name, self.components, self.sslbls,
                                                 self.reps)

    def __reduce__(self):
        return (CircuitLabel, (self.name, self.components, self.sslbls, self.reps))
