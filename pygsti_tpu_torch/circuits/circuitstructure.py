"""Plaquette-structured circuit lists (counterpart of
pygsti_tpu/circuits/circuitstructure.py): a CircuitPlaquette is one (row,
col) grid of circuits; the fiducial-pair plaquettes are the ones that
``make_lsgst_structs`` and ``create_cloudnoise_circuits`` build."""

from __future__ import annotations

import collections

from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.circuits.circuitlist import CircuitList


class CircuitPlaquette(object):
    """The circuits of one cell of a circuit structure, keyed (row, col);
    the grid's size defaults to the largest keys."""

    def __init__(self, elements, num_rows=None, num_cols=None, op_label_aliases=None):
        self.elements = collections.OrderedDict(elements)
        self.op_label_aliases = op_label_aliases
        if num_rows is None:
            num_rows = max([i for i, _ in self.elements], default=-1) + 1
        if num_cols is None:
            num_cols = max([j for _, j in self.elements], default=-1) + 1
        self.num_rows = num_rows
        self.num_cols = num_cols

    def __iter__(self):
        return iter(self.elements.items())

    def __len__(self):
        return len(self.elements)

    @property
    def circuits(self):
        return list(self.elements.values())

    def elementvec_to_matrix(self, elementvec, layout, mergeop="sum"):
        """A per-element vector (per-circuit chi2 contributions, say)
        arranged on this plaquette's (num_rows, num_cols) grid: each cell
        the sum ('sum') or the value of its circuit's elements in `layout`,
        nan where the layout lacks the circuit."""
        import numpy as np
        mx = np.full((self.num_rows, self.num_cols), np.nan)
        for (i, j), c in self.elements.items():
            sl = layout.indices(c) if hasattr(layout, 'indices') else None
            if sl is None:
                continue
            vals = elementvec[sl]
            mx[i, j] = float(np.sum(vals)) if mergeop == "sum" else float(vals)
        return mx

    def process_circuits(self, processor_fn, updated_aliases=None):
        """This plaquette with `processor_fn` applied to every circuit."""
        return CircuitPlaquette({k: processor_fn(c) for k, c in self.elements.items()},
                                self.num_rows, self.num_cols, updated_aliases)

    def summary_label(self):
        return "%d circuits" % len(self)


class FiducialPairPlaquette(CircuitPlaquette):
    """Circuits prep_fid + base + meas_fid, keyed (meas_index, prep_index)."""

    def __init__(self, base, fidpairs, num_rows=None, num_cols=None,
                 op_label_aliases=None):
        self.base = base
        self.fidpairs = collections.OrderedDict(fidpairs)
        self.elements = collections.OrderedDict(
            ((i, j), prep + base + meas)
            for (i, j), (prep, meas) in self.fidpairs.items())
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.op_label_aliases = op_label_aliases

    def process_circuits(self, processor_fn, updated_aliases=None):
        return FiducialPairPlaquette(
            processor_fn(self.base),
            {k: (processor_fn(p), processor_fn(m)) for k, (p, m) in self.fidpairs.items()},
            self.num_rows, self.num_cols, updated_aliases)


class GermFiducialPairPlaquette(FiducialPairPlaquette):
    """FiducialPairPlaquette whose base is germ^power."""

    def __init__(self, germ, power, fidpairs, num_rows=None, num_cols=None,
                 op_label_aliases=None):
        self.germ = germ
        self.power = power
        base = germ.repeat(power) if power > 0 else Circuit((), germ.line_labels)
        super().__init__(base, fidpairs, num_rows, num_cols, op_label_aliases)


class PlaquetteGridCircuitStructure(CircuitList):
    """A CircuitList made of plaquettes on an (L, germ) grid, with extra
    circuits (the LGST set) first."""

    def __init__(self, plaquettes, x_values, y_values, xlabel, ylabel,
                 additional_circuits=None, op_label_aliases=None, name=None):
        self._plaquettes = collections.OrderedDict(plaquettes)
        self.xs = list(x_values)
        self.ys = list(y_values)
        self.xlabel = xlabel
        self.ylabel = ylabel
        circuits = collections.OrderedDict(
            (c, None) for c in (additional_circuits or []))
        for plaq in self._plaquettes.values():
            circuits.update((c, None) for c in plaq.circuits)
        super().__init__(list(circuits.keys()), op_label_aliases, name)

    @property
    def plaquettes(self):
        return self._plaquettes

    def plaquette(self, x, y, empty_if_missing=False):
        """The plaquette at (x, y); None when absent and
        `empty_if_missing`, else KeyError."""
        if (x, y) in self._plaquettes:
            return self._plaquettes[(x, y)]
        if empty_if_missing:
            return None
        raise KeyError("No plaquette at (%s, %s)" % (x, y))
