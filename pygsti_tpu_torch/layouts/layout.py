"""Circuit compilation: circuits -> padded index arrays + element maps, host
numpy (counterpart of pygsti_tpu/layouts/layout.py).

Every circuit becomes one or more rows of int32 operation indices padded
with a virtual identity op: one row per combination of the members of the
instruments it holds, each instrument replaced by the member's
pseudo-operation.  Each (row, outcome) pair becomes one element, and a
circuit's outcomes are its rows' member labels followed by the POVM's
outcome, e.g. ('p0', '00').

With ``observed_outcomes_only`` the elements whose outcome has no counts
in the dataset are left out; the objective puts their probability mass
back as one zero-frequency term per circuit (the omitted-probability
correction), so the objective's value is kept while the element count
shrinks.
"""

from __future__ import annotations

import itertools
import weakref

import numpy as np

from pygsti_tpu_torch.baseobjs.label import Label, LabelStr, LabelTupTup
from pygsti_tpu_torch.circuits.circuit import Circuit


class CircuitOutcomeProbabilityLayout(object):
    """Compiled layout for a list of circuits against a model's structure.

      op_keys         : the model's op stack the indices refer to
      op_indices      : int32 [n_rows, max_depth], padded with identity_index
      depths          : int32 [n_rows]
      prep_index      : int32 [n_rows]  (row into the stacked preps)
      row_circuit     : int32 [n_rows]  (circuit index per row)
      elem_circuit    : int32 [n_elements]  (row index per element)
      elem_effect     : int32 [n_elements]  (row into the stacked effects)
      elem_to_circuit : int32 [n_elements]  (circuit index per element)
      element_slices  : per circuit, its slice of the elements
      outcomes        : per circuit, its outcome tuples
      omitted_firsts  : int32, first element of each circuit with omitted
                        outcomes; omitted_circuits: those circuits
    """

    def __init__(self, circuits, model, dataset=None, observed_outcomes_only=False):
        self.circuits = [c if isinstance(c, Circuit) else Circuit(c) for c in circuits]
        # a parallel layer becomes a composite layer of the model's op stack
        model.register_circuit_layers(self.circuits)
        self.op_keys = tuple(model.op_keys)
        op_index_map = {k: i for i, k in enumerate(self.op_keys)}
        # a bare gate name (the legacy packs' 'Gx' on line '*') that names
        # exactly one operation keyed with state-space labels ('Gx:T0')
        # stands for that operation; op_keys are left as they are
        by_name = {}
        for k, i in op_index_map.items():
            name = getattr(k, 'name', None)
            if name is not None and name != k:
                by_name.setdefault(name, []).append(i)
        for name, idxs in by_name.items():
            if len(idxs) == 1 and name not in op_index_map:
                op_index_map[Label(name)] = idxs[0]
        prep_index_map = {k: i for i, k in enumerate(model.prep_keys)}
        povm_rows = model.povm_effect_rows()
        instruments = model.instruments
        self.identity_index = len(self.op_keys)   # appended by the simulators
        self.num_ops = len(self.op_keys)

        seqs, prep_rows, povm_lbls, prefixes, row_circuit = [], [], [], [], []
        for b, c in enumerate(self.circuits):
            layers = list(c.layertup)
            if layers and isinstance(layers[0], LabelStr) and layers[0] in model.preps:
                prep_lbl = layers.pop(0)
            else:
                prep_lbl = model._default_prep_label()
            if layers and isinstance(layers[-1], LabelStr) and layers[-1] in model.povms:
                povm_lbl = layers.pop()
            else:
                povm_lbl = model._default_povm_label()
            inst_at = [t for t, l in enumerate(layers) if l in instruments]
            # one row per combination of instrument members
            for combo in itertools.product(*[instruments[layers[t]].member_labels
                                             for t in inst_at]):
                keys = list(layers)
                for t, member in zip(inst_at, combo):
                    keys[t] = ('INSTRUMENT', layers[t], member)
                try:
                    seqs.append([op_index_map[k] for k in keys])
                except KeyError as e:
                    raise KeyError("Circuit layer %s is not an operation of the "
                                   "model (circuit %s)" % (e.args[0], c.str))
                prep_rows.append(prep_index_map[prep_lbl])
                povm_lbls.append(povm_lbl)
                prefixes.append(tuple(combo))
                row_circuit.append(b)

        n_rows = len(seqs)
        self.num_rows = n_rows
        self.depths = np.array([len(s) for s in seqs], dtype=np.int32)
        D = int(self.depths.max()) if n_rows > 0 else 0
        self.op_indices = np.full((n_rows, D), self.identity_index, dtype=np.int32)
        for r, s in enumerate(seqs):
            self.op_indices[r, :len(s)] = s
        self.prep_index = np.array(prep_rows, dtype=np.int32)
        self.row_circuit = np.array(row_circuit, dtype=np.int32)
        self.max_depth = D

        elem_circuit, elem_effect, elem_to_circuit = [], [], []
        self.element_slices, self.outcomes = [], []
        omitted_firsts, omitted_circuits = [], []
        row_nouts = set()
        off = 0
        r = 0
        for b, c in enumerate(self.circuits):
            start, full_n, circ_outcomes = off, 0, []
            sparse = observed_outcomes_only and dataset is not None and c in dataset
            row_counts = dataset[c].counts if sparse else None
            while r < n_rows and row_circuit[r] == b:
                row_slice, outcome_labels = povm_rows[povm_lbls[r]]
                effects = list(range(row_slice.start, row_slice.stop))
                outs = [prefixes[r] + (ol,) for ol in outcome_labels]
                full_n += len(effects)
                if sparse:
                    # an outcome recorded with zero counts is omitted too:
                    # simulated data records every outcome
                    keep = [i for i, o in enumerate(outs) if row_counts.get(o, 0) > 0]
                    effects = [effects[i] for i in keep]
                    outs = [outs[i] for i in keep]
                n = len(effects)
                row_nouts.add(n)
                elem_circuit.extend([r] * n)
                elem_effect.extend(effects)
                elem_to_circuit.extend([b] * n)
                circ_outcomes.extend(outs)
                off += n
                r += 1
            self.element_slices.append(slice(start, off))
            self.outcomes.append(circ_outcomes)
            if 0 < off - start < full_n:
                omitted_firsts.append(start)
                omitted_circuits.append(b)
        self.elem_circuit = np.array(elem_circuit, dtype=np.int32)
        self.elem_effect = np.array(elem_effect, dtype=np.int32)
        self.elem_to_circuit = np.array(elem_to_circuit, dtype=np.int32)
        self.num_elements = off
        self.rows_uniform_n_out = len(row_nouts) <= 1
        self.omitted_firsts = np.array(omitted_firsts, dtype=np.int32)
        self.omitted_circuits = np.array(omitted_circuits, dtype=np.int32)
        self.has_omitted = len(omitted_firsts) > 0
        self._counts_cache = weakref.WeakKeyDictionary()

    def __len__(self):
        return self.num_elements

    def check_op_stack(self, model):
        """Make sure this layout's op indices mean `model`'s op stack.  The
        layout's composite layers are registered with `model` first (a
        model that never saw these circuits); a model whose op stack has
        changed since, by composite layers registered later for other
        circuits, is refused: its identity and instrument slots have moved."""
        for k in self.op_keys:
            if isinstance(k, LabelTupTup):
                model._register_layer(k)
        if tuple(model.op_keys) != self.op_keys:
            raise ValueError("the layout was built for another op stack (%d slots; the model "
                             "now has %d): create the layout again"
                             % (len(self.op_keys), len(model.op_keys)))

    @property
    def num_circuits(self):
        return len(self.circuits)

    def counts_arrays(self, dataset):
        """(counts, total_counts) flat element arrays from a dataset; each
        element of a circuit carries the circuit's total.  Cached per
        dataset (the stages of a nested fit share one layout); the arrays
        returned are the caller's own."""
        hit = self._counts_cache.get(dataset)
        if hit is None:
            counts = np.zeros(self.num_elements)
            totals = np.zeros(self.num_elements)
            for b, c in enumerate(self.circuits):
                row = dataset[c]
                sl = self.element_slices[b]
                totals[sl] = row.total
                counts[sl] = [row.counts.get(o, 0) for o in self.outcomes[b]]
            hit = self._counts_cache[dataset] = (counts, totals)
        return hit[0].copy(), hit[1].copy()
