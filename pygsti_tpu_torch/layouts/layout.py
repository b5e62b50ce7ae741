"""Circuit compilation: circuits -> padded index arrays + element maps, host
numpy (counterpart of pygsti_tpu/layouts/layout.py, without instruments or
sparse outcomes).

Every circuit becomes a row of int32 operation indices padded with a
virtual identity op, and each (circuit, outcome) pair becomes one element.
"""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.baseobjs.label import LabelStr
from pygsti_tpu_torch.circuits.circuit import Circuit


class CircuitOutcomeProbabilityLayout(object):
    """Compiled layout for a list of circuits against a model's structure.

      op_indices     : int32 [n_circuits, max_depth], padded with identity_index
      depths         : int32 [n_circuits]
      prep_index     : int32 [n_circuits]  (row into the stacked preps)
      elem_circuit   : int32 [n_elements]  (circuit index per element)
      elem_effect    : int32 [n_elements]  (row into the stacked effects)
      element_slices : per circuit, its slice of the elements
      outcomes       : per circuit, its outcome tuples
    """

    def __init__(self, circuits, model):
        self.circuits = [c if isinstance(c, Circuit) else Circuit(c) for c in circuits]
        op_index_map = {k: i for i, k in enumerate(model.op_keys)}
        prep_index_map = {k: i for i, k in enumerate(model.prep_keys)}
        povm_rows = model.povm_effect_rows()
        self.identity_index = len(model.op_keys)   # appended by the simulators
        self.num_ops = len(model.op_keys)

        seqs, prep_rows, povm_lbls = [], [], []
        for c in self.circuits:
            layers = list(c.layertup)
            if layers and isinstance(layers[0], LabelStr) and layers[0] in model.preps:
                prep_lbl = layers.pop(0)
            else:
                prep_lbl = model._default_prep_label()
            if layers and isinstance(layers[-1], LabelStr) and layers[-1] in model.povms:
                povm_lbl = layers.pop()
            else:
                povm_lbl = model._default_povm_label()
            try:
                seqs.append([op_index_map[l] for l in layers])
            except KeyError as e:
                raise KeyError("Circuit layer %s is not an operation of the "
                               "model (circuit %s)" % (e.args[0], c.str))
            prep_rows.append(prep_index_map[prep_lbl])
            povm_lbls.append(povm_lbl)

        B = len(seqs)
        self.depths = np.array([len(s) for s in seqs], dtype=np.int32)
        D = int(self.depths.max()) if B > 0 else 0
        self.op_indices = np.full((B, D), self.identity_index, dtype=np.int32)
        for r, s in enumerate(seqs):
            self.op_indices[r, :len(s)] = s
        self.prep_index = np.array(prep_rows, dtype=np.int32)
        self.max_depth = D

        elem_circuit, elem_effect = [], []
        self.element_slices, self.outcomes = [], []
        n_outs = set()
        off = 0
        for b, povm_lbl in enumerate(povm_lbls):
            row_slice, outcome_labels = povm_rows[povm_lbl]
            n = row_slice.stop - row_slice.start
            n_outs.add(n)
            elem_circuit.extend([b] * n)
            elem_effect.extend(range(row_slice.start, row_slice.stop))
            self.element_slices.append(slice(off, off + n))
            self.outcomes.append([(ol,) for ol in outcome_labels])
            off += n
        self.elem_circuit = np.array(elem_circuit, dtype=np.int32)
        self.elem_effect = np.array(elem_effect, dtype=np.int32)
        self.num_elements = off
        self.rows_uniform_n_out = len(n_outs) <= 1

    def __len__(self):
        return self.num_elements

    @property
    def num_circuits(self):
        return len(self.circuits)

    def counts_arrays(self, dataset):
        """(counts, total_counts) flat element arrays from a dataset; each
        element of a circuit carries the circuit's total."""
        counts = np.zeros(self.num_elements)
        totals = np.zeros(self.num_elements)
        for b, c in enumerate(self.circuits):
            row = dataset[c]
            total = row.total
            start = self.element_slices[b].start
            for k, outcome in enumerate(self.outcomes[b]):
                counts[start + k] = row.counts.get(outcome, 0)
                totals[start + k] = total
        return counts, totals
