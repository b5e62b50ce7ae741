"""Helpers for building nested circuit-list structures ("locking" designs)
(counterpart of pygsti_tpu/tools/locking.py)."""

import numpy as _np

from pygsti_tpu_torch.circuits.circuit import Circuit as _Circuit


def histonested_circuitlists(circuits, bins='auto-int', trans='log'):
    """Bin `circuits` by (transformed) length into nested circuit lists
    suitable for CircuitListsDesign(..., nested=True) (reference
    locking.py:25): list i contains every circuit whose length falls in
    bin <= i, so the lists are nested by construction."""
    assert len(circuits) > 0
    lengths = _np.array([len(c) + 1 for c in circuits])
    if isinstance(bins, str) and 'auto' in bins and 'int' in bins:
        bins = int(_np.log2(_np.max(lengths)))
    if isinstance(trans, _np.ufunc):
        lengths = trans(lengths)
    elif trans == 'log':
        lengths = _np.log2(lengths)
    elif (trans != 'none') and (trans is not None):
        raise ValueError('Argument `trans` had unsupported value, '
                         '{}.'.format(trans))
    counts, edges = _np.histogram(lengths, bins)
    edges = _np.concatenate([[edges[0]], edges[1:][counts > 0]])
    assignments = _np.digitize(lengths, edges) - 1
    num_bins = edges.size - 1
    circuit_lists = [list() for _ in range(num_bins)]
    for j, c in zip(assignments, circuits):
        for i in range(min(int(j), num_bins - 1), num_bins):
            circuit_lists[i].append(c)
    return circuit_lists


def logspaced_prefix_circuits(c, povms_to_keep=('Mdefault',), base=2,
                              editable=False):
    """Successively halve (by `base`) a circuit into its prefixes, keeping a
    trailing POVM label in place on each prefix (reference locking.py:65).
    Our circuits are immutable, so `editable` is accepted for signature
    parity and ignored."""
    povm_names = {str(p) for p in povms_to_keep}
    layers = c.layertup if hasattr(c, 'layertup') else tuple(c)
    if len(layers) > 0 and str(layers[-1]) in povm_names:
        povm_lbl = layers[-1]
        body = _Circuit(layers[:-1], c.line_labels)
        return [_Circuit(p.layertup + (povm_lbl,), c.line_labels)
                for p in logspaced_prefix_circuits(body, (), base)]

    assert base > 1
    circuits = [c]
    next_len = int(len(layers) // base)
    while next_len > 0:
        layers = layers[:next_len]
        circuits.append(_Circuit(layers, c.line_labels))
        next_len = int(len(layers) // base)
    return circuits
