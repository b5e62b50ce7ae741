"""Circuit designs as files: written once, read by the program's side and by
the reference alike.

A design file is JSON: ``layers`` is the table of distinct circuit layers,
each a list of components [gate name, qubit, ...] (the empty list is the
idle layer); ``circuits`` gives each circuit as indices into that table;
``list_ends`` the length of each nested circuit list (every list a prefix
of the next); ``line_labels`` the qubits; ``written_by`` the call that
wrote it.
"""

from __future__ import annotations

import json

import numpy as np


def load(path):
    with open(path) as fh:
        d = json.load(fh)
    d['depths'] = [len(c) for c in d['circuits']]
    return d


def seqs_array(design):
    """[N, D] int64 layer indices, -1 past each circuit's end."""
    circuits = design['circuits']
    out = np.full((len(circuits), max(design['depths'])), -1, dtype=np.int64)
    for i, c in enumerate(circuits):
        out[i, :len(c)] = c
    return out


def check(design, cfg):
    """Raise unless the design has the configuration's circuit count,
    largest depth and list ends, each circuit once."""
    if len(set(map(tuple, design['circuits']))) != len(design['circuits']):
        raise SystemExit("design %s repeats a circuit" % cfg['design'])
    got = (len(design['circuits']), max(design['depths']), design['list_ends'])
    want = (cfg['circuits'], cfg['max_depth'], cfg['list_ends'])
    if got != tuple(want):
        raise SystemExit("design %s: %d circuits, depth up to %d, lists %s; the configuration "
                         "states %d, %d, %s" % ((cfg['design'],) + got + tuple(want)))


def port_circuits(design):
    """The design's circuits as the program's Circuit objects."""
    from pygsti_tpu_torch.baseobjs.label import Label, LabelTupTup
    from pygsti_tpu_torch.circuits.circuit import Circuit

    def layer_label(layer):
        comps = [Label(c[0], tuple(c[1:])) for c in layer]
        if not comps:
            return Label(())
        return comps[0] if len(comps) == 1 else LabelTupTup.init(tuple(comps))

    table = [layer_label(l) for l in design['layers']]
    lines = tuple(design['line_labels'])
    return [Circuit(tuple(table[i] for i in c), lines) for c in design['circuits']]


def from_port_circuits(circuits, list_ends, written_by):
    """The design (module note) of the program's Circuit objects."""
    table, index, rows = [], {}, []
    for c in circuits:
        row = []
        for layer in c.layertup:
            key = tuple((comp.name,) + tuple(comp.sslbls or ()) for comp in layer.components)
            if key not in index:
                index[key] = len(table)
                table.append([list(k) for k in key])
            row.append(index[key])
        rows.append(row)
    return {'written_by': written_by, 'line_labels': list(circuits[0].line_labels),
            'list_ends': list(list_ends), 'layers': table, 'circuits': rows}


def write(path, design):
    with open(path, 'w') as fh:
        fh.write('{\n')
        for k in ('written_by', 'line_labels', 'list_ends', 'layers'):
            fh.write('%s: %s,\n' % (json.dumps(k), json.dumps(design[k])))
        fh.write('"circuits": [\n')
        fh.write(',\n'.join(json.dumps(r, separators=(',', ':')) for r in design['circuits']))
        fh.write('\n]\n}\n')
