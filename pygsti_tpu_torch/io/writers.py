"""Writers of the text formats (counterpart of pygsti_tpu/io/writers.py).

For the same dataset, circuit list or model each text writer writes the
same bytes as the JAX package's, so a file written by either package reads
in the other.
"""

from __future__ import annotations

import os

from pygsti_tpu_torch.baseobjs.outcomelabeldict import OutcomeLabelDict
from pygsti_tpu_torch.circuits.circuit import Circuit


def _ol_str(o):
    return ":".join(o) if isinstance(o, tuple) else str(o)


def write_circuit_list(filename, circuits, header=None):
    with open(filename, 'w') as f:
        if header:
            f.write("# %s\n" % header)
        for c in circuits:
            f.write(c.str + "\n")


def write_dataset(filename, dataset, circuits=None, outcome_label_order=None,
                  fixed_column_mode="auto", with_times="auto"):
    """A dataset file: '## Columns' and one line of counts per circuit, in
    the dataset's outcome-label order (or `outcome_label_order`); with time
    series ('auto': when the dataset has them) an '## Outcomes' line and a
    times:/outcomes:/repetitions: block per circuit.  `fixed_column_mode`
    is accepted for the JAX package's signature."""
    circuits = list(circuits) if circuits is not None else list(dataset.keys())
    outcome_labels = outcome_label_order if outcome_label_order is not None \
        else dataset.outcome_labels
    if with_times == "auto":
        with_times = dataset.has_timestamps
    lines = []
    if not with_times:
        lines.append("## Columns = " + ", ".join("%s count" % _ol_str(o)
                                                 for o in outcome_labels))
    else:
        lines.append("## Outcomes = " + ", ".join(_ol_str(o) for o in outcome_labels))
    keys = [OutcomeLabelDict.to_outcome(o) for o in outcome_labels]
    for c in circuits:
        row = dataset[c]
        if with_times and row.time is not None and len(row.time) > 0:
            series = row.outcome_series if row.outcome_series is not None \
                else list(row.counts.keys())
            lines += [c.str,
                      "times: " + " ".join("%g" % t for t in row.time),
                      "outcomes: " + " ".join(_ol_str(o) for o in series)]
            if row.reps is not None:
                lines.append("repetitions: " + " ".join(
                    str(int(r)) if float(r).is_integer() else str(r) for r in row.reps))
            lines.append("")
        else:
            lines.append(c.str + "  " + "  ".join(str(row.counts.get(k, 0)) for k in keys))
    with open(filename, 'w') as f:
        f.write("\n".join(lines) + "\n")


def write_multidataset(filename, multidataset, circuits=None, outcome_label_order=None):
    """A multi-dataset file: '<dataset> <outcome> count' columns."""
    ds_labels = list(multidataset.keys())
    if circuits is None:
        circuits = list(multidataset[ds_labels[0]].keys())
    cols, col_map = [], []
    for dl in ds_labels:
        ols = outcome_label_order if outcome_label_order is not None \
            else multidataset[dl].outcome_labels
        for o in ols:
            cols.append("%s %s count" % (dl, _ol_str(o)))
            col_map.append((dl, OutcomeLabelDict.to_outcome(o)))
    with open(filename, 'w') as f:
        f.write("## Columns = " + ", ".join(cols) + "\n")
        for c in circuits:
            vals = [multidataset[dl][c].counts.get(o, 0) for dl, o in col_map]
            f.write(c.str + "  " + "  ".join(str(v) for v in vals) + "\n")


def write_empty_dataset(filename, circuits, header_string='## Columns = 0 count, 1 count',
                        num_zero_cols=None, append_weights_column=False):
    """A dataset template of zero counts, to be filled in."""
    if num_zero_cols is None:
        num_zero_cols = header_string.count(',') + 1 if 'Columns' in header_string else 0
    zeros = "  ".join(['0'] * num_zero_cols)
    with open(filename, 'w') as f:
        f.write(header_string + "\n")
        for c in circuits:
            f.write(c.str + ("  " + zeros if zeros else "") + "\n")


def convert_circuits_to_strings(obj):
    """`obj` (nested lists, tuples and dicts) with every Circuit replaced by
    'circuit/<its string>', JSON-able."""
    def convert(x):
        if isinstance(x, Circuit):
            return 'circuit/' + x.str
        if isinstance(x, (list, tuple)):
            return [convert(v) for v in x]
        if isinstance(x, dict):
            return {(('circuit/' + k.str) if isinstance(k, Circuit) else k): convert(v)
                    for k, v in x.items()}
        return x

    return convert(obj)


def write_circuit_strings(filename, obj):
    """`obj` as JSON with its circuits as strings (a '.json' filename)."""
    import json
    if not str(filename).endswith('.json'):
        raise ValueError("Cannot determine format from extension of filename: %s"
                         % str(filename))
    with open(filename, 'w') as f:
        json.dump(convert_circuits_to_strings(obj), f, indent=4)


def write_empty_protocol_data(dirname, edesign, sparse="auto", clobber_ok=False):
    """The design's directory and an empty dataset template
    data/dataset.txt of its circuits, for the lab to fill in.  'auto'
    writes the sparse header above 3 qubits."""
    dirname = str(dirname)
    data_dir = os.path.join(dirname, 'data')
    path = os.path.join(data_dir, 'dataset.txt')
    if os.path.exists(path) and not clobber_ok:
        raise ValueError("Would clobber %s; pass clobber_ok=True" % path)
    edesign.write(dirname)
    os.makedirs(data_dir, exist_ok=True)
    if sparse == "auto":
        sparse = len(getattr(edesign, 'qubit_labels', None) or (0,)) > 3
    if sparse:
        write_empty_dataset(path, edesign.all_circuits_needing_data,
                            header_string="## Outcomes = --")
    else:
        write_empty_dataset(path, edesign.all_circuits_needing_data)


def fill_in_empty_dataset_with_fake_data(dataset_filename, model, num_samples,
                                         sample_error="multinomial", seed=None,
                                         rand_state=None, alias_dict=None,
                                         collision_action="aggregate", record_zero_counts=True,
                                         comm=None, mem_limit=None, times=None,
                                         fixed_column_mode="auto", device="cuda"):
    """Replace a dataset template's contents with counts simulated from
    `model` on `device` for the template's circuits, and return the
    DataSet.  The arguments may also come as (model, dataset_filename, ...),
    as in the JAX package."""
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    from pygsti_tpu_torch.io.stdinput import StdInputParser
    if hasattr(dataset_filename, 'probabilities') and isinstance(model, (str, os.PathLike)):
        model, dataset_filename = dataset_filename, model
    dataset_filename = os.fspath(dataset_filename)
    parser = StdInputParser()
    circuits = []
    with open(dataset_filename) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith('#'):
                circuits.append(parser.parse_circuit(line.split()[0]))
    ds = simulate_data(model, circuits, num_samples, sample_error=sample_error, seed=seed,
                       rand_state=rand_state, alias_dict=alias_dict,
                       collision_action=collision_action,
                       record_zero_counts=record_zero_counts, times=times, device=device)
    write_dataset(dataset_filename, ds, circuits)
    return ds


def write_model(model, filename, title=None):
    """An explicit model as a text model file: PREP/POVM/GATE blocks of
    Liouville vectors and matrices, then STATESPACE/BASIS/GAUGEGROUP lines
    (TP blocks and gauge group for a 'full TP' or 'TP' model)."""
    import numpy as np

    def fmt_vec(v):
        return " ".join("%.8g" % el for el in np.asarray(v).ravel())

    def fmt_mx(m):
        return "\n".join("".join("%16.8g" % el for el in row) for row in np.asarray(m)) + "\n"

    gate_type = str(getattr(model, 'default_gate_type', 'full'))
    tp = gate_type.endswith('TP')
    prep_typ, povm_typ, gate_typ = ("TP-PREP", "TP-POVM", "TP-GATE") if tp \
        else ("PREP", "POVM", "GATE")
    with open(str(filename), 'w') as f:
        if title is not None:
            f.write("# %s\n" % title)
        f.write("\n")
        for lbl, rho in model.preps.items():
            f.write("%s: %s\n" % (prep_typ, lbl))
            f.write("LiouvilleVec\n%s\n\n" % fmt_vec(rho.dense()))
        for plbl, povm in model.povms.items():
            f.write("%s: %s\n\n" % (povm_typ, plbl))
            for elbl, evec in zip(povm.outcome_labels, np.asarray(povm.dense())):
                f.write("EFFECT: %s\nLiouvilleVec\n%s\n\n" % (elbl, fmt_vec(evec)))
            f.write("END POVM\n\n")
        for lbl, op in model.operations.items():
            f.write("%s: %s\nLiouvilleMx\n%s\n" % (gate_typ, lbl, fmt_mx(op.dense())))
        f.write("STATESPACE: 0(%d)\n" % model.dim)
        f.write("BASIS: %s %d\n" % (getattr(model.basis, 'name', 'pp'), model.dim))
        f.write("GAUGEGROUP: %s\n" % ("TP" if tp else "Full"))
