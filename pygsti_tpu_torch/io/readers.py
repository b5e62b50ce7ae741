"""Readers of the text formats and of directories (counterpart of
pygsti_tpu/io/readers.py).

A dataset file:

    ## Columns = 0 count, 1 count
    {}@(0)  95  5
    Gxpi2:0@(0)  50  50

The directory readers read what ``write`` of a design, a ProtocolData or a
results object wrote, in either package: a state that names a
``pygsti_tpu.`` module is read as the port's module of the same path.
"""

from __future__ import annotations

import os

from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.io.stdinput import StdInputParser


def read_circuit_list(filename, read_raw_strings=False, line_labels=None):
    """The circuits of a text file, one per line ('#' starts a comment
    line); with `read_raw_strings` the strings themselves."""
    out = []
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            out.append(line if read_raw_strings else Circuit(line, line_labels))
    return out


def read_dataset(filename, cache=False, collision_action="aggregate", record_zero_counts=False,
                 ignore_zero_count_lines=True, with_times="auto", circuit_parse_cache=None,
                 verbosity=1):
    """A DataSet from a dataset file.  As in the JAX package and pyGSTi,
    zero counts are not recorded by default, which lowers the degrees of
    freedom of a row with an outcome never seen; pass
    ``record_zero_counts=True`` to keep every column."""
    return StdInputParser().parse_datafile(
        filename, collision_action=collision_action, record_zero_counts=record_zero_counts,
        ignore_zero_count_lines=ignore_zero_count_lines, with_times=with_times)


def read_multidataset(filename, cache=False, collision_action="aggregate",
                      record_zero_counts=False, verbosity=1):
    """A MultiDataSet from a multi-dataset file."""
    return StdInputParser().parse_multidatafile(
        filename, collision_action=collision_action, record_zero_counts=record_zero_counts)


def read_time_dependent_dataset(filename, record_zero_counts=True):
    """A time-series DataSet from a file of 'timestamp circuit outcome' lines."""
    return StdInputParser().parse_tddatafile(filename, record_zero_counts=record_zero_counts)


load_dataset = read_dataset
load_circuit_list = read_circuit_list
load_multidataset = read_multidataset


def convert_strings_to_circuits(obj):
    """`obj` with every 'circuit/<string>' (in lists, tuples, dict keys and
    values) parsed into a Circuit: the inverse of
    writers.convert_circuits_to_strings."""
    parser = StdInputParser()

    def convert_key(k):
        if isinstance(k, str) and k.startswith('circuit/'):
            return parser.parse_circuit(k[len('circuit/'):])
        return k

    def convert(x):
        if isinstance(x, (list, tuple)):
            return [convert(v) for v in x]
        if isinstance(x, dict):
            return {convert_key(k): convert(v) for k, v in x.items()}
        return convert_key(x)

    return convert(obj)


def read_circuit_strings(filename):
    """The structure a writers.write_circuit_strings JSON file holds."""
    import json
    if str(filename).endswith('.json'):
        with open(filename) as f:
            return convert_strings_to_circuits(json.load(f))
    raise ValueError("Cannot determine format from extension of filename: %s" % str(filename))


def read_edesign_from_dir(dirname, quick_load=False):
    """The ExperimentDesign under `dirname`/edesign."""
    from pygsti_tpu_torch.protocols.protocol import ExperimentDesign
    return ExperimentDesign.from_dir(dirname)


def read_data_from_dir(dirname, preferred_comm=None, quick_load=False):
    """The ProtocolData under `dirname`: its design and its dataset
    (data/dataset.json, else a filled-in data/dataset.txt)."""
    from pygsti_tpu_torch.protocols.protocol import ProtocolData
    return ProtocolData.from_dir(dirname)


def read_results_from_dir(dirname, name=None, preferred_comm=None, quick_load=False):
    """The results under `dirname`: a ProtocolResultsDir of every
    protocol's results, or with `name` that protocol's results."""
    from pygsti_tpu_torch.protocols.protocol import ProtocolResults, ProtocolResultsDir
    if name is None:
        return ProtocolResultsDir.from_dir(dirname)
    return ProtocolResults.from_dir(dirname, name)


def read_protocol_from_dir(dirname, quick_load=False):
    """The object whose class the directory's meta.json names, read by that
    class's ``from_dir``."""
    from pygsti_tpu_torch.io.metadir import _cls_from_meta_json
    return _cls_from_meta_json(dirname).from_dir(dirname)


def create_edesign_from_dir(dirname):
    """The design under `dirname`: the written one, else an
    ExperimentDesign of the circuits in edesign/circuits*.txt."""
    from pygsti_tpu_torch.protocols.protocol import ExperimentDesign
    edir = os.path.join(str(dirname), 'edesign')
    if os.path.exists(os.path.join(edir, 'edesign.json')):
        return ExperimentDesign.from_dir(dirname)
    circuit_files = sorted(fn for fn in (os.listdir(edir) if os.path.isdir(edir) else [])
                           if fn.startswith('circuits') and fn.endswith('.txt'))
    if not circuit_files:
        raise ValueError("No edesign found under %s" % str(dirname))
    all_circuits = []
    for fn in circuit_files:
        all_circuits.extend(read_circuit_list(os.path.join(edir, fn)))
    return ExperimentDesign(all_circuits)


# -- MongoDB: a pymongo database, or the mock one of
#    baseobjs/mongoserializable.py ----------------------------------------------

def _mongo_read(mongodb, collection_name, doc_id):
    from pygsti_tpu_torch.io.mongodb import read_auxtree_from_mongodb
    return read_auxtree_from_mongodb(mongodb[collection_name], doc_id)


def read_edesign_from_mongodb(mongodb, doc_id, quick_load=False, comm=None):
    return _mongo_read(mongodb, 'pygsti_experiment_designs', doc_id)


def read_data_from_mongodb(mongodb, doc_id, quick_load=False, comm=None):
    return _mongo_read(mongodb, 'pygsti_protocol_data', doc_id)


def read_results_from_mongodb(mongodb, doc_id, quick_load=False, comm=None):
    return _mongo_read(mongodb, 'pygsti_protocol_results', doc_id)


def read_resultsdir_from_mongodb(mongodb, doc_id, quick_load=False, comm=None,
                                 read_all_results_for_data=False):
    return _mongo_read(mongodb, 'pygsti_protocol_results_dirs', doc_id)


def read_protocol_from_mongodb(mongodb, doc_id, quick_load=False):
    return _mongo_read(mongodb, 'pygsti_protocols', doc_id)


def _mongo_remove(mongodb, collection_name, doc_id, session=None):
    from pygsti_tpu_torch.io.mongodb import remove_auxtree_from_mongodb
    return remove_auxtree_from_mongodb(mongodb[collection_name], doc_id, session=session)


def remove_edesign_from_mongodb(mongodb, doc_id, session=None):
    return _mongo_remove(mongodb, 'pygsti_experiment_designs', doc_id, session)


def remove_data_from_mongodb(mongodb, doc_id, session=None):
    return _mongo_remove(mongodb, 'pygsti_protocol_data', doc_id, session)


def remove_results_from_mongodb(mongodb, doc_id, session=None):
    return _mongo_remove(mongodb, 'pygsti_protocol_results', doc_id, session)


def remove_resultsdir_from_mongodb(mongodb, doc_id, session=None):
    return _mongo_remove(mongodb, 'pygsti_protocol_results_dirs', doc_id, session)


def remove_protocol_from_mongodb(mongodb, doc_id, session=None):
    return _mongo_remove(mongodb, 'pygsti_protocols', doc_id, session)
