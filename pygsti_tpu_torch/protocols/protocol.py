"""Protocol framework: ExperimentDesign / ProtocolData / Protocol / Results
(counterpart of pygsti_tpu/protocols/protocol.py), with the directory trees
they write and read: edesign/edesign.json, data/dataset.json (or a
filled-in data/dataset.txt) and results/<protocol name>.json.  A directory
the JAX package wrote reads here: its module names are read as the port's
(``resolve_module_name``).  The combined, simultaneous and freeform
designs write their children and auxiliary information and read back as
what they were (the JAX package's three do not read back: ROADMAP.md
section 3); the runners are not ported yet.  Host work only."""

from __future__ import annotations

import collections
import importlib
import json
import pathlib

from pygsti_tpu_torch.baseobjs.nicelyserializable import (NicelySerializable, decode_value,
                                                          encode_value, resolve_module_name)
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.circuits.circuitlist import CircuitList


class ExperimentDesign(NicelySerializable):
    """A set of circuits to run + metadata; nestable into trees."""

    def __init__(self, circuits=None, qubit_labels=None, children=None):
        self._all_circuits_needing_data = [c if isinstance(c, Circuit) else Circuit(c)
                                           for c in (circuits or [])]
        self.qubit_labels = tuple(qubit_labels) if qubit_labels is not None else None
        self._children = collections.OrderedDict(children or {})

    @property
    def all_circuits_needing_data(self):
        if self._all_circuits_needing_data:
            return list(self._all_circuits_needing_data)
        out, seen = [], set()
        for child in self._children.values():
            for c in child.all_circuits_needing_data:
                if c not in seen:
                    seen.add(c)
                    out.append(c)
        return out

    # -- tree protocol --------------------------------------------------------
    def keys(self):
        return list(self._children.keys())

    def items(self):
        return self._children.items()

    def __getitem__(self, key):
        return self._children[key]

    def __contains__(self, key):
        return key in self._children

    # -- serialization --------------------------------------------------------
    def _to_nice_serialization(self):
        return {
            'circuits': [c.str for c in self._all_circuits_needing_data],
            'qubit_labels': list(self.qubit_labels) if self.qubit_labels else None,
            'children': {str(k): v.to_nice_serialization() for k, v in self._children.items()},
        }

    @classmethod
    def _from_nice_serialization(cls, state):
        children = {k: NicelySerializable.from_nice_serialization(v)
                    for k, v in state.get('children', {}).items()}
        return cls(circuits=[Circuit(s) for s in state['circuits']],
                   qubit_labels=state.get('qubit_labels'), children=children)

    def write(self, dirname):
        """The design's state into `dirname`/edesign/edesign.json."""
        p = pathlib.Path(dirname) / 'edesign'
        p.mkdir(parents=True, exist_ok=True)
        with open(p / 'edesign.json', 'w') as f:
            json.dump(encode_value(self.to_nice_serialization()), f, indent=1)

    @classmethod
    def from_dir(cls, dirname):
        with open(pathlib.Path(dirname) / 'edesign' / 'edesign.json') as f:
            return NicelySerializable.from_nice_serialization(decode_value(json.load(f)))


class CircuitListsDesign(ExperimentDesign):
    """An experiment design with several circuit lists (e.g. GST iterations)."""

    def __init__(self, circuit_lists, all_circuits_needing_data=None, qubit_labels=None,
                 nested=False):
        self.circuit_lists = [cl if isinstance(cl, CircuitList) else CircuitList(cl)
                              for cl in circuit_lists]
        self.nested = nested
        if all_circuits_needing_data is None:
            seen = set()
            all_c = []
            for cl in self.circuit_lists:
                for c in cl:
                    if c not in seen:
                        seen.add(c)
                        all_c.append(c)
            all_circuits_needing_data = all_c
        super().__init__(all_circuits_needing_data, qubit_labels)

    def _to_nice_serialization(self):
        state = super()._to_nice_serialization()
        state['circuit_lists'] = [[c.str for c in cl] for cl in self.circuit_lists]
        state['nested'] = self.nested
        return state

    @classmethod
    def _from_nice_serialization(cls, state):
        lists = [[Circuit(s) for s in cl] for cl in state['circuit_lists']]
        return cls(lists, [Circuit(s) for s in state['circuits']],
                   state.get('qubit_labels'), state.get('nested', False))


class CombinedExperimentDesign(ExperimentDesign):
    """Several named sub-designs run together; their circuits are the union
    of the sub-designs', in order."""

    def __init__(self, sub_designs, qubit_labels=None):
        super().__init__(None, qubit_labels, children=sub_designs)

    @classmethod
    def _from_nice_serialization(cls, state):
        children = collections.OrderedDict(
            (k, NicelySerializable.from_nice_serialization(v))
            for k, v in state.get('children', {}).items())
        return cls(children, state.get('qubit_labels'))


class SimultaneousExperimentDesign(ExperimentDesign):
    """Side-by-side designs on disjoint qubit subsets: circuit i is the
    layer-by-layer parallel composition of each sub-design's circuit i (a
    sub-design with fewer circuits contributes an empty one)."""

    def __init__(self, edesigns, qubit_labels=None):
        from pygsti_tpu_torch.baseobjs.label import LabelTupTup
        edesigns = list(edesigns)
        children = collections.OrderedDict(
            (str(tuple(ed.qubit_labels) if ed.qubit_labels else ('*',)), ed) for ed in edesigns)
        circuits = []
        for i in range(max(len(ed.all_circuits_needing_data) for ed in edesigns)):
            group = []
            for ed in edesigns:
                cl = ed.all_circuits_needing_data
                group.append(cl[i] if i < len(cl) else Circuit((), ed.qubit_labels))
            lines = [q for c in group if c.line_labels != ('*',) for q in c.line_labels]
            layers = []
            for t in range(max(c.depth for c in group)):
                comps = []
                for c in group:
                    if t < c.depth:
                        lbl = c[t]
                        comps.extend(lbl.components if not lbl.is_simple else (lbl,))
                layers.append(LabelTupTup.init(tuple(comps)))
            circuits.append(Circuit(layers, tuple(lines) if lines else None))
        super().__init__(circuits, qubit_labels, children=children)

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls([NicelySerializable.from_nice_serialization(v)
                    for v in state['children'].values()], state.get('qubit_labels'))


class FreeformDesign(ExperimentDesign):
    """Circuits with per-circuit auxiliary information: ``aux_info`` maps
    each circuit to its value (None when a plain list was given)."""

    def __init__(self, circuits, qubit_labels=None):
        if isinstance(circuits, dict):
            self.aux_info = dict(circuits)
            circuits = list(circuits.keys())
        else:
            self.aux_info = {c: None for c in circuits}
        super().__init__(circuits, qubit_labels)

    def _to_nice_serialization(self):
        state = super()._to_nice_serialization()
        state['aux_info'] = [self.aux_info[c] for c in self._all_circuits_needing_data]
        return state

    @classmethod
    def _from_nice_serialization(cls, state):
        circuits = [Circuit(s) for s in state['circuits']]
        aux = state.get('aux_info', [None] * len(circuits))
        return cls(dict(zip(circuits, aux)), state.get('qubit_labels'))


class ProtocolData(object):
    """An experiment design + the data taken for it."""

    def __init__(self, edesign, dataset=None):
        self.edesign = edesign if edesign is not None else ExperimentDesign()
        self.dataset = dataset

    @property
    def passes(self):
        return {None: self}

    def is_multipass(self):
        return False

    def keys(self):
        return self.edesign.keys()

    def items(self):
        for k, sub in self.edesign.items():
            yield k, ProtocolData(sub, self.dataset)

    def __getitem__(self, key):
        return ProtocolData(self.edesign[key], self.dataset)

    def write(self, dirname):
        """The design, then the dataset as `dirname`/data/dataset.json."""
        self.edesign.write(dirname)
        p = pathlib.Path(dirname) / 'data'
        p.mkdir(parents=True, exist_ok=True)
        if self.dataset is not None:
            with open(p / 'dataset.json', 'w') as f:
                json.dump(encode_value(self.dataset.to_nice_serialization()), f)

    @classmethod
    def from_dir(cls, dirname):
        """The design and dataset under `dirname`: data/dataset.json, else a
        text data/dataset.txt (a filled-in template of
        io.write_empty_protocol_data, read with io.read_dataset's defaults),
        else no dataset."""
        from pygsti_tpu_torch.data.dataset import DataSet
        p = pathlib.Path(dirname) / 'data'
        ds = None
        if (p / 'dataset.json').exists():
            with open(p / 'dataset.json') as f:
                ds = DataSet.from_nice_serialization(decode_value(json.load(f)))
        elif (p / 'dataset.txt').exists():
            from pygsti_tpu_torch.io.readers import read_dataset
            ds = read_dataset(str(p / 'dataset.txt'))
        return cls(ExperimentDesign.from_dir(dirname), ds)


class Protocol(NicelySerializable):
    """Base protocol: .run(data) -> ProtocolResults."""

    def __init__(self, name=None):
        self.name = name or type(self).__name__

    def run(self, data, memlimit=None, comm=None):
        raise NotImplementedError()


class ProtocolResults(object):
    """Results of running a protocol."""

    def __init__(self, data, protocol_instance):
        self.data = data
        self.protocol = protocol_instance

    @property
    def edesign(self):
        return self.data.edesign

    @property
    def dataset(self):
        return self.data.dataset

    def to_nice_serialization(self):
        return {'protocol_name': self.protocol.name}

    def write(self, dirname):
        """The data, then `dirname`/results/<protocol name>.json: the
        results' state with 'results_type', the module and class that read
        it back."""
        self.data.write(dirname)
        rd = pathlib.Path(dirname) / 'results'
        rd.mkdir(parents=True, exist_ok=True)
        state = self.to_nice_serialization()
        state['results_type'] = '%s.%s' % (type(self).__module__, type(self).__name__)
        with open(rd / ('%s.json' % self.protocol.name), 'w') as f:
            json.dump(encode_value(state), f, indent=1)

    @classmethod
    def from_dir(cls, dirname, name=None, preferred_comm=None, quick_load=False):
        """The results `write` put under `dirname`: those of protocol `name`,
        or of the first protocol by name."""
        rd = pathlib.Path(dirname) / 'results'
        files = [rd / ('%s.json' % name)] if name is not None else sorted(rd.glob('*.json'))
        if not files:
            raise ValueError("No results found under %s" % str(rd))
        with open(files[0]) as f:
            state = decode_value(json.load(f))
        data = ProtocolData.from_dir(dirname)
        type_name = state.get('results_type')
        if type_name:
            mod, clsname = type_name.rsplit('.', 1)
            rcls = getattr(importlib.import_module(resolve_module_name(mod)), clsname)
        else:
            rcls = cls
        if hasattr(rcls, '_from_nice_serialization_with_data'):
            return rcls._from_nice_serialization_with_data(state, data)
        return rcls(data, Protocol(state.get('protocol_name')))


class ProtocolResultsDir(object):
    """The results of several protocols on one ProtocolData, by protocol
    name (``for_protocol``), and the results of the nodes below it."""

    def __init__(self, data, protocol_results=None, children=None):
        self.data = data
        self.for_protocol = dict(protocol_results or {})
        self._children = dict(children or {})

    def keys(self):
        return self._children.keys()

    def __getitem__(self, key):
        return self._children[key]

    @classmethod
    def from_dir(cls, dirname, preferred_comm=None, quick_load=False):
        """Every results file under `dirname`/results, by protocol name.
        (The JAX package's class has no from_dir, so its
        ``read_results_from_dir`` without a name raises AttributeError.)"""
        names = sorted(f.stem for f in (pathlib.Path(dirname) / 'results').glob('*.json'))
        return cls(ProtocolData.from_dir(dirname),
                   {n: ProtocolResults.from_dir(dirname, n) for n in names})


class ProtocolCheckpoint(NicelySerializable):
    """Serializable checkpoint base; ``write(path)`` and ``read(path)`` are
    NicelySerializable's JSON file helpers."""

    def __init__(self, name, parent=None):
        self.name = name
        self.parent = parent
