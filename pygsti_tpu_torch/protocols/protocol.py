"""Protocol framework: ExperimentDesign / ProtocolData / Protocol / Results
(counterpart of pygsti_tpu/protocols/protocol.py).  Writing designs, data
and results to directory trees, the combined and simultaneous designs, and
the runners are not ported yet."""

from __future__ import annotations

import collections

from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
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


class ProtocolCheckpoint(NicelySerializable):
    """Serializable checkpoint base; ``write(path)`` and ``read(path)`` are
    NicelySerializable's JSON file helpers."""

    def __init__(self, name, parent=None):
        self.name = name
        self.parent = parent
