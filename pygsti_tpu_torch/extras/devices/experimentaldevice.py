"""ExperimentalDevice: a device's qubits, connectivity and native
two-qubit gate (counterpart of
pygsti_tpu/extras/devices/experimentaldevice.py).

Named device topologies are data: this package's own ``device_data.json``
holds each device's undirected qubit-index pairs, its native two-qubit gate
and its calibration format.  Common topology families also have generators
below.  Host work only.
"""

from __future__ import annotations

import functools
import json
import os

from pygsti_tpu_torch.baseobjs.qubitgraph import QubitGraph


_DATA_PATH = os.path.join(os.path.dirname(__file__), 'device_data.json')


@functools.lru_cache(maxsize=1)
def _device_data():
    """The {devname: {'n', 'pairs', 'gate', 'fmt'}} table, read once."""
    with open(_DATA_PATH) as f:
        return json.load(f)


def _line(n):
    return [('Q%d' % i, 'Q%d' % (i + 1)) for i in range(n - 1)]


def _t5():
    # 5-qubit "T" (belem/lima/quito style): 0-1, 1-2, 1-3, 3-4
    return [('Q0', 'Q1'), ('Q1', 'Q2'), ('Q1', 'Q3'), ('Q3', 'Q4')]


def _h7():
    # 7-qubit "H" (lagos/casablanca/jakarta style)
    return [('Q0', 'Q1'), ('Q1', 'Q2'), ('Q1', 'Q3'), ('Q3', 'Q5'),
            ('Q4', 'Q5'), ('Q5', 'Q6')]


def _grid(rows, cols):
    edges = []
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            if c + 1 < cols:
                edges.append(('Q%d' % i, 'Q%d' % (i + 1)))
            if r + 1 < rows:
                edges.append(('Q%d' % i, 'Q%d' % (i + cols)))
    return edges


def _guadalupe16():
    # 16-qubit heavy-hex (falcon r4P: guadalupe)
    pairs = [(0, 1), (1, 2), (1, 4), (2, 3), (3, 5), (4, 7), (5, 8), (6, 7),
             (7, 10), (8, 9), (8, 11), (10, 12), (11, 14), (12, 13), (12, 15),
             (13, 14)]
    return [('Q%d' % a, 'Q%d' % b) for a, b in pairs]


def _falcon27():
    # 27-qubit heavy-hex (falcon r4: montreal/toronto/mumbai/cairo class)
    pairs = [(0, 1), (1, 2), (1, 4), (2, 3), (3, 5), (4, 7), (5, 8), (6, 7),
             (7, 10), (8, 9), (8, 11), (10, 12), (11, 14), (12, 13), (12, 15),
             (13, 14), (14, 16), (15, 18), (16, 19), (17, 18), (18, 21),
             (19, 20), (19, 22), (21, 23), (22, 25), (23, 24), (24, 25),
             (25, 26)]
    return [('Q%d' % a, 'Q%d' % b) for a, b in pairs]


# named public device topologies (connectivity only)
DEVICE_EDGELISTS = {
    'ibmq_athens': _line(5), 'ibmq_bogota': _line(5),
    'ibmq_santiago': _line(5), 'ibmq_manila': _line(5),
    'ibmq_belem': _t5(), 'ibmq_lima': _t5(), 'ibmq_quito': _t5(),
    'ibmq_essex': _t5(), 'ibmq_london': _t5(), 'ibmq_burlington': _t5(),
    'ibmq_lagos': _h7(), 'ibmq_casablanca': _h7(), 'ibmq_jakarta': _h7(),
    'ibmq_perth': _h7(), 'ibmq_nairobi': _h7(),
    'ibmq_guadalupe': _guadalupe16(),
    'ibmq_montreal': _falcon27(), 'ibmq_toronto': _falcon27(),
    'ibmq_mumbai': _falcon27(), 'ibmq_cairo': _falcon27(),
    'ibmq_hanoi': _falcon27(), 'ibmq_auckland': _falcon27(),
    'ibmq_algiers': _falcon27(), 'ibmq_kolkata': _falcon27(),
}


class ExperimentalDevice(object):
    """Qubits + connectivity graph + native-gate mapping."""

    def __init__(self, qubits, graph, gate_mapping=None):
        self.qubits = list(qubits)
        self.graph = graph
        self.gate_mapping = gate_mapping if gate_mapping is not None \
            else {'Gcnot': 'cx'}
        self.two_qubit_gate = next(iter(self.gate_mapping))
        self.spec_format = None

    @classmethod
    def from_edgelist(cls, qubits, edgelist, gate_mapping=None):
        return cls(qubits, QubitGraph(list(qubits), initial_edges=list(edgelist)),
                   gate_mapping)

    @classmethod
    def from_legacy_device(cls, devname, gate_mapping=None):
        # 'ibm_*' spellings of retired 'ibmq_*' devices, and historical names
        special = {'ibmqx2': 'ibmq_yorktown',
                   'ibmq_16_melbourne': 'ibmq_melbourne',
                   'ibm_nazco': 'ibmq_nazca', 'ibmq_nazco': 'ibmq_nazca'}
        devname = special.get(devname, devname)
        if devname.startswith('ibm_'):
            devname = 'ibmq_' + devname[4:]
        data = _device_data()
        if devname in data:
            d = data[devname]
            qubits = d.get('qubits') or ['Q%d' % i for i in range(d['n'])]
            edges = [(qubits[a], qubits[b]) for a, b in d['pairs']]
            dev = cls.from_edgelist(qubits, edges, gate_mapping)
            if gate_mapping is None and d['gate'] != 'Gcnot':
                dev.gate_mapping = {d['gate']: {'Gcphase': 'cz'}.get(
                    d['gate'], 'cx')}
            dev.two_qubit_gate = d['gate']
            dev.spec_format = d['fmt']
            return dev
        if devname in DEVICE_EDGELISTS:
            edges = DEVICE_EDGELISTS[devname]
            qubits = sorted({q for e in edges for q in e},
                            key=lambda s: int(s[1:]))
            return cls.from_edgelist(qubits, edges, gate_mapping)
        raise ValueError("Unknown device %r (known: %s)"
                         % (devname, sorted(set(data) | set(DEVICE_EDGELISTS))))

    @classmethod
    def from_qiskit_backend(cls, backend, gate_mapping=None):
        num_qubits = backend.num_qubits
        qubits = ['Q%d' % i for i in range(num_qubits)]
        edges = [(qubits[e[0]], qubits[e[1]]) for e in backend.coupling_map]
        return cls.from_edgelist(qubits, edges, gate_mapping)

    def create_processor_spec(self, gate_names=None, qubit_subset=None,
                              remove_edges=None, subset_only=True):
        """Processor spec for the device (or a qubit subset).  With
        ``subset_only=False`` the spec keeps the full device qubit list and
        only restricts the edge set to the subset's edges (for specs that
        must share the device's qubit count)."""
        from pygsti_tpu_torch.processors import QubitProcessorSpec
        if gate_names is None:
            gate_names = ['Gxpi2', 'Gypi2'] + list(self.gate_mapping.keys())
        if qubit_subset is None:
            qubit_subset = list(self.qubits)
        if not subset_only:
            edges_sub = [e for e in self.graph.edges()
                         if e[0] in qubit_subset and e[1] in qubit_subset]
            graph = QubitGraph(list(self.qubits), initial_edges=edges_sub)
            return QubitProcessorSpec(len(self.qubits), gate_names,
                                      geometry=graph,
                                      qubit_labels=tuple(self.qubits))
        if not set(qubit_subset) <= set(self.qubits):
            raise ValueError("qubits %s are not on the device"
                             % sorted(set(qubit_subset) - set(self.qubits), key=str))
        remove = set(map(tuple, remove_edges or []))
        edges = [e for e in self.graph.edges()
                 if e[0] in qubit_subset and e[1] in qubit_subset
                 and e not in remove and (e[1], e[0]) not in remove]
        graph = QubitGraph(list(qubit_subset), initial_edges=edges)
        return QubitProcessorSpec(len(qubit_subset), gate_names,
                                  geometry=graph,
                                  qubit_labels=tuple(qubit_subset))

    def create_error_rates_model(self, caldata=None, calformat='native',
                                 model_type='TwirledLayers', idle_name=None):
        from pygsti_tpu_torch.extras.devices.devcore import create_error_rates_model
        return create_error_rates_model(caldata, self, calformat=calformat,
                                        model_type=model_type,
                                        idle_name=idle_name)
