"""Processor specifications: a device's qubits, native gates and where each
gate is available, host Python (counterpart of
pygsti_tpu/processors/processorspec.py), with
``compute_clifford_symplectic_reps`` through the port's symplectic tools."""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.baseobjs.qubitgraph import QubitGraph
from pygsti_tpu_torch.tools.internalgates import standard_gatename_unitaries

IDLE_NAMES = ('{idle}', '(idle)', 'Gidle', '[]', '')


class ProcessorSpec(object):
    """Base class of processor specifications."""


class QubitProcessorSpec(ProcessorSpec):
    """Qubits, native gates (standard names or given unitaries) and their
    availability: a list of target tuples, 'all-edges' (the default) or
    'all-permutations' of the qubit graph's edges."""

    def __init__(self, num_qubits, gate_names, nonstd_gate_unitaries=None,
                 availability=None, geometry=None, qubit_labels=None):
        self.num_qubits = num_qubits
        self.qubit_labels = tuple(qubit_labels) if qubit_labels is not None \
            else tuple(range(num_qubits))
        self.gate_names = list(gate_names)
        std = standard_gatename_unitaries()
        nonstd = nonstd_gate_unitaries or {}
        self.gate_unitaries = {}
        for name in self.gate_names:
            if name in nonstd:
                u = nonstd[name]
                # a callable is a factory of a continuously parameterized gate
                self.gate_unitaries[name] = u if callable(u) else np.asarray(u)
            elif name in std:
                self.gate_unitaries[name] = std[name]
            elif name in IDLE_NAMES:
                self.gate_unitaries[name] = np.eye(2 ** num_qubits, dtype=complex)
            else:
                raise ValueError("Unknown gate name %r (provide nonstd_gate_unitaries)" % name)
        if geometry is None or isinstance(geometry, str):
            self.qubit_graph = QubitGraph.common_graph(
                num_qubits, geometry or 'fully_connected', qubit_labels=self.qubit_labels)
        else:
            self.qubit_graph = geometry
        availability = availability or {}
        self.availability = {name: availability.get(name, 'all-edges')
                             for name in self.gate_names}

    def gate_num_qubits(self, gate_name):
        u = self.gate_unitaries[gate_name]
        if u is None:
            return self.num_qubits
        if callable(u):
            u = np.asarray(u((0.0,)))
        return int(round(np.log2(u.shape[0])))

    def resolved_availability(self, gate_name, tuple_or_function='tuple'):
        """The target-qubit tuples of a gate."""
        avail = self.availability.get(gate_name, 'all-edges')
        nq_gate = self.gate_num_qubits(gate_name)
        if isinstance(avail, (list, tuple)):
            return tuple(tuple(a) for a in avail)
        if nq_gate == self.num_qubits:
            return (self.qubit_labels,) if self.num_qubits > 1 else \
                tuple((q,) for q in self.qubit_labels)
        if nq_gate == 1:
            return tuple((q,) for q in self.qubit_labels)
        if nq_gate == 2:
            edges = self.qubit_graph.edges()
            if avail == 'all-permutations':
                return tuple(e for edge in edges for e in (tuple(edge), tuple(reversed(edge))))
            return tuple(tuple(e) for e in edges)
        raise ValueError("Cannot resolve availability for %d-qubit gate" % nq_gate)

    @property
    def idle_gate_names(self):
        return [n for n in self.gate_names if n in IDLE_NAMES]

    @property
    def primitive_op_labels(self):
        """Every (gate, targets) label: the global idle as ``Label(())``, a
        gate on all the qubits once, any other once per target tuple."""
        out = []
        for name in self.gate_names:
            if name in ('{idle}', '(idle)', '[]', ''):
                out.append(Label(()))
            elif self.gate_num_qubits(name) == self.num_qubits and self.num_qubits > 1:
                out.append(Label(name, self.qubit_labels))
            else:
                out.extend(Label(name, targets) for targets in self.resolved_availability(name))
        return out

    def compute_clifford_symplectic_reps(self, subset=None):
        """{gate name: (s, p)} for the native gates that are Cliffords."""
        from pygsti_tpu_torch.tools import symplectic
        out = {}
        for name in (subset if subset is not None else self.gate_names):
            u = self.gate_unitaries.get(name)
            if u is None:
                continue
            try:
                out[name] = symplectic.unitary_to_symplectic(u)
            except ValueError:
                pass  # not a Clifford
        return out


class QuditProcessorSpec(ProcessorSpec):
    """Qudits of given Hilbert dimensions with native gates given as
    unitaries (standard names are looked up)."""

    def __init__(self, qudit_labels, qudit_udims, gate_names, nonstd_gate_unitaries=None,
                 availability=None, geometry=None, prep_names=('rho0',),
                 povm_names=('Mdefault',)):
        self.qudit_labels = tuple(qudit_labels)
        self.qudit_udims = tuple(qudit_udims)
        self.gate_names = list(gate_names)
        self.gate_unitaries = dict(nonstd_gate_unitaries or {})
        std = standard_gatename_unitaries()
        for name in self.gate_names:
            if name not in self.gate_unitaries and name in std:
                self.gate_unitaries[name] = std[name]
        self.availability = dict(availability or {})
        self.geometry = geometry
        self.prep_names = tuple(prep_names)
        self.povm_names = tuple(povm_names)

    @property
    def num_qudits(self):
        return len(self.qudit_labels)

    @property
    def udim(self):
        return int(np.prod(self.qudit_udims, dtype=np.int64))

    def gate_num_qudits(self, gate_name):
        """How many leading qudits the gate's unitary spans (1 when the
        dimension matches no prefix, or for a factory)."""
        u = self.gate_unitaries.get(gate_name)
        if u is None or callable(u):
            return 1
        dim = np.asarray(u).shape[0]
        for n in range(1, len(self.qudit_labels) + 1):
            if int(np.prod(self.qudit_udims[:n], dtype=np.int64)) == dim:
                return n
        return 1
