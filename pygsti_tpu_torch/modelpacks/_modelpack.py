"""Model pack base (counterpart of pygsti_tpu/modelpacks/_modelpack.py).

A pack bundles a target gate set with its GST circuits (germs, lite germs,
prep and measurement fiducials) and its fiducial-pair-reduction data.  The
target model is built directly from the gate unitaries, embedded on the
pack's qubits in the 'pp' basis, with its operations in the JAX package's
order, so parameter vectors line up.  That order is the primitive
operation labels of the pack's processor spec (the global idle first, when
the pack has one, then each gate in turn, a gate on all of the pack's
qubits once, any other once per available target); then a pack's
``_op_order`` moves the labels it names to the front, in its order.
"""

from __future__ import annotations

import collections

import numpy as np

from pygsti_tpu_torch.baseobjs.basis import Basis
from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel
from pygsti_tpu_torch.models.modelconstruction import (LINDBLAD_SPAM_TYPES, _make_op,
                                                        _make_povm, _make_prep,
                                                        embed_unitary_superop)
from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec
from pygsti_tpu_torch.tools import optools as _ot
from pygsti_tpu_torch.tools.basistools import stdmx_to_vec
from pygsti_tpu_torch.tools.internalgates import standard_gatename_unitaries



def _spam_type(gate_type):
    """The SPAM type that goes with a gate type: 'full TP' and 'full' keep
    their family, a Lindblad type with a SPAM form is used as it is, every
    other type ('static', the unitary types, 'H') gets computational SPAM."""
    if gate_type in ('full TP', 'TP'):
        return 'full TP'
    if gate_type in ('full', 'full arbitrary'):
        return 'full'
    if gate_type in LINDBLAD_SPAM_TYPES:
        return gate_type
    return 'computational'


class GSTModelPack(object):
    """Base for GST model packs: subclasses set _nqubits, _gates, _germs,
    _germs_lite, _prep_fids, _meas_fids (circuit strings on qubits 0..n-1)
    and optionally _include_idle, _availability ({gate: [qubit-index
    tuples]}) and _op_order ([(gate, qubit-index tuple)], '' = the idle)."""

    _nqubits = 1
    _gates = []
    _include_idle = True
    _germs = []
    _germs_lite = None
    _prep_fids = []
    _meas_fids = []
    _availability = None
    _op_order = None

    @classmethod
    def _check_qubit_labels(cls, qubit_labels):
        if qubit_labels is None:
            return None
        qubit_labels = tuple(qubit_labels)
        if len(qubit_labels) != cls._nqubits:
            raise ValueError("Expected %d qubit labels and got: %s!"
                             % (cls._nqubits, str(qubit_labels)))
        return qubit_labels

    @classmethod
    def _relabel(cls, circuits, qubit_labels):
        """The circuits with qubit i renamed qubit_labels[i]."""
        qubit_labels = cls._check_qubit_labels(qubit_labels)
        if qubit_labels is None or qubit_labels == tuple(range(cls._nqubits)):
            return circuits
        mapper = dict(enumerate(qubit_labels))
        return [c.map_state_space_labels(mapper) for c in circuits]

    @classmethod
    def processor_spec(cls, qubit_labels=None):
        """The pack's QubitProcessorSpec: the global idle '{idle}' (when the
        pack has one) and its gates on a line of qubits.  An availability
        list is mapped onto `qubit_labels`; the JAX package passes it on as
        written, on qubits 0..n-1 (ROADMAP.md section 3)."""
        qubit_labels = cls._check_qubit_labels(qubit_labels)
        qubits = qubit_labels or tuple(range(cls._nqubits))
        names = (['{idle}'] if cls._include_idle else []) + list(cls._gates)
        avail = None if cls._availability is None else {
            g: [tuple(qubits[i] for i in t) for t in targets]
            for g, targets in cls._availability.items()}
        return QubitProcessorSpec(cls._nqubits, names, geometry='line', availability=avail,
                                  qubit_labels=qubit_labels)

    @classmethod
    def _op_labels(cls, qubit_labels=None):
        qubits = cls._check_qubit_labels(qubit_labels) or tuple(range(cls._nqubits))
        out = cls.processor_spec(qubit_labels).primitive_op_labels
        if cls._op_order is not None:
            order = [Label(()) if name == '' else Label((name,) + tuple(qubits[i] for i in idx))
                     for name, idx in cls._op_order]
            out = [k for k in order if k in out] + [k for k in out if k not in order]
        return out

    @classmethod
    def target_model(cls, gate_type='full', qubit_labels=None):
        """The ideal model with every member of type `gate_type` ('static',
        'full', 'full TP', 'static unitary', 'full unitary', 'CPTPLND',
        'GLND', 'H+S', 'H+s', 'H', ...), its SPAM following the gate type,
        on qubits `qubit_labels` (default 0..n-1)."""
        qubits = cls._check_qubit_labels(qubit_labels) or tuple(range(cls._nqubits))
        nq = cls._nqubits
        spam_type = _spam_type(gate_type)
        mdl = ExplicitOpModel(4 ** nq, 'pp', gate_type, spam_type, spam_type)
        std = standard_gatename_unitaries()
        for lbl in cls._op_labels(qubit_labels):
            if lbl == Label(()):
                u, targets = np.eye(2 ** nq, dtype=complex), qubits
            else:
                u, targets = std[lbl.name], lbl.sslbls
            mdl.operations[lbl] = _make_op(embed_unitary_superop(u, targets, qubits),
                                           gate_type, mdl.basis)
        udim = 2 ** nq
        rho = np.zeros((udim, udim), dtype=complex)
        rho[0, 0] = 1.0
        mdl.preps[Label('rho0')] = _make_prep(np.real(stdmx_to_vec(rho, mdl.basis)),
                                              spam_type, mdl.basis, nq)
        effects = collections.OrderedDict()
        for i in range(udim):
            e = np.zeros((udim, udim), dtype=complex)
            e[i, i] = 1.0
            effects[format(i, '0%db' % nq)] = np.real(stdmx_to_vec(e, mdl.basis))
        mdl.povms[Label('Mdefault')] = _make_povm(effects, spam_type, mdl.basis, nq)
        return mdl

    @classmethod
    def germs(cls, lite=False, qubit_labels=None):
        strs = cls._germs_lite if (lite and cls._germs_lite is not None) else cls._germs
        return cls._relabel([Circuit(s) for s in strs], qubit_labels)

    @classmethod
    def prep_fiducials(cls, qubit_labels=None):
        return cls._relabel([Circuit(s) for s in cls._prep_fids], qubit_labels)

    @classmethod
    def meas_fiducials(cls, qubit_labels=None):
        return cls._relabel([Circuit(s) for s in cls._meas_fids], qubit_labels)

    @classmethod
    def clifford_compilation(cls, max_length=7):
        """For a 1-qubit pack whose gates reach all 24 Cliffords within
        `max_length` gates: an OrderedDict 'Gc0'..'Gc23' -> a shortest word
        of (gate, 0) labels implementing it, found breadth-first as the JAX
        package does; else None."""
        if cls._nqubits != 1:
            return None
        std = standard_gatename_unitaries()
        basis = Basis('pp', 4)

        def superop(name):
            return np.real(_ot.unitary_to_superop(std[name], basis.name))

        gate_sups = {g: superop(g) for g in cls._gates if g in std}
        targets = {('Gc%d' % i): superop('Gc%d' % i).round(8) for i in range(24)}

        def key(mx):
            return tuple(np.round(mx, 6).ravel())

        def word_mx(word):
            mx = np.eye(4)
            for g in word:
                mx = gate_sups[g] @ mx
            return mx

        found = {}
        frontier = {key(np.eye(4)): ()}
        seen = set(frontier)
        for _ in range(max_length + 1):
            for word in frontier.values():
                mx = word_mx(word)
                for cname, tmx in targets.items():
                    if cname not in found and np.allclose(mx, tmx, atol=1e-6):
                        found[cname] = word
            if len(found) == 24:
                break
            new_frontier = {}
            for word in frontier.values():
                mx = word_mx(word)
                for g, gs in gate_sups.items():
                    nk = key(gs @ mx)
                    if nk not in seen:
                        seen.add(nk)
                        new_frontier[nk] = word + (g,)
            frontier = new_frontier
        if len(found) < 24:
            return None
        out = collections.OrderedDict()
        for i in range(24):
            word = found['Gc%d' % i]
            out['Gc%d' % i] = [(g, 0) for g in word] if word else [()]
        return out

    @classmethod
    def _fidpairs_entry(cls):
        from pygsti_tpu_torch.modelpacks._fidpairs_data import FIDPAIRS
        return FIDPAIRS.get(cls.__module__.rsplit('.', 1)[-1], {})

    @classmethod
    def pergerm_fidpair_dict(cls, qubit_labels=None, lite=True):
        """The pack's per-germ fiducial pairs {germ Circuit: [(prep index,
        meas index), ...]}, or None when the pack has none."""
        data = cls._fidpairs_entry().get('pergerm_lite' if lite else 'pergerm')
        if data is None:
            return None
        germs = {c.str: c for c in cls.germs(lite)}
        out = {}
        for gstr, pairs in data.items():
            c = germs.get(gstr, Circuit(gstr))
            if qubit_labels is not None:
                c = cls._relabel([c], qubit_labels)[0]
            out[c] = [tuple(p) for p in pairs]
        return out

    @classmethod
    def global_fidpairs(cls, lite=True):
        """The pack's global fiducial-pair list, or None."""
        return cls._fidpairs_entry().get('global_lite' if lite else 'global')

    @classmethod
    def create_gst_experiment_design(cls, max_max_length, qubit_labels=None,
                                     fpr=False, lite=True, **kwargs):
        """The standard GST design with max lengths 1, 2, 4, ... up to
        `max_max_length`; with ``fpr=True`` only the pack's per-germ
        fiducial pairs (ValueError for a pack without them).  Other keywords
        go to StandardGSTDesign."""
        from pygsti_tpu_torch.protocols.gst import StandardGSTDesign
        if fpr:
            fidpairs = cls.pergerm_fidpair_dict(qubit_labels, lite=lite)
            if fidpairs is None:
                raise ValueError("No FPR information for lite=%s" % lite)
            kwargs = dict(kwargs, fiducial_pairs=fidpairs)
        maxlengths = [2 ** i for i in range(int(np.log2(max_max_length)) + 1)]
        return StandardGSTDesign(cls.target_model('static', qubit_labels=qubit_labels),
                                 cls.prep_fiducials(qubit_labels),
                                 cls.meas_fiducials(qubit_labels),
                                 cls.germs(lite, qubit_labels), maxlengths, **kwargs)
