"""Model construction (counterpart of pygsti_tpu/models/modelconstruction.py):
members by parameterization name (_make_op, _make_prep, _make_povm, for
every type the JAX package's functions take), unitaries embedded on a
qubit register, the expression constructors of the legacy packs
(create_operation, create_spam_vector,
create_explicit_model_from_expressions), create_identity_vec,
create_explicit_alias_model, and the models of a processor spec:
create_explicit_model, and the implicit create_crosstalk_free_model,
create_cloud_crosstalk_model and
create_cloud_crosstalk_model_from_hops_and_weights.

A state space is given as the JAX package takes it: a list of qubit labels
('Q0', ...) or of tuples of them, one tuple per tensor-product block; the
port supports one block of qubits.
"""

from __future__ import annotations

import collections
import re

import numpy as np
import scipy.linalg

from pygsti_tpu_torch.baseobjs.basis import Basis
from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.modelmembers import operations as _op
from pygsti_tpu_torch.modelmembers import states as _st
from pygsti_tpu_torch.modelmembers import povms as _pv
from pygsti_tpu_torch.tools import optools as _ot
from pygsti_tpu_torch.tools.basistools import stdmx_to_vec
from pygsti_tpu_torch.tools.internalgates import sigmaX, sigmaY, sigmaZ

LINDBLAD_GATE_TYPES = ('CPTP', 'CPTPLND', 'GLND', 'H+S', 'H+s', 'H')
LINDBLAD_SPAM_TYPES = ('CPTP', 'CPTPLND', 'GLND', 'H+S', 'H+s')
COMPUTATIONAL_SPAM_TYPES = ('computational', 'static', 'static unitary', 'static standard',
                            'full unitary', 'static pure')


def _lindblad_error_map(name, basis):
    return _op.ExpErrorgenOp(_op.build_lindblad_errorgen(
        basis, 'CPTPLND' if name == 'CPTP' else name))


def _require_qubits(kind, name, nqubits):
    if nqubits is None:
        raise ValueError("%s type %r requires a qubit state space" % (kind, name))


def _make_op(ideal_mx, gate_type, basis):
    """The operation of type `gate_type` at the dense superoperator
    `ideal_mx`; a Lindblad type composes the static ideal with exp(error
    generator), the generator starting at zero."""
    if gate_type in ('static', 'static arbitrary'):
        return _op.StaticArbitraryOp(ideal_mx)
    if gate_type in ('full', 'full arbitrary'):
        return _op.FullArbitraryOp(ideal_mx)
    if gate_type in ('full TP', 'TP'):
        return _op.FullTPOp(ideal_mx)
    if gate_type in ('static unitary', 'static standard'):
        return _op.StaticUnitaryOp(_ot.superop_to_unitary(np.asarray(ideal_mx), basis), basis)
    if gate_type == 'full unitary':
        return _op.FullUnitaryOp(_ot.superop_to_unitary(np.asarray(ideal_mx), basis), basis)
    if gate_type in LINDBLAD_GATE_TYPES:
        return _op.ComposedOp([_op.StaticArbitraryOp(ideal_mx),
                               _lindblad_error_map(gate_type, basis)])
    raise ValueError("Unknown gate type %r" % gate_type)


def _make_prep(ideal_vec, prep_type, basis, nqubits=None):
    """The state preparation of type `prep_type`.  The computational and
    Lindblad types build on |0...0> of `nqubits` qubits, not on `ideal_vec`."""
    if prep_type in COMPUTATIONAL_SPAM_TYPES:
        _require_qubits('prep', prep_type, nqubits)
        return _st.ComputationalBasisState([0] * nqubits, basis)
    if prep_type in ('full', 'full arbitrary'):
        return _st.FullState(ideal_vec)
    if prep_type in ('full TP', 'TP'):
        return _st.TPState(ideal_vec)
    if prep_type in LINDBLAD_SPAM_TYPES:
        _require_qubits('prep', prep_type, nqubits)
        return _st.ComposedState(_st.ComputationalBasisState([0] * nqubits, basis),
                                 _lindblad_error_map(prep_type, basis))
    raise ValueError("Unknown prep type %r" % prep_type)


def _make_povm(ideal_effects, povm_type, basis, nqubits=None):
    """The POVM of type `povm_type`.  The computational and Lindblad types
    build on the Z-basis measurement of `nqubits` qubits, not on
    `ideal_effects`."""
    if povm_type in COMPUTATIONAL_SPAM_TYPES:
        _require_qubits('povm', povm_type, nqubits)
        return _pv.ComputationalBasisPOVM(nqubits, basis)
    if povm_type in ('full', 'full arbitrary'):
        return _pv.UnconstrainedPOVM(ideal_effects)
    if povm_type in ('full TP', 'TP'):
        return _pv.TPPOVM(ideal_effects)
    if povm_type in LINDBLAD_SPAM_TYPES:
        _require_qubits('povm', povm_type, nqubits)
        return _pv.ComposedPOVM(_lindblad_error_map(povm_type, basis),
                                _pv.ComputationalBasisPOVM(nqubits, basis))
    raise ValueError("Unknown povm type %r" % povm_type)


def embed_unitary_superop(u, target_qubits, all_qubits, basis='pp'):
    """The superoperator, in the `basis` basis of the whole register, of the
    unitary `u` acting on `target_qubits` of `all_qubits` and the identity
    on the others."""
    from pygsti_tpu_torch.baseobjs.statespace import QubitSpace
    nq_gate = int(round(np.log2(u.shape[0])))
    bname = basis if isinstance(basis, str) else basis.name
    small = np.real(_ot.unitary_to_superop(u, Basis(bname, 4 ** nq_gate)))
    return _op.Embedding(QubitSpace(tuple(all_qubits)), tuple(target_qubits))(small)


def state_space_qubits(state_space):
    """The qubit labels of a state space given as a list of labels or a list
    of one tuple of labels."""
    blocks = list(state_space)
    if blocks and all(isinstance(b, (tuple, list)) for b in blocks):
        if len(blocks) != 1:
            raise ValueError("state spaces of several tensor-product blocks are not ported")
        return tuple(blocks[0])
    return tuple(blocks)


def create_spam_vector(vec_expr, state_space, basis):
    """The superket |i><i| of the computational state named by the integer
    expression `vec_expr` ('0', '1', ...)."""
    udim = 2 ** len(state_space_qubits(state_space))
    idx = int(vec_expr)
    rho = np.zeros((udim, udim), dtype=complex)
    rho[idx, idx] = 1.0
    return np.real(stdmx_to_vec(rho, basis))


def _angle(s):
    return float(eval(s, {'pi': np.pi, 'sqrt': np.sqrt, '__builtins__': {}}))  # noqa: S307


def create_operation(op_expr, state_space, basis='pp', parameterization='full'):
    """The dense superoperator of an expression: 'I(Q0)', 'X(theta,Q0)',
    'Y(...)', 'Z(...)', 'N(theta, sx, sy, sz, Q0)' (a rotation about the
    axis (sx, sy, sz)), 'CX(theta,Q0,Q1)', 'CZ(theta,Q0,Q1)', 'CNOT(Q0,Q1)',
    'CPHASE(Q0,Q1)', and products of factors on disjoint qubits joined by
    ':' ('X(pi/2,Q0):Y(pi/2,Q1)').  Angles may use pi and sqrt."""
    qlbls = state_space_qubits(state_space)
    dim = 4 ** len(qlbls)
    parts = [p for p in op_expr.strip().split(':') if p.strip()]
    if len(parts) > 1:
        # factors on disjoint qubits commute: their product is the tensor product
        out = np.eye(dim)
        for part in parts:
            out = create_operation(part, state_space, basis, parameterization) @ out
        return out
    m = re.match(r'([A-Z]+)\((.*)\)\s*$', op_expr.strip())
    if not m:
        if op_expr.strip() in ('I', ''):
            return np.eye(dim)
        raise ValueError("Cannot parse operation expression %r" % op_expr)
    kind, argstr = m.group(1), m.group(2)
    args = [a.strip() for a in argstr.split(',')] if argstr else []
    if kind in ('X', 'Y', 'Z'):
        sigma = {'X': sigmaX, 'Y': sigmaY, 'Z': sigmaZ}[kind]
        u = scipy.linalg.expm(-1j * _angle(args[0]) / 2 * sigma)
        return embed_unitary_superop(u, (args[1],), qlbls, basis)
    if kind == 'I':
        return np.eye(dim)
    if kind in ('CX', 'CZ'):
        u4 = np.eye(4, dtype=complex)
        u4[2:, 2:] = scipy.linalg.expm(-1j * _angle(args[0]) / 2
                                       * (sigmaX if kind == 'CX' else sigmaZ))
        return embed_unitary_superop(u4, (args[1], args[2]), qlbls, basis)
    if kind == 'CNOT':
        u4 = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype=complex)
        return embed_unitary_superop(u4, (args[0], args[1]), qlbls, basis)
    if kind == 'CPHASE':
        return embed_unitary_superop(np.diag([1, 1, 1, -1]).astype(complex),
                                     (args[0], args[1]), qlbls, basis)
    if kind == 'N':
        sx, sy, sz = (_angle(a) for a in args[1:4])
        u = scipy.linalg.expm(-1j * _angle(args[0]) / 2
                              * (sx * sigmaX + sy * sigmaY + sz * sigmaZ))
        return embed_unitary_superop(u, (args[4],), qlbls, basis)
    raise ValueError("Unknown operation kind %r" % kind)


def create_explicit_model_from_expressions(state_space, op_labels, op_expressions,
                                           prep_labels=('rho0',), prep_expressions=('0',),
                                           effect_labels='standard',
                                           effect_expressions='standard',
                                           povm_labels='Mdefault', basis='pp',
                                           gate_type='full', prep_type='auto',
                                           povm_type='auto'):
    """An ExplicitOpModel from expression strings (create_operation,
    create_spam_vector); 'standard' effects are the computational basis,
    labelled by bit strings.  The SPAM types follow `gate_type` when
    'auto' ('TP' gates get 'full TP' SPAM)."""
    from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel
    qlbls = state_space_qubits(state_space)
    nq = len(qlbls)
    basis_obj = Basis.cast(basis, 4 ** nq)
    if prep_type == 'auto':
        prep_type = 'full TP' if gate_type in ('full TP', 'TP') else gate_type
    if povm_type == 'auto':
        povm_type = 'full TP' if gate_type in ('full TP', 'TP') else gate_type
    mdl = ExplicitOpModel(4 ** nq, basis_obj, gate_type, prep_type, povm_type)
    for plbl, pexpr in zip(prep_labels, prep_expressions):
        mdl.preps[Label(plbl)] = _make_prep(create_spam_vector(pexpr, qlbls, basis_obj),
                                            prep_type, basis_obj, nq)
    if effect_labels == 'standard':
        effect_labels = [format(i, '0%db' % nq) for i in range(2 ** nq)]
        effect_expressions = [str(i) for i in range(2 ** nq)]
    effects = collections.OrderedDict(
        (elbl, create_spam_vector(eexpr, qlbls, basis_obj))
        for elbl, eexpr in zip(effect_labels, effect_expressions))
    for povm_lbl in ((povm_labels,) if isinstance(povm_labels, str) else povm_labels):
        mdl.povms[Label(povm_lbl)] = _make_povm(effects, povm_type, basis_obj, nq)
    for olbl, oexpr in zip(op_labels, op_expressions):
        mdl.operations[Label(olbl)] = _make_op(create_operation(oexpr, qlbls, basis_obj),
                                               gate_type, basis_obj)
    return mdl


def create_identity_vec(basis):
    """The identity superket in `basis` (a Basis)."""
    b = Basis.cast(basis, None)
    udim = int(round(np.sqrt(b.dim)))
    return np.real(np.asarray(stdmx_to_vec(np.eye(udim).astype(complex), b))).ravel()


def create_explicit_alias_model(mdl_primitives, alias_dict):
    """A copy of `mdl_primitives` whose operations are {alias label: the
    product of the primitive operations of a Circuit}, each a full
    operation; the SPAM is copied unchanged."""
    mdl_new = mdl_primitives.copy()
    mdl_new.operations.clear()
    mdl_new._derived_layers.clear()
    for alias_lbl, circuit in alias_dict.items():
        mx = np.eye(mdl_primitives.dim)
        for layer in circuit.layertup:
            mx = mdl_primitives.operations[layer].dense() @ mx
        mdl_new.operations[alias_lbl] = _op.FullArbitraryOp(mx)
    mdl_new._mark_for_rebuild()
    return mdl_new


def create_explicit_model(processor_spec, custom_gates=None, basis='pp',
                          ideal_gate_type='auto', ideal_prep_type='auto',
                          ideal_spam_type='auto', ideal_povm_type='auto',
                          simulator='auto', evotype=None, embed_gates=True):
    """An ExplicitOpModel whose operations are the processor spec's
    primitive operations, each embedded on the whole register, of type
    `ideal_gate_type` ('auto' is 'static'); the SPAM types follow
    `ideal_spam_type` when 'auto' ('auto' is 'computational').  A unitary
    type embeds the gate's unitary on the register directly, so the
    superoperator is never taken back to a unitary (at five qubits that
    costs seconds per operation).  `simulator` becomes the model's (a type
    name or a ForwardSimulator); `evotype` and `embed_gates` are accepted
    and not used."""
    from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel
    from pygsti_tpu_torch.baseobjs.statespace import QubitSpace
    if ideal_gate_type == 'auto':
        ideal_gate_type = 'static'
    if ideal_prep_type == 'auto':
        ideal_prep_type = ideal_spam_type if ideal_spam_type != 'auto' else 'computational'
    if ideal_povm_type == 'auto':
        ideal_povm_type = ideal_spam_type if ideal_spam_type != 'auto' else 'computational'
    pspec = processor_spec
    nq = pspec.num_qubits
    qlbls = tuple(pspec.qubit_labels)
    space = QubitSpace(qlbls)
    basis_obj = Basis.cast(basis, space.dim)
    mdl = ExplicitOpModel(space.dim, basis_obj, ideal_gate_type, ideal_prep_type,
                          ideal_povm_type, simulator)
    custom_gates = custom_gates or {}
    for lbl in pspec.primitive_op_labels:
        if lbl in custom_gates:
            mdl.operations[lbl] = custom_gates[lbl]
            continue
        if lbl == Label(()):
            u, targets = np.eye(2 ** nq, dtype=complex), qlbls
        else:
            u, targets = pspec.gate_unitaries[lbl.name], lbl.sslbls
        mx = embed_unitary_superop(u, targets, qlbls, basis_obj)
        if ideal_gate_type in ('static unitary', 'static standard', 'full unitary'):
            u_full = _op.Embedding(space, targets, unitary=True)(np.asarray(u, complex))
            mdl.operations[lbl] = _op.StaticUnitaryOp(u_full, basis_obj, superop=mx) \
                if ideal_gate_type != 'full unitary' else _op.FullUnitaryOp(u_full, basis_obj)
        else:
            mdl.operations[lbl] = _make_op(mx, ideal_gate_type, basis_obj)
    udim = 2 ** nq
    rho = np.zeros((udim, udim), dtype=complex)
    rho[0, 0] = 1.0
    mdl.preps[Label('rho0')] = _make_prep(np.real(stdmx_to_vec(rho, basis_obj)),
                                          ideal_prep_type, basis_obj, nq)
    effects = collections.OrderedDict()
    for i in range(udim):
        e = np.zeros((udim, udim), dtype=complex)
        e[i, i] = 1.0
        effects[format(i, '0%db' % nq)] = np.real(stdmx_to_vec(e, basis_obj))
    mdl.povms[Label('Mdefault')] = _make_povm(effects, ideal_povm_type, basis_obj, nq)
    return mdl


def _noise_op_for_gate(udim_gate, basis_name, depol=None, stochastic=None, lindblad=None):
    """The noise operation on a gate's qubits from its noise specification:
    a DepolarizeOp, a StochasticNoiseOp, an exp(Lindblad) of the given 'H'
    and 'S' coefficients ('H+s' when any S, C or A term is given, else
    'H'), composed in that order when several are given; None for none."""
    d2 = udim_gate * udim_gate
    factors = []
    if depol is not None:
        factors.append(_op.DepolarizeOp(d2, float(depol)))
    if stochastic is not None:
        factors.append(_op.StochasticNoiseOp(d2, Basis.cast('pp', d2),
                                             np.asarray(stochastic, dtype=float)))
    if lindblad is not None:
        coeffs = {(k[0],) + tuple(k[1:]): val for k, val in lindblad.items()}
        param = 'H+s' if any(k[0] in ('S', 'C', 'A') for k in coeffs) else 'H'
        init = {(k[0], k[1]): val for k, val in coeffs.items() if k[0] in ('H', 'S')}
        factors.append(_op.ExpErrorgenOp(_op.build_lindblad_errorgen(
            Basis.cast('pp', d2), param, initial_coeffs=init)))
    if not factors:
        return None
    return factors[0] if len(factors) == 1 else _op.ComposedOp(factors)


def create_crosstalk_free_model(processor_spec, custom_gates=None,
                                depolarization_strengths=None, stochastic_error_probs=None,
                                lindblad_error_coeffs=None,
                                depolarization_parameterization='depolarize',
                                stochastic_parameterization='stochastic',
                                lindblad_parameterization='auto', evotype=None,
                                simulator='auto', on_construction_error='raise',
                                independent_gates=False, independent_spam=True,
                                ensure_composed_gates=False, ideal_gate_type='auto',
                                ideal_spam_type='computational', implicit_idle_mode='none',
                                basis='pp'):
    """A crosstalk-free (local-noise) implicit model: each gate's noise, from
    the three dicts keyed by gate name, acts on its target qubits only, and
    one leaf per gate name serves every target.  A gate given as a function
    of label arguments becomes an op factory.  The settings the JAX package
    refuses raise NotImplementedError here with its words; `simulator`
    becomes the model's; `independent_spam` is accepted and not used."""
    from pygsti_tpu_torch.models.localnoisemodel import LocalNoiseModel
    from pygsti_tpu_torch.modelmembers.opfactory import UnitaryOpFactory
    if depolarization_parameterization != 'depolarize':
        raise NotImplementedError(
            "depolarization_parameterization=%r is not implemented (only "
            "'depolarize'); express the noise via stochastic_error_probs or "
            "lindblad_error_coeffs instead" % (depolarization_parameterization,))
    if stochastic_parameterization != 'stochastic':
        raise NotImplementedError(
            "stochastic_parameterization=%r is not implemented (only "
            "'stochastic')" % (stochastic_parameterization,))
    if lindblad_parameterization != 'auto':
        raise NotImplementedError(
            "lindblad_parameterization=%r is not implemented (only 'auto', "
            "which infers H/H+s blocks from the given coefficients)"
            % (lindblad_parameterization,))
    if evotype not in (None, 'default', 'densitymx'):
        raise NotImplementedError(
            "evotype=%r: the TPU pipeline implements dense superoperator "
            "(densitymx) semantics only" % (evotype,))
    if on_construction_error not in ('raise', 'warn'):
        raise ValueError("on_construction_error must be 'raise' or 'warn'")
    if independent_gates:
        raise NotImplementedError(
            "independent_gates=True (independent parameters per gate "
            "instance) is not implemented; gate noise is shared by name")
    if ideal_gate_type not in ('auto', 'static', 'full', 'full TP', 'TP'):
        raise NotImplementedError(
            "ideal_gate_type=%r is not supported" % (ideal_gate_type,))
    if ideal_spam_type != 'computational':
        raise NotImplementedError(
            "ideal_spam_type=%r is not supported (only 'computational')"
            % (ideal_spam_type,))
    if implicit_idle_mode != 'none':
        raise NotImplementedError(
            "implicit_idle_mode=%r is not supported (only 'none'); model "
            "idle noise with an explicit '{idle}' gate instead"
            % (implicit_idle_mode,))
    pspec = processor_spec
    depolarization_strengths = depolarization_strengths or {}
    stochastic_error_probs = stochastic_error_probs or {}
    lindblad_error_coeffs = lindblad_error_coeffs or {}
    custom_gates = custom_gates or {}
    nq = pspec.num_qubits

    def noise_for(key):
        return (depolarization_strengths.get(key), stochastic_error_probs.get(key),
                lindblad_error_coeffs.get(key))

    gate_members = collections.OrderedDict()
    factory_fns = collections.OrderedDict()
    for name in pspec.gate_names:
        if name in ('{idle}', '(idle)'):
            continue
        u = pspec.gate_unitaries[name]
        if callable(u):
            factory_fns[name] = u
            continue
        udim = u.shape[0]
        smx = np.real(_ot.unitary_to_superop(u, Basis.cast(basis, udim * udim)))
        ideal = {'auto': _op.StaticArbitraryOp, 'static': _op.StaticArbitraryOp,
                 'full': _op.FullArbitraryOp}.get(ideal_gate_type, _op.FullTPOp)(smx)
        try:
            noise = _noise_op_for_gate(udim, basis, *noise_for(name))
        except Exception:
            if on_construction_error == 'raise':
                raise
            import warnings
            warnings.warn("Failed to construct noise for gate %r; proceeding without it"
                          % (name,))
            noise = None
        member = ideal if noise is None else _op.ComposedOp([ideal, noise])
        if ensure_composed_gates and not isinstance(member, _op.ComposedOp):
            member = _op.ComposedOp([member])
        gate_members[Label(name)] = custom_gates.get(name, member)
    idle_member = None
    idle_names = [n for n in pspec.gate_names if n in ('{idle}', '(idle)')]
    if idle_names:
        noise = _noise_op_for_gate(2 ** nq, basis, *noise_for(idle_names[0]))
        idle_member = noise if noise is not None else _op.StaticArbitraryOp(np.eye(4 ** nq))
    prep_member = _st.ComputationalBasisState([0] * nq, basis)
    pn = _noise_op_for_gate(2 ** nq, basis, *noise_for('rho0'))
    if pn is not None:
        prep_member = _st.ComposedState(prep_member, pn)
    povm_member = _pv.ComputationalBasisPOVM(nq, basis)
    mn = _noise_op_for_gate(2 ** nq, basis, *noise_for('Mdefault'))
    if mn is not None:
        povm_member = _pv.ComposedPOVM(mn, povm_member)
    mdl = LocalNoiseModel(pspec, gate_members, prep_member, povm_member, basis, idle_member,
                          simulator)
    for name, fn in factory_fns.items():
        try:
            udim = np.asarray(fn((0.0,))).shape[0]
        except Exception:
            udim = 2
        mdl.factories['gates'][name] = UnitaryOpFactory(fn, udim, basis)
    return mdl


def create_cloud_crosstalk_model(processor_spec, custom_gates=None,
                                 depolarization_strengths=None, stochastic_error_probs=None,
                                 lindblad_error_coeffs=None, evotype=None, simulator='auto',
                                 independent_gates=True, errcomp_type='gates',
                                 implicit_idle_mode='none', basis='pp', verbosity=0):
    """A cloud-crosstalk implicit model: a gate's noise may act on qubits
    other than its targets, given by stencils.

    ``lindblad_error_coeffs`` maps gate names to ``{(typ, spec): rate}``,
    `typ` 'H' or 'S' and `spec` ``'PAULIS:q1,q2,...'``, each q ``@k`` (the
    gate's k-th target) or an absolute qubit label, e.g. ``('H', 'X:@0')``,
    ``('S', 'XX:@0,@1')``, ``('S', 'X:2')``; a bare ``'PAULIS'`` acts on the
    gate's targets.  The union of the qubits a gate's terms touch is its
    cloud, one member per (gate, targets).  Depolarizing and stochastic
    noise act on the gate's targets, composed onto the gate.  The settings
    the JAX package refuses raise NotImplementedError with its words."""
    from pygsti_tpu_torch.models.cloudnoisemodel import CloudNoiseModel
    if evotype not in (None, 'default', 'densitymx'):
        raise NotImplementedError(
            "evotype=%r: only dense superoperator (densitymx) semantics are "
            "implemented" % (evotype,))
    if not independent_gates:
        raise NotImplementedError(
            "independent_gates=False (stencil-shared cloud parameters "
            "across gate instances) is not implemented: each (gate, "
            "targets) cloud gets its own parameters here")
    if errcomp_type != 'gates':
        raise NotImplementedError(
            "errcomp_type=%r is not implemented (only 'gates': noise "
            "composed as error maps)" % (errcomp_type,))
    if implicit_idle_mode != 'none':
        raise NotImplementedError(
            "implicit_idle_mode=%r is not supported (only 'none')"
            % (implicit_idle_mode,))
    pspec = processor_spec
    depolarization_strengths = depolarization_strengths or {}
    stochastic_error_probs = stochastic_error_probs or {}
    lindblad_error_coeffs = lindblad_error_coeffs or {}
    custom_gates = custom_gates or {}
    nq = pspec.num_qubits
    qlbls = tuple(pspec.qubit_labels)

    def resolve(spec, targets):
        """'PAULIS[:q1,q2]' -> [(Pauli letter, qubit), ...]."""
        if ':' in spec:
            paulis, qs = spec.split(':')
            qubits = []
            for q in qs.split(','):
                q = q.strip()
                if q.startswith('@'):
                    qubits.append(targets[int(q[1:])])
                else:
                    qubits.append(q if isinstance(qlbls[0], str) else type(qlbls[0])(q))
        else:
            paulis, qubits = spec, list(targets)
        if len(paulis) != len(qubits):
            raise ValueError("Pauli string %r does not match qubit list %r" % (paulis, qubits))
        return list(zip(paulis, qubits))

    def coefficients(lcoeffs, targets, cloud_of):
        """({(typ, Pauli string on the cloud): rate}, cloud)."""
        resolved = []
        for key, rate in lcoeffs.items():
            if key[0] not in ('H', 'S'):
                raise ValueError("cloud-crosstalk noise takes 'H' and 'S' terms")
            resolved.append((key[0], resolve(key[1], targets), rate))
        cloud = cloud_of(resolved)
        init = {}
        for typ, pq, rate in resolved:
            chars = ['I'] * len(cloud)
            for p, q in pq:
                chars[cloud.index(q)] = p
            init[(typ, ''.join(chars))] = init.get((typ, ''.join(chars)), 0.0) + rate
        return init, cloud

    def lindblad_map(init, n):
        param = 'H+s' if any(k[0] == 'S' for k in init) else 'H'
        return _op.ExpErrorgenOp(_op.build_lindblad_errorgen(
            Basis.cast(basis, 4 ** n), param, initial_coeffs=init))

    gate_members = collections.OrderedDict()
    cloud_members_blk = collections.OrderedDict()
    cloud_map = {}
    for name in pspec.gate_names:
        if name in ('{idle}', '(idle)'):
            continue
        u = pspec.gate_unitaries[name]
        udim = u.shape[0]
        member = custom_gates.get(name, _op.StaticArbitraryOp(
            np.real(_ot.unitary_to_superop(u, Basis.cast(basis, udim * udim)))))
        local_noise = _noise_op_for_gate(udim, basis, depolarization_strengths.get(name),
                                         stochastic_error_probs.get(name), None)
        if local_noise is not None:
            member = _op.ComposedOp([member, local_noise])
        gate_members[Label(name)] = member
        lcoeffs = lindblad_error_coeffs.get(name)
        if not lcoeffs:
            continue
        for targets in pspec.resolved_availability(name):
            targets = tuple(targets)
            init, cloud = coefficients(lcoeffs, targets, lambda res: tuple(sorted(
                {q for _, pq, _ in res for _, q in pq}, key=qlbls.index)))
            key = (name, targets)
            cloud_members_blk[key] = lindblad_map(init, len(cloud))
            cloud_map[(Label(name), targets)] = (key, cloud)
    idle_member = None
    for idle_name in ('{idle}', '(idle)'):
        lc = lindblad_error_coeffs.get(idle_name)
        if lc:
            init, _ = coefficients(lc, qlbls, lambda res: qlbls)
            idle_member = lindblad_map(init, nq)
    prep_member = _st.ComputationalBasisState([0] * nq, basis)
    pn = _noise_op_for_gate(2 ** nq, basis, depolarization_strengths.get('rho0'),
                            stochastic_error_probs.get('rho0'),
                            lindblad_error_coeffs.get('rho0'))
    if pn is not None:
        prep_member = _st.ComposedState(prep_member, pn)
    povm_member = _pv.ComputationalBasisPOVM(nq, basis)
    mn = _noise_op_for_gate(2 ** nq, basis, depolarization_strengths.get('Mdefault'),
                            stochastic_error_probs.get('Mdefault'),
                            lindblad_error_coeffs.get('Mdefault'))
    if mn is not None:
        povm_member = _pv.ComposedPOVM(mn, povm_member, basis)
    return CloudNoiseModel(pspec, gate_members, prep_member, povm_member, cloud_map,
                           cloud_members_blk, basis, idle_member, simulator)


def create_cloud_crosstalk_model_from_hops_and_weights(
        processor_spec, custom_gates=None, max_idle_weight=1,
        max_spam_weight=1, maxhops=0, extra_weight_1_hops=0,
        extra_gate_weight=0, simulator="auto", evotype=None,
        gate_type="H+S", spam_type="H+S", implicit_idle_mode="none",
        errcomp_type="gates", independent_gates=True, independent_spam=True,
        connected_highweight_errors=False, basis='pp', verbosity=0):
    """models.cloudnoisemodel.create_cloud_crosstalk_model_from_hops_and_weights
    with this module's defaults ('H+S' gates and SPAM), `independent_gates`
    passed as its `independent_clouds`; `independent_spam` is accepted and
    not used (one prep, one POVM)."""
    from pygsti_tpu_torch.models.cloudnoisemodel import \
        create_cloud_crosstalk_model_from_hops_and_weights as impl
    return impl(processor_spec, custom_gates=custom_gates, max_idle_weight=max_idle_weight,
                max_spam_weight=max_spam_weight, maxhops=maxhops,
                extra_weight_1_hops=extra_weight_1_hops, extra_gate_weight=extra_gate_weight,
                simulator=simulator, evotype=evotype, gate_type=gate_type,
                spam_type=spam_type, implicit_idle_mode=implicit_idle_mode,
                errcomp_type=errcomp_type, independent_clouds=independent_gates,
                connected_highweight_errors=connected_highweight_errors, basis=basis,
                verbosity=verbosity)
