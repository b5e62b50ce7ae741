"""What the legacy packs share (counterpart of
pygsti_tpu/modelpacks/legacy/_legacy.py).

A legacy pack takes its fiducials and germs from the matching smq pack,
each layer renamed to its positional legacy name ('Gxpi2:1' on two qubits
is 'Gix', '[]' is 'Gii'), on line '*', and builds its target model from
the gate expressions of modelconstruction.create_operation.
"""

from __future__ import annotations

import collections

from pygsti_tpu_torch.circuits.circuit import Circuit

_CHAR = {'Gxpi2': 'x', 'Gypi2': 'y', 'Gzpi2': 'z', 'Gxpi4': 'x', 'Gn': 'n'}


def _legacy_layer_name(layer, nq):
    """The legacy gate name of an smq layer label."""
    comps = tuple(layer.components) if not layer.is_simple else (layer,)
    if len(comps) == 0:
        return 'Gi' if nq == 1 else 'Gii'
    if len(comps) == 1 and len(comps[0].sslbls or (0,)) > 1:
        return comps[0].name          # a multi-qubit gate keeps its name (Gcnot, ...)
    if nq == 1:
        return 'G' + _CHAR[comps[0].name]
    chars = ['i'] * nq
    for lbl in comps:
        chars[int((lbl.sslbls or (0,))[0])] = _CHAR[lbl.name]
    return 'G' + ''.join(chars)


def convert_circuit_strs(strs, nq):
    """smq circuit strings -> legacy Circuits on line '*'."""
    return [Circuit(tuple(_legacy_layer_name(l, nq) for l in Circuit(s).layertup),
                    line_labels=('*',)) for s in strs]


def populate(ns, smq_pack, description, gates, state_space, op_labels, op_expressions,
             effect_labels=None, effect_expressions=None):
    """Fill the namespace `ns` of a legacy module with the legacy surface
    derived from `smq_pack` (a GSTModelPack) and the expression table of
    its target model."""
    from pygsti_tpu_torch.models.modelconstruction import (
        create_explicit_model_from_expressions, state_space_qubits)

    nq = smq_pack._nqubits
    prep_strs = convert_circuit_strs(smq_pack._prep_fids, nq)
    effect_strs = convert_circuit_strs(smq_pack._meas_fids, nq)
    germs = convert_circuit_strs(smq_pack._germs, nq)
    germs_lite = convert_circuit_strs(smq_pack._germs_lite if smq_pack._germs_lite is not None
                                      else smq_pack._germs, nq)

    def target_model(parameterization_type="full", sim_type="auto"):
        kwargs = {}
        if effect_labels is not None:
            kwargs = {'effect_labels': effect_labels, 'effect_expressions': effect_expressions}
        mdl = create_explicit_model_from_expressions(state_space, list(op_labels),
                                                     list(op_expressions), **kwargs)
        if parameterization_type not in ("full", "full arbitrary"):
            mdl.set_all_parameterizations(parameterization_type)
        return mdl

    def processor_spec():
        return target_model('static').create_processor_spec(state_space_qubits(state_space))

    ns.update(description=description, gates=list(gates), prepStrs=prep_strs,
              effectStrs=effect_strs, fiducials=prep_strs, prep_fiducials=prep_strs,
              meas_fiducials=effect_strs, germs=germs, germs_lite=germs_lite,
              target_model=target_model, processor_spec=processor_spec)
    cc = _clifford_compilation_for(smq_pack, gates)
    if cc is not None:
        ns['clifford_compilation'] = cc


def _clifford_compilation_for(smq_pack, legacy_gates):
    """The legacy Clifford compilation table from the smq pack's
    breadth-first one: 'Gc0'..'Gc23' for a one-qubit pack; for a two-qubit
    pack with per-qubit x/y gates and 'Gii', the paired 'Gc{i}c{j}' table
    (all 576 pairs when it has the parallel gates 'Gxx', 'Gyy', 'Gxy',
    'Gyx', else the one-sided 'Gc0c{j}' and 'Gc{i}c0'); else None."""
    nq = smq_pack._nqubits
    if nq == 1:
        base = smq_pack.clifford_compilation()
        if base is None:
            return None
        out = collections.OrderedDict()
        for cname, word in base.items():
            names = ['G' + _CHAR[lbl[0]] for lbl in word if lbl != ()]
            if not names:
                names = ['Gi'] if 'Gi' in legacy_gates else \
                    ['G' + _CHAR[smq_pack._gates[0]]] * 4
            out[cname] = names
        return out
    if nq == 2 and {'Gxi', 'Gyi', 'Gix', 'Giy', 'Gii'} <= set(legacy_gates):
        from pygsti_tpu_torch.modelpacks.smq1Q_XYI import _Pack as _XYI
        base = _XYI.clifford_compilation()
        if base is None:
            return None
        chars = {c: ([_CHAR[lbl[0]] for lbl in w if lbl != ()] or ['i'])
                 for c, w in base.items()}
        maxlen = max(len(v) for v in chars.values())
        full = {'Gxx', 'Gyy', 'Gxy', 'Gyx'} <= set(legacy_gates)
        pairs = [(i, j) for i in range(24) for j in range(24)] if full \
            else [(0, j) for j in range(24)] + [(i, 0) for i in range(1, 24)]
        out = collections.OrderedDict()
        for i, j in pairs:
            ci, cj = chars['Gc%d' % i], chars['Gc%d' % j]
            out['Gc%dc%d' % (i, j)] = [
                'G' + (ci[k] if k < len(ci) else 'i') + (cj[k] if k < len(cj) else 'i')
                for k in range(maxlen)]
        return out
    return None
