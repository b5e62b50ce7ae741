"""Idle-tomography combinatorial helpers and the bridges between a model's
global idle and intrinsic rates (counterpart of
pygsti_tpu/extras/idletomography/idttools.py).  Host work only."""

from __future__ import annotations

import itertools

import numpy as np

from pygsti_tpu_torch.extras.idletomography.pauliobjs import (NQOutcome,
                                                        NQPauliState,
                                                        NQPauliOp)


def alloutcomes(prep, meas, maxweight):
    """Every "error bit string" a weight <= `maxweight` error could cause
    when preparing `prep` and measuring `meas` (same Pauli bases, possibly
    different signs) (reference: idttools.alloutcomes:26)."""
    if not (0 < maxweight <= 2):
        raise NotImplementedError("Only maxweight <= 2 is supported")
    assert prep.rep == meas.rep, "`prep` and `meas` must share a basis!"
    expected = NQOutcome(''.join(
        '0' if s1 == s2 else '1' for s1, s2 in zip(prep.signs, meas.signs)))
    n = len(prep)
    out = [expected.flip(i) for i in range(n)]
    if maxweight == 2:
        out += [expected.flip(i, j)
                for i in range(n) for j in range(i + 1, n)]
    return out


def allerrors(nqubits, maxweight):
    """All weight <= `maxweight` Pauli errors on `nqubits` qubits
    (reference: idttools.allerrors:57)."""
    if not (0 < maxweight <= 2):
        raise NotImplementedError("Only maxweight <= 2 is supported")
    out = [NQPauliOp.weight_1_pauli(nqubits, loc, p)
           for loc in range(nqubits) for p in range(3)]
    if maxweight == 2:
        out += [NQPauliOp.weight_2_pauli(nqubits, l1, l2, p1, p2)
                for l1 in range(nqubits) for l2 in range(l1 + 1, nqubits)
                for p1 in range(3) for p2 in range(3)]
    return out


def allobservables(meas, maxweight):
    """All weight <= `maxweight` observables extractable from the local
    Pauli measurement `meas` (always '+' sign) (reference:
    idttools.allobservables:80)."""
    if not (0 < maxweight <= 2):
        raise NotImplementedError("Only maxweight <= 2 is supported")
    full = NQPauliOp(meas.rep)
    out = [full.subpauli([i]) for i in range(len(meas))]
    if maxweight == 2:
        out += [full.subpauli([i, j])
                for i in range(len(meas)) for j in range(i + 1, len(meas))]
    return out


def tile_pauli_fidpairs(base_fidpairs, nqubits, maxweight):
    """Tile `maxweight`-qubit (prep, meas) NQPauliState pairs onto
    `nqubits` qubits via a k-coverage template so that every size-
    `maxweight` qubit subset experiences every base pair (reference:
    idttools.tile_pauli_fidpairs:107)."""
    from pygsti_tpu_torch.circuits.cloudcircuitconstruction import \
        create_kcoverage_template
    tmpl = create_kcoverage_template(nqubits, maxweight)
    out = []
    seen = set()
    for base_prep, base_meas in base_fidpairs:
        for row in tmpl:
            prep = NQPauliState(''.join(base_prep.rep[i] for i in row),
                                [base_prep.signs[i] for i in row])
            meas = NQPauliState(''.join(base_meas.rep[i] for i in row),
                                [base_meas.signs[i] for i in row])
            key = (str(prep), tuple(prep.signs), str(meas), tuple(meas.signs))
            if key not in seen:
                seen.add(key)
                out.append((prep, meas))
    return out


def nontrivial_paulis(wt):
    """All length-`wt` tuples over {'X','Y','Z'} (reference:
    idttools.nontrivial_paulis:153)."""
    return list(itertools.product(('X', 'Y', 'Z'), repeat=wt))


# -- model <-> intrinsic-rate bridges (reference: idttools.py:172-549) --------

def _global_idle_op(model):
    """Locate the model's global-idle operator (Label(()) layer)."""
    from pygsti_tpu_torch.baseobjs.label import Label
    idle_lbl = Label(())
    if hasattr(model, 'operations') and idle_lbl in model.operations:
        return model.operations[idle_lbl]
    blks = getattr(model, 'operation_blks', None)
    if blks:
        for blk in blks.values():
            if idle_lbl in blk:
                return blk[idle_lbl]
    raise ValueError("Model has no global idle (Label(())) operation")


def _idle_errgen_factors(model):
    """Yield (exp_errorgen_op, target_qubit_indices) for each factor of the
    global idle (handles bare / composed / embedded ExpErrorgenOp)."""
    from pygsti_tpu_torch.modelmembers.operations import (ComposedOp, EmbeddedOp,
                                                          ExpErrorgenOp)
    idle = _global_idle_op(model)
    factors = idle.factors if isinstance(idle, ComposedOp) else [idle]

    def qindex(lbl, all_lbls):
        if isinstance(lbl, int):
            return lbl
        s = str(lbl)
        return int(s[1:]) if s[:1] in ('Q', 'q') and s[1:].isdigit() \
            else all_lbls.index(lbl)

    for f in factors:
        if isinstance(f, EmbeddedOp):
            all_lbls = list(f.state_space.tensor_product_block_labels)
            op, targets = f.embedded_op, [qindex(t, all_lbls) for t in f.target_labels]
        else:
            # an op on the whole register: the model's qubits in order
            op, targets = f, list(range(int(round(np.log2(model.dim) / 2))))
        if isinstance(op, ExpErrorgenOp):
            yield op, targets


def set_idle_errors(nqubits, model, errdict, rand_default=None,
                    hamiltonian=True, stochastic=True, affine=False):
    """Set specific (or random) H/S error-generator rates on the model's
    global idle (reference: idttools.set_idle_errors:172).  `errdict` keys
    are "H(<paulis>)" / "S(<paulis>)" with an nqubits-long Pauli string,
    e.g. "S(XIZ)"; values are rates in the IDT (intrinsic) convention.
    Returns the array of randomly-chosen rates."""
    from pygsti_tpu_torch.baseobjs.errorgenlabel import LocalElementaryErrorgenLabel
    assert not affine, "Affine errors are no longer supported (reference parity)"
    rng_rates = []
    i_rand = 0
    for op, targets in _idle_errgen_factors(model):
        w = len(targets)
        # IDT intrinsic rate -> coefficient scale (normalized-Pauli elementary
        # errorgens): H coeff c gives intrinsic 2^(1-w/2) c; S gives 2^-w c
        h_scale = 2.0 ** (1 - w / 2.0)
        s_scale = 2.0 ** (-w)
        coeffs = {}
        for lbl in op.errorgen_coefficient_labels():
            p_local = lbl.basis_element_labels[0]
            lst = ['I'] * nqubits
            for ii, t in enumerate(targets):
                lst[t] = p_local[ii]
            label = ''.join(lst)
            key = "%s(%s)" % (lbl.errorgen_type, label)
            if key in errdict:
                rate = errdict[key]
            elif rand_default is None:
                rate = 0.0
            elif isinstance(rand_default, float):
                rate = rand_default * np.random.random()
                rng_rates.append(rate)
            else:
                rate = rand_default[i_rand]
                i_rand += 1
            if lbl.errorgen_type == 'H' and hamiltonian:
                coeffs[lbl] = rate / h_scale
            elif lbl.errorgen_type == 'S' and stochastic:
                coeffs[lbl] = rate / s_scale
        op.set_errorgen_coefficients(coeffs)
    if hasattr(model, '_mark_for_rebuild'):
        model._mark_for_rebuild()
    return np.array(rng_rates, 'd')


def extract_idle_errors(nqubits, model, hamiltonian=True, stochastic=True,
                        affine=False, scale_for_idt=True):
    """Nonzero H/S rates on the global idle, keyed by full-length Pauli
    label (reference: idttools.extract_idle_errors:292)."""
    ham_rates, sto_rates, aff_rates = {}, {}, {}
    for op, targets in _idle_errgen_factors(model):
        w = len(targets)
        h_scale = 2.0 ** (1 - w / 2.0) if scale_for_idt else 1.0
        s_scale = 2.0 ** (-w) if scale_for_idt else 1.0
        for lbl, val in op.errorgen_coefficients().items():
            if abs(val) <= 1e-12:
                continue
            p_local = lbl.basis_element_labels[0]
            lst = ['I'] * nqubits
            for ii, t in enumerate(targets):
                lst[t] = p_local[ii]
            label = ''.join(lst)
            if lbl.errorgen_type == 'H' and hamiltonian:
                ham_rates[label] = float(val) * h_scale
            elif lbl.errorgen_type == 'S' and stochastic:
                sto_rates[label] = float(val) * s_scale
            elif lbl.errorgen_type == 'A' and affine:
                # affine idle errors are the 'A'-type elementary generators
                # (reference idttools.extract_idle_errors affine rates)
                aff_rates[label] = float(val) * s_scale
    return ham_rates, sto_rates, aff_rates


def predicted_intrinsic_rates(nqubits, maxweight, model, hamiltonian=True,
                              stochastic=True, affine=False):
    """The exact intrinsic rates idle tomography should recover from `model`
    (reference: idttools.predicted_intrinsic_rates:367).  Returns
    (ham_rates, sto_rates, aff_rates) arrays ordered like
    allerrors(nqubits, maxweight); None for disabled types."""
    error_labels = [str(op.rep) for op in allerrors(nqubits, maxweight)]
    ham = np.zeros(len(error_labels)) if hamiltonian else None
    sto = np.zeros(len(error_labels)) if stochastic else None
    aff = np.zeros(len(error_labels)) if affine else None
    ham_d, sto_d, _ = extract_idle_errors(nqubits, model, hamiltonian,
                                          stochastic, False, True)
    if hamiltonian:
        for label, rate in ham_d.items():
            if label in error_labels:
                ham[error_labels.index(label)] = rate
    if stochastic:
        for label, rate in sto_d.items():
            if label in error_labels:
                sto[error_labels.index(label)] = rate
    return ham, sto, aff


def predicted_observable_rates(idtresults, typ, nqubits, maxweight, model):
    """The exact observable rates `model` predicts for the configurations in
    `idtresults` -- rate = J_row . intrinsic (reference:
    idttools.predicted_observable_rates:469).  `typ` is 'samebasis' or
    'diffbasis'; returns {fidpair: {outcome_or_obs: rate}}."""
    intrinsic = None
    ret = {}
    ne = len(idtresults.error_list)
    if typ == "samebasis":
        for fidpair, dict_of_infos in zip(idtresults.pauli_fidpairs[typ],
                                          idtresults.observed_rate_infos[typ]):
            ret[fidpair] = {}
            for obs_or_out, info in dict_of_infos.items():
                jrow = info['jacobian row']
                if intrinsic is None:
                    affine = bool(len(jrow) == 2 * ne)
                    _, sto, aff = predicted_intrinsic_rates(
                        nqubits, maxweight, model, False, True, affine)
                    intrinsic = np.concatenate([sto, aff]) if affine else sto
                ret[fidpair][obs_or_out] = float(np.dot(jrow, intrinsic))
    elif typ == "diffbasis":
        for fidpair, dict_of_infos in zip(idtresults.pauli_fidpairs[typ],
                                          idtresults.observed_rate_infos[typ]):
            ret[fidpair] = {}
            for obs_or_out, info in dict_of_infos.items():
                jrow = info['jacobian row']
                if intrinsic is None:
                    affine = 'affine jacobian row' in info
                    ham, _, aff = predicted_intrinsic_rates(
                        nqubits, maxweight, model, True, False, affine)
                    intrinsic = (ham, aff)
                rate = float(np.dot(jrow, intrinsic[0]))
                if 'affine jacobian row' in info:
                    rate += float(np.dot(info['affine jacobian row'],
                                         intrinsic[1]))
                ret[fidpair][obs_or_out] = rate
    else:
        raise ValueError("Unknown `typ` argument: %s" % typ)
    return ret
