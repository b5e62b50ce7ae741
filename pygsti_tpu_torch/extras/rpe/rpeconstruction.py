"""Config-driven RPE models, circuits and data (counterpart of
pygsti_tpu/extras/rpe/rpeconstruction.py)."""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.circuits.circuit import Circuit


def create_parameterized_rpe_model(alpha_true, epsilon_true, aux_rot, spam_depol,
                                   gate_depol=None, with_id=True, rpeconfig_inst=None):
    """A one-qubit model whose Gx rotates about X by `alpha_true` and whose
    Gy rotates about Y by `epsilon_true`, tilted by the Z rotation
    `aux_rot`, then depolarized.  Only the standard (X, Y) configuration is
    implemented; another raises NotImplementedError."""
    if rpeconfig_inst is not None:
        axes = (getattr(rpeconfig_inst, 'fixed_axis_label', 'X'),
                getattr(rpeconfig_inst, 'loose_axis_label', 'Y'))
        if axes != ('X', 'Y'):
            raise NotImplementedError("rpeconfig with axes (%s, %s) is not supported; only the "
                                      "standard (X, Y) configuration is implemented" % axes)
    from pygsti_tpu_torch.modelmembers.operations import FullArbitraryOp
    from pygsti_tpu_torch.models.modelconstruction import create_explicit_model_from_expressions
    gates = (['Gi'] if with_id else []) + ['Gx', 'Gy']
    exprs = (["I(Q0)"] if with_id else []) + \
        ["X(%.12f,Q0)" % alpha_true, "Y(%.12f,Q0)" % epsilon_true]
    model = create_explicit_model_from_expressions(['Q0'], gates, exprs)
    if aux_rot != 0:
        aux = create_explicit_model_from_expressions(['Q0'], ['Gz'], ["Z(%.12f,Q0)" % aux_rot])
        gz = aux.operations[_find(aux, 'Gz')].dense()
        gy_lbl = _find(model, 'Gy')
        model.operations[gy_lbl] = FullArbitraryOp(
            np.linalg.inv(gz) @ model.operations[gy_lbl].dense() @ gz)
    if gate_depol:
        model = model.depolarize(op_noise=gate_depol)
    if spam_depol:
        model = model.depolarize(spam_noise=spam_depol)
    return model


def _find(model, name):
    from pygsti_tpu_torch.baseobjs.label import Label
    for cand in (name, Label(name, 0)):
        if cand in model.operations:
            return cand
    raise KeyError(name)


def create_rpe_angle_circuit_lists(k_list, angle_name, rpeconfig_inst):
    """(sine circuits, cosine circuits) of an angle: prep + germ^k + meas
    for each k of `k_list`, from the config's tuples."""
    def tup(kind, part):
        return list(getattr(rpeconfig_inst, '%s_%s_%s_tuple' % (angle_name, kind, part)))
    cos_list = [Circuit(tup('cos', 'prep')) + Circuit(tup('cos', 'germ')).repeat(k)
                + Circuit(tup('cos', 'meas')) for k in k_list]
    sin_list = [Circuit(tup('sin', 'prep')) + Circuit(tup('sin', 'germ')).repeat(k)
                + Circuit(tup('sin', 'meas')) for k in k_list]
    return sin_list, cos_list


def create_rpe_angle_circuits_dict(log2k_max_or_k_list, rpeconfig_inst):
    """{(angle, 'sin'|'cos'): circuits} for alpha, epsilon and theta, with
    'k_list' and 'totalCircList' (every circuit once, in first-seen order);
    an int n means k = 1, 2, ..., 2^n."""
    if isinstance(log2k_max_or_k_list, int):
        k_list = [2 ** k for k in range(log2k_max_or_k_list + 1)]
    else:
        k_list = list(log2k_max_or_k_list)
    d = {'k_list': k_list}
    all_circuits = []
    for angle in ('alpha', 'epsilon', 'theta'):
        sin_l, cos_l = create_rpe_angle_circuit_lists(k_list, angle, rpeconfig_inst)
        d[angle, 'sin'], d[angle, 'cos'] = sin_l, cos_l
        for c in sin_l + cos_l:
            if c not in all_circuits:
                all_circuits.append(c)
    d['totalCircList'] = all_circuits
    return d


def create_rpe_dataset(model_or_dataset, string_list_d, n_samples, sample_error='binomial',
                       seed=None, device="cuda"):
    """Data of the dictionary's circuits simulated from the model on
    `device` (multinomial counts, which for two outcomes are binomial)."""
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    return simulate_data(model_or_dataset, string_list_d['totalCircList'], n_samples,
                         seed=seed, device=device)
