"""Config-driven RPE estimation (counterpart of
pygsti_tpu/extras/rpe/rpetools.py): per-generation estimates of the
angles alpha, epsilon and theta from counts, the angles of a model, and
analyze_rpe_data."""

from __future__ import annotations

import numpy as np
import scipy.optimize as _opt


def extract_rotation_hat(xhat, yhat, k, nx, ny, angle_name="epsilon",
                         previous_angle=None, rpeconfig_inst=None):
    """Angle estimate for one germ generation, branch-selected to lie within
    pi/k of the previous generation's estimate."""
    fn = {'alpha': rpeconfig_inst.alpha_hat_func,
          'epsilon': rpeconfig_inst.epsilon_hat_func,
          'Phi': rpeconfig_inst.Phi_hat_func}[angle_name]
    arctan2_val = fn(xhat, yhat, nx, ny)
    if k == 1:
        return arctan2_val
    if previous_angle is None:
        raise ValueError("Need previous_angle for k > 1")
    angle_j = arctan2_val / k
    while angle_j <= previous_angle - np.pi / k:
        angle_j += 2 * np.pi / k
    while angle_j > previous_angle + np.pi / k:
        angle_j -= 2 * np.pi / k
    return angle_j


def _counts(dataset, circ, labels):
    row = dataset[circ]
    return sum(row.counts.get(l if isinstance(l, tuple) else (l,), 0)
               for l in labels)


def estimate_angles(dataset, angle_sin_strs, angle_cos_strs,
                    angle_name="epsilon", length_list=None,
                    rpeconfig_inst=None):
    """Per-generation angle estimates."""
    up = rpeconfig_inst.up_labels
    dn = rpeconfig_inst.dn_labels
    n_gen = len(angle_sin_strs)
    if length_list is None:
        length_list = [2 ** k for k in range(n_gen)]
    prev = None
    out = []
    for i, length in enumerate(length_list):
        xhat = _counts(dataset, angle_sin_strs[i], up)
        yhat = _counts(dataset, angle_cos_strs[i], up)
        nx = xhat + _counts(dataset, angle_sin_strs[i], dn)
        ny = yhat + _counts(dataset, angle_cos_strs[i], dn)
        prev = extract_rotation_hat(xhat, yhat, length, nx, ny, angle_name,
                                    prev, rpeconfig_inst)
        out.append(prev)
    return out


def _sin_phi2(theta, phi, epsilon, rpeconfig_inst=None):
    """Zero of this function (in theta) satisfies RPE Eq. III.7."""
    new_eps = rpeconfig_inst.new_epsilon_func(epsilon)
    return np.abs(2 * np.sin(theta) * np.cos(np.pi * new_eps / 2)
                  * np.sqrt(1 - np.sin(theta) ** 2
                            * np.cos(np.pi * new_eps / 2) ** 2)
                  - np.sin(phi / 2))


def estimate_thetas(dataset, angle_sin_strs, angle_cos_strs, epsilon_list,
                    return_phi_fun_list=False, rpeconfig_inst=None):
    """Per-generation theta (axis-tilt) estimates."""
    phi_list = estimate_angles(dataset, angle_sin_strs, angle_cos_strs,
                               'Phi', rpeconfig_inst=rpeconfig_inst)
    thetas, phifuns = [], []
    for phi, eps in zip(phi_list, epsilon_list):
        soln = _opt.minimize(lambda x: _sin_phi2(x[0], phi, eps,
                                                 rpeconfig_inst), [0.0])
        thetas.append(float(soln.x[0]))
        phifuns.append(float(soln.fun))
    return (thetas, phifuns) if return_phi_fun_list else thetas


def extract_alpha(model, rpeconfig_inst):
    """Fixed-axis rotation angle of a model (gauge-variant!)."""
    from pygsti_tpu_torch.tools.optools import decompose_gate_matrix
    op = model.operations[_label_for(model, rpeconfig_inst.fixed_axis_gate_label)]
    decomp = decompose_gate_matrix(op.dense())
    return decomp['pi rotations'] * np.pi


def extract_epsilon(model, rpeconfig_inst):
    """Loose-axis rotation angle."""
    from pygsti_tpu_torch.tools.optools import decompose_gate_matrix
    op = model.operations[_label_for(model, rpeconfig_inst.loose_axis_gate_label)]
    decomp = decompose_gate_matrix(op.dense())
    return decomp['pi rotations'] * np.pi


def extract_theta(model, rpeconfig_inst):
    """Angle between the loose rotation axis and its target."""
    from pygsti_tpu_torch.tools.optools import decompose_gate_matrix
    op = model.operations[_label_for(model, rpeconfig_inst.loose_axis_gate_label)]
    decomp = decompose_gate_matrix(op.dense())
    target = np.array(rpeconfig_inst.loose_axis_target[1:], float)
    target = target / np.linalg.norm(target)
    axis = np.asarray(decomp['axis of rotation'][1:], float)
    nrm = np.linalg.norm(axis)
    if nrm < 1e-12:
        return 0.0
    axis = axis / nrm
    cosang = np.clip(abs(np.dot(axis, target)), 0, 1.0)
    return float(np.arccos(cosang))


def _label_for(model, name):
    from pygsti_tpu_torch.baseobjs.label import Label
    for cand in (name, Label(name), Label(name, 0), Label(name, (0,))):
        if cand in model.operations:
            return cand
    raise KeyError("No operation %r in model" % name)


def analyze_rpe_data(input_dataset, true_or_target_model, string_list_d,
                     rpeconfig_inst, do_consistency_check=False,
                     k_list=None):
    """Full RPE analysis: alpha/epsilon/theta per-generation estimates and
    errors vs the true model."""
    alphas = estimate_angles(input_dataset, string_list_d['alpha', 'sin'],
                             string_list_d['alpha', 'cos'], 'alpha',
                             rpeconfig_inst=rpeconfig_inst)
    epsilons = estimate_angles(input_dataset, string_list_d['epsilon', 'sin'],
                               string_list_d['epsilon', 'cos'], 'epsilon',
                               rpeconfig_inst=rpeconfig_inst)
    thetas = estimate_thetas(input_dataset, string_list_d['theta', 'sin'],
                             string_list_d['theta', 'cos'], epsilons,
                             rpeconfig_inst=rpeconfig_inst)
    results = {'alphaHatList': alphas, 'epsilonHatList': epsilons,
               'thetaHatList': thetas}
    alpha_true = extract_alpha(true_or_target_model, rpeconfig_inst)
    eps_true = extract_epsilon(true_or_target_model, rpeconfig_inst)
    theta_true = extract_theta(true_or_target_model, rpeconfig_inst)
    results['alphaErrorList'] = [abs(alpha_true - a) for a in alphas]
    results['epsilonErrorList'] = [abs(eps_true - e) for e in epsilons]
    results['thetaErrorList'] = [abs(theta_true - t) for t in thetas]

    if do_consistency_check:
        # lower-triangular-by-column consistency matrices: entry (i, j) =
        # is the stage-i estimate within pi/(2 k_i) of the stage-j estimate
        import numpy as _np
        if k_list is None:
            raise ValueError("Consistency check requested, but no k List "
                             "given!")
        num_ks = len(k_list)
        for key, vals in (('alphaCheckMat', alphas),
                          ('epsilonCheckMat', epsilons),
                          ('thetaCheckMat', thetas)):
            mat = _np.zeros([num_ks, num_ks], float)
            for j in range(num_ks):
                for i, k_small in enumerate(k_list[:j + 1]):
                    mat[i, j] = consistency_check(vals[i], vals[j], k_small)
            results[key] = mat
    return results


def consistency_check(angle_k, angle_final, k):
    """1.0 if the stage-k angle estimate lies within pi/(2k) of the final
    estimate (mod 2pi), else 0.0."""
    import numpy as _np
    wedge = _np.pi / (2 * k)
    a = (_np.asarray(angle_k) + _np.pi) % (2 * _np.pi) - _np.pi
    b = (_np.asarray(angle_final) + _np.pi) % (2 * _np.pi) - _np.pi
    for shift in (0.0, 2 * _np.pi, -2 * _np.pi):
        if _np.abs(a - (b + shift)) <= wedge:
            return 1.0
    return 0.0
