"""RB theory: L-matrix predictions of RB decay rates
(reference: pygsti/tools/rbtheory.py, Proctor et al PRL 119, 130502 (2017)).

The decay parameter p in Pm = A + B p^m of an RB experiment sampled uniformly
(or with `weights`) over a gate set is the second-largest-magnitude eigenvalue
of the L-matrix L = (1/W) sum_g w_g kron(G_g^T, T_g^-1).
"""

from __future__ import annotations

import warnings

import numpy as np

from pygsti_tpu_torch.tools.rbtools import p_to_r, r_to_p


def L_matrix(model, target_model, weights=None):  # noqa: N802
    """The weighted L operator as a matrix in the stacking convention
    (reference: rbtheory.L_matrix:290)."""
    keys = list(target_model.operations.keys())
    if weights is None:
        weights = {key: 1.0 for key in keys}
    normalizer = float(np.sum([weights[key] for key in keys]))
    L = 0
    for key in keys:
        G = model.operations[key].dense()
        T = target_model.operations[key].dense()
        L = L + weights[key] * np.kron(G.T, np.linalg.inv(T))
    return L / normalizer


def predicted_rb_decay_parameter(model, target_model, weights=None):
    """Second-largest-magnitude eigenvalue of the L-matrix (reference:
    rbtheory.predicted_rb_decay_parameter:98)."""
    try:
        L = L_matrix(model, target_model, weights=weights)
        evals = np.linalg.eigvals(L)
        mags = np.flipud(np.sort(np.absolute(evals)))
        if abs(mags[0] - 1) > 1e-12:
            warnings.warn("Output may be unreliable: the model is not "
                          "approximately trace-preserving.")
        p = float(mags[1])
    except np.linalg.LinAlgError:
        p = float('nan')
    return p


def predicted_rb_number(model, target_model, weights=None, d=None, rtype='EI'):
    """Predicted RB error rate r from the L-matrix theory (reference:
    rbtheory.predicted_rb_number:23)."""
    if d is None:
        d = int(round(np.sqrt(model.dim)))
    p = predicted_rb_decay_parameter(model, target_model, weights=weights)
    return p_to_r(p, d=d, rtype=rtype) if not np.isnan(p) else float('nan')


def rb_gauge(model, target_model, weights=None, eigenvector_weighting=1.0):
    """The gauge transformation matrix into the 'RB gauge', in which the
    L-matrix eigenvector with eigenvalue p defines the depolarizing direction
    (reference: rbtheory.rb_gauge:153)."""
    L = L_matrix(model, target_model, weights=weights)
    evals, evecs = np.linalg.eig(L)
    order = np.argsort(-np.abs(evals))
    # eigenvector for the decay eigenvalue (2nd largest), unstacked
    d2 = int(round(np.sqrt(L.shape[0])))
    vec_l = evecs[:, order[1]]
    B = vec_l.reshape(d2, d2, order='F')
    # mix in the identity direction (largest eigenvalue ~ 1)
    vec_1 = evecs[:, order[0]]
    B1 = vec_1.reshape(d2, d2, order='F')
    M = np.real(B + eigenvector_weighting * B1)
    if np.linalg.matrix_rank(M) < d2:
        warnings.warn("RB gauge matrix is singular; adjusting the "
                      "eigenvector weighting may help.")
    return M


def transform_to_rb_gauge(model, target_model, weights=None,
                          eigenvector_weighting=1.0):
    """A copy of `model` transformed into the RB gauge (reference:
    rbtheory.transform_to_rb_gauge:235)."""
    from pygsti_tpu_torch.models.gaugegroup import GaugeGroupElement
    M = rb_gauge(model, target_model, weights=weights,
                 eigenvector_weighting=eigenvector_weighting)
    mdl = model.copy()
    mdl.transform_inplace(GaugeGroupElement(M))
    return mdl


def errormaps(model, target_model):
    """Per-gate error maps E_g = G_g T_g^-1, plus the average error map under
    key 'Gavg' (reference: rbtheory.errormaps:478).  Returns a dict."""
    out = {}
    avg = 0
    keys = list(target_model.operations.keys())
    for key in keys:
        G = model.operations[key].dense()
        T = target_model.operations[key].dense()
        E = G @ np.linalg.inv(T)
        out[key] = E
        avg = avg + E
    out['Gavg'] = avg / len(keys)
    return out


def R_matrix(model, group, group_to_model=None, weights=None):
    """The RB 'R-matrix' of Proctor et al PRL 119, 130502 (2017),
    generalized to weighted subset sampling (reference:
    rbtheory.R_matrix:401)."""
    import numpy as _np
    if group_to_model is None:
        for key in model.operations.keys():
            assert group.label_indices([key]), "Gate labels not in `group`!"
    d2 = model.dim
    group_dim = len(group)
    R = _np.zeros((group_dim * d2, group_dim * d2), float)
    if weights is None:
        weights = {key: 1.0 for key in model.operations.keys()}
    normalizer = sum(weights[k] for k in model.operations.keys())
    for i in range(group_dim):
        inv_i = group.inverse_index(i)
        for j in range(group_dim):
            # the element taking group element i to j under left-to-right
            # circuit composition: C_j C_i^{-1} as a MATRIX product (the
            # reference's product() composes in circuit order; ours composes
            # in matrix order, hence [j, inv_i])
            label_itoj = group.labels[group.product([j, inv_i])]
            gslabel = None
            if group_to_model is not None:
                gslabel = group_to_model.get(label_itoj)
            elif label_itoj in model.operations:
                gslabel = label_itoj
            if gslabel is not None:
                R[j * d2:(j + 1) * d2, i * d2:(i + 1) * d2] = \
                    weights[gslabel] * model.operations[gslabel].dense()
    return R / normalizer


def R_matrix_predicted_rb_decay_parameter(model, group, group_to_model=None,
                                          weights=None):
    """The RB decay parameter predicted by the R-matrix: its second-largest
    'eigenvalue in magnitude after the trivial unit eigenvalue (reference:
    rbtheory.R_matrix_predicted_rb_decay_parameter:352)."""
    import numpy as _np
    E = _np.absolute(_np.linalg.eigvals(
        R_matrix(model, group, group_to_model, weights)))
    E = _np.flipud(_np.sort(E))
    return float(E[1])
