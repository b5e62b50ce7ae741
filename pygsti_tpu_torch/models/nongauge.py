"""The model's parameter space split into gauge and non-gauge directions
(counterpart of pygsti_tpu/models/nongauge.py).

The gauge directions are the derivatives, at the identity, of the gauge
group's action S on the model's tensors (G -> S^-1 G S, rho -> S^-1 rho,
E -> E S), pulled back to parameter space through Tv = d tensors / d v.
Both Jacobians are taken on `device`: Tv from the model's own
``flat_tensors_jacobian_fn``, the action's by ``torch.func.jacfwd`` of the
group's ``element_matrix``.
"""

from __future__ import annotations

import numpy as np
import torch

from pygsti_tpu_torch import DTYPE


def nongauge_and_gauge_spaces(model, tol=1e-7, device="cuda"):
    """(nongauge_space, gauge_space) as tensors on `device`: orthonormal
    bases (columns) of the parameter space, each direction of the gauge
    group's action that the parameterization realizes, and the rest."""
    from pygsti_tpu_torch.models.gaugegroup import default_gauge_group_for_model
    gg = default_gauge_group_for_model(model)
    P = model.num_params
    eye = torch.eye(P, dtype=DTYPE, device=device)
    if gg.num_params == 0:
        return eye, eye[:, :0]
    v = torch.as_tensor(model.to_vector(), dtype=DTYPE, device=device)
    dF = model.flat_tensors_jacobian_fn()(v)                     # [NT, P]
    t0 = model.tensors_fn()(v)

    def transformed(gv):
        S = gg.element_matrix(gv)
        Sinv = torch.linalg.inv(S)
        return torch.cat([(Sinv @ t0.ops @ S).reshape(-1), (t0.preps @ Sinv.T).reshape(-1),
                          (t0.effects @ S).reshape(-1)])

    g0 = torch.as_tensor(np.asarray(gg.initial_params(), dtype=float), dtype=DTYPE,
                         device=device)
    dX = torch.func.jacfwd(transformed)(g0)                       # [NT, n_gauge]
    # the least-squares pull-back dF Vg = dX (numpy's lstsq cut: eps * max dim)
    Vg = torch.linalg.pinv(dF, rtol=torch.finfo(DTYPE).eps * max(dF.shape)) @ dX
    realized = torch.linalg.vector_norm(dF @ Vg, dim=0)
    Vg = Vg[:, realized > tol * max(float(torch.linalg.vector_norm(dX)), 1e-12)]
    if Vg.shape[1] > 0:
        U, s, _ = torch.linalg.svd(Vg, full_matrices=False)
        gauge = U[:, :int(torch.sum(s > tol * max(float(s[0]), 1e-12)))]
    else:
        gauge = eye[:, :0]
    return _orth_complement(gauge, P, tol), gauge


def _orth_complement(basis, dim, tol=1e-7):
    """Orthonormal basis of the complement of `basis`'s column space."""
    eye = torch.eye(dim, dtype=basis.dtype, device=basis.device)
    if basis.shape[1] == 0:
        return eye
    U, s, _ = torch.linalg.svd(eye - basis @ basis.T)
    return U[:, :int(torch.sum(s > tol))]


def compute_nongauge_and_gauge_spaces(model, item_weights=None, non_gauge_mix_mx=None,
                                      tol=1e-7, device="cuda"):
    """(nongauge_space, gauge_space) as host arrays [P, n]: the JAX
    package's function.  With `non_gauge_mix_mx` [n_nongauge, n_gauge]
    each non-gauge direction i gains sum_j M_ij gauge_j.  `item_weights` is
    accepted and not used, as in the JAX package."""
    ng, g = nongauge_and_gauge_spaces(model, tol, device)
    if non_gauge_mix_mx is not None:
        ng = ng + g @ torch.as_tensor(np.asarray(non_gauge_mix_mx), dtype=g.dtype,
                                      device=g.device).T
    return ng.cpu().numpy(), g.cpu().numpy()
