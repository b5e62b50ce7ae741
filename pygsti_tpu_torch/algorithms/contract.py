"""Contract models to physically valid (CP / TP / CPTP) sets (counterpart
of pygsti_tpu/algorithms/contract.py; reference: pygsti/algorithms/contract.py:24).
Host numpy: a handful of small eigendecompositions per operation."""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.tools.basistools import change_basis, vec_to_stdmx, stdmx_to_vec
from pygsti_tpu_torch.tools.jamiolkowski import (fast_jamiolkowski_iso_std,
                                                 fast_jamiolkowski_iso_std_inv)


def _contract_op_to_cp(mx, basis='pp'):
    """Project a superoperator onto the CP cone: clip negative Choi
    eigenvalues to zero (the reference's direct CP contraction)."""
    std = change_basis(np.asarray(mx), basis, 'std')
    choi = fast_jamiolkowski_iso_std(std, 'std')
    evals, evecs = np.linalg.eigh((choi + choi.conj().T) / 2)
    clipped = np.clip(evals, 0, None)
    choi_cp = (evecs * clipped) @ evecs.conj().T
    std_cp = fast_jamiolkowski_iso_std_inv(choi_cp, 'std')
    return np.real(change_basis(std_cp, 'std', basis))


def _contract_op_to_tp(mx):
    """Force the first row to e0 (identity-first basis TP condition)."""
    mx = np.array(mx)
    mx[0, :] = 0
    mx[0, 0] = 1.0
    return mx


def contract(model, to_what, dataset=None, maxiter=100, tol=1e-7, use_direct_cp=True,
             method="Nelder-Mead", verbosity=0):
    """Contract a model to 'CP', 'TP', 'CPTP', 'vSPAM' or 'nothing'
    (reference: contract.contract:24); CPTP alternates the CP and TP
    projections.  The dataset-driven targets ('XP'/'XPTP') and the
    optimization-based CP path (use_direct_cp=False) raise, as in the JAX
    package."""
    if to_what in ('XP', 'XPTP'):
        raise NotImplementedError(
            "to_what=%r (contract so the DATASET's circuit probabilities "
            "lie in [0,1]) is not implemented; use 'CP'/'TP'/'CPTP'" % (to_what,))
    if not use_direct_cp:
        raise NotImplementedError(
            "use_direct_cp=False (optimization-based CP contraction, tuned "
            "by `method`) is not implemented; the direct eigenvalue "
            "projection (the reference default) is always used")
    new_model = model.copy()
    if to_what == 'nothing':
        return new_model
    basis = model.basis

    for lbl, op in list(new_model.operations.items()):
        mx = op.dense()
        if to_what == 'TP':
            mx = _contract_op_to_tp(mx)
        elif to_what == 'CP':
            mx = _contract_op_to_cp(mx, basis)
        elif to_what == 'CPTP':
            for _ in range(maxiter):
                mx_tp = _contract_op_to_tp(_contract_op_to_cp(mx, basis))
                if np.max(np.abs(mx_tp - mx)) < tol:
                    mx = mx_tp
                    break
                mx = mx_tp
        elif to_what == 'vSPAM':
            continue
        else:
            raise ValueError("Invalid contraction target %r" % to_what)
        new_model.operations[lbl] = type(op)(mx)

    if to_what in ('vSPAM', 'CPTP', 'CP'):
        # contract SPAM to valid states: clip density-matrix eigenvalues
        for lbl, prep in list(new_model.preps.items()):
            rho = vec_to_stdmx(prep.dense(), basis)
            evals, evecs = np.linalg.eigh((rho + rho.conj().T) / 2)
            clipped = np.clip(evals, 0, None)
            if clipped.sum() > 0:
                clipped = clipped / clipped.sum()
            rho2 = (evecs * clipped) @ evecs.conj().T
            new_vec = np.real(stdmx_to_vec(rho2, basis))
            try:
                new_model.preps[lbl] = type(prep)(new_vec)
            except (AssertionError, ValueError):
                pass  # parameterization constraint (e.g. TP first element)
    return new_model
