"""Goodness of fit of a GST estimate (counterpart of
pygsti_tpu/protocols/estimate.py: Estimate.misfit_sigma)."""

from __future__ import annotations

import numpy as np


def misfit_sigma(final_objfn_value, final_dof):
    """N_sigma = (2*DeltaLogL - k) / sqrt(2k), with k the data's degrees of
    freedom less the model's parameter count (at least 1), as the JAX
    package's GateSetTomography sets ``final_dof``."""
    k = max(final_dof, 1)
    return (final_objfn_value - k) / np.sqrt(2 * k)
