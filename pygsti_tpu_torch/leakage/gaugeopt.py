"""Leakage-aware gauge optimization (LAGO) (counterpart of
pygsti_tpu/leakage/gaugeopt.py).

A leakage model's gauge must keep the computational and leakage subspaces
apart: the group is U(k) (+) U(d-k) acting on the d-level Hilbert space,
U(2) (+) U(1) for a qubit with one leakage level.
"""

from __future__ import annotations

import numpy as np
import torch

from pygsti_tpu_torch.baseobjs.basis import Basis
from pygsti_tpu_torch.models.gaugegroup import GaugeGroup
from pygsti_tpu_torch.modelmembers.operations import _matrix_exp, _real_params_to_hermitian


class DirectSumUnitaryGaugeGroup(GaugeGroup):
    """Superoperators of block-diagonal unitaries exp(-i H1) (+) exp(-i H2),
    H1 Hermitian on the first `comp_dim` levels and H2 on the rest, each
    from its real parameters (the diagonal, then (re, im) of the upper
    triangle).  The exponentials go through _matrix_exp, whose derivative
    stays finite at H = 0, where gauge optimization starts."""

    name = "DirectSumUnitary"

    def __init__(self, state_space, basis='gm', comp_dim=2):
        super().__init__(state_space)
        self.basis = Basis.cast(basis, self.dim)
        self.udim = self.basis.matrix_dim
        self.comp_dim = comp_dim
        self.leak_dim = self.udim - comp_dim
        M = np.asarray(self.basis.create_transform_matrix('std'))
        self._host = (np.linalg.inv(M), M)
        self._consts = {}

    @property
    def num_params(self):
        return self.comp_dim ** 2 + self.leak_dim ** 2

    def initial_params(self):
        return np.zeros(self.num_params)

    def element_matrix(self, v):
        k, m = self.comp_dim, self.leak_dim
        u1 = _matrix_exp(-1j * _real_params_to_hermitian(v[:k * k], k))
        blocks = [u1]
        if m > 0:
            blocks.append(_matrix_exp(-1j * _real_params_to_hermitian(v[k * k:], m)))
        u = torch.block_diag(*blocks)
        key = (str(v.device), u.dtype)
        if key not in self._consts:
            self._consts[key] = tuple(torch.as_tensor(a, dtype=u.dtype, device=v.device)
                                      for a in self._host)
        std2basis, basis2std = self._consts[key]
        return torch.real(std2basis @ torch.kron(u, u.conj()) @ basis2std)


def std_lago_gopsuite(model):
    """The standard leakage-aware gauge-optimization suite: one stage over
    the direct-sum unitary group of the model's levels, gates and SPAM
    weighted equally."""
    group = DirectSumUnitaryGaugeGroup(model.dim, model.basis)
    return {'LAGO': [{'gauge_group': group, 'item_weights': {'gates': 1.0, 'spam': 1.0}}]}


def add_lago_models(results, est_key=None, gos=None, verbosity=0, device="cuda"):
    """Gauge-optimize each estimate's final model to its target over the
    leakage-preserving group (the suite `gos`, by default
    std_lago_gopsuite), on `device`, and store the result as the
    estimate's model of the suite's label ('LAGO')."""
    from pygsti_tpu_torch.algorithms.gaugeopt import gaugeopt_to_target
    est_keys = [est_key] if est_key is not None else list(results.estimates)
    for key in est_keys:
        est = results.estimates[key]
        mdl = est.models['final iteration estimate'].copy()
        target = est.models.get('target')
        if target is None:
            continue
        suite = gos or std_lago_gopsuite(mdl)
        for label, params_list in suite.items():
            for params in params_list:
                est.models[label] = gaugeopt_to_target(
                    mdl, target, item_weights=params.get('item_weights'),
                    gauge_group=params['gauge_group'], verbosity=verbosity, device=device)
    return results
