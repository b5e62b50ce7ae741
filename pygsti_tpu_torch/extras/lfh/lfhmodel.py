"""Explicit model with fluctuating-Hamiltonian error generators
(counterpart of pygsti_tpu/extras/lfh/lfhmodel.py)."""

from __future__ import annotations

from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel
from pygsti_tpu_torch.extras.lfh.lfherrorgen import LFHLindbladErrorgen


class LFHExplicitOpModel(ExplicitOpModel):
    """ExplicitOpModel whose operations may hold LFHLindbladErrorgen
    members; `sample_hamiltonian_rates()` redraws every fluctuating
    Hamiltonian rate in the model (reference: lfhmodel.py:41)."""

    def sample_hamiltonian_rates(self):
        for member in self.operations.values():
            for attr in ('errorgen', 'factorops'):
                obj = getattr(member, attr, None)
                if obj is None:
                    continue
                factors = obj if isinstance(obj, (list, tuple)) else [obj]
                for factor in factors:
                    eg = getattr(factor, 'errorgen', factor)
                    if isinstance(eg, LFHLindbladErrorgen):
                        eg.sample_hamiltonian_rates()
