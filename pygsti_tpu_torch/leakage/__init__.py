"""Leakage modeling: 3-level (qubit plus one leakage level) models, their
metrics and leakage-aware gauge optimization (counterpart of
pygsti_tpu/leakage/)."""

from pygsti_tpu_torch.leakage.models import (to_3level_unitary, create_3level_model,
                                             create_leakage_model)
from pygsti_tpu_torch.leakage.metrics import (gate_leakage_rate, gate_seepage_rate,
                                              subspace_entanglement_fidelity,
                                              subspace_jtracedist, subspace_superop_fro_dist,
                                              subspace_diamonddist, subspace_restriction)
from pygsti_tpu_torch.leakage.gaugeopt import (DirectSumUnitaryGaugeGroup,
                                               std_lago_gopsuite, add_lago_models)
from pygsti_tpu_torch.leakage.core import (computational_effect, computational_superkets,
                                           computational_projector,
                                           augment_for_leakage_modeling)
