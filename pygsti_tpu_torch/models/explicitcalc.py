"""The module path of the explicit model's gauge calculations (counterpart
of pygsti_tpu/models/explicitcalc.py): the non-gauge and gauge spaces are
models/nongauge.py's."""

from pygsti_tpu_torch.models.nongauge import compute_nongauge_and_gauge_spaces  # noqa: F401
