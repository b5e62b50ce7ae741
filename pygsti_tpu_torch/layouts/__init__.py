"""Circuit-outcome probability layouts (counterpart of
pygsti_tpu/layouts)."""

from pygsti_tpu_torch.layouts.layout import CircuitOutcomeProbabilityLayout
