"""Error-generator propagation through Clifford circuits
(counterpart of pygsti_tpu/errorgenpropagation; reference:
pygsti/errorgenpropagation/, tools/errgenproptools.py)."""

from pygsti_tpu_torch.errorgenpropagation.errorpropagator import (
    ErrorGeneratorPropagator, PauliLabel, ElementaryErrorgenLabel)
