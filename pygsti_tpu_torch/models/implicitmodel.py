"""Implicit models (counterpart of pygsti_tpu/models/implicitmodel.py): the
working classes are LocalNoiseModel and CloudNoiseModel, whose layer
operators are built from per-gate recipes."""

from pygsti_tpu_torch.models.cloudnoisemodel import CloudNoiseModel  # noqa: F401
from pygsti_tpu_torch.models.localnoisemodel import LocalNoiseModel  # noqa: F401
from pygsti_tpu_torch.models.localnoisemodel import LocalNoiseModel as ImplicitOpModel  # noqa: F401
