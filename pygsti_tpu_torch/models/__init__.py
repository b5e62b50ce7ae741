"""Models and their construction (counterpart of pygsti_tpu/models)."""

from pygsti_tpu_torch.models.model import Model, OpModel
from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel
from pygsti_tpu_torch.models.modelconstruction import (
    create_explicit_model, create_explicit_model_from_expressions,
    create_operation, create_spam_vector,
)
from pygsti_tpu_torch.models import modelnoise
