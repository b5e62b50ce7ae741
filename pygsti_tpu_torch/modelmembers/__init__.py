"""Model members: operations, states, POVMs and instruments (counterpart
of pygsti_tpu/modelmembers)."""

from pygsti_tpu_torch.modelmembers.modelmember import ModelMember
from pygsti_tpu_torch.modelmembers import operations
from pygsti_tpu_torch.modelmembers import states
from pygsti_tpu_torch.modelmembers import povms
from pygsti_tpu_torch.modelmembers import instruments
from pygsti_tpu_torch.modelmembers.modelmembergraph import ModelMemberGraph
