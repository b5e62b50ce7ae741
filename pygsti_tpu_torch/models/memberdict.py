"""Member dicts (counterpart of pygsti_tpu/models/memberdict.py): the working
container is explicitmodel._MemberDict, an ordered dict that marks its
parent model for a parameter-vector rebuild on every change."""

from pygsti_tpu_torch.models.explicitmodel import _MemberDict as OrderedMemberDict  # noqa: F401
