"""Forward simulator for SuccessFailModel-type opless models
(reference: pygsti/forwardsims/successfailfwdsim.py:17
SuccessFailForwardSimulator)."""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.baseobjs.outcomelabeldict import OutcomeLabelDict


class SuccessFailForwardSimulator(object):
    """Computes ('success',)/('fail',) outcome probabilities via the model's
    `_success_prob` / `_success_dprob`."""

    def __init__(self, model=None):
        self.model = model

    def probs(self, circuit, outcomes=None, time=None, clip_to=None):
        p = self.model.probabilities(circuit, outcomes, time)
        if clip_to is not None:
            p = OutcomeLabelDict(
                [(k, float(np.clip(v, clip_to[0], clip_to[1])))
                 for k, v in p.items()])
        return p

    def dprobs(self, circuit):
        dsp = self.model._success_dprob(circuit, None, None)
        return OutcomeLabelDict([(('success',), dsp), (('fail',), -dsp)])

    def bulk_probs(self, circuits, clip_to=None, resource_alloc=None, smartc=None):
        return {c: self.probs(c, clip_to=clip_to) for c in circuits}
