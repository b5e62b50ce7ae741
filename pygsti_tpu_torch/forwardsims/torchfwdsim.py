"""TorchForwardSimulator and StatelessModel (counterpart of
pygsti_tpu/forwardsims/torchfwdsim.py).  The JAX package's class carries
its model's tensors into torch to take torch.autograd Jacobians; the port
is torch already, so both are thin: the probabilities are
SimpleForwardSimulator's scan, differentiable by torch.autograd, and
bulk_fill_dprobs takes ``torch.autograd.functional.jacobian`` of them, as
the JAX package's class does."""

from __future__ import annotations

import torch

from pygsti_tpu_torch import DTYPE
from pygsti_tpu_torch.forwardsims.forwardsim import ForwardSimulator, SimpleForwardSimulator


class StatelessModel(object):
    """The pure map parameters -> probabilities of `layout`'s elements
    (circuit_probs), on `device`."""

    def __init__(self, model, layout, device="cuda"):
        self.model = model
        self.layout = layout
        self.device = torch.device(device)
        self.outcome_probs_dim = layout.num_elements
        self._probs = SimpleForwardSimulator(model, device).probs_fn(layout)

    def get_free_params(self, model=None):
        model = model if model is not None else self.model
        return torch.tensor(model.to_vector(), dtype=DTYPE, device=self.device,
                            requires_grad=True)

    def circuit_probs(self, free_params):
        """The outcome probabilities as a tensor, differentiable."""
        return self._probs(free_params)

    # the JAX package's name
    def circuit_probs_from_torch_bases(self, free_params):
        return self.circuit_probs(free_params)


class TorchForwardSimulator(ForwardSimulator):
    """Probabilities and their Jacobian by torch.autograd."""

    ENABLED = True

    def local_probs_fn(self, layout):
        return StatelessModel(self.model, layout, self.device).circuit_probs

    def bulk_fill_probs(self, array_to_fill, layout):
        slm = StatelessModel(self.model, layout, self.device)
        p = slm.circuit_probs(slm.get_free_params()).detach().cpu().numpy()
        if array_to_fill is not None:
            array_to_fill[:] = p
        return p

    def bulk_fill_dprobs(self, array_to_fill, layout, pr_array_to_fill=None):
        slm = StatelessModel(self.model, layout, self.device)
        free = slm.get_free_params()
        J = torch.autograd.functional.jacobian(slm.circuit_probs, free).detach().cpu().numpy()
        if pr_array_to_fill is not None:
            pr_array_to_fill[:] = slm.circuit_probs(free).detach().cpu().numpy()
        if array_to_fill is not None:
            array_to_fill[:] = J
        return J
