"""Complex-amplitude (state-vector) forward simulation (counterpart of
pygsti_tpu/forwardsims/statevecsim.py).

Pure states evolve as a [B, u] complex batch through the circuits' layers
in the u = 2^n dimensional Hilbert space, not the 4^n superoperator space:
each layer gathers its circuits' unitaries and applies them in one batched
product.  A probability is Re(psi^dag E psi), E the effect's matrix in the
standard basis.  The model must be unitary: a member without a unitary or
pure-state form raises ValueError when the simulator builds its function.
"""

from __future__ import annotations

import torch

from pygsti_tpu_torch import DTYPE
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator, layout_tensors


class StateVectorForwardSimulator(SimpleForwardSimulator):
    """Batched pure-state propagation on one device (or, with a mesh
    ``sim.mesh``, on each rank's shard of the circuits); layouts, fills,
    derivatives and the probability dictionaries are the base class's."""

    def local_probs_fn(self, layout):
        """A pure function v -> probabilities [n_elements] for `layout`."""
        layout.check_op_stack(self.model)
        compute = self.model.statevec_tensors_fn()
        idx = layout_tensors(layout, self.device)

        def probs(v):
            us, psis, emxs = compute(v)
            u = psis.shape[1]
            U = torch.cat([us, torch.eye(u, dtype=us.dtype, device=us.device)[None]])
            psi = psis[idx['prep_index']]                             # [B, u]
            op_idx = idx['op_indices']
            for t in range(op_idx.shape[1]):
                psi = torch.bmm(U[op_idx[:, t]], psi.unsqueeze(-1)).squeeze(-1)
            # every row's probability of every effect, then the elements'
            Epsi = torch.tensordot(psi, emxs, dims=([1], [2]))        # [B, n_eff, u]
            P = (psi.conj()[:, None, :] * Epsi).sum(-1).real          # [B, n_eff]
            return P[idx['elem_circuit'], idx['elem_effect']].to(DTYPE)

        return probs


# the JAX package's alias
SimpleMatrixForwardSimulator = StateVectorForwardSimulator
