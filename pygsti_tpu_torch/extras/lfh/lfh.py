"""Locally-fluctuating-Hamiltonian simulation: models whose (Hamiltonian)
error rates fluctuate between shots with Gaussian statistics (counterpart of
pygsti_tpu/extras/lfh/lfh.py; reference: pygsti/extras/lfh/lfherrorgen.py:40
LFHLindbladErrorgen, lfhforwardsims.py:42 LFHWeakForwardSimulator, :188
LFHIntegratingForwardSimulator, :529 LFHSigmaForwardSimulator).

Every model here is a pure function of its parameter vector, so averaging
over fluctuations is batched evaluation over a grid of parameter vectors.
The JAX package builds one layout per circuit and maps its probability
function over the grid; here one layout holds all the circuits, and the
grid goes through the model's probability function in batches of
parameter vectors (torch.vmap) sized so that one batch's gathered ops stay
under BATCH_BYTES on the device.  The integrating simulator weights a
Gauss-Hermite product grid, the weak one averages seeded Monte-Carlo draws
(numpy ``RandomState(base_seed)``, drawn as the JAX package draws them:
one set of offsets, the same for every circuit), and the sigma-point one
adds each fluctuating parameter's second directional derivative, taken by
nested forward-mode differentiation (torch.func.jvp) of the whole scan.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from pygsti_tpu_torch import DTYPE

#: the most bytes one batch of grid points may gather per circuit layer
#: (batch size x rows x d^2 x 8)
BATCH_BYTES = 1 << 30


class GaussianParamFluctuation(object):
    """Specifies Gaussian fluctuations on selected model parameters:
    v_i ~ Normal(v_i, dev_i) for each (param_index -> dev)."""

    def __init__(self, param_devs):
        self.param_devs = dict(param_devs)

    @property
    def indices(self):
        return sorted(self.param_devs.keys())

    @property
    def devs(self):
        return np.array([self.param_devs[i] for i in self.indices])


class _LFHBase(object):
    def __init__(self, model, fluctuation, device="cuda"):
        self.model = model
        self.fluctuation = fluctuation
        self.device = torch.device(device)

    def _layout(self, circuits):
        from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
        sim = SimpleForwardSimulator(self.model, self.device)
        layout = sim.create_layout(circuits)
        return sim, layout

    def _v0(self):
        return torch.as_tensor(self.model.to_vector(), dtype=DTYPE, device=self.device)

    def _probs_at_offsets(self, circuits, offsets):
        """The probabilities [n_grid, n_elements] of `circuits` at the model's
        parameters with each row of `offsets` [n_grid, n_fluct] added to the
        fluctuating ones, and the layout."""
        sim, layout = self._layout(circuits)
        pf = sim.probs_fn(layout)
        v0 = self._v0()
        idx = torch.as_tensor(self.fluctuation.indices, dtype=torch.int64, device=self.device)
        offsets = torch.as_tensor(np.asarray(offsets, dtype=float), dtype=DTYPE,
                                  device=self.device)
        d = self.model.dim
        per_point = layout.num_rows * d * d * torch.finfo(DTYPE).bits // 8
        n = max(1, BATCH_BYTES // max(per_point, 1))
        out = []
        with torch.no_grad():
            for start in range(0, offsets.shape[0], n):
                off = offsets[start:start + n]
                V = v0.repeat(off.shape[0], 1)
                V[:, idx] += off
                out.append(torch.vmap(pf)(V))
        return torch.cat(out), layout

    @staticmethod
    def _as_dicts(layout, vals, clip_to):
        from pygsti_tpu_torch.baseobjs.outcomelabeldict import OutcomeLabelDict
        vals = vals.cpu().numpy()
        if clip_to is not None:
            vals = np.clip(vals, clip_to[0], clip_to[1])
        return {c: OutcomeLabelDict(zip(layout.outcomes[i],
                                        map(float, vals[layout.element_slices[i]])))
                for i, c in enumerate(layout.circuits)}

    def probs(self, circuit, clip_to=None, time=None):
        """OutcomeLabelDict(outcome -> probability) of one circuit."""
        from pygsti_tpu_torch.circuits.circuit import Circuit
        c = circuit if isinstance(circuit, Circuit) else Circuit(circuit)
        return self.bulk_probs([c], clip_to)[c]

    def bulk_probs(self, circuits, clip_to=None):
        """{circuit: OutcomeLabelDict} over one layout of all `circuits`."""
        from pygsti_tpu_torch.circuits.circuit import Circuit
        circuits = [c if isinstance(c, Circuit) else Circuit(c) for c in circuits]
        vals, layout = self.bulk_fill_probs(circuits)
        return self._as_dicts(layout, vals, clip_to)


class LFHIntegratingForwardSimulator(_LFHBase):
    """Average probabilities over a Gauss-Hermite product grid of the
    fluctuating parameters (reference: lfhforwardsims.py:188)."""

    def __init__(self, model, fluctuation, order=5, device="cuda"):
        super().__init__(model, fluctuation, device)
        self.order = order
        # Gauss-Hermite for weight exp(-x^2): x -> sqrt(2)*dev*x, w /= sqrt(pi)
        nodes, weights = np.polynomial.hermite.hermgauss(order)
        self._nodes = nodes
        self._weights = weights / np.sqrt(np.pi)

    def _grid(self):
        devs = self.fluctuation.devs
        n = len(devs)
        offsets, weights = [], []
        for combo in itertools.product(range(self.order), repeat=n):
            offsets.append([np.sqrt(2) * devs[k] * self._nodes[c]
                            for k, c in enumerate(combo)])
            weights.append(np.prod([self._weights[c] for c in combo]))
        return np.asarray(offsets), np.asarray(weights)

    def bulk_fill_probs(self, circuits):
        """(averaged probabilities [n_elements] on the device, layout)."""
        offsets, weights = self._grid()
        vals, layout = self._probs_at_offsets(circuits, offsets)
        return torch.as_tensor(weights, dtype=vals.dtype, device=vals.device) @ vals, layout


class LFHWeakForwardSimulator(_LFHBase):
    """Monte-Carlo fluctuation averaging: sample rate realizations and
    average the exact per-realization probabilities (reference:
    lfhforwardsims.py:42)."""

    def __init__(self, model, fluctuation, shots=100, base_seed=None, device="cuda"):
        super().__init__(model, fluctuation, device)
        self.shots = shots
        self.base_seed = base_seed

    def offsets(self):
        """The draws [shots, n_fluct]: RandomState(base_seed), as the JAX
        package draws them for each circuit."""
        rng = np.random.RandomState(self.base_seed)
        devs = self.fluctuation.devs
        return rng.randn(self.shots, len(devs)) * devs[None, :]

    def bulk_fill_probs(self, circuits):
        """(averaged probabilities [n_elements] on the device, layout)."""
        vals, layout = self._probs_at_offsets(circuits, self.offsets())
        return vals.mean(dim=0), layout


class LFHSigmaForwardSimulator(_LFHBase):
    """Second-order (sigma-point) fluctuation approximation: probs at the
    mean plus 0.5 * sum_i dev_i^2 * d^2 probs / dtheta_i^2 (reference:
    lfhforwardsims.py:529)."""

    def bulk_fill_probs(self, circuits):
        """(probabilities [n_elements] on the device, layout)."""
        sim, layout = self._layout(circuits)
        pf = sim.probs_fn(layout)
        v0 = self._v0()
        with torch.no_grad():
            total = pf(v0)
        for i, dev in zip(self.fluctuation.indices, self.fluctuation.devs):
            e = torch.zeros_like(v0)
            e[i] = 1.0
            d2 = torch.func.jvp(lambda x: torch.func.jvp(pf, (x,), (e,))[1], (v0,), (e,))[1]
            total = total + 0.5 * float(dev) ** 2 * d2.detach()
        return total, layout
