"""Simulated data (counterpart of pygsti_tpu/data/datasetconstruction.py:
simulate_data with multinomial sampling)."""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.data.dataset import DataSet


def simulate_data(model, circuit_list, num_samples, seed=None, device="cuda"):
    """A DataSet of multinomial counts drawn from the model's outcome
    probabilities, circuit by circuit in list order, from a numpy
    ``RandomState(seed)`` -- the JAX package's draw order, so the same seed
    gives the same counts from the same probabilities."""
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    circuits = [c if isinstance(c, Circuit) else Circuit(c) for c in circuit_list]
    rng = np.random.RandomState(seed)
    prob_dicts = SimpleForwardSimulator(model, device=device).bulk_probs(circuits)
    ds = DataSet()
    for c in circuits:
        probs = prob_dicts[c]
        outcomes = list(probs.keys())
        p = np.array([max(float(probs[o]), 0.0) for o in outcomes])
        p = p / max(p.sum(), 1e-300)
        draws = rng.multinomial(num_samples, p)
        ds.add_count_dict(c, {o: int(n) for o, n in zip(outcomes, draws)})
    return ds
