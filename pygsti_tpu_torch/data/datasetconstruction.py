"""Simulated data (counterpart of pygsti_tpu/data/datasetconstruction.py:
simulate_data)."""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.data.dataset import DataSet


def simulate_data(model_or_dataset, circuit_list, num_samples, sample_error='multinomial',
                  seed=None, rand_state=None, alias_dict=None, collision_action='aggregate',
                  record_zero_counts=True, times=None, device="cuda"):
    """A DataSet of counts drawn from the model's outcome probabilities (or
    from the frequencies of a DataSet), circuit by circuit in list order,
    from a numpy ``RandomState(seed)`` (or `rand_state`) -- the JAX
    package's draw order, so the same seed gives the same counts from the
    same probabilities.

    sample_error: 'multinomial', 'binomial' (two outcomes), 'round' (the
    rounded expectation) or 'none' (the expectation, float).
    `num_samples` is one count or one per circuit.  `alias_dict` maps layer
    labels to Circuits that replace them for the simulation only; the
    dataset stays keyed by the circuits given.  With record_zero_counts
    False an outcome drawn zero times is not recorded, which lowers the
    circuit's degrees of freedom.  With `times` the dataset holds time
    series: one independent draw per timestamp (the first is the draw above,
    'none' and 'round' repeat it), each outcome recorded with its count as
    the repetitions at that time, as in the JAX package.  collision_action
    'keepseparate' raises NotImplementedError, as in the JAX package."""
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    if collision_action not in ('aggregate', 'keepseparate'):
        raise ValueError("Invalid collision_action %r" % (collision_action,))
    if collision_action == 'keepseparate':
        raise NotImplementedError(
            "collision_action='keepseparate' (occurrence-tagged repeated "
            "circuits) is not supported; deduplicate the circuit list or "
            "use 'aggregate'")
    circuits = [c if isinstance(c, Circuit) else Circuit(c) for c in circuit_list]
    rng = rand_state if rand_state is not None else np.random.RandomState(seed)
    sim_circuits = [c.replace_layers_with_aliases(alias_dict) for c in circuits] \
        if alias_dict else circuits
    if isinstance(model_or_dataset, DataSet):
        all_probs = []
        for c in sim_circuits:
            row = model_or_dataset[c]
            all_probs.append({ol: cnt / row.total for ol, cnt in row.items()})
    else:
        prob_dicts = SimpleForwardSimulator(model_or_dataset, device=device).bulk_probs(
            sim_circuits)
        all_probs = [prob_dicts[c] for c in sim_circuits]
    ds = DataSet()
    for i, (c, probs) in enumerate(zip(circuits, all_probs)):
        outcomes = list(probs.keys())
        p = np.array([max(float(probs[o]), 0.0) for o in outcomes])
        if p.sum() > 1.0 or sample_error == 'multinomial':
            p = p / max(p.sum(), 1e-300)
        N = num_samples if np.isscalar(num_samples) else num_samples[i]
        if sample_error == 'none':
            counts = {o: N * pi for o, pi in zip(outcomes, p)}
        elif sample_error == 'round':
            counts = {o: int(round(N * pi)) for o, pi in zip(outcomes, p)}
        elif sample_error == 'binomial':
            if len(outcomes) != 2:
                raise ValueError("binomial sampling needs 2 outcomes")
            n0 = rng.binomial(N, min(max(p[0], 0.0), 1.0))
            counts = {outcomes[0]: n0, outcomes[1]: N - n0}
        elif sample_error == 'multinomial':
            counts = {o: int(n) for o, n in zip(outcomes, rng.multinomial(N, p))}
        else:
            raise ValueError("Invalid sample_error %r" % sample_error)
        if times is None:
            ds.add_count_dict(c, counts, record_zero_counts=record_zero_counts)
            continue
        ols, ts, reps = [], [], []
        for k, t in enumerate(times):
            if k == 0 or sample_error in ('none', 'round'):
                tc = counts
            elif sample_error == 'multinomial':
                tc = {o: int(n) for o, n in zip(outcomes, rng.multinomial(N, p))}
            else:
                n0 = rng.binomial(N, min(max(p[0], 0.0), 1.0))
                tc = {outcomes[0]: n0, outcomes[1]: N - n0}
            for o, n in tc.items():
                if n == 0 and not record_zero_counts:
                    continue
                ols.append(o)
                ts.append(float(t))
                reps.append(n)
        ds.add_raw_series_data(c, ols, ts, reps)
    return ds
