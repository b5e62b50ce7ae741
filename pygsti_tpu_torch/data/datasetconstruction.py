"""Simulated data and dataset transforms (counterpart of
pygsti_tpu/data/datasetconstruction.py): simulate_data, and the host
transforms aggregate_dataset_outcomes, filter_dataset and
trim_to_constant_numtimesteps, row for row the JAX package's."""

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


def aggregate_dataset_outcomes(dataset, label_merge_dict, record_zero_counts=True):
    """A static DataSet whose outcomes merge the old ones, e.g. 2-qubit
    data into one qubit's marginal.  `label_merge_dict` maps each new
    outcome label to the list of old labels (strings or tuples) it
    absorbs; a merged count of 0 is recorded unless record_zero_counts is
    False."""
    norm = {}
    for new, olds in label_merge_dict.items():
        new_t = new if isinstance(new, tuple) else (new,)
        norm[new_t] = [o if isinstance(o, tuple) else (o,) for o in olds]
    out = DataSet(outcome_labels=[k[0] for k in norm])
    for c in dataset.keys():
        row = dataset[c]
        counts = {}
        for new_t, olds in norm.items():
            tot = sum(row.counts.get(o, 0) for o in olds)
            if tot > 0 or record_zero_counts:
                counts[new_t[0]] = tot
        out.add_count_dict(c, counts)
    out.done_adding_data()
    return out


def _marginalize_outcome(outcome, keep_indices):
    """The outcome string kept at `keep_indices`, as a 1-tuple."""
    return (''.join(outcome[0][i] for i in keep_indices),)


def filter_dataset(dataset, sectors_to_keep, sindices_to_keep=None, new_sectors=None,
                   idle=((),), record_zero_counts=True, filtercircuits=True):
    """A static DataSet on the lines `sectors_to_keep`: each outcome string
    marginalized to the kept lines' characters (at `sindices_to_keep`, or
    the kept lines' positions among the circuit's), and with
    `filtercircuits` only the circuits whose gates all act within the kept
    lines; `new_sectors` relabels the kept lines.  None when no circuit
    is kept.  `idle` and `record_zero_counts` are accepted and not used,
    as in the JAX package."""
    sectors = list(sectors_to_keep)
    out = None
    for c in dataset.keys():
        lls = list(c.line_labels)
        keep_idx = list(sindices_to_keep) if sindices_to_keep is not None \
            else [lls.index(s) for s in sectors if s in lls]
        if filtercircuits and any(
                comp.sslbls is not None and not set(comp.sslbls) <= set(sectors)
                for layer in c.layertup
                for comp in ((layer,) if layer.is_simple else tuple(layer.components))):
            continue
        if new_sectors is not None:
            mapping = {s: new_sectors[i] for i, s in enumerate(sectors)}
            new_c = c.map_state_space_labels(lambda x: mapping.get(x, x))
            new_c = Circuit(new_c.layertup, tuple(mapping[s] for s in sectors if s in lls))
        else:
            new_c = Circuit(c.layertup, tuple(s for s in sectors if s in lls))
        counts = {}
        for outcome, cnt in dataset[c].counts.items():
            m = _marginalize_outcome(outcome, keep_idx)
            counts[m] = counts.get(m, 0) + cnt
        if out is None:
            out = DataSet(outcome_labels=sorted({o[0] for o in counts}))
        out.add_count_dict(new_c, {k[0]: v for k, v in counts.items()})
    if out is not None:
        out.done_adding_data()
    return out


def trim_to_constant_numtimesteps(ds):
    """A time-series DataSet in which every circuit keeps its first n
    distinct timestamps, n the least number any circuit has, with their
    repetitions (the JAX package drops them, so its trimmed counts are
    wrong where a repetition passes 1: ROADMAP.md section 3)."""
    n_times = []
    for c in ds.keys():
        row = ds[c]
        if row.time is None:
            raise ValueError("trim_to_constant_numtimesteps requires time-series data")
        n_times.append(len(set(row.time)))
    min_times = min(n_times) if n_times else 0
    out = DataSet(outcome_labels=ds.outcome_labels)
    for c in ds.keys():
        row = ds[c]
        keep = set(sorted(set(row.time))[:min_times])
        reps = row.reps if row.reps is not None else [1] * len(row.time)
        kept = [(ol, t, r) for ol, t, r in zip(row.outcome_series, row.time, reps) if t in keep]
        out.add_raw_series_data(c, [k[0] for k in kept], [k[1] for k in kept],
                                [k[2] for k in kept])
    out.done_adding_data()
    return out
