"""Bootstrapped error bars of GST estimates (counterpart of
pygsti_tpu/drivers/bootstrap.py).

'nonparametric' resamples draw on the host from numpy's
``RandomState(seed)``, circuit by circuit in the JAX package's order, so one
seed gives the JAX package's resample count for count.  'parametric'
resamples simulate the model on `device`, each circuit at its own total
(the JAX package draws every circuit at the first circuit's total).  The
refits and gauge optimizations run on `device`.
"""

from __future__ import annotations

import time

import numpy as np

from pygsti_tpu_torch.baseobjs.outcomelabeldict import OutcomeLabelDict
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.data.datasetconstruction import simulate_data


def create_bootstrap_dataset(input_dataset, generation_method, input_model=None, seed=None,
                             outcome_labels=None, verbosity=1, device="cuda"):
    """A resample of `input_dataset`: 'nonparametric' draws each circuit's
    total from its observed frequencies, 'parametric' from `input_model`'s
    probabilities."""
    if generation_method == 'nonparametric':
        rng = np.random.RandomState(seed)
        ds = DataSet(outcome_labels=outcome_labels)
        for c in input_dataset.keys():
            row = input_dataset[c]
            outcomes = list(row.counts.keys())
            p = np.array([row.counts[o] / row.total for o in outcomes])
            draws = rng.multinomial(int(round(row.total)), p / p.sum())
            ds.add_count_dict(c, {o: int(n) for o, n in zip(outcomes, draws)})
        return ds
    if generation_method == 'parametric':
        if input_model is None:
            raise ValueError("'parametric' resampling needs an input_model")
        circuits = list(input_dataset.keys())
        totals = [int(round(input_dataset[c].total)) for c in circuits]
        ds = simulate_data(input_model, circuits, totals, seed=seed, device=device)
        for ol in outcome_labels or ():
            ol = OutcomeLabelDict.to_outcome(ol)
            if ol not in ds._outcome_labels:
                ds._outcome_labels.append(ol)
        return ds
    raise ValueError("Invalid generation_method %r" % generation_method)


def create_bootstrap_models(num_models, input_data_set, generation_method, prep_fiducials,
                            meas_fiducials, germs, max_lengths, input_model=None,
                            target_model=None, start_seed=0, return_data=False, verbosity=2,
                            device="cuda", stats=None):
    """`num_models` GST fits, each of a resample (seeds start_seed,
    start_seed + 1, ...) from the target: chi2 stages then the Poisson logL
    over the long-sequence lists of the fiducials, germs and max lengths.
    Returns the final models (and the resamples with `return_data`).  A
    list given as `stats` gets one dict per refit: 'seconds' (resample and
    fit) and 'optimizer_results' (per list, per stage)."""
    from pygsti_tpu_torch.algorithms.core import run_iterative_gst
    from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists
    if target_model is None:
        target_model = input_model
    lists = create_lsgst_circuit_lists(target_model, prep_fiducials, meas_fiducials, germs,
                                       max_lengths)
    models, datasets = [], []
    for i in range(num_models):
        t0 = time.time()
        ds = create_bootstrap_dataset(input_data_set, generation_method, input_model,
                                      seed=start_seed + i, device=device)
        ms, opt_results = run_iterative_gst(ds, target_model.copy(), lists, None, ['chi2'],
                                            ['logl'], verbosity=0, device=device)
        models.append(ms[-1])
        datasets.append(ds)
        if stats is not None:
            stats.append({'seconds': time.time() - t0, 'optimizer_results': opt_results})
    return (models, datasets) if return_data else models


def gauge_optimize_models(models, target_model, gate_metric="frobenius",
                          spam_metric="frobenius", plot=False, device="cuda"):
    """Each model gauge-optimized to the target on `device`."""
    from pygsti_tpu_torch.algorithms.gaugeopt import gaugeopt_to_target
    return [gaugeopt_to_target(m, target_model, device=device) for m in models]


def to_std_array(prop_list):
    return np.array(prop_list)


def _mean_std(values):
    arr = np.asarray(values, dtype=float)
    return float(arr.mean()), float(arr.std(ddof=1) if len(arr) > 1 else 0.0)


def bootstrap_error_bars(models, fn_of_model):
    """(mean, sample standard deviation) of a scalar function over the
    models."""
    return _mean_std([fn_of_model(m) for m in models])
