"""Iterative long-sequence GST (counterpart of pygsti_tpu/algorithms/core.py:
run_gst_fit, iterative_gst_generator and run_iterative_gst)."""

from __future__ import annotations

from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.objectivefns.objectivefns import (
    ObjectiveFunctionBuilder, TimeIndependentMDCObjectiveFunction)
from pygsti_tpu_torch.optimize.simplerlm import SimplerLMOptimizer


def run_gst_fit(mdc_store, optimizer, objective_function_builder):
    """Fit the store's model to its data; returns (result, objective)."""
    optimizer = SimplerLMOptimizer.cast(optimizer)
    builder = ObjectiveFunctionBuilder.cast(objective_function_builder)
    objective = builder.build_from_store(mdc_store)
    return optimizer.run(objective), objective


def iterative_gst_generator(dataset, start_model, circuit_lists, optimizer,
                            iteration_objfn_builders, final_objfn_builders,
                            starting_index=0, device="cuda"):
    """Yields (opt_results_list, model copy) per circuit list, each stage
    seeded by the previous one's model; the last list also runs the final
    builders.

    When every list is a prefix of the last one (the standard GST
    structure), all stages share the last list's layout, with counts
    beyond the active prefix masked: one layout, one set of device index
    tensors and depth buckets for the whole fit."""
    optimizer = SimplerLMOptimizer.cast(optimizer)
    iteration_objfn_builders = [ObjectiveFunctionBuilder.cast(b)
                                for b in iteration_objfn_builders]
    final_objfn_builders = [ObjectiveFunctionBuilder.cast(b)
                            for b in final_objfn_builders]
    mdl = start_model.copy()
    lists = [list(cl) for cl in circuit_lists]
    n_iters = len(lists)
    nested = all(lists[i] == lists[-1][:len(lists[i])] for i in range(n_iters - 1))
    shared_layout = SimpleForwardSimulator(mdl, device).create_layout(lists[-1]) \
        if nested else None

    def make_objective(builder, i):
        if nested:
            return TimeIndependentMDCObjectiveFunction(
                builder.build_raw(), mdl, dataset, lists[-1], name=builder.name,
                layout=shared_layout, num_active_circuits=len(lists[i]),
                device=device)
        return TimeIndependentMDCObjectiveFunction(
            builder.build_raw(), mdl, dataset, lists[i], name=builder.name,
            device=device)

    for i in range(starting_index, n_iters):
        builders = list(iteration_objfn_builders)
        if i == n_iters - 1:
            builders += final_objfn_builders
        yield [optimizer.run(make_objective(b, i)) for b in builders], mdl.copy()


def run_iterative_gst(dataset, start_model, circuit_lists, optimizer,
                      iteration_objfn_builders, final_objfn_builders,
                      device="cuda"):
    """Run all iterations; returns (models, opt_results) per iteration."""
    models, results = [], []
    for opt_results, mdl in iterative_gst_generator(
            dataset, start_model, circuit_lists, optimizer,
            iteration_objfn_builders, final_objfn_builders, device=device):
        models.append(mdl)
        results.append(opt_results)
    return models, results
