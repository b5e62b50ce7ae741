"""Generic GRASP (greedy randomized adaptive search procedure) machinery
(reference: pygsti/algorithms/grasp.py; counterpart of
pygsti_tpu/algorithms/grasp.py, host code seeded as the JAX package seeds it).

GRASP is the combinatorial-search backbone of germ and fiducial selection:
each iteration performs a randomized greedy construction (restricted
candidate list + random pick) up to feasibility, then a first-improvement
local search over single-swap neighbors.  `germselection._find_germs_grasp`
and `fiducialselection._grasp` drive specialized variants of this loop;
this module exposes the reference's generic public API for user code that
wants to GRASP over arbitrary element sets and score functions.
"""

from __future__ import annotations

import itertools
import random as _random

import numpy as np

from pygsti_tpu_torch.baseobjs.verbosityprinter import VerbosityPrinter


def neighboring_weight_vectors(weights, forced_weights=None, shuffle=False):
    """All binary vectors one swap away from `weights` (one included element
    swapped out for one excluded element).  Elements marked in
    `forced_weights` are never swapped out (reference:
    grasp.neighboring_weight_vectors:22).
    """
    weights = np.asarray(weights)
    if forced_weights is None:
        forced_weights = np.zeros(len(weights))
    outs = np.where((weights == 1) & (np.asarray(forced_weights) == 0))[0]
    ins = np.where(weights == 0)[0]
    neighbors = []
    for o, i in itertools.product(outs, ins):
        nb = weights.copy()
        nb[o], nb[i] = 0, 1
        neighbors.append(nb)
    if shuffle:
        _random.shuffle(neighbors)
    return neighbors


def _feasibility_test(feasible_threshold, feasible_fn):
    if feasible_threshold is not None:
        return lambda soln, score: score < feasible_threshold
    if feasible_fn is not None:
        return lambda soln, score: feasible_fn(soln)
    raise ValueError("Must provide either feasible_fn or feasible_threshold!")


def _grasp_construct_feasible_solution(elements, score_fn, rcl_fn,
                                       feasible_threshold=None,
                                       feasible_fn=None,
                                       initial_elements=None, rng=None):
    """Randomized greedy construction: repeatedly score all one-element
    extensions of the partial solution, restrict to the RCL via `rcl_fn`,
    and add a random RCL member, until feasible (reference:
    grasp._grasp_construct_feasible_solution:70)."""
    is_feasible = _feasibility_test(feasible_threshold, feasible_fn)
    rng = rng if rng is not None else _random.Random()

    if initial_elements is None:
        weights = np.zeros(len(elements), dtype=int)
    else:
        weights = np.asarray(initial_elements).astype(int).copy()
        if len(weights) != len(elements):
            raise ValueError("initial_elements must have the same length "
                             "as elements")

    soln = [elements[i] for i in np.nonzero(weights)[0]]
    while True:
        if soln:
            score = score_fn(soln)
            if is_feasible(soln, score):
                return soln
        remaining = np.where(weights == 0)[0]
        if len(remaining) == 0:
            raise ValueError("Exhausted all elements without reaching a "
                             "feasible solution")
        candidate_solns = [soln + [elements[i]] for i in remaining]
        scores = [score_fn(cs) for cs in candidate_solns]
        rcl = rcl_fn(scores)
        chosen = remaining[rng.choice(list(rcl))]
        weights[chosen] = 1
        soln = soln + [elements[chosen]]


def _grasp_local_search(initial_solution, score_fn, elements,
                        get_neighbors_fn, feasible_threshold=None,
                        feasible_fn=None):
    """First-improvement local search: walk single-swap neighbors, moving to
    the first feasible neighbor that strictly improves the score; stop when
    no neighbor improves (reference: grasp._grasp_local_search:174)."""
    is_feasible = _feasibility_test(feasible_threshold, feasible_fn)

    current = list(initial_solution)
    weights = np.zeros(len(elements), dtype=int)
    for el in current:
        weights[elements.index(el)] = 1
    current_score = score_fn(current)

    improved = True
    while improved:
        improved = False
        for nb_weights in get_neighbors_fn(weights):
            nb_soln = [elements[i] for i in np.nonzero(nb_weights)[0]]
            nb_score = score_fn(nb_soln)
            if nb_score < current_score and is_feasible(nb_soln, nb_score):
                current, current_score, weights = nb_soln, nb_score, \
                    np.asarray(nb_weights).astype(int)
                improved = True
                break
    return current


def run_grasp_iteration(elements, greedy_score_fn, rcl_fn, local_score_fn,
                        get_neighbors_fn, feasible_threshold=None,
                        feasible_fn=None, initial_elements=None, rng=None,
                        verbosity=0):
    """One GRASP iteration: greedy construction then local search.  Returns
    (initial_solution, local_solution) (reference:
    grasp.run_grasp_iteration:275)."""
    printer = VerbosityPrinter.create_printer(verbosity)
    rng = rng if rng is not None else _random.Random()

    initial = _grasp_construct_feasible_solution(
        elements, greedy_score_fn, rcl_fn,
        feasible_threshold=feasible_threshold, feasible_fn=feasible_fn,
        initial_elements=initial_elements, rng=rng)
    printer.log('Initial construction: %s' % (initial,), 1)

    local = _grasp_local_search(initial, local_score_fn, elements,
                                get_neighbors_fn, feasible_threshold,
                                feasible_fn)
    printer.log('Local optimum: %s' % (local,), 1)
    return initial, local


def run_grasp(elements, greedy_score_fn, rcl_fn, local_score_fn,
              get_neighbors_fn, final_score_fn, iterations,
              feasible_threshold=None, feasible_fn=None,
              initial_elements=None, seed=None, verbosity=0):
    """Full GRASP: `iterations` independent construction+search rounds,
    keeping the solution with the best `final_score_fn` (reference:
    grasp.run_grasp:366)."""
    printer = VerbosityPrinter.create_printer(verbosity)
    rng = _random.Random(seed)
    best = None
    for it in range(iterations):
        printer.log('Iteration %d' % it, 1)
        _, local = run_grasp_iteration(
            elements, greedy_score_fn, rcl_fn, local_score_fn,
            get_neighbors_fn, feasible_threshold=feasible_threshold,
            feasible_fn=feasible_fn, initial_elements=initial_elements,
            rng=rng, verbosity=verbosity)
        if best is None or final_score_fn(local) < final_score_fn(best):
            best = local
    return best
