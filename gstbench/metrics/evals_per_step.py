"""evals_per_step: residual evaluations (`objective.lsvec` spans) per LM
iteration of the window: one for each step tried, so rejected steps and
line-search backtracks raise it above 1."""

from gstbench import spans


def read(rec):
    sp = rec.get('spans')
    iters = spans.iterations(rec)
    if not sp or not iters:
        return None
    return sp['count'].get('objective.lsvec', 0) / iters
