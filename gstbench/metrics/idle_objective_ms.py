"""idle_objective_ms: card-idle milliseconds per LM iteration while the host
was in the objective's own code (spans `objective.jtj_jtf` and
`objective.lsvec`: the terms, the per-bucket Grams, the SPAM columns, the
kernel's wrapper), from the join of the program's spans with the device
trace (spans.py)."""

from gstbench import spans


def read(rec):
    return spans.idle_ms_per_step(rec, ('objective.jtj_jtf', 'objective.lsvec'))
