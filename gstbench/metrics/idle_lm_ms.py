"""idle_lm_ms: card-idle milliseconds per LM iteration while the host was
in the LM loop's own code (spans `lm.run` and `lm.iteration`: the damped
solves, the updates, the reads of each decision), from the join of the
program's spans with the device trace (spans.py)."""

from gstbench import spans


def read(rec):
    return spans.idle_ms_per_step(rec, ('lm.run', 'lm.iteration'))
