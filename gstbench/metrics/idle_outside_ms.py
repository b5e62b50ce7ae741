"""idle_outside_ms: card-idle milliseconds per LM iteration while no span of
the program was open (the client: the resample and its DataSet), from the
join of the program's spans with the device trace (spans.py)."""

from gstbench import spans


def read(rec):
    return spans.idle_ms_per_step(rec, (spans.OUTSIDE,))
