"""idle_tensors_ms: card-idle milliseconds per LM iteration while the host
built the model's flat tensors and their Jacobian Tv (span
`model.tensors`), from the join of the program's spans with the device
trace (spans.py)."""

from gstbench import spans


def read(rec):
    return spans.idle_ms_per_step(rec, ('model.tensors',))
