"""idle_scan_ms: card-idle milliseconds per LM iteration while the host
dispatched the depth loops (span `scan`: the residual's propagate and the
blocked Jacobian's state stash, one span a scan), from the join of the
program's spans with the device trace (spans.py)."""

from gstbench import spans


def read(rec):
    return spans.idle_ms_per_step(rec, ('scan',))
