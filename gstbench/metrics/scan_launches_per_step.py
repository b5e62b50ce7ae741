"""scan_launches_per_step: device activities launched while the host was in
a `scan` span (the depth loops), per LM iteration of the window: each
activity charged by the CUDA runtime call that launched it (spans.py)."""

from gstbench import spans


def read(rec):
    sp = rec.get('spans')
    iters = spans.iterations(rec)
    if not sp or not iters or sp['launches'] is None:
        return None
    return sp['launches'].get('scan', 0) / iters
