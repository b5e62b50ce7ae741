"""lm_step_ms: milliseconds per LM iteration, the window's time over every
iteration of the fits it ran, objective builds included (host clock)."""


def read(rec):
    iters = sum(s['iterations'] for f in rec['fits'] for s in f['stages'])
    return 1e3 * rec['window_s'] / iters if iters else None
