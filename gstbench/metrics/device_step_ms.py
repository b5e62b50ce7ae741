"""device_step_ms: device milliseconds per LM iteration, the union of the
device activities' intervals in the window over every iteration of the
fits it ran (device trace): the card's share of a step, whatever the
host's speed."""


def read(rec):
    tr = rec['trace']
    iters = sum(s['iterations'] for f in rec['fits'] for s in f['stages'])
    if tr is None or not iters or not tr['events']:
        return None
    return 1e3 * tr['busy_s'] / iters
