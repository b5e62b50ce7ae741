"""launches_per_step: device activities (kernels, copies, fills) in the
traced window per LM iteration of its fits: the host's dispatch load."""


def read(rec):
    tr = rec['trace']
    iters = sum(s['iterations'] for f in rec['fits'] for s in f['stages'])
    if tr is None or not iters or not tr['events']:
        return None
    return tr['events'] / iters
