"""objfn_build_s: seconds of a fit's objective builds, the protocol's own
'... objective build' timers summed per fit, averaged over the window's
fits; nothing where the request is not timed by the protocol."""


def read(rec):
    vals = [f['objfn_build_s'] for f in rec['fits'] if f.get('objfn_build_s') is not None]
    return sum(vals) / len(vals) if vals else None
