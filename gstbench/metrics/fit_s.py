"""fit_s: seconds per whole fit, the window's time over the fits it ran (host clock)."""


def read(rec):
    return rec['window_s'] / len(rec['fits']) if rec['fits'] else None
