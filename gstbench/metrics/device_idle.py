"""device_idle: the share of the traced window in which no device activity
runs, the complement of the union of the activity intervals, in percent."""


def read(rec):
    tr = rec['trace']
    if tr is None or not tr['events']:
        return None
    return 100.0 * (1.0 - tr['busy_s'] / tr['window_s'])
