"""Developer utilities: caching and timing blocks (counterpart of
pygsti_tpu/tools/opttools.py)."""

from __future__ import annotations

import functools
import time
from contextlib import contextmanager


def cache_by_hashed_args(obj):
    """Memoize by hashable positional args (reference:
    opttools.cache_by_hashed_args:27)."""
    cache = {}

    @functools.wraps(obj)
    def memoizer(*args, **kwargs):
        try:
            key = args
            if key not in cache:
                cache[key] = obj(*args, **kwargs)
            return cache[key]
        except TypeError:  # unhashable args: no caching
            return obj(*args, **kwargs)

    memoizer.cache = cache
    return memoizer


@contextmanager
def timed_block(label, time_dict=None, printer=None, verbosity=2,
                round_places=6, pre_message=None, format_str=None):
    """Context manager timing its block (reference:
    opttools.timed_block:48)."""
    if pre_message and printer is not None:
        printer.log(pre_message.format(label))
    t0 = time.time()
    try:
        yield
    finally:
        dt = time.time() - t0
        if time_dict is not None:
            if hasattr(time_dict, 'setdefault'):
                time_dict.setdefault(label, []).append(dt)
            else:
                time_dict[label] = dt
        if printer is not None:
            fmt = format_str or '{0} took {1} seconds'
            printer.log(fmt.format(label, round(dt, round_places)), verbosity)


def time_hash():
    """A timestamp string usable as a unique-ish label (reference:
    opttools.time_hash:106)."""
    import datetime
    return datetime.datetime.now().strftime('%Y%m%d%H%M%S%f')
