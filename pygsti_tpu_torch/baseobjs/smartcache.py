"""SmartCache: argument-digest memoization used by the report layer
(counterpart of pygsti_tpu/baseobjs/smartcache.py)."""

from __future__ import annotations

import functools
import hashlib
import pickle


def _digest(obj):
    try:
        return hashlib.sha1(pickle.dumps(obj)).hexdigest()
    except Exception:
        return str(id(obj))


class SmartCache(object):
    """Cache keyed on digests of the (fn, args) pair, with hit/miss stats."""

    def __init__(self, decorating=()):
        self.cache = {}
        self.hits = 0
        self.misses = 0
        self.unpickleable = set()

    def cached_compute(self, fn, arg_vals, kwargs=None):
        kwargs = kwargs or {}
        key = (fn.__name__, tuple(_digest(a) for a in arg_vals),
               tuple(sorted((k, _digest(v)) for k, v in kwargs.items())))
        if key in self.cache:
            self.hits += 1
            return key, self.cache[key]
        self.misses += 1
        val = fn(*arg_vals, **kwargs)
        self.cache[key] = val
        return key, val

    def status(self):
        return {'hits': self.hits, 'misses': self.misses,
                'size': len(self.cache)}


def smart_cached(fn):
    """Decorator attaching a SmartCache to a function."""
    cache = SmartCache()

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        _, val = cache.cached_compute(fn, args, kwargs)
        return val

    wrapper.cache = cache
    return wrapper


class CustomDigestError(Exception):
    """Raised by custom digest handlers that cannot digest a value
    (reference: smartcache.CustomDigestError)."""


def digest(obj, custom_digests=None):
    """Stable hash digest of (almost) any python object, used for
    memoization keys (reference: smartcache.digest)."""
    import hashlib
    import numbers
    import numpy as _np
    custom_digests = custom_digests or []
    md5 = hashlib.md5()

    def _update(o):
        if o is None:
            md5.update(b"NONE")
        elif isinstance(o, bool):
            md5.update(b"T" if o else b"F")
        elif isinstance(o, numbers.Number):
            md5.update(repr(o).encode())
        elif isinstance(o, (str, bytes)):
            md5.update(o.encode() if isinstance(o, str) else o)
        elif isinstance(o, _np.ndarray):
            md5.update(o.tobytes())
        elif isinstance(o, (tuple, list)):
            for x in o:
                _update(x)
        elif isinstance(o, dict):
            for k in sorted(o.keys(), key=repr):
                _update(k)
                _update(o[k])
        else:
            for custom in custom_digests:
                try:
                    custom(md5, o)
                    break
                except CustomDigestError:
                    continue
            else:
                md5.update(repr(o).encode())

    _update(obj)
    return md5.digest()
