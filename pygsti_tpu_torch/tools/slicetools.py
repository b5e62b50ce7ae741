"""Slice arithmetic utilities (counterpart of pygsti_tpu/tools/slicetools.py)."""

from __future__ import annotations

import numpy as np


def length(s):
    """Number of indices in slice s (reference: slicetools.length)."""
    if not isinstance(s, slice):
        return len(s)
    if s.start is None or s.stop is None:
        return 0
    return max(0, (s.stop - s.start + ((s.step or 1) - 1)) // (s.step or 1))


def shift(s, offset):
    """Slice shifted by offset (reference: slicetools.shift)."""
    if s.start is None and s.stop is None:
        return s
    return slice(s.start + offset, s.stop + offset, s.step)


def intersect(s1, s2):
    """Intersection of two step-1 slices (reference: slicetools.intersect)."""
    assert (s1.step or 1) == 1 and (s2.step or 1) == 1
    start = max(s1.start or 0, s2.start or 0)
    stop = min(s1.stop if s1.stop is not None else start,
               s2.stop if s2.stop is not None else start)
    return slice(start, max(start, stop))


def indices(s, n=None):
    """List of indices in slice s (reference: slicetools.indices)."""
    if not isinstance(s, slice):
        return list(s)
    if s.start is None and s.stop is None:
        assert n is not None
        return list(range(n))
    return list(range(s.start, s.stop, s.step or 1))


def indices_as_array(s, n=None):
    return np.array(indices(s, n), dtype=np.int64)


def list_to_slice(lst, array_ok=False, require_contiguous=True):
    """Convert a contiguous index list to a slice (reference:
    slicetools.list_to_slice)."""
    if isinstance(lst, slice):
        return lst
    if lst is None or len(lst) == 0:
        return slice(0, 0)
    start = int(lst[0])
    if all(int(lst[i]) == start + i for i in range(len(lst))):
        return slice(start, start + len(lst))
    if require_contiguous:
        raise ValueError("List is not contiguous: cannot convert to slice")
    return np.asarray(lst) if array_ok else list(lst)


def to_array(obj):
    """Slice or list -> numpy index array (reference: slicetools.to_array)."""
    if isinstance(obj, slice):
        return indices_as_array(obj)
    return np.asarray(obj)


def divide(s, max_len):
    """Split a slice into contiguous sub-slices of at most max_len
    (reference: slicetools.divide)."""
    assert isinstance(s, slice) and (s.step or 1) == 1
    out = []
    start = s.start or 0
    while start < s.stop:
        out.append(slice(start, min(start + max_len, s.stop)))
        start += max_len
    return out


def slice_of_slice(s, base):
    """The sub-slice of `base` selected by s (reference:
    slicetools.slice_of_slice)."""
    b0 = base.start or 0
    return slice(b0 + (s.start or 0), b0 + s.stop)


def slice_hash(s):
    return (s.start, s.stop, s.step)


def intersect_within(s1, s2):
    """Intersection of two slices plus the sub-slices of each that select
    the intersection (reference: slicetools.intersect_within:97).  `s2` may
    be an index array, in which case index arrays are returned."""
    import numpy as _np
    assert s1.step in (None, 1), "only step-1 slices supported"
    if isinstance(s2, slice):
        assert s2.step in (None, 1)
        start = max(s1.start, s2.start)
        stop = min(s1.stop, s2.stop)
        if start >= stop:
            empty = slice(0, 0)
            return empty, empty, empty
        return (slice(start, stop),
                slice(start - s1.start, stop - s1.start),
                slice(start - s2.start, stop - s2.start))
    s2 = _np.asarray(s2)
    mask = (s2 >= s1.start) & (s2 < s1.stop)
    within2 = _np.nonzero(mask)[0]
    intersection = s2[mask]
    within1 = intersection - s1.start
    return intersection, within1, within2
