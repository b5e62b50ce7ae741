"""Multiprocessing helpers (counterpart of pygsti_tpu/tools/mptools.py).

The reference uses multiprocessing.Pool for RB circuit sampling; the same
API runs serially for one processor and through a process pool otherwise.
"""

from __future__ import annotations

import multiprocessing as _mp


def starmap_with_kwargs(fn, num_runs, num_processors, args_list, kwargs_list):
    """Run `fn(*args_list[i], **kwargs_list[i])` for i in range(num_runs),
    optionally with a process pool (reference:
    mptools.starmap_with_kwargs:18)."""
    if len(args_list) != num_runs or len(kwargs_list) != num_runs:
        raise ValueError("args_list and kwargs_list must each hold num_runs entries")
    if num_processors is None or num_processors <= 1:
        return [fn(*a, **k) for a, k in zip(args_list, kwargs_list)]
    with _mp.Pool(processes=min(num_processors, num_runs)) as pool:
        results = [pool.apply_async(fn, a, k)
                   for a, k in zip(args_list, kwargs_list)]
        return [r.get() for r in results]
