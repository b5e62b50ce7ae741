"""List utilities (counterpart of pygsti_tpu/tools/listtools.py)."""

from __future__ import annotations

import itertools


def remove_duplicates_in_place(l, index_to_test=None):
    """Remove duplicates preserving order, in place (reference:
    listtools.remove_duplicates_in_place)."""
    seen = set()
    i = 0
    while i < len(l):
        key = l[i] if index_to_test is None else l[i][index_to_test]
        if key in seen:
            del l[i]
        else:
            seen.add(key)
            i += 1
    return l


def remove_duplicates(l, index_to_test=None):
    """Order-preserving duplicate removal (reference:
    listtools.remove_duplicates)."""
    out = list(l)
    return remove_duplicates_in_place(out, index_to_test)


def compute_occurrence_indices(lst):
    """For each element, how many times it has occurred before (reference:
    listtools.compute_occurrence_indices)."""
    counts = {}
    out = []
    for x in lst:
        out.append(counts.get(x, 0))
        counts[x] = counts.get(x, 0) + 1
    return out


def find_replace_tuple(t, alias_dict):
    """Expand aliases within a tuple (reference:
    listtools.find_replace_tuple)."""
    t = tuple(t)
    if alias_dict:
        for lbl, expansion in alias_dict.items():
            while lbl in t:
                i = t.index(lbl)
                t = t[:i] + tuple(expansion) + t[i + 1:]
    return t


def find_replace_tuple_list(list_of_tuples, alias_dict):
    return [find_replace_tuple(t, alias_dict) for t in list_of_tuples]


def apply_aliases_to_circuits(list_of_circuits, alias_dict):
    """Expand op-label aliases in circuits (reference:
    listtools.apply_aliases_to_circuits)."""
    if not alias_dict:
        return list(list_of_circuits)
    from pygsti_tpu_torch.circuits.circuitconstruction import translate_circuits
    return translate_circuits(list(list_of_circuits), alias_dict)


def sorted_partitions(n):
    """Sorted (descending) integer partitions of n (reference:
    listtools.sorted_partitions)."""
    if n == 0:
        yield ()
        return

    def gen(n, max_part):
        if n == 0:
            yield ()
            return
        for first in range(min(n, max_part), 0, -1):
            for rest in gen(n - first, first):
                yield (first,) + rest

    yield from gen(n, n)


def partitions(n):
    """All ordered integer partitions (compositions' multisets as perms of
    sorted partitions; reference: listtools.partitions)."""
    for p in sorted_partitions(n):
        yield from set(itertools.permutations(p))


def partition_into(n, nbins):
    """Partitions of n into exactly nbins nonnegative parts (reference:
    listtools.partition_into)."""
    if nbins == 1:
        yield (n,)
        return
    for first in range(n, -1, -1):
        for rest in partition_into(n - first, nbins - 1):
            yield (first,) + rest


def incd_product(*ranges):
    """Iterate a product in 'incremented-digit' order, yielding (index that
    changed, tuple) (reference: listtools.incd_product)."""
    prev = None
    for combo in itertools.product(*ranges):
        if prev is None:
            yield 0, combo
        else:
            for i, (a, b) in enumerate(zip(prev, combo)):
                if a != b:
                    yield i, combo
                    break
        prev = combo


def lists_to_tuples(obj):
    """Recursively convert lists to tuples (reference:
    listtools.lists_to_tuples)."""
    if isinstance(obj, list):
        return tuple(lists_to_tuples(x) for x in obj)
    if isinstance(obj, dict):
        return {k: lists_to_tuples(v) for k, v in obj.items()}
    return obj
