"""Outcome-label dictionary whose keys are outcome tuples like ('01',)
(counterpart of pygsti_tpu/baseobjs/outcomelabeldict.py)."""

from __future__ import annotations

import collections


class OutcomeLabelDict(collections.OrderedDict):
    """An ordered dict whose keys are canonicalized outcome tuples."""

    @staticmethod
    def to_outcome(val):
        """Strings become 1-tuples; tuples pass through with str entries."""
        if isinstance(val, str):
            return (val,)
        if isinstance(val, tuple):
            return tuple(v if isinstance(v, str) else str(v) for v in val)
        return (str(val),)

    def __getitem__(self, key):
        return super().__getitem__(OutcomeLabelDict.to_outcome(key))

    def __setitem__(self, key, val):
        super().__setitem__(OutcomeLabelDict.to_outcome(key), val)

    def __contains__(self, key):
        return super().__contains__(OutcomeLabelDict.to_outcome(key))

    def get(self, key, default=None):
        return super().get(OutcomeLabelDict.to_outcome(key), default)
