"""TypedDict: a dict with typed keys that converts to pandas dataframes
(counterpart of pygsti_tpu/tools/typeddict.py)."""

from __future__ import annotations


class TypedDict(dict):
    """A dict carrying per-key type metadata, convertible to a dataframe
    row (reference: typeddict.TypedDict)."""

    def __init__(self, types=None, items=()):
        super().__init__(items)
        self._types = dict(types or {})

    def __reduce__(self):
        return (TypedDict, (self._types, list(self.items())), None)

    def as_dataframe(self):
        """A single-row pandas DataFrame of this dict's items."""
        import pandas as pd
        cols = {k: [v] for k, v in self.items()}
        return pd.DataFrame(cols)
