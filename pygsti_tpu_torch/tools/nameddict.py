"""NamedDict: a dict with category names, flattenable into pandas data frames
(counterpart of pygsti_tpu/tools/nameddict.py)."""

from __future__ import annotations


class NamedDict(dict):
    """A dict holding a category name for its keys and (optionally) its
    values, so nested NamedDicts flatten into labeled dataframe columns."""

    def __init__(self, keyname=None, keytype=None, valname=None, valtype=None,
                 items=()):
        super().__init__(items)
        self.keyname = keyname
        self.keytype = keytype
        self.valname = valname
        self.valtype = valtype

    @classmethod
    def create_nested(cls, key_val_type_list, inner):
        """Create a nested NamedDict from [(keyname, keytype), ...] layers
        wrapping `inner` (reference: nameddict.py create_nested)."""
        if len(key_val_type_list) == 0:
            return inner
        keyname, keytype = key_val_type_list[0]
        return cls(keyname, keytype,
                   items=[(k, cls.create_nested(key_val_type_list[1:], v))
                          for k, v in (inner.items()
                                       if isinstance(inner, dict) else inner)])

    def _flatten(self, prefix_cols):
        rows = []
        for k, v in self.items():
            cols = prefix_cols + [(self.keyname or 'key', k)]
            if isinstance(v, NamedDict):
                rows.extend(v._flatten(cols))
            elif isinstance(v, dict):
                for vk, vv in v.items():
                    rows.append(cols + [(str(vk), vv)])
            else:
                rows.append(cols + [(self.valname or 'value', v)])
        return rows

    def to_dataframe(self):
        """Flatten into a pandas DataFrame with one column per category
        level (reference: nameddict.py to_dataframe)."""
        import pandas as pd
        rows = self._flatten([])
        records = [dict(r) for r in rows]
        return pd.DataFrame(records)

    def __reduce__(self):
        return (NamedDict, (self.keyname, self.keytype, self.valname,
                            self.valtype, list(self.items())))
