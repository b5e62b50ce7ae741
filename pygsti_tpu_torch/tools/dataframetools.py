"""Column tables and their post-processing (counterpart of
pygsti_tpu/tools/dataframetools.py).

The JAX package keeps benchmark results in pandas frames.  The port keeps
them in a ColumnTable, named columns of numpy arrays, so that nothing on the
card's path needs pandas; ``ColumnTable.to_dataframe()`` gives the pandas
frame of the same data where pandas is installed.  Host numpy.
"""

from __future__ import annotations

import numpy as np


def _column_array(values):
    """A numpy array of one column: numbers as a numeric array, anything
    else (strings, None, tuples) as an object array."""
    values = list(values)
    if all(isinstance(v, (bool, int, float, np.integer, np.floating)) for v in values):
        return np.asarray(values) if values else np.empty(0, float)
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def _same(a, b):
    """Equality with NaN equal to NaN, as pandas' unique() counts it."""
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a) and np.isnan(b):
        return True
    return a == b


def _unique(values):
    """The distinct values of a column, in order of first appearance."""
    out = []
    for v in values:
        if not any(_same(v, u) for u in out):
            out.append(v)
    return out


class ColumnTable(object):
    """Rows of named columns, each column a numpy array of one length.

    ``table[name]`` is a column, ``table.rows(mask)`` the rows where a
    boolean mask is true, ``len(table)`` the number of rows."""

    def __init__(self, columns=None):
        self._cols = {}
        n = None
        for name, vals in (columns or {}).items():
            arr = vals if isinstance(vals, np.ndarray) else _column_array(vals)
            if n is not None and len(arr) != n:
                raise ValueError("column %r has %d rows, not %d" % (name, len(arr), n))
            n = len(arr)
            self._cols[name] = arr

    @classmethod
    def from_rows(cls, rows):
        """One row per dict; a key missing from a row is NaN there, as in
        ``pandas.DataFrame(rows)``."""
        names = []
        for r in rows:
            names.extend(k for k in r if k not in names)
        return cls({k: _column_array([r.get(k, np.nan) for r in rows]) for k in names})

    @classmethod
    def from_dataframe(cls, df):
        """The columns of a pandas frame (read without importing pandas)."""
        return cls({c: np.asarray(df[c].to_numpy()) for c in df.columns})

    @property
    def columns(self):
        return list(self._cols.keys())

    def __getitem__(self, name):
        return self._cols[name]

    def __contains__(self, name):
        return name in self._cols

    def __len__(self):
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def rows(self, mask_or_index):
        """The table of the rows a boolean mask (or index array) picks."""
        return ColumnTable({k: v[mask_or_index] for k, v in self._cols.items()})

    def row_dicts(self):
        return [{k: v[i] for k, v in self._cols.items()} for i in range(len(self))]

    def unique(self, name):
        return _unique(self._cols[name])

    def drop(self, columns):
        return ColumnTable({k: v for k, v in self._cols.items() if k not in set(columns)})

    @staticmethod
    def concat(tables, like=None):
        """The rows of `tables` one after another; with none, the empty table
        with the columns of `like`."""
        tables = list(tables)
        if not tables:
            return ColumnTable({k: v[:0] for k, v in like._cols.items()})
        return ColumnTable({k: np.concatenate([t[k] for t in tables]) for k in tables[0].columns})

    def to_dataframe(self):
        """The pandas frame of this table (ImportError without pandas)."""
        try:
            import pandas as pd
        except ImportError as e:
            raise ImportError("pandas is not installed; the ColumnTable itself holds the same "
                              "data (table[column] is a numpy array)") from e
        return pd.DataFrame({k: v for k, v in self._cols.items()})

    def __repr__(self):
        return "ColumnTable(%d rows: %s)" % (len(self), ", ".join(map(str, self.columns)))


def _drop_constant_cols(table):
    return table.drop([c for c in table.columns if len(table.unique(c)) == 1])


def _reset_index(table):
    """The table with a leading 'index' column 0 ... N-1 (what pandas'
    reset_index gives a frame with a default index)."""
    cols = {'index': np.arange(len(table))}
    cols.update({c: table[c] for c in table.columns})
    return ColumnTable(cols)


def _process_dataframe(table, pivot_valuename, pivot_value, drop_columns,
                       preserve_order=False):
    """Optionally drop columns, then pivot: one row per distinct combination
    of the other columns, one column per value of `pivot_valuename` holding
    the mean of `pivot_value` (NaN where no row has it), as pandas'
    pivot_table then reset_index do.  Rows and new columns are sorted unless
    `preserve_order`."""
    if drop_columns:
        for col in (drop_columns if not isinstance(drop_columns, bool) else []):
            table = table.drop([col])
        if drop_columns is True:
            table = _drop_constant_cols(table)
    if pivot_valuename is None and pivot_value is None:
        return table
    assert pivot_valuename is not None and pivot_value is not None, \
        "Both pivot_valuename and pivot_value must be given"
    index_cols = [c for c in table.columns if c not in (pivot_valuename, pivot_value)]
    keys, sums = [], {}
    names = table.unique(pivot_valuename)
    for r in table.row_dicts():
        key = tuple(r[c] for c in index_cols)
        if key not in sums:
            keys.append(key)
            sums[key] = {}
        acc = sums[key].setdefault(r[pivot_valuename], [0.0, 0])
        acc[0] += r[pivot_value]
        acc[1] += 1
    if not preserve_order:
        keys = sorted(keys)
        names = sorted(names)
    cols = {c: [k[i] for k in keys] for i, c in enumerate(index_cols)}
    for name in names:
        cols[name] = [sums[k][name][0] / sums[k][name][1] if name in sums[k] else np.nan
                      for k in keys]
    return ColumnTable(cols)


def starmap_with_kwargs(fn, num_runs, num_processors, args_list, kwargs_list):
    """fn over the args and kwargs lists, one call after another."""
    return [fn(*args, **kwargs) for args, kwargs in zip(args_list, kwargs_list)]
