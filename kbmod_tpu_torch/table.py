"""A lightweight column-oriented table.

The reference builds its ``Results`` class on ``astropy.table.Table``;
astropy is not a dependency of kbmod_tpu_torch (nor of the JAX package whose
module this copies), so this module provides the small
subset of Table behavior the framework needs: named numpy columns (1D or
N-D), row/column/mask indexing, metadata, sorting, and simple IO hooks.
"""

import copy as _copy

import numpy as np


class Row:
    """A lightweight view of one table row."""

    def __init__(self, table, index):
        self._table = table
        self._index = index

    def __getitem__(self, key):
        return self._table[key][self._index]

    def __setitem__(self, key, value):
        self._table[key][self._index] = value

    def __contains__(self, key):
        return key in self._table.colnames

    def keys(self):
        return self._table.colnames

    def as_dict(self):
        return {k: self._table[k][self._index] for k in self._table.colnames}

    def __repr__(self):
        return f"Row({self.as_dict()})"


class Table:
    """A dict of named numpy columns sharing a common length."""

    def __init__(self, data=None, names=None, meta=None):
        self._cols = {}
        self.meta = dict(meta) if meta else {}
        if data is None:
            return
        if isinstance(data, Table):
            for name in data.colnames:
                self._cols[name] = np.array(data[name])
            self.meta.update(data.meta)
        elif isinstance(data, dict):
            for name, col in data.items():
                self[name] = col
        elif isinstance(data, (list, tuple)) and data and isinstance(data[0], dict):
            # List of row dicts.
            keys = list(data[0].keys())
            for key in keys:
                self[key] = [row[key] for row in data]
        elif isinstance(data, (list, tuple)) and names is not None:
            for name, col in zip(names, data):
                self[name] = col
        elif isinstance(data, np.ndarray) and data.dtype.names:
            for name in data.dtype.names:
                self._cols[name] = np.array(data[name])
        elif isinstance(data, (list, tuple)) and len(data) == 0:
            pass
        else:
            raise ValueError(f"Unsupported Table initialization data: {type(data)}")

    # --- basic properties ---

    @property
    def colnames(self):
        return list(self._cols.keys())

    def __len__(self):
        if not self._cols:
            return 0
        return len(next(iter(self._cols.values())))

    def __contains__(self, key):
        return key in self._cols

    def __iter__(self):
        for i in range(len(self)):
            yield Row(self, i)

    # --- indexing ---

    def _coerce_column(self, col):
        if isinstance(col, np.ndarray):
            return col
        if isinstance(col, (list, tuple)):
            # Ragged entries (e.g. variable-size stamps) become object arrays.
            try:
                return np.asarray(col)
            except ValueError:
                arr = np.empty(len(col), dtype=object)
                for i, item in enumerate(col):
                    arr[i] = item
                return arr
        return np.asarray(col)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        if isinstance(key, (int, np.integer)):
            if key < 0:
                key += len(self)
            return Row(self, int(key))
        if isinstance(key, slice) or isinstance(key, (list, np.ndarray)):
            new = Table(meta=self.meta)
            for name, col in self._cols.items():
                new._cols[name] = col[key]
            return new
        if isinstance(key, tuple) and all(isinstance(k, str) for k in key):
            new = Table(meta=self.meta)
            for name in key:
                new._cols[name] = self._cols[name]
            return new
        raise KeyError(f"Unsupported Table index: {key!r}")

    def __setitem__(self, key, value):
        if not isinstance(key, str):
            raise KeyError("Only string column assignment is supported.")
        col = self._coerce_column(value)
        if np.isscalar(value) or (isinstance(value, np.ndarray) and value.ndim == 0):
            col = np.full(max(len(self), 1), value)
        if self._cols and len(col) != len(self):
            raise ValueError(f"Column {key} has length {len(col)}; expected {len(self)}.")
        self._cols[key] = col

    def __delitem__(self, key):
        del self._cols[key]

    # --- mutation ---

    def add_column(self, col, name=None, index=None):
        if name is None:
            raise ValueError("Column name required.")
        self[name] = col

    def remove_column(self, name):
        del self._cols[name]

    def remove_columns(self, names):
        for name in names:
            self._cols.pop(name, None)

    def rename_column(self, old, new):
        self._cols = {new if k == old else k: v for k, v in self._cols.items()}

    def sort(self, keys, reverse=False):
        if isinstance(keys, str):
            keys = [keys]
        order = np.lexsort(tuple(self._cols[k] for k in reversed(keys)))
        if reverse:
            order = order[::-1]
        for name in self._cols:
            self._cols[name] = self._cols[name][order]
        return order

    def copy(self):
        new = Table(meta=_copy.deepcopy(self.meta))
        for name, col in self._cols.items():
            new._cols[name] = np.array(col, copy=True)
        return new

    def as_dict(self):
        return dict(self._cols)

    # --- simple IO (delegates to pandas/pyarrow/h5py where useful) ---

    def to_pandas(self):
        import pandas as pd

        flat = {}
        for name, col in self._cols.items():
            if col.ndim == 1 and col.dtype != object:
                flat[name] = col
            else:
                flat[name] = list(col)
        return pd.DataFrame(flat)

    def __repr__(self):
        cols = ", ".join(f"{k}{list(v.shape[1:]) if v.ndim > 1 else ''}" for k, v in self._cols.items())
        return f"<Table length={len(self)} cols=[{cols}]>"


def vstack(tables):
    """Concatenate tables row-wise over the union of their columns."""
    tables = [t for t in tables if len(t) > 0]
    if not tables:
        return Table()
    all_names = []
    for t in tables:
        for name in t.colnames:
            if name not in all_names:
                all_names.append(name)
    out = Table(meta=tables[0].meta)
    for name in all_names:
        pieces = []
        for t in tables:
            if name in t:
                pieces.append(t[name])
            else:
                proto = next(tt[name] for tt in tables if name in tt)
                fill = np.zeros((len(t),) + proto.shape[1:], dtype=proto.dtype)
                pieces.append(fill)
        out._cols[name] = np.concatenate(pieces, axis=0)
    return out
