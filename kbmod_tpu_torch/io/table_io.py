"""Table serialization: .ecsv (text), .parquet/.parq (pyarrow), .hdf5 (h5py).

Copy of the JAX package's io/table_io.py. The reference delegates to
astropy.table IO (results.py:78, 245); this module implements the three
formats directly on kbmod_tpu_torch.table.Table. Metadata (dicts of
JSON-serializable values) round-trips in all three formats.
Multi-dimensional columns are flattened to (N, prod(shape)) for parquet and
stored natively for hdf5/ecsv; Results restores shapes from the
``image_column_shapes`` metadata. The metadata keys are the JAX package's,
so either package reads the other's files, and the ECSV writer writes the
JAX package's bytes. ECSV needs only numpy and json (its float columns go
through the native library where it builds); parquet (pyarrow) and hdf5
(h5py) import their library when used.
"""

import json
import math
from pathlib import Path

import numpy as np

from kbmod_tpu_torch import native, tracing
from kbmod_tpu_torch.table import Table

_META_KEY = b"kbmod_tpu_meta"


# ----------------------------------------------------------------------
# ecsv: a '# %ECSV'-style header with JSON metadata + CSV body
# ----------------------------------------------------------------------

def _write_ecsv(table, filepath):
    lines = ["# %ECSV 1.0", "# ---"]
    schema = {}
    for name in table.colnames:
        col = table[name]
        if col.dtype == object:
            schema[name] = {"dtype": "json"}
        elif col.ndim > 1:
            schema[name] = {"dtype": str(col.dtype), "shape": list(col.shape[1:])}
        else:
            schema[name] = {"dtype": str(col.dtype)}
    header = {"meta": table.meta, "schema": schema, "colnames": table.colnames}
    for line in json.dumps(header).splitlines():
        lines.append(f"# {line}")
    lines.append(",".join(table.colnames))

    n = len(table)
    cols = []
    for name in table.colnames:
        col = table[name]
        if col.dtype == object:
            cols.append([json.dumps(_to_jsonable(v)) for v in col])
        elif col.ndim > 1:
            cols.append(_json_rows(col.reshape(n, math.prod(col.shape[1:]))))
        else:
            cols.append([_scalar_str(v) for v in col])
    for i in range(n):
        row = []
        for c in cols:
            cell = c[i]
            if "," in cell or '"' in cell:
                cell = '"' + cell.replace('"', '""') + '"'
            row.append(cell)
        lines.append(",".join(row))
    filepath.write_text("\n".join(lines) + "\n")


def _json_rows(flat):
    """``json.dumps`` of each row of a 2-D numeric column as a list of
    Python scalars: float columns through the native formatter where it
    builds, every other column (and floats without it) through ``tolist``.
    Either way the bytes are those of ``_scalar`` per element."""
    if flat.dtype.kind == "f":
        flat = flat.astype(np.float64, copy=False)
        if native.available():
            tracing.count("ecsv.values.native", flat.size)
            return native.format_float_rows(flat)
        tracing.count("ecsv.values.python", flat.size)
    return [json.dumps(row) for row in flat.tolist()]


def _scalar(x):
    if isinstance(x, (np.floating, float)):
        return float(x)
    if isinstance(x, (np.integer, int)):
        return int(x)
    if isinstance(x, (np.bool_, bool)):
        return bool(x)
    return x


def _scalar_str(v):
    if isinstance(v, (np.floating, float)):
        return repr(float(v))
    if isinstance(v, (np.bool_, bool)):
        return "True" if v else "False"
    return str(v)


def _to_jsonable(v):
    if isinstance(v, np.ndarray):
        return {"__ndarray__": v.tolist(), "dtype": str(v.dtype), "shape": list(v.shape)}
    return _scalar(v)


def _from_jsonable(v):
    if isinstance(v, dict) and "__ndarray__" in v:
        return np.asarray(v["__ndarray__"], dtype=v["dtype"]).reshape(v["shape"])
    return v


def _read_ecsv(filepath):
    import csv as csv_mod
    import io as io_mod
    import sys

    # Image columns serialize to very large JSON cells.
    csv_mod.field_size_limit(sys.maxsize)

    text = filepath.read_text()
    header_lines = []
    body_lines = []
    for line in text.splitlines():
        if line.startswith("# %ECSV") or line.strip() == "# ---":
            continue
        if line.startswith("# "):
            header_lines.append(line[2:])
        elif line.startswith("#"):
            header_lines.append(line[1:])
        else:
            body_lines.append(line)
    header = json.loads("\n".join(header_lines)) if header_lines else {}
    schema = header.get("schema", {})
    colnames = header.get("colnames", [])

    reader = csv_mod.reader(io_mod.StringIO("\n".join(body_lines)))
    rows = list(reader)
    if rows and rows[0] == colnames:
        rows = rows[1:]
    elif rows and not colnames:
        colnames = rows[0]
        rows = rows[1:]

    data = {}
    for j, name in enumerate(colnames):
        info = schema.get(name, {"dtype": "str"})
        raw = [r[j] for r in rows]
        dtype = info["dtype"]
        if dtype == "json":
            vals = [_from_jsonable(json.loads(v)) for v in raw]
            arr = np.empty(len(vals), dtype=object)
            for i, v in enumerate(vals):
                arr[i] = v
            data[name] = arr
        elif "shape" in info:
            shape = tuple(info["shape"])
            vals = [np.asarray(json.loads(v), dtype=dtype).reshape(shape) for v in raw]
            data[name] = np.stack(vals) if vals else np.zeros((0,) + shape, dtype=dtype)
        elif dtype.startswith("bool"):
            data[name] = np.array([v == "True" for v in raw], dtype=bool)
        elif dtype.startswith(("<U", "str", "object")):
            data[name] = np.array(raw, dtype=object)
        else:
            data[name] = np.array(raw, dtype=dtype) if raw else np.array([], dtype=dtype)
    table = Table(data)
    table.meta.update(header.get("meta", {}))
    return table


# ----------------------------------------------------------------------
# parquet
# ----------------------------------------------------------------------

def _write_parquet(table, filepath):
    import pyarrow as pa
    import pyarrow.parquet as pq

    arrays = {}
    for name in table.colnames:
        col = table[name]
        if col.dtype == object:
            arrays[name] = pa.array([None if v is None else str(v) for v in col])
        elif col.ndim > 1:
            flat = col.reshape(len(col), -1)
            arrays[name] = pa.array(list(flat))
        else:
            arrays[name] = pa.array(col)
    pa_table = pa.table(arrays)
    meta = dict(pa_table.schema.metadata or {})
    meta[_META_KEY] = json.dumps(table.meta).encode()
    pa_table = pa_table.replace_schema_metadata(meta)
    pq.write_table(pa_table, filepath)


def parquet_metadata(pf):
    """Extract kbmod metadata from an open pyarrow ParquetFile."""
    raw = (pf.schema_arrow.metadata or {}).get(_META_KEY)
    return json.loads(raw.decode()) if raw else {}


def arrow_batch_to_table(batch, meta=None):
    """Convert a pyarrow RecordBatch to a Table."""
    data = {}
    for name, col in zip(batch.schema.names, batch.columns):
        vals = col.to_pylist()
        if vals and isinstance(vals[0], list):
            data[name] = np.asarray(vals)
        else:
            arr = np.asarray(vals)
            if arr.dtype.kind in "OU" and all(isinstance(v, str) or v is None for v in vals):
                arr = np.array(vals, dtype=object)
            data[name] = arr
    table = Table(data)
    if meta:
        table.meta.update(meta)
    return table


def _read_parquet(filepath):
    import pyarrow.parquet as pq

    pa_table = pq.read_table(filepath)
    meta = {}
    raw = (pa_table.schema.metadata or {}).get(_META_KEY)
    if raw:
        meta = json.loads(raw.decode())
    data = {}
    for name in pa_table.schema.names:
        col = pa_table[name]
        vals = col.to_pylist()
        if vals and isinstance(vals[0], list):
            data[name] = np.asarray(vals)
        else:
            arr = np.asarray(vals)
            if arr.dtype.kind in "OU":
                arr = np.array(vals, dtype=object)
            data[name] = arr
    table = Table(data)
    table.meta.update(meta)
    return table


# ----------------------------------------------------------------------
# hdf5
# ----------------------------------------------------------------------

def _write_hdf5(table, filepath):
    import h5py

    with h5py.File(filepath, "w") as f:
        grp = f.create_group("table")
        grp.attrs["kbmod_tpu_meta"] = json.dumps(table.meta)
        grp.attrs["colnames"] = json.dumps(table.colnames)
        for name in table.colnames:
            col = table[name]
            if col.dtype == object:
                dt = h5py.string_dtype()
                grp.create_dataset(name, data=[str(v) for v in col], dtype=dt)
                grp[name].attrs["was_object"] = True
            else:
                grp.create_dataset(name, data=col)


def _read_hdf5(filepath):
    import h5py

    data = {}
    with h5py.File(filepath, "r") as f:
        grp = f["table"]
        meta = json.loads(grp.attrs.get("kbmod_tpu_meta", "{}"))
        colnames = json.loads(grp.attrs.get("colnames", "[]"))
        for name in colnames:
            ds = grp[name]
            if ds.attrs.get("was_object", False):
                vals = [v.decode() if isinstance(v, bytes) else v for v in ds[...]]
                arr = np.array(vals, dtype=object)
                data[name] = arr
            else:
                data[name] = ds[...]
    table = Table(data)
    table.meta.update(meta)
    return table


# ----------------------------------------------------------------------
# dispatch
# ----------------------------------------------------------------------

def write_table(table, filepath):
    filepath = Path(filepath)
    suffix = filepath.suffix
    if suffix in (".ecsv", ".collection"):
        # .collection is the reference's ImageCollection extension; the
        # payload is ecsv (image_collection.py write format).
        _write_ecsv(table, filepath)
    elif suffix in (".parquet", ".parq"):
        _write_parquet(table, filepath)
    elif suffix == ".hdf5":
        _write_hdf5(table, filepath)
    else:
        raise ValueError(f"Unsupported table format {suffix}")


def read_table(filepath):
    filepath = Path(filepath)
    suffix = filepath.suffix
    if suffix in (".ecsv", ".collection"):
        return _read_ecsv(filepath)
    if suffix in (".parquet", ".parq"):
        return _read_parquet(filepath)
    if suffix == ".hdf5":
        return _read_hdf5(filepath)
    raise ValueError(f"Unsupported table format {suffix}")
