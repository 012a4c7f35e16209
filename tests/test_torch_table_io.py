"""The port's ECSV writer against the JAX package's, byte for byte: float
columns through the native formatter and through the Python path, every
other column through the Python path; the formatter alone against
``json.dumps``; a table with no rows; the counters of the two paths."""

import json
from unittest import mock

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from kbmod_tpu.io import table_io as j_table_io
from kbmod_tpu.results import Results as JResults
from kbmod_tpu.table import Table as JTable

from kbmod_tpu_torch import native, tracing
from kbmod_tpu_torch.io import table_io
from kbmod_tpu_torch.results import Results
from kbmod_tpu_torch.search import TrajectoryList
from kbmod_tpu_torch.table import Table

N = 5
EDGES = [0.0, -0.0, 5e-324, -5e-324, 2.2250738585072014e-308, 2.225073858507201e-308, 1.7976931348623157e308,
         -1.7976931348623157e308, float("nan"), float("inf"), float("-inf"), 1e-5, 1e-4, 9.999999999999999e-05,
         0.00011, 1e15, 1e16, 9999999999999998.0, 1.0000000000000002e16, 1e17, 1.0, -1.0, 0.1, 123456789.125,
         1e22, 1e23, 1e-7, 1e100, 1e-100, 2.0**53, 2.0**63]


def _path(use_native):
    """The native path or the Python one; the native case skips where the
    library does not build."""
    if use_native and not native.available():
        pytest.skip("no C++ compiler for the native library")
    return mock.patch.object(native, "available", return_value=use_native)


def _column(dtype, shape, seed=11):
    rng = np.random.default_rng(seed)
    size = int(np.prod((N, *shape)))
    if np.dtype(dtype).kind == "f":
        vals = rng.normal(0, 1, size) * 10.0 ** rng.integers(-8, 8, size)
        vals[: min(size, len(EDGES))] = EDGES[:size]
    elif np.dtype(dtype).kind == "b":
        vals = rng.uniform(size=size) < 0.5
    else:
        info = np.iinfo(dtype)
        vals = rng.integers(info.min, info.max, size, endpoint=True, dtype=dtype)
    with np.errstate(over="ignore"):
        return np.asarray(vals).astype(dtype).reshape((N, *shape))


def _write_both(tmp_path, data, use_native, meta=None):
    """The port's file on the asked path and the JAX package's, as bytes."""
    with _path(use_native):
        table = Table(dict(data))
        table.meta.update(meta or {})
        table_io._write_ecsv(table, tmp_path / "port.ecsv")
    ref = JTable(dict(data))
    ref.meta.update(meta or {})
    j_table_io._write_ecsv(ref, tmp_path / "jax.ecsv")
    return (tmp_path / "port.ecsv").read_bytes(), (tmp_path / "jax.ecsv").read_bytes()


PATHS = pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])


@PATHS
@pytest.mark.parametrize("shape", [(), (1,), (3,), (2, 3), (2, 2, 3)], ids=lambda s: f"{len(s) + 1}d-{s}")
@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_],
                         ids=lambda d: np.dtype(d).name)
def test_ecsv_bytes_equal_reference(tmp_path, dtype, shape, use_native):
    port, jax = _write_both(tmp_path, {"col": _column(dtype, shape), "id": np.arange(N)}, use_native)
    assert port == jax


@PATHS
def test_ecsv_results_table_bytes_equal_reference(tmp_path, use_native):
    """A results-like table: 1-D columns, curves, obs_valid, two 21 x 21
    stamps, an all-stamps cube and an object column of arrays and dicts."""
    rng = np.random.default_rng(4)
    stamp = rng.normal(0, 30, (N, 21, 21)).astype(np.float32)
    stamp[1, 3, 4] = np.nan
    objects = np.empty(N, dtype=object)
    for i in range(N):
        objects[i] = rng.normal(size=3).astype(np.float32) if i % 2 else {"a": i, "b": [1.5, -0.0]}
    data = {
        "x": rng.integers(0, 500, N).astype(np.int32), "vx": rng.normal(0, 30, N).astype(np.float32),
        "likelihood": rng.normal(20, 5, N).astype(np.float32), "uuid": np.array([f"u{i}" for i in range(N)], dtype=object),
        "psi_curve": rng.normal(size=(N, 20)).astype(np.float32), "phi_curve": rng.uniform(size=(N, 20)),
        "obs_valid": rng.uniform(size=(N, 20)) < 0.8, "coadd_median": stamp, "stamp": stamp.copy(),
        "all_stamps": rng.normal(size=(N, 4, 3, 3)), "extra": objects,
    }
    port, jax = _write_both(tmp_path, data, use_native, meta={"num_img": 20, "dims": [512, 1024]})
    assert port == jax


def _json_rows(vals):
    return [json.dumps(row) for row in np.asarray(vals, dtype=np.float64).tolist()]


@pytest.mark.parametrize("value", EDGES, ids=repr)
def test_formatter_edge_values(value):
    if not native.available():
        pytest.skip("no C++ compiler for the native library")
    for row in ([value], [value, -value, value]):
        assert native.format_float_rows(np.array([row])) == _json_rows([row])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_formatter_matches_json_on_random_values(dtype):
    """10^5 seeded values a dtype across exponents 1e-30 to 1e30, and as
    many random float64 bit patterns."""
    if not native.available():
        pytest.skip("no C++ compiler for the native library")
    rng = np.random.default_rng(20261018)
    n = 100_000
    vals = (rng.uniform(-10, 10, n) * 10.0 ** rng.uniform(-30, 30, n)).astype(dtype).reshape(-1, 50)
    assert native.format_float_rows(vals) == _json_rows(vals)
    bits = rng.integers(0, 2**64, n, dtype=np.uint64, endpoint=False).view(np.float64).reshape(-1, 25)
    assert native.format_float_rows(bits) == _json_rows(bits)


def test_formatter_empty_shapes():
    if not native.available():
        pytest.skip("no C++ compiler for the native library")
    assert native.format_float_rows(np.zeros((0, 4))) == []
    assert native.format_float_rows(np.zeros((3, 0))) == ["[]"] * 3


@PATHS
def test_zero_rows_with_image_columns(tmp_path, use_native):
    """A results table with stamp and curve columns and no rows writes its
    header and reads back, in the port and in the JAX package, with no rows
    and the columns' shapes."""
    results = Results.from_trajectories(TrajectoryList(0))
    results.add_psi_phi_data(np.zeros((0, 20), np.float32), np.zeros((0, 20), np.float32),
                             obs_valid=np.zeros((0, 20), bool))
    results.table["coadd_median"] = np.zeros((0, 21, 21), np.float32)
    with _path(use_native):
        results.write_table(tmp_path / "empty.ecsv")
    for back in (Results.read_table(tmp_path / "empty.ecsv"), JResults.read_table(tmp_path / "empty.ecsv")):
        assert len(back) == 0
        assert set(back.colnames) == set(results.colnames)
        for name in ("psi_curve", "phi_curve", "obs_valid", "coadd_median"):
            assert back[name].shape == results.table[name].shape, name
            assert back[name].dtype == results.table[name].dtype, name


@PATHS
def test_counters(tmp_path, use_native):
    """One traced write counts the values of its multi-dimensional float
    columns under the path that formatted them, and nothing under the other."""
    data = {"a": _column(np.float32, (2, 3)), "b": _column(np.float64, (4,)), "c": _column(np.int32, (3,)),
            "d": _column(np.bool_, (2,)), "e": _column(np.float32, ())}
    floats = data["a"].size + data["b"].size
    tracing.reset()
    with _path(use_native):
        with profile(activities=[ProfilerActivity.CPU]):
            table_io.write_table(Table(data), tmp_path / "t.ecsv")
    totals = tracing.totals()
    tracing.reset()
    used, other = ("ecsv.values.native", "ecsv.values.python")[:: 1 if use_native else -1]
    assert totals.get(used) == floats
    assert other not in totals
