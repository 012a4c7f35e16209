"""Native (C++) host-side helpers, loaded with ctypes.

A copy of the JAX package's native/ helper: ``kbmod_native.cpp`` (grid
dedup, stamp cutouts, the RICE_1 codec, and, the port's own, the JSON text
of float rows for the ECSV writer) is compiled on first use with
``g++ -O3 -shared -fPIC -std=c++17 -pthread`` into
``kbmod_tpu_torch/_build/libkbmod_native-<hash>.so``, keyed by a hash of the
source and the flags, as ``ops/_build.py`` keys the CUDA build; nothing is
written beside the source. Where the library cannot be built (no compiler)
``available()`` is False, one warning is logged, and every caller runs its
pure-Python path, which gives the same results.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from kbmod_tpu_torch import tracing

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "kbmod_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib = None
_tried = False


def library_path():
    """Where the library lives once built: keyed by the source and flags."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libkbmod_native-{digest}.so"


def _build(out):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    tracing.count("native.build")
    logger.info(f"Building native library: {' '.join(cmd)}")
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.grid_dedup.restype = ctypes.c_int64
            lib.grid_dedup.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.c_double,
                ctypes.c_double,
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.extract_stamps.restype = None
            lib.extract_stamps.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.rice_decode.restype = ctypes.c_int
            lib.rice_decode.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.rice_encode.restype = ctypes.c_int64
            lib.rice_encode.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64,
            ]
            lib.format_float_rows.restype = None
            lib.format_float_rows.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_char),
                ctypes.POINTER(ctypes.c_int64),
            ]
            _lib = lib
        except Exception as err:  # no compiler, or the build failed
            logger.warning(f"Native library unavailable ({err}); using the pure-Python paths.")
            _lib = None
    return _lib


def available():
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def grid_dedup(x, y, vx, vy, lh, bin_width, max_time):
    """Best-lh-per-bin indices (ascending) via the native hash map.

    Semantics match kbmod_tpu_torch.filters.clustering_grid.grid_keep_indices
    for bin coordinates within +/-32767 bins (survey-scale images); returns
    None when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.int32)
    y = np.ascontiguousarray(y, dtype=np.int32)
    vx = np.ascontiguousarray(vx, dtype=np.float32)
    vy = np.ascontiguousarray(vy, dtype=np.float32)
    lh = np.ascontiguousarray(lh, dtype=np.float32)
    n = len(x)
    out = np.empty(n, dtype=np.int64)
    count = lib.grid_dedup(
        _ptr(x, ctypes.c_int32),
        _ptr(y, ctypes.c_int32),
        _ptr(vx, ctypes.c_float),
        _ptr(vy, ctypes.c_float),
        _ptr(lh, ctypes.c_float),
        n,
        float(bin_width),
        float(max_time),
        _ptr(out, ctypes.c_int64),
    )
    return out[:count]


def extract_stamps(imgs, xs, ys, radius):
    """(n, T, S, S) NaN-padded stamps via the native loop; None when the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    imgs = np.ascontiguousarray(imgs, dtype=np.float32)
    xs = np.ascontiguousarray(xs, dtype=np.int32)
    ys = np.ascontiguousarray(ys, dtype=np.int32)
    T, H, W = imgs.shape
    n = xs.shape[0]
    S = 2 * radius + 1
    out = np.empty((n, T, S, S), dtype=np.float32)
    lib.extract_stamps(
        _ptr(imgs, ctypes.c_float),
        T, H, W,
        _ptr(xs, ctypes.c_int32),
        _ptr(ys, ctypes.c_int32),
        n,
        radius,
        _ptr(out, ctypes.c_float),
    )
    return out


def rice_decode(data, npix, bytepix):
    """Decode a RICE_1 stream via the native codec; None when the native
    library is unavailable (the caller falls back to io/rice.py)."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    out = np.empty(int(npix), dtype=np.int32)
    rc = lib.rice_decode(
        _ptr(buf, ctypes.c_uint8), len(buf), int(npix), int(bytepix),
        _ptr(out, ctypes.c_int32),
    )
    if rc != 0:
        raise ValueError("Corrupt RICE stream (native decoder).")
    return out


def rice_encode(values, bytepix):
    """Encode int values as a RICE_1 stream via the native codec; None
    when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(values, dtype=np.int32)
    # Worst case: every block verbatim -> bytepix + fsbits bits overhead
    # per block plus bbits per value; 2x + 64 covers all of it.
    cap = 2 * vals.size * int(bytepix) + vals.size // 4 + 64
    out = np.empty(cap, dtype=np.uint8)
    n = lib.rice_encode(
        _ptr(vals, ctypes.c_int32), vals.size, int(bytepix),
        _ptr(out, ctypes.c_uint8), cap,
    )
    if n < 0:
        raise ValueError("RICE encode buffer overflow (native encoder).")
    return out[:n].tobytes()


def format_float_rows(values):
    """Each row of the 2-D float array ``values`` as the text
    ``json.dumps(row.tolist())`` gives, byte for byte, in a list; None when
    the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(values, dtype=np.float64)
    n, m = vals.shape
    # A value takes at most 24 characters and its separator 2.
    out = np.empty(n * (26 * m + 2), dtype=np.uint8)
    ends = np.empty(n, dtype=np.int64)
    lib.format_float_rows(_ptr(vals, ctypes.c_double), n, m, _ptr(out, ctypes.c_char), _ptr(ends, ctypes.c_int64))
    ends = ends.tolist()
    text = str(out[: ends[-1] if n else 0].data, "ascii")
    return [text[start:end] for start, end in zip([0, *ends], ends)]
