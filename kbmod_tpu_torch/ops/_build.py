"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source in ``kbmod_tpu_torch/csrc`` has a plain C interface and is
compiled on first use into ``kbmod_tpu_torch/_build/lib<name>-<hash>.so``,
keyed by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source rebuilds and an unchanged one loads at once. Nothing here runs at import time: the
CPU tests import every module on hosts that have no nvcc. Each compile adds one to the tracer's counter
``native.build``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from kbmod_tpu_torch import tracing

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# Register and spill report of every kernel; it does not change the binary.
_REPORT_FLAGS = ("-Xptxas", "-v")
# Dynamic shared memory one block may use on an H100 (after opting in).
MAX_SMEM_BYTES = 232448

_loaded = {}


def nvcc_path():
    """The nvcc to build with: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or the one on PATH. Raises when there is none."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build.")


def library_path(name):
    """Where the library for ``csrc/<name>.cu`` lives once built."""
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name):
    """Start nvcc for one source unless its library exists. Returns
    (name, process or None, target, temporary output)."""
    out = library_path(name)
    if out.exists():
        return name, None, out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *_REPORT_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    tracing.count("native.build")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return name, proc, out, tmp


def build(names):
    """Build the named sources, all nvcc processes started together.

    Returns {name: compiler output} ("" for a library already built).
    Raises RuntimeError with the compiler's output if any build fails."""
    jobs = [_start(n) for n in names]
    logs, failed = {}, []
    for name, proc, out, tmp in jobs:
        if proc is None:
            logs[name] = ""
            continue
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            if tmp.exists():
                tmp.unlink()
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name, signatures):
    """The ctypes library for ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps each C function to (argtypes, restype); every
    pointer and the stream must be ``ctypes.c_void_p``, or ctypes passes
    them as 32-bit ints and cuts them."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib


def check(err, what):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
