"""Per-tile checkpoint/resume for the core search.

Port of the JAX package's search/checkpoint.py. ``checkpointed_core_search``
splits the starting-pixel y-range into row tiles, runs
:func:`kbmod_tpu_torch.ops.search.core_search` (or a given per-tile search,
such as the mesh-sharded one) on each, and writes one
``tile_<y0>_<y1>.npz`` per finished tile under ``checkpoint_dir``. A
resumed call with the same inputs (checked by a content fingerprint stored
in ``manifest.json``) loads the finished tiles and computes the rest. The
output equals one un-tiled ``core_search`` call bit for bit: each pixel's
top-K depends only on that pixel's curves (the in-kernel sigma-G re-rank
and refinement are per pixel too), and the result layout is pixel-major, so
row tiles concatenate exactly.

The fingerprint covers every element of every plane: a digest of each time
plane is computed on the planes' device and only the digests (T values a
plane set) come to the host. It differs from the JAX package's sampled
fingerprint, so a directory the JAX package wrote is discarded as stale.

In a ``torch.distributed`` group, ``checkpoint_dir`` must be shared
storage: process 0 owns the manifest and every write, a barrier follows the
manifest, and process 0's finished-tile set is broadcast (an int32 tensor
on the CPU under ``gloo``, on the process's card under NCCL), so that
every process takes the same load-or-compute branch and the collectives
inside a sharded per-tile search stay aligned. A barrier precedes the
cleanup.
"""

import hashlib
import json
import logging
import os
import queue
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from kbmod_tpu_torch.ops import search as search_ops
from kbmod_tpu_torch.ops.psi_phi import padded_width
from kbmod_tpu_torch.parallel.distributed import collective_device, process_rank_and_count

logger = logging.getLogger(__name__)

_RESULT_KEYS = ("x", "y", "vx", "vy", "lh", "flux", "obs_count")
# The switches that change what core_search returns: part of the fingerprint.
_RESULT_SWITCHES = ("KB_SIGMAG_MODE", "KB_SIGMAG_TOPK_FACTOR", "KB_SIGMAG_AUTO")
# Odd multiplier of the plane digests (2^64 / golden ratio, as int64).
_MIX = 0x9E3779B97F4A7C15 - (1 << 64)


class _TileWriter:
    """Background checkpoint writer: one thread drains a bounded queue of
    (path, arrays) jobs, so that a tile's write overlaps the next tile's
    device work.

    Files are published atomically, written to a hidden ``.<name>.tmp.npz``
    sibling and then ``os.replace``d, so a SIGKILL at any point leaves only
    complete ``tile_*.npz`` files (and at most one hidden tmp, which a
    resume ignores). ``close()`` drains the queue and re-raises the first
    write error, so success guarantees every tile is on disk.
    """

    def __init__(self, directory, max_pending=2):
        self._dir = directory
        self._queue = queue.Queue(maxsize=max_pending)
        self._error = None
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self):
        while True:
            job = self._queue.get()
            if job is None:
                return
            path, arrays = job
            try:
                tmp = os.path.join(self._dir, "." + os.path.basename(path) + ".tmp.npz")
                np.savez(tmp, **arrays)
                os.replace(tmp, path)
            except Exception as exc:  # surfaced by close()
                if self._error is None:
                    self._error = exc

    def submit(self, path, arrays):
        if self._error is not None:
            raise self._error
        self._queue.put((path, arrays))

    def close(self):
        self._queue.put(None)
        self._thread.join()
        if self._error is not None:
            raise self._error


def _as_int64(flat):
    """A 1-D tensor's elements as int64: the bit patterns of floats, the
    values of integers (uint16 through its int16 view)."""
    if flat.dtype == torch.float32:
        return flat.view(torch.int32).to(torch.int64)
    if flat.dtype == torch.float64:
        return flat.view(torch.int64)
    if flat.dtype == torch.uint16:
        return flat.view(torch.int16).to(torch.int64)
    return flat.to(torch.int64)


def _plane_digests(a):
    """(R,) int64 digests of the R leading-axis planes of a tensor, computed
    on its device: the sum, modulo 2^64, of each element's bits times an
    odd weight of its position. A change of any one element changes its
    plane's digest (an odd weight is invertible modulo 2^64)."""
    if a.dim() == 0:
        a = a.reshape(1)
    n = a[0].numel()
    weights = torch.arange(1, n + 1, dtype=torch.int64, device=a.device) * _MIX | 1
    return torch.stack([(_as_int64(a[r].reshape(-1)) * weights).sum() for r in range(a.shape[0])]).cpu().numpy()


def checkpoint_bytes(H, W):
    """Device bytes of the fingerprint's digest (:func:`_plane_digests`, 3 int64 an
    element) of the widest plane of an H x W stack, a quantized one's code pairs."""
    return 48 * H * padded_width(W)


def _fingerprint(psi, phi, valid, times, vxs, vys, bounds, rpp, kwargs):
    """Content hash binding a checkpoint directory to one search: shapes,
    a digest of every plane of psi, phi and the validity plane (or of a
    quantized stack's code pairs), the times, the candidates, the bounds,
    the results per pixel, every keyword argument (arrays by digest,
    callables by presence) and the result-changing switches."""
    h = hashlib.sha256()

    def upd(a):
        if isinstance(a, np.ndarray) or np.isscalar(a):
            a = torch.as_tensor(np.ascontiguousarray(a))
        h.update(repr((tuple(a.shape), str(a.dtype))).encode())
        h.update(_plane_digests(a).tobytes())

    if isinstance(psi, search_ops.EncodedPlanes):
        # The code pairs hold both code planes; em decodes them.
        if psi.pairs is not None:
            upd(psi.pairs)
        else:
            upd(psi.psi_codes)
            upd(psi.phi_codes)
        upd(np.asarray(psi.em, dtype=np.float32))
    else:
        upd(psi)
        upd(phi)
    if valid is not None:
        upd(valid)
    h.update(np.asarray(times, dtype=np.float64).tobytes())
    h.update(np.asarray(vxs, dtype=np.float32).tobytes())
    h.update(np.asarray(vys, dtype=np.float32).tobytes())
    h.update(np.asarray(bounds, dtype=np.int64).tobytes())
    h.update(np.int64(rpp).tobytes())
    for k, v in sorted(kwargs.items()):
        if v is None or np.isscalar(v):
            h.update(json.dumps({k: v}, default=str).encode())
        elif callable(v) and not hasattr(v, "shape"):
            # A callable carries no hashable content; record its presence.
            h.update(f"{k}:<callable>".encode())
        else:
            h.update(k.encode())
            upd(v)
    h.update(json.dumps({k: os.environ.get(k) for k in _RESULT_SWITCHES}).encode())
    return h.hexdigest()


def _barrier():
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def checkpointed_core_search(
    psi, phi, valid, times, vxs, vys, x_min, x_max, y_min, y_max, results_per_pixel,
    checkpoint_dir, tile_rows=256, cleanup=False, search_fn=None, timings=None, **core_kwargs,
):
    """Run core_search in resumable row tiles.

    Parameters mirror :func:`kbmod_tpu_torch.ops.search.core_search` plus:

    * ``checkpoint_dir``: directory for the per-tile ``.npz`` files and the
      ``manifest.json`` fingerprint; created if missing.
    * ``tile_rows``: starting-pixel rows per tile (the unit of resume).
    * ``cleanup``: delete the tiles and the manifest on success.
    * ``search_fn``: per-tile search with core_search's positional
      signature; defaults to core_search. The sharded path passes a
      mesh-sharded adapter.
    * ``timings``: a dict that receives "search_ms" and "assemble_ms"
      summed over the computed tiles, "fingerprint_ms" and "tiles_loaded".

    Returns the same pixel-major dict of numpy arrays as ``core_search``.
    """
    if search_fn is None:
        search_fn = search_ops.core_search
    os.makedirs(checkpoint_dir, exist_ok=True)
    bounds = (int(x_min), int(x_max), int(y_min), int(y_max))
    t_fp = time.perf_counter()
    fp = _fingerprint(psi, phi, valid, times, vxs, vys, bounds, results_per_pixel, core_kwargs)
    fp_ms = (time.perf_counter() - t_fp) * 1e3
    logger.info(f"Checkpoint fingerprint in {fp_ms:.1f} ms.")

    rank, nproc = process_rank_and_count()
    is_primary = rank == 0
    manifest_path = os.path.join(checkpoint_dir, "manifest.json")
    if is_primary:
        stale = False
        if os.path.exists(manifest_path):
            try:
                with open(manifest_path) as f:
                    old = json.load(f)
                stale = old.get("fingerprint") != fp or old.get("tile_rows") != int(tile_rows)
            except (json.JSONDecodeError, OSError):
                stale = True
        if stale:
            logger.warning(f"Checkpoint dir {checkpoint_dir} belongs to a different search; discarding it.")
            for name in os.listdir(checkpoint_dir):
                if (
                    name == "manifest.json"
                    or (name.startswith("tile_") and name.endswith(".npz"))
                    or (name.startswith(".tile_") and name.endswith(".tmp.npz"))
                ):
                    os.remove(os.path.join(checkpoint_dir, name))
        with open(manifest_path, "w") as f:
            json.dump({"fingerprint": fp, "tile_rows": int(tile_rows), "bounds": bounds}, f)

    edges = list(range(int(y_min), int(y_max), int(tile_rows))) + [int(y_max)]
    tiles = list(zip(edges[:-1], edges[1:]))
    paths = [os.path.join(checkpoint_dir, f"tile_{y0}_{y1}.npz") for y0, y1 in tiles]
    if nproc > 1:
        # No process lists the tiles while process 0 may still be
        # discarding a stale directory; then process 0's list is the list.
        _barrier()
        local = torch.tensor([os.path.exists(p) for p in paths], dtype=torch.int32, device=collective_device())
        if not is_primary:
            local.zero_()
        dist.broadcast(local, src=0)
        finished = local.cpu().numpy().astype(bool)
    else:
        finished = np.array([os.path.exists(p) for p in paths], bool)

    parts = []
    n_loaded = 0
    stage = {"search_ms": 0.0, "assemble_ms": 0.0}
    writer = _TileWriter(checkpoint_dir) if is_primary else None
    try:
        for (y0, y1), path, done in zip(tiles, paths, finished):
            if done:
                try:
                    with np.load(path) as z:
                        parts.append({k: z[k] for k in _RESULT_KEYS})
                except OSError as exc:
                    raise OSError(
                        f"Process {rank} cannot read finished tile {path}; multi-process checkpointing "
                        f"needs checkpoint_dir on shared storage."
                    ) from exc
                n_loaded += 1
                continue
            tile_t = {} if timings is not None else None
            extra = {} if tile_t is None else {"timings": tile_t}
            part = search_fn(
                psi, phi, valid, times, vxs, vys, x_min, x_max, y0, y1, results_per_pixel, **core_kwargs, **extra,
            )
            for key in stage:
                stage[key] += (tile_t or {}).get(key, 0.0)
            # Persist off the critical path: the writer thread stores this
            # tile while the next tile's device work runs.
            if writer is not None:
                writer.submit(path, {k: part[k] for k in _RESULT_KEYS})
            parts.append(part)
            logger.debug(f"Checkpointed search tile y=[{y0},{y1}) -> {path}")
    finally:
        if writer is not None:
            writer.close()
    if n_loaded:
        logger.info(f"Resumed {n_loaded}/{len(tiles)} search tiles from {checkpoint_dir}.")
    if timings is not None:
        timings.update(stage, fingerprint_ms=fp_ms, tiles_loaded=n_loaded)

    results = {k: np.concatenate([p[k] for p in parts]) for k in _RESULT_KEYS}
    if cleanup and nproc > 1:
        # No process may still be loading tiles once process 0 deletes them.
        _barrier()
    if cleanup and is_primary:
        for path in paths:
            if os.path.exists(path):
                os.remove(path)
        os.remove(manifest_path)
    return results
