"""Sharded (multi-device) search over a mesh of devices.

Port of the JAX package's parallel/sharded.py. A :class:`Mesh` is an ordered
list of this process's devices, one shard each, and, inside a
``torch.distributed`` group, the process's rank and the group's size: the
group's shards are the processes' lists in rank order. A device may hold
more than one shard (two shards on one card check the sharded path there;
four on the CPU in the tests); the planes are copied once per device, never
once per shard.

Where the JAX package runs one ``shard_map`` program, the port runs a loop:
each local shard's work is launched on its device (asynchronously across
devices, on each device's current stream), its output copied to the first
device, and across processes gathered with ``torch.distributed.all_gather``
(``psum`` becomes ``all_reduce``). The modes:

* ``candidates``: the velocity grid is padded to a multiple of the shard
  count (``cand_valid`` 0) and split; each shard searches every pixel over
  its slice with global candidate indices, through K2 (float) or the
  encoded dispatcher (K5 where the shard's grouping plan fills, else K4 or
  K3); :func:`merge_topk` merges the maps, one shard at a time.
* ``pixels``: the starting-pixel rows are split; the maps concatenate.
* ``time``: each shard holds a slice of T on its device and sums a chunk
  of candidates' windows over it at once (gathers, plain PyTorch); the
  partial sums are added (and all-reduced across processes), then gated
  and merged into the top-K. The JAX package runs this mode in XLA only
  (no Pallas kernel), so the port runs it as plain PyTorch on the card.
  Its lh are within the float64 bound of a single-device search (the sums
  run in another order), not bit-equal.

The psi/phi build shards over the time axis (K1 per shard), and the winner
re-scoring gathers over the winners' rows.
"""

import math
import os

import numpy as np
import torch
import torch.distributed as dist

from kbmod_tpu_torch.ops import search as search_ops
from kbmod_tpu_torch.ops.conv_kernel import psi_phi_conv
from kbmod_tpu_torch.ops.psi_phi import _f32, code_pair_views
from kbmod_tpu_torch.ops.search import EncodedPlanes, _gather_codes, merge_topk
from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
from kbmod_tpu_torch.ops.search_kernel import FLT_MAX, search_topk
from kbmod_tpu_torch.parallel.distributed import collective_device, process_rank_and_count

# (candidate, pixel) sums of a chunk that a time-sharded search adds up at
# once on each shard.
TIME_CHUNK_ELEMENTS = 1 << 24


def _norm(dev):
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """This process's shards and its place in the process group.

    ``devices``: one torch.device per local shard (repeats allowed);
    ``rank``, ``world_size``: the process's rank and the group's size (0
    and 1 outside a group). Global shard ``rank * len(devices) + i`` is
    local shard i; every process holds as many shards."""

    def __init__(self, devices, rank=0, world_size=1):
        self.devices = [_norm(d) for d in devices]
        self.rank = int(rank)
        self.world_size = int(world_size)

    @property
    def size(self):
        """The global shard count."""
        return len(self.devices) * self.world_size

    @property
    def root(self):
        """The device the merged outputs land on."""
        return self.devices[0]

    def local_shards(self):
        """[(global shard index, device)] of this process's shards."""
        base = self.rank * len(self.devices)
        return [(base + i, d) for i, d in enumerate(self.devices)]

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, rank={self.rank}, world_size={self.world_size})"


def build_mesh(num_devices=None, devices=None):
    """A mesh over ``devices``, cut to the first ``num_devices``, in this
    process's group when there is one (every process passes as many
    devices). By default: every visible CUDA device outside a group; in a
    group of more than one process, the process's own card (the one
    ``initialize_distributed`` bound), so that each card of the group is
    one shard."""
    rank, world = process_rank_and_count()
    if devices is None and world > 1:
        devices = [torch.device("cuda", torch.cuda.current_device())]
    elif devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if num_devices is not None:
        devices = devices[: int(num_devices)]
    return Mesh(devices, rank, world)


def search_mesh(device):
    """The mesh ``StackSearch.search_all`` shards a search on ``device``
    over, or None: ``KB_SHARDED=0`` never shards; ``1`` shards whenever
    ``build_mesh()`` has more than one shard, all on ``device``'s type;
    ``auto`` (the default) only a CUDA search, over more than one card in
    all (this process's cards, or the group's)."""
    device = torch.device(device)
    mode = os.environ.get("KB_SHARDED", "auto")
    if mode == "0" or (mode != "1" and device.type != "cuda"):
        return None
    mesh = build_mesh()
    if mesh.size < 2 or any(d.type != device.type for d in mesh.devices):
        return None
    return mesh


def _pad_to_multiple(arr, multiple, axis=0, fill=0):
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad_widths = [(0, 0)] * arr.ndim
    pad_widths[axis] = (0, rem)
    return np.pad(arr, pad_widths, constant_values=fill), n


def _process_parts(t, mesh):
    """``t`` of every process in rank order (``[t]`` outside a group). The
    shapes must agree. The collective's tensors live on the CPU under
    ``gloo``, on this process's card under NCCL."""
    if mesh.world_size == 1:
        return [t]
    x = t.to(collective_device())
    if t.dtype == torch.bool:
        x = x.to(torch.uint8)
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x.contiguous())
    return [p.to(t.dtype) for p in parts]


def _gather_processes(t, mesh, dim=0):
    """``t`` of every process concatenated along ``dim`` in rank order, on
    the mesh's root device (``t`` itself outside a group)."""
    if mesh.world_size == 1:
        return t
    return torch.cat(_process_parts(t, mesh), dim).to(mesh.root)


def _all_reduce(t, mesh):
    """The elementwise sum of ``t`` over the processes (``psum``)."""
    if mesh.world_size == 1:
        return t
    x = t.to(collective_device()).contiguous()
    dist.all_reduce(x)
    return x.to(t.device)


def _planes_on(psi, phi, valid, dev):
    """(psi, phi, valid) on ``dev``; unchanged where they already are. An
    ``EncodedPlanes`` moves its code pairs and views them again."""
    if isinstance(psi, EncodedPlanes):
        if _norm(psi.device) == dev:
            return psi, phi, valid
        pairs = psi.pairs.to(dev) if psi.pairs is not None else None
        if pairs is not None:
            pc, fc = code_pair_views(pairs, psi.shape[2])
        else:
            pc, fc = psi.psi_codes.to(dev), psi.phi_codes.to(dev)
        return EncodedPlanes(pc, fc, psi.em, pairs), None, None
    return tuple(None if a is None else a.to(dev) for a in (psi, phi, valid))


class _Replicas:
    """The planes on each device of a mesh, copied at most once per device."""

    def __init__(self, psi, phi, valid):
        self.src = (psi, phi, valid)
        self.by_device = {}

    def on(self, dev):
        key = str(_norm(dev))
        if key not in self.by_device:
            self.by_device[key] = _planes_on(*self.src, _norm(dev))
        return self.by_device[key]


def _merge_in_order(parts, root, K):
    """The top-K of (K, SH, SW) maps that hold ascending candidate ranges,
    merged on ``root`` one part at a time, so that it holds at most two
    parts' maps (and their sort) at once."""
    lh, idx = None, None
    for p_lh, p_idx in parts:
        p_lh, p_idx = p_lh.to(root), p_idx.to(root)
        if lh is None:
            lh, idx = p_lh, p_idx
        else:
            lh, idx = merge_topk(torch.cat([lh, p_lh]), torch.cat([idx, p_idx]), K)
    return lh, idx


def _local_merge(parts, mesh, K):
    """Merge this process's shards' (K, SH, SW) maps on the root device,
    then the processes' merges: the global top-K."""
    lh, idx = _merge_in_order(parts, mesh.root, K)
    if mesh.world_size > 1:
        lh, idx = _merge_in_order(zip(_process_parts(lh, mesh), _process_parts(idx, mesh)), mesh.root, K)
    return lh, idx


def _shard_search(planes, dxs, dys, dev, kw, min_obs, min_lh, has_masked):
    """One shard's top-K search on ``dev``: K2 on float planes, the encoded
    dispatcher on codes. ``planes`` are already on ``dev``."""
    psi, phi, valid = planes
    if isinstance(psi, EncodedPlanes):
        return search_topk_encoded(psi, dxs, dys, float(min_obs), float(min_lh), **kw)
    return search_topk(psi, phi, valid, torch.as_tensor(dxs), torch.as_tensor(dys), float(min_obs), float(min_lh),
                       has_masked=has_masked, **kw)


def _window(oy, ox, SH, SW, H, W):
    """A chunk's (SH, SW) windows at one time step from their origins oy,
    ox (c,): row and column indices (c, SH, 1) and (c, 1, SW) clamped into
    the (H, W) plane, and the (c, SH, SW) mask of the positions inside it."""
    dev = oy.device
    rows = oy[:, None] + torch.arange(SH, device=dev)
    cols = ox[:, None] + torch.arange(SW, device=dev)
    inside = ((rows >= 0) & (rows < H))[:, :, None] & ((cols >= 0) & (cols < W))[:, None, :]
    return rows.clamp(0, H - 1)[:, :, None], cols.clamp(0, W - 1)[:, None, :], inside


def _float_partials(psi, phi, valid, oy, ox, SH, SW, has_masked):
    """A chunk's (3, c, SH, SW) float32 psi, phi and observation sums over
    the planes' T steps, added in time order (the K2 twin's sums): psi,
    phi (T, H, W) zero-filled, valid (T, H, W) uint8; oy, ox (c, T) window
    origins on the planes' device."""
    T, H, W = psi.shape
    acc = torch.zeros((3, oy.shape[0], SH, SW), dtype=torch.float32, device=psi.device)
    for t in range(T):
        r, c, ok = _window(oy[:, t], ox[:, t], SH, SW, H, W)
        if has_masked:
            ok = ok & (valid[t][r, c] != 0)
        acc[0] += torch.where(ok, psi[t][r, c], 0.0)
        acc[1] += torch.where(ok, phi[t][r, c], 0.0)
        acc[2] += ok.to(torch.float32)
    return acc


def _code_partials(psi_codes, phi_codes, em, oy, ox, SH, SW):
    """:func:`_float_partials` over code planes, as the K3-K5 twin sums
    them: integer code sums over the samples where both codes are non-zero,
    decoded once, ``psi = scale * sum + (min - scale) * obs``."""
    T, H, W = psi_codes.shape
    dev = psi_codes.device
    acc = torch.zeros((3, oy.shape[0], SH, SW), dtype=torch.int32, device=dev)
    for t in range(T):
        r, c, ok = _window(oy[:, t], ox[:, t], SH, SW, H, W)
        p, f = _gather_codes(psi_codes, t, r, c), _gather_codes(phi_codes, t, r, c)
        ok = ok & (p > 0) & (f > 0)
        acc[0] += torch.where(ok, p, 0)
        acc[1] += torch.where(ok, f, 0)
        acc[2] += ok.to(torch.int32)
    em = np.asarray(em, dtype=np.float32).reshape(4)
    obs = acc[2].to(torch.float32)
    return torch.stack([
        _f32(em[1], dev) * acc[0].to(torch.float32) + _f32(em[0] - em[1], dev) * obs,
        _f32(em[3], dev) * acc[1].to(torch.float32) + _f32(em[2] - em[3], dev) * obs,
        obs,
    ])


def _time_search(psi, phi, valid, dxs, dys, mesh, *, x_min, x_max, y_min, y_max, k_results,
                 min_obs, min_lh, gate_min_obs, gate_min_lh, has_masked):
    """The time-sharded search: each shard's slice of T on its own device;
    for each chunk of candidates every shard sums its slice
    (:func:`_float_partials`, :func:`_code_partials`), the partial sums are
    added on the root device and all-reduced across processes, then the
    lh are computed and gated as the twins do and merged into the top-K by
    (lh desc, index asc)."""
    encoded = isinstance(psi, EncodedPlanes)
    T = psi.shape[0]
    t_per = math.ceil(T / mesh.size)
    SH, SW, K = int(y_max) - int(y_min), int(x_max) - int(x_min), int(k_results)
    oy = torch.as_tensor(dys, dtype=torch.int64) + int(y_min)
    ox = torch.as_tensor(dxs, dtype=torch.int64) + int(x_min)
    shards = []
    for g, dev in mesh.local_shards():
        t0, t1 = min(T, g * t_per), min(T, (g + 1) * t_per)
        if t1 > t0:
            planes = (psi.psi_codes, psi.phi_codes) if encoded else (psi, phi, valid)
            shards.append((tuple(a[t0:t1].to(dev) for a in planes), t0, t1, dev))
    root = mesh.root
    top = torch.full((K, SH, SW), -FLT_MAX, dtype=torch.float32, device=root)
    topi = torch.full((K, SH, SW), -1, dtype=torch.int32, device=root)
    neg_inf = torch.full((), float("-inf"), device=root)
    C = oy.shape[0]
    chunk = max(1, TIME_CHUNK_ELEMENTS // (SH * SW))
    for c0 in range(0, C, chunk):
        c1 = min(C, c0 + chunk)
        total = torch.zeros((3, c1 - c0, SH, SW), dtype=torch.float32, device=root)
        for planes, t0, t1, dev in shards:
            oy_s, ox_s = oy[c0:c1, t0:t1].to(dev), ox[c0:c1, t0:t1].to(dev)
            if encoded:
                part = _code_partials(*planes, psi.em, oy_s, ox_s, SH, SW)
            else:
                part = _float_partials(*planes, oy_s, ox_s, SH, SW, has_masked)
            total += part.to(root)
        psi_s, phi_s, obs = _all_reduce(total, mesh)
        # IEEE float32 sqrt (through float64) and division, as the twins.
        lh = torch.where(phi_s > 0, psi_s / torch.sqrt(phi_s.double()).float(), -1.0)
        ok = obs >= float(min_obs) if gate_min_obs else torch.ones_like(lh, dtype=torch.bool)
        if gate_min_lh:
            ok &= lh >= float(min_lh)
        idx = torch.arange(c0, c1, dtype=torch.int32, device=root)[:, None, None].expand(-1, SH, SW)
        top, topi = merge_topk(torch.cat([top, torch.where(ok, lh, neg_inf)]), torch.cat([topi, idx]), K)
    return top, topi


def sharded_search_topk(
    psi, phi, valid, dxs, dys, mesh, *, x_min, x_max, y_min, y_max, k_results,
    min_obs=0.0, min_lh=0.0, gate_min_obs=True, gate_min_lh=False,
    shard_mode="candidates", has_masked=True, replicas=None,
):
    """The top-K search sharded over a mesh.

    psi, phi, valid as ``ops.search.core_search`` takes them (float planes,
    or an ``EncodedPlanes`` with phi and valid None); dxs, dys (C, T) int
    offsets. Candidates and pixels modes run each shard through K2 or the
    encoded dispatcher; time mode is plain PyTorch. Returns (top_lh,
    top_idx) (K, SH, SW) on the mesh's root device, equal slot for slot to
    a single-device search in candidates and pixels modes.
    """
    dxs = np.asarray(dxs, dtype=np.int32)
    dys = np.asarray(dys, dtype=np.int32)
    SH, SW, K = int(y_max) - int(y_min), int(x_max) - int(x_min), int(k_results)
    n = mesh.size
    if n < 1:
        raise ValueError("sharded_search_topk: the mesh has no device")
    gates = dict(gate_min_obs=gate_min_obs, gate_min_lh=bool(gate_min_lh))
    if shard_mode == "time":
        return _time_search(psi, phi, valid, dxs, dys, mesh, x_min=x_min, x_max=x_max, y_min=y_min, y_max=y_max,
                            k_results=K, min_obs=min_obs, min_lh=min_lh, has_masked=has_masked, **gates)
    replicas = replicas or _Replicas(psi, phi, valid)
    if shard_mode == "candidates":
        dxs_p, C = _pad_to_multiple(dxs, n)
        dys_p, _ = _pad_to_multiple(dys, n)
        cand_valid = np.arange(dxs_p.shape[0]) < C
        c_local = dxs_p.shape[0] // n
        parts = []
        for g, dev in mesh.local_shards():
            sl = slice(g * c_local, (g + 1) * c_local)
            kw = dict(x_min=x_min, x_max=x_max, y_min=y_min, y_max=y_max, k_results=K,
                      cand_valid=torch.as_tensor(cand_valid[sl]), cand_offset=g * c_local, **gates)
            parts.append(_shard_search(replicas.on(dev), dxs_p[sl], dys_p[sl], dev, kw, min_obs, min_lh,
                                       has_masked))
        return _local_merge(parts, mesh, K)
    if shard_mode == "pixels":
        rows_per = math.ceil(SH / n)
        lhs, idxs = [], []
        for g, dev in mesh.local_shards():
            y0 = min(int(y_max), int(y_min) + g * rows_per)
            y1 = min(int(y_max), y0 + rows_per)
            lh = torch.full((K, rows_per, SW), -FLT_MAX, dtype=torch.float32, device=mesh.root)
            idx = torch.full((K, rows_per, SW), -1, dtype=torch.int32, device=mesh.root)
            if y1 > y0:
                kw = dict(x_min=x_min, x_max=x_max, y_min=y0, y_max=y1, k_results=K, **gates)
                got = _shard_search(replicas.on(dev), dxs, dys, dev, kw, min_obs, min_lh, has_masked)
                lh[:, : y1 - y0] = got[0].to(mesh.root)
                idx[:, : y1 - y0] = got[1].to(mesh.root)
            lhs.append(lh)
            idxs.append(idx)
        lh = _gather_processes(torch.cat(lhs, 1), mesh, 1)[:, :SH]
        idx = _gather_processes(torch.cat(idxs, 1), mesh, 1)[:, :SH]
        return lh.contiguous(), idx.contiguous()
    raise ValueError(f"Unknown shard_mode {shard_mode}")


def sharded_sigmag_exact_topk(
    psi, phi, valid, dxs, dys, mesh, *, x_min, x_max, y_min, y_max, k_results,
    min_obs=0.0, min_lh=0.0, sigmag_coeff=-1.0, sgl_L=0.25, sgl_H=0.75,
    row_tile=search_ops.EXACT_ROW_TILE, replicas=None,
):
    """The exact sigma-G search (``ops.search.search_topk_sigmag_exact``,
    plain PyTorch) sharded over candidates: each shard scores its slice
    with global indices on its device, then the maps merge. Clipped gating
    is per candidate, so the result equals the single-device search.
    psi, phi, valid are float planes."""
    dxs = np.asarray(dxs, dtype=np.int32)
    dys = np.asarray(dys, dtype=np.int32)
    C = dxs.shape[0]
    c_local = math.ceil(C / mesh.size)
    replicas = replicas or _Replicas(psi, phi, valid)
    parts = []
    for g, dev in mesh.local_shards():
        lo, hi = min(C, g * c_local), min(C, (g + 1) * c_local)
        parts.append(search_ops.search_topk_sigmag_exact(
            *replicas.on(dev), torch.as_tensor(dxs[lo:hi], device=dev), torch.as_tensor(dys[lo:hi], device=dev),
            min_obs, min_lh, sigmag_coeff, x_min=x_min, x_max=x_max, y_min=y_min, y_max=y_max,
            k_results=k_results, sgl_L=sgl_L, sgl_H=sgl_H, row_tile=row_tile, cand_offset=lo,
        ))
    return _local_merge(parts, mesh, k_results)


def sharded_psi_phi_build(sci, var, psf, mesh):
    """psi/phi of a (T, H, W) stack with one PSF, the time axis split over
    the shards, each running K1 (the twin on the CPU) on its device.
    Returns the zero-filled float32 (psi, phi) and the uint8 validity plane
    (both finite) on the mesh's root device, equal to a one-shard build."""
    sci = torch.as_tensor(np.asarray(sci, dtype=np.float32))
    var = torch.as_tensor(np.asarray(var, dtype=np.float32))
    psf = torch.as_tensor(np.asarray(psf, dtype=np.float32))
    T, H, W = sci.shape
    t_per = math.ceil(T / mesh.size)
    psis, phis = [], []
    for g, dev in mesh.local_shards():
        t0, t1 = min(T, g * t_per), min(T, (g + 1) * t_per)
        psi = torch.full((t_per, H, W), float("nan"), dtype=torch.float32, device=mesh.root)
        phi = torch.full_like(psi, float("nan"))
        if t1 > t0:
            p, f = psi_phi_conv(sci[t0:t1].to(dev), var[t0:t1].to(dev), psf.to(dev))
            psi[: t1 - t0] = p.to(mesh.root)
            phi[: t1 - t0] = f.to(mesh.root)
        psis.append(psi)
        phis.append(phi)
    psi = _gather_processes(torch.cat(psis), mesh)[:T]
    phi = _gather_processes(torch.cat(phis), mesh)[:T]
    ok = torch.isfinite(psi) & torch.isfinite(phi)
    zero = torch.zeros((), dtype=torch.float32, device=mesh.root)
    return torch.where(ok, psi, zero), torch.where(ok, phi, zero), ok.to(torch.uint8)


def _sharded_gather_curves(psi, phi, valid, xs, ys, dxs, dys, mesh, replicas):
    """Mesh-sharded drop-in of ``ops.search._gather_curves``: the N rows are
    split over the shards, each gathers its rows on its device, and the
    curves come back to psi's device in row order. A gather has no
    reduction, so the curves equal a one-device gather's."""
    N = xs.shape[0]
    rows_per = max(1, math.ceil(N / mesh.size))
    T = psi.shape[0]
    home = psi.device
    outs = []
    for g, dev in mesh.local_shards():
        lo, hi = min(N, g * rows_per), min(N, (g + 1) * rows_per)
        pv = torch.zeros((rows_per, T), dtype=torch.float32, device=home)
        fv = torch.zeros_like(pv)
        ok = torch.zeros((rows_per, T), dtype=torch.bool, device=home)
        if hi > lo:
            got = search_ops._gather_curves(
                *replicas.on(dev), xs[lo:hi].to(dev), ys[lo:hi].to(dev), dxs[lo:hi].to(dev), dys[lo:hi].to(dev))
            pv[: hi - lo], fv[: hi - lo], ok[: hi - lo] = (a.to(home) for a in got)
        outs.append((pv, fv, ok))
    return tuple(_gather_processes(torch.cat([o[i] for o in outs]), mesh).to(home)[:N] for i in range(3))


def make_sharded_evaluators(mesh):
    """The winner re-scoring gather that ``assemble_core_results`` and
    ``exact_refine_pixels`` take (their ``gather``), sharded over the mesh:
    the port's form of the JAX package's (curves_fn, eval_fn) pair, whose
    sums stay on one device so that they equal a one-device re-scoring.
    The planes are copied to each device once, for the planes it is first
    called with."""
    held = {}

    def gather(psi, phi, valid, xs, ys, dxs, dys):
        if held.get("src") is not psi:
            held["src"], held["replicas"] = psi, _Replicas(psi, phi, valid)
        return _sharded_gather_curves(psi, phi, valid, xs, ys, dxs, dys, mesh, held["replicas"])

    return gather


def sharded_core_search(
    psi, phi, valid, times, vxs, vys, mesh, *, x_min, x_max, y_min, y_max, results_per_pixel,
    min_obs=0, min_lh=0.0, do_sigmag=False, sgl_L=0.25, sgl_H=0.75, sigmag_coeff=-1.0,
    gate_min_obs=True, gate_min_lh=None, compact_min_lh=None, shard_mode="candidates", timings=None,
):
    """Sharded ``ops.search.core_search``: the same pixel-major result dict.

    The top-K maps come from :func:`sharded_search_topk`, or under
    ``KB_SIGMAG_MODE=exact`` from :func:`sharded_sigmag_exact_topk` (on
    decoded planes for a quantized stack); with ``do_sigmag`` each shard
    keeps its own over-provisioned pool, so the merged pool is the
    single-device pool and the re-rank and refinement are those of
    ``core_search``. The winners' re-scoring gathers run sharded
    (:func:`make_sharded_evaluators`)."""
    replicas = _Replicas(psi, phi, valid)

    def topk_fn(psi_, phi_, valid_, dxs, dys, *, sigmag_mode, min_obs, min_lh, sgl_L, sgl_H, sigmag_coeff,
                has_masked, **bounds):
        if sigmag_mode == "exact":
            planes, exact = search_ops.exact_inputs(psi_, phi_, valid_, bounds)
            return sharded_sigmag_exact_topk(
                *planes, dxs, dys, mesh, min_obs=min_obs, min_lh=min_lh, sigmag_coeff=sigmag_coeff,
                sgl_L=sgl_L, sgl_H=sgl_H, **exact,
            )
        return sharded_search_topk(
            psi_, phi_, valid_, dxs, dys, mesh, min_obs=min_obs, min_lh=min_lh, shard_mode=shard_mode,
            has_masked=has_masked, replicas=replicas, **bounds,
        )

    return search_ops.core_search(
        psi, phi, valid, times, vxs, vys, x_min, x_max, y_min, y_max, results_per_pixel,
        min_obs=min_obs, min_lh=min_lh, do_sigmag=do_sigmag, sgl_L=sgl_L, sgl_H=sgl_H, sigmag_coeff=sigmag_coeff,
        gate_min_obs=gate_min_obs, gate_min_lh=gate_min_lh, compact_min_lh=compact_min_lh, timings=timings,
        topk_fn=topk_fn, gather=make_sharded_evaluators(mesh),
    )


__all__ = [
    "Mesh", "build_mesh", "search_mesh", "sharded_search_topk", "sharded_sigmag_exact_topk", "sharded_psi_phi_build",
    "make_sharded_evaluators", "sharded_core_search",
]
