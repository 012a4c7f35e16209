"""The core search: offsets, winner re-scoring, sigma-G and assembly.

Port of the JAX package's ops/search.py. Starting pixels are integers, so
``floor(x + v*t + 0.5) == x + floor(v*t + 0.5)``: each (candidate, time)
pair shifts the whole image by one integer offset, which the host
precomputes in float64 (the reference's kernels.cu:33-35). The top-K search
itself is kernel K2 (ops/search_kernel.py) on float planes, or the encoded
dispatcher (ops/search_encoded.py: kernels K3, K4 and K5) on quantized code
planes. The gathers that re-score the winners run as plain PyTorch on the
search's device, over the code planes for a quantized stack; the sigma-G
clipping and the pixel-major assembly run in numpy on the host, as in the
JAX package.

With the in-kernel sigma-G filter the search keeps an over-provisioned pool
by unclipped lh (``KB_SIGMAG_TOPK_FACTOR`` times K) and re-ranks it by
clipped lh, refining the pixels whose membership the re-rank changed
(unless ``KB_SIGMAG_AUTO=0``); ``KB_SIGMAG_MODE=exact`` instead scores
every candidate by its clipped lh (:func:`search_topk_sigmag_exact`, plain
PyTorch on the search's device, as the JAX package runs it in XLA).
"""

import logging
import os
import time
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from kbmod_tpu_torch.ops.psi_phi import _f32, _storage
from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
from kbmod_tpu_torch.ops.search_kernel import search_topk

logger = logging.getLogger("kbmod.search")

FLT_MAX = float(np.finfo(np.float32).max)
# Default over-provisioning of the sigma-G pool: search the top
# SIGMAG_POOL_FACTOR * K by unclipped lh, then re-rank by clipped lh.
SIGMAG_POOL_FACTOR = 4
# Rows per winner re-scoring gather.
EVAL_CHUNK = 524288
# The exact sigma-G search: start-pixel rows a tile, and the (candidate,
# pixel, time) samples whose curves one step gathers and sorts at most
# (more only when one candidate's tile holds more).
EXACT_ROW_TILE = 256
EXACT_CHUNK_SAMPLES = 1 << 25
# Device bytes one such sample holds at most: the int64 index, the masks,
# the gathered float32 values and their sort (values, int64 order, the
# sorted psi/phi and the kept products).
EXACT_BYTES_PER_SAMPLE = 96


def sigmag_pool_factor():
    """The sigma-G pool's over-provisioning factor: ``KB_SIGMAG_TOPK_FACTOR``
    when set, else SIGMAG_POOL_FACTOR."""
    return int(os.environ.get("KB_SIGMAG_TOPK_FACTOR", str(SIGMAG_POOL_FACTOR)))


# ----------------------------------------------------------------------
# Host-side offset precomputation
# ----------------------------------------------------------------------

def snap_vy_rows(vys, zeroed_times, max_row_error=0.75):
    """Quantize vy onto a lattice so that the rounded per-time row sequences
    ``floor(vy*t + 0.5)`` collapse into few classes, with a bounded row
    error: vy snaps to multiples of ``q = 2*max_row_error/t_max``, so every
    candidate's row moves at most ``max_row_error`` px at the last
    observation. Column offsets (vx) are untouched. The snapped vy is the
    searched and reported velocity (``KB_SNAP_ROW_ERROR`` in
    ``StackSearch.search_all``).

    Returns
    -------
    (snapped, num_classes) : (np.ndarray float32 of vy, int)
    """
    vys = np.asarray(vys, dtype=np.float64)
    t_max = float(np.max(zeroed_times)) if len(np.asarray(zeroed_times)) else 0.0
    if t_max <= 0.0 or max_row_error <= 0.0:
        return vys.astype(np.float32), len(np.unique(vys.astype(np.float32)))
    q = 2.0 * float(max_row_error) / t_max
    snapped = (np.round(vys / q) * q).astype(np.float32)
    return snapped, len(np.unique(snapped))


def trajectory_offsets(vxs, vys, times):
    """Integer pixel offsets floor(v * t + 0.5) for each (candidate, time).

    Computed in float64 after rounding velocities to float32 (the reference
    stores Trajectory velocities as C floats; common.h:57-58).

    Returns
    -------
    (dxs, dys) : np.ndarray int32 of shape (C, T)
    """
    vxs = np.asarray(vxs, dtype=np.float32).astype(np.float64)
    vys = np.asarray(vys, dtype=np.float32).astype(np.float64)
    times = np.asarray(times, dtype=np.float64)
    dxs = np.floor(vxs[:, None] * times[None, :] + 0.5).astype(np.int32)
    dys = np.floor(vys[:, None] * times[None, :] + 0.5).astype(np.int32)
    return dxs, dys


def predict_index(pos0, vel0, time):
    """Reference-parity predicted pixel index (kernels.cu:33-35)."""
    return int(np.floor(np.float64(pos0) + np.float64(np.float32(vel0)) * np.float64(time) + 0.5))


# ----------------------------------------------------------------------
# Gather-based exact evaluation (curves, single-trajectory evaluation and
# re-scoring of search winners)
# ----------------------------------------------------------------------

class EncodedPlanes(NamedTuple):
    """Quantized psi/phi code planes and their decode vector, accepted by
    the search and the gathers in place of decoded float planes (port of
    the JAX package's ops/search.py:119-153).

    Gathering the codes and decoding each sample keeps the evaluation at
    the codes' footprint: the decoded float planes, about 4.5x (uint8) the
    codes, are never built. ``em`` is [psi_min, psi_scale, phi_min,
    phi_scale] as float32; a value decodes to (code - 1) * scale + min, code
    0 being masked. ``pairs`` is the interleaved (T, H, Wp, 2) layout the
    search kernels read (``PsiPhiArray.code_pairs``), of which the code
    planes may be views; None builds it when a kernel needs it.
    """

    psi_codes: torch.Tensor  # (T, H, W) uint8 or uint16
    phi_codes: torch.Tensor  # (T, H, W) same dtype
    em: np.ndarray           # (4,) float32
    pairs: torch.Tensor = None

    @property
    def shape(self):
        return tuple(self.psi_codes.shape)

    @property
    def device(self):
        return self.psi_codes.device

    def decode_full(self):
        """The decoded (psi, phi, valid) planes: float32 zero-filled where
        masked and a uint8 validity plane (valid where the psi code is
        non-zero; phi is 0 where its own code is). About 4.5x the uint8
        codes' memory; only the exact sigma-G search needs whole planes."""
        dev = self.device
        em = np.asarray(self.em, dtype=np.float32)
        pc = _storage(self.psi_codes).to(torch.int32)
        fc = _storage(self.phi_codes).to(torch.int32)
        if self.psi_codes.dtype == torch.uint16:
            pc, fc = pc & 0xFFFF, fc & 0xFFFF
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        psi = torch.where(pc == 0, zero, (pc.to(torch.float32) - 1.0) * _f32(em[1], dev) + _f32(em[0], dev))
        phi = torch.where(fc == 0, zero, (fc.to(torch.float32) - 1.0) * _f32(em[3], dev) + _f32(em[2], dev))
        return psi, phi, (pc != 0).to(torch.uint8)


def _gather_codes(codes, tt, py, px):
    """int32 codes of a (T, H, W) code tensor at (tt, py, px), indexed
    through its strides (the planes may be views into the code pairs)."""
    g = _storage(codes)[tt, py, px].to(torch.int32)
    return g & 0xFFFF if codes.dtype == torch.uint16 else g


def _gather_curves(psi, phi, valid, xs, ys, dxs, dys):
    """Gather per-time psi/phi values along trajectories.

    psi, phi: (T, H, W) float32 zero-filled at masked; valid: (T, H, W)
    uint8. Alternatively psi may be an :class:`EncodedPlanes` (phi and
    valid are then ignored): the codes are gathered and decoded per sample,
    with the JAX package's rules (ops/search.py:196-208): a sample is valid
    where its psi code is non-zero, and its phi value is 0 where the phi
    code is 0. xs, ys: (N,) int tensors of starting pixels; dxs, dys: (N, T)
    int tensors of offsets, all on psi's device.

    Returns psi_v, phi_v: (N, T) float32 (0 where invalid) and ok: (N, T)
    bool.
    """
    T, H, W = psi.shape
    dev = psi.device
    px = xs[:, None].to(torch.int64) + dxs
    py = ys[:, None].to(torch.int64) + dys
    inb = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    pxc = px.clamp(0, W - 1)
    pyc = py.clamp(0, H - 1)
    tt = torch.arange(T, dtype=torch.int64, device=dev)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if isinstance(psi, EncodedPlanes):
        em = np.asarray(psi.em, dtype=np.float32)
        pc = _gather_codes(psi.psi_codes, tt, pyc, pxc)
        fc = _gather_codes(psi.phi_codes, tt, pyc, pxc)
        ok = inb & (pc != 0)
        psi_v = torch.where(ok, (pc.to(torch.float32) - 1.0) * _f32(em[1], dev) + _f32(em[0], dev), zero)
        phi_v = torch.where(ok & (fc != 0), (fc.to(torch.float32) - 1.0) * _f32(em[3], dev) + _f32(em[2], dev), zero)
        return psi_v, phi_v, ok
    flat_idx = (tt * H + pyc) * W + pxc
    ok = inb & (valid.reshape(-1)[flat_idx] > 0)
    psi_v = torch.where(ok, psi.reshape(-1)[flat_idx], zero)
    phi_v = torch.where(ok, phi.reshape(-1)[flat_idx], zero)
    return psi_v, phi_v, ok


def _gather_curves_idx(psi, phi, valid, xs, ys, cidx, dxs_tab, dys_tab, gather=_gather_curves):
    """``gather`` (:func:`_gather_curves` or a drop-in with its signature)
    with per-row offsets looked up on the device from the (C, T) offset
    tables by the rows' candidate indices."""
    return gather(psi, phi, valid, xs, ys, dxs_tab[cidx], dys_tab[cidx])


def _stats_from_sums(psi_sum, phi_sum, obs):
    """lh and flux from per-row sums, on the host (numpy float32)."""
    good = phi_sum > 0
    lh = np.where(good, psi_sum / np.sqrt(phi_sum, where=good, out=np.ones_like(phi_sum)), -1.0)
    flux = np.where(good, psi_sum / np.where(good, phi_sum, 1.0), -1.0)
    return {"psi_sum": psi_sum, "phi_sum": phi_sum, "obs_count": obs, "lh": lh, "flux": flux}


def _eval_chunks(xs, ys, chunk, want_curves, T, gather):
    """Chunk loop shared by the evaluations. ``gather(lo, hi, xs, ys)``
    returns the (psi_v, phi_v, ok) device curves of rows [lo, hi), given
    those rows' starting pixels (numpy int32). Returns the stats dict, plus
    the (N, T) psi/phi/ok curves when ``want_curves``."""
    xs = np.asarray(xs, dtype=np.int32)
    ys = np.asarray(ys, dtype=np.int32)
    n = len(xs)
    out = {k: np.zeros(n, dtype=np.float32) for k in ("psi_sum", "phi_sum", "lh", "flux")}
    out["obs_count"] = np.zeros(n, dtype=np.int32)
    if want_curves:
        curves = [np.zeros((n, T), dtype=np.float32) for _ in range(3)]
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        psi_v, phi_v, ok = gather(lo, hi, xs[lo:hi], ys[lo:hi])
        stats = _stats_from_sums(
            psi_v.sum(dim=1).cpu().numpy(),
            phi_v.sum(dim=1).cpu().numpy(),
            ok.sum(dim=1, dtype=torch.int32).cpu().numpy(),
        )
        for key, val in stats.items():
            out[key][lo:hi] = val
        if want_curves:
            curves[0][lo:hi] = psi_v.cpu().numpy()
            curves[1][lo:hi] = phi_v.cpu().numpy()
            curves[2][lo:hi] = ok.cpu().numpy()
    if want_curves:
        return curves[0], curves[1], curves[2], out
    return out


def _by_velocity(psi, phi, valid, times, vxs, vys, gather=_gather_curves):
    """A gather for :func:`_eval_chunks` whose rows carry velocities."""
    dev = psi.device
    vxs = np.asarray(vxs, dtype=np.float32)
    vys = np.asarray(vys, dtype=np.float32)

    def rows(lo, hi, xs, ys):
        dxs, dys = trajectory_offsets(vxs[lo:hi], vys[lo:hi], times)
        return gather(
            psi, phi, valid, torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev),
            torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev),
        )

    return rows


def evaluate_trajectories(psi, phi, valid, times, xs, ys, vxs, vys, chunk=EVAL_CHUNK):
    """Exact evaluation of a list of trajectories (reference semantics of
    evaluateTrajectory without sigma-G; kernels.cu:154-197).

    Returns a dict of numpy arrays: psi_sum, phi_sum, obs_count, lh, flux.
    """
    rows = _by_velocity(psi, phi, valid, times, vxs, vys)
    return _eval_chunks(xs, ys, chunk, False, len(np.asarray(times)), rows)


def _curves_and_stats(psi, phi, valid, times, xs, ys, vxs, vys, chunk=EVAL_CHUNK, gather=_gather_curves):
    """One chunked gather serving both the trajectory statistics and the
    per-time curves + validity that the sigma-G re-scoring needs.
    Returns (psi_curves, phi_curves, ok_curves, stats)."""
    rows = _by_velocity(psi, phi, valid, times, vxs, vys, gather)
    return _eval_chunks(xs, ys, chunk, True, len(np.asarray(times)), rows)


def _eval_by_index_chunked(psi, phi, valid, xs, ys, cidx, dxs_tab, dys_tab, chunk, want_curves, T,
                           gather=_gather_curves):
    """Winner re-scoring by candidate index: the (C, T) offset tables live
    on the device and each chunk looks its rows up there."""
    dev = psi.device
    cidx = torch.as_tensor(np.asarray(cidx, dtype=np.int64), device=dev)

    def rows(lo, hi, xs_c, ys_c):
        return _gather_curves_idx(
            psi, phi, valid, torch.as_tensor(xs_c, device=dev), torch.as_tensor(ys_c, device=dev),
            cidx[lo:hi], dxs_tab, dys_tab, gather,
        )

    return _eval_chunks(xs, ys, chunk, want_curves, T, rows)


def extract_psi_phi_curves(psi, phi, valid, times, xs, ys, vxs, vys):
    """Per-time psi/phi curves with 0.0 at invalid samples, matching
    extract_joint_psi_phi_curve (stack_search.cpp:14-31).

    Returns (psi_curves, phi_curves): numpy (N, T) float32.
    """
    dev = psi.device
    dxs, dys = trajectory_offsets(vxs, vys, times)
    psi_v, phi_v, _ = _gather_curves(
        psi, phi, valid,
        torch.as_tensor(np.asarray(xs, dtype=np.int32), device=dev),
        torch.as_tensor(np.asarray(ys, dtype=np.int32), device=dev),
        torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev),
    )
    return psi_v.cpu().numpy(), phi_v.cpu().numpy()


# ----------------------------------------------------------------------
# Sigma-G clipped re-scoring (parity with the in-kernel GPU filter)
# ----------------------------------------------------------------------

def sigmag_bounds_indices(num_values, sgl0, sgl1):
    """The reference's nonstandard percentile indexing
    (SigmaGFilteredIndicesCU, kernels.cu:93-127): index of percentile q in a
    sorted array of n values is clamp(int(ceil(n*q) + 0.001) - 1, 0, n-1)."""
    sgl0 = max(sgl0, 0.0001)
    sgl1 = min(sgl1, 0.9999)

    def pct(q):
        idx = int(np.ceil(num_values * q) + 0.001) - 1
        return min(max(idx, 0), num_values - 1)

    return pct(sgl0), pct(0.5), pct(sgl1)


def clipped_sigmag_scores(psi_v, phi_v, ok, sgl_L, sgl_H, coeff, width=2.0):
    """Recompute (lh, flux) after the reference's in-kernel sigma-G clipping
    (kernels.cu:213-241), vectorized over N trajectories on the host.

    psi_v, phi_v: (N, T) per-time values, ok: (N, T) validity. The light
    curve is psi/phi over the valid samples, in time order; clipping keeps
    the sorted values within [median - width*sigma_g, median +
    width*sigma_g] with the reference's scan-from-median rules.

    Returns (new_lh, new_flux, new_psi_sum, new_phi_sum) as numpy arrays.
    """
    psi_v = np.asarray(psi_v, dtype=np.float32)
    phi_v = np.asarray(phi_v, dtype=np.float32)
    ok = np.asarray(ok, dtype=bool)
    N, T = psi_v.shape

    n = ok.sum(axis=1)
    lc = np.where(ok & (phi_v != 0), psi_v / np.where(phi_v != 0, phi_v, 1.0), np.where(ok, 0.0, np.inf))
    order = np.argsort(lc, axis=1, kind="stable")  # valid entries first (inf last)
    vals = np.take_along_axis(lc, order, axis=1)
    psi_sorted = np.take_along_axis(np.where(ok, psi_v, 0.0), order, axis=1)
    phi_sorted = np.take_along_axis(np.where(ok, phi_v, 0.0), order, axis=1)

    sgl_L_c = max(sgl_L, 0.0001)
    sgl_H_c = min(sgl_H, 0.9999)

    def pct_idx(q):
        # The reference's indexing: int(ceil(n*q) + 0.001) - 1, the epsilon
        # outside the ceil.
        idx = np.floor(np.ceil(n * q) + 0.001).astype(int) - 1
        return np.clip(idx, 0, np.maximum(n - 1, 0))

    iL = pct_idx(sgl_L_c)
    iM = pct_idx(0.5)
    iH = pct_idx(sgl_H_c)
    rows = np.arange(N)
    safe = n > 0
    vL = vals[rows, iL]
    vM = vals[rows, iM]
    vH = vals[rows, iH]
    sigma_g = coeff * (vH - vL)
    min_value = vM - width * sigma_g
    max_value = vM + width * sigma_g

    # start = first index in [0, iM) with vals >= min_value (else iM).
    cols = np.arange(T)[None, :]
    start = np.minimum((vals < min_value[:, None]).sum(axis=1), iM)
    # end = first index > iM with vals > max_value (else n).
    gt_max = (vals > max_value[:, None]) & (cols > iM[:, None])
    end = np.where(gt_max.any(axis=1), gt_max.argmax(axis=1), np.minimum(n, T))
    end = np.minimum(end, n)

    keep = (cols >= start[:, None]) & (cols < end[:, None])
    new_psi = np.where(safe, (psi_sorted * keep).sum(axis=1, dtype=np.float32), 0.0)
    new_phi = np.where(safe, (phi_sorted * keep).sum(axis=1, dtype=np.float32), 0.0)

    good = new_phi > 0
    new_lh = np.where(good, new_psi / np.sqrt(np.where(good, new_phi, 1.0)), -1.0).astype(np.float32)
    new_flux = np.where(good, new_psi / np.where(good, new_phi, 1.0), -1.0).astype(np.float32)
    return new_lh, new_flux, new_psi.astype(np.float32), new_phi.astype(np.float32)


def _sqrt_rn(x):
    """float32 sqrt correctly rounded on any device: through float64 (exact
    once rounded back), since PyTorch's vectorized float32 sqrt on the CPU
    is not always correctly rounded."""
    return torch.sqrt(x.double()).float()


def _clipped_scores(psi_v, phi_v, ok, sgl_L, sgl_H, coeff, width=2.0):
    """Torch counterpart of :func:`clipped_sigmag_scores` (the JAX package's
    ``_clipped_scores_jnp``), on the device of its inputs: (N, T) float32
    curves and their (N, T) bool validity in, (new_lh, new_flux) float32
    (N,) out.

    The same stable sort of the psi/phi ratios (masked samples last, as
    +inf), the same percentile indices (in float64, as numpy computes them)
    and the same keep window, so the kept samples are those of the host
    function; the kept sums are float32 sums in PyTorch's order.
    """
    N, T = psi_v.shape
    dev = psi_v.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    n = ok.sum(dim=1)
    nz = phi_v != 0
    lc = torch.where(ok & nz, psi_v / torch.where(nz, phi_v, one), torch.where(ok, zero, inf))
    vals, order = torch.sort(lc, dim=1, stable=True)
    psi_sorted = torch.gather(torch.where(ok, psi_v, zero), 1, order)
    phi_sorted = torch.gather(torch.where(ok, phi_v, zero), 1, order)

    nf = n.to(torch.float64)
    top = torch.clamp(n - 1, min=0)

    def pct_idx(q):
        # The reference's indexing: int(ceil(n*q) + 0.001) - 1.
        idx = torch.floor(torch.ceil(nf * q) + 0.001).to(torch.int64) - 1
        return torch.minimum(torch.clamp(idx, min=0), top)

    iL = pct_idx(max(float(sgl_L), 0.0001))
    iM = pct_idx(0.5)
    iH = pct_idx(min(float(sgl_H), 0.9999))
    vL, vM, vH = (vals.gather(1, i[:, None])[:, 0] for i in (iL, iM, iH))
    sigma_g = _f32(coeff, dev) * (vH - vL)
    reach = _f32(width, dev) * sigma_g
    min_value = vM - reach
    max_value = vM + reach

    cols = torch.arange(T, device=dev)[None, :]
    start = torch.minimum((vals < min_value[:, None]).sum(dim=1), iM)
    gt_max = (vals > max_value[:, None]) & (cols > iM[:, None])
    end = torch.where(gt_max.any(dim=1), gt_max.to(torch.uint8).argmax(dim=1), torch.clamp(n, max=T))
    end = torch.minimum(end, n)
    keep = (cols >= start[:, None]) & (cols < end[:, None])
    safe = n > 0
    new_psi = torch.where(safe, torch.where(keep, psi_sorted, zero).sum(dim=1), zero)
    new_phi = torch.where(safe, torch.where(keep, phi_sorted, zero).sum(dim=1), zero)
    good = new_phi > 0
    safe_phi = torch.where(good, new_phi, one)
    new_lh = torch.where(good, new_psi / _sqrt_rn(safe_phi), -one)
    new_flux = torch.where(good, new_psi / safe_phi, -one)
    return new_lh, new_flux


def _exact_curves(psi, phi, valid, dxs, dys, x_min, x_max, y0, y1):
    """The (Cc * N, T) psi/phi curves (0 where invalid) and validity of Cc
    candidates ((Cc, T) int64 offsets) at the N = (y1 - y0) * (x_max -
    x_min) start pixels of a row tile, candidate-major then pixel-major."""
    T, H, W = psi.shape
    dev = psi.device
    ys = torch.arange(y0, y1, device=dev)
    xs = torch.arange(x_min, x_max, device=dev)
    tt = torch.arange(T, device=dev)
    py = ys[None, :, None, None] + dys[:, None, None, :]  # (Cc, SHt, 1, T)
    px = xs[None, None, :, None] + dxs[:, None, None, :]  # (Cc, 1, SW, T)
    inb = (py >= 0) & (py < H) & (px >= 0) & (px < W)
    flat = (tt * H + py.clamp(0, H - 1)) * W + px.clamp(0, W - 1)
    ok = inb & (valid.reshape(-1)[flat] > 0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    psi_v = torch.where(ok, psi.reshape(-1)[flat], zero)
    phi_v = torch.where(ok, phi.reshape(-1)[flat], zero)
    return psi_v.reshape(-1, T), phi_v.reshape(-1, T), ok.reshape(-1, T)


def search_topk_sigmag_exact(
    psi, phi, valid, dxs, dys, min_obs, min_lh, sigmag_coeff,
    *, x_min, x_max, y_min, y_max, k_results, sgl_L, sgl_H,
    row_tile=EXACT_ROW_TILE, cand_offset=0,
):
    """Exact sigma-G top-K over the search window (port of the JAX
    package's ``search_topk_sigmag_exact`` and ``_sigmag_exact_tile``):
    every candidate is scored by its CLIPPED lh at every start pixel.

    Pre-gates (kernels.cu:201-203): obs >= min_obs, obs > 0 and unclipped
    lh >= min_lh; insertion is gated on the clipped lh >= min_lh
    (kernels.cu:318-330). Each pixel keeps the top ``k_results`` by (clipped
    lh desc, candidate index asc). The window is searched in tiles of
    ``row_tile`` start-pixel rows, candidates in chunks whose curves hold
    about EXACT_CHUNK_SAMPLES samples; a chunk's curves are gathered and
    sorted along T, and merged into the tile's lists by a stable sort.

    psi, phi (T, H, W) float32 zero-filled and valid (T, H, W) uint8 on the
    search's device; dxs, dys (C, T) integer offsets. Returns (K, SH, SW)
    float32 lh (-FLT_MAX where empty) and int32 candidate indices (-1), on
    the planes' device. Plain PyTorch: the reference runs this in XLA.
    """
    T = psi.shape[0]
    dev = psi.device
    dxs = torch.as_tensor(dxs, device=dev).to(torch.int64)
    dys = torch.as_tensor(dys, device=dev).to(torch.int64)
    C = dxs.shape[0]
    K = int(k_results)
    SH, SW = int(y_max) - int(y_min), int(x_max) - int(x_min)
    out_lh = torch.full((K, SH, SW), -FLT_MAX, dtype=torch.float32, device=dev)
    out_idx = torch.full((K, SH, SW), -1, dtype=torch.int32, device=dev)
    neg = torch.full((), -FLT_MAX, dtype=torch.float32, device=dev)
    none = torch.full((), -1, dtype=torch.int32, device=dev)
    min_lh_t = _f32(min_lh, dev)
    for y0 in range(int(y_min), int(y_max), int(row_tile)):
        y1 = min(int(y_max), y0 + int(row_tile))
        N = (y1 - y0) * SW
        top_lh = torch.full((K, N), -FLT_MAX, dtype=torch.float32, device=dev)
        top_idx = torch.full((K, N), -1, dtype=torch.int32, device=dev)
        step = max(1, EXACT_CHUNK_SAMPLES // (N * T))
        for c0 in range(0, C, step):
            c1 = min(C, c0 + step)
            psi_v, phi_v, ok = _exact_curves(psi, phi, valid, dxs[c0:c1], dys[c0:c1], int(x_min), int(x_max), y0, y1)
            psi_sum = psi_v.sum(dim=1)
            phi_sum = phi_v.sum(dim=1)
            obs = ok.sum(dim=1)
            unclipped = torch.where(
                phi_sum > 0, psi_sum / _sqrt_rn(torch.clamp(phi_sum, min=1e-30)), -torch.ones_like(psi_sum)
            )
            clipped, _ = _clipped_scores(psi_v, phi_v, ok, sgl_L, sgl_H, sigmag_coeff)
            del psi_v, phi_v, ok
            ins = (obs >= min_obs) & (obs > 0) & (unclipped >= min_lh_t) & (clipped >= min_lh_t)
            cidx = (torch.arange(c0, c1, dtype=torch.int32, device=dev) + int(cand_offset))[:, None]
            new_lh = torch.where(ins, clipped, neg).reshape(c1 - c0, N)
            new_idx = torch.where(ins.reshape(c1 - c0, N), cidx, none)
            # The kept list first, then the chunk in index order: a stable
            # sort keeps equal lh in candidate order.
            merged_lh, order = torch.sort(torch.cat([top_lh, new_lh]), dim=0, descending=True, stable=True)
            top_lh = merged_lh[:K]
            top_idx = torch.cat([top_idx, new_idx]).gather(0, order[:K])
        out_lh[:, y0 - int(y_min) : y1 - int(y_min)] = top_lh.reshape(K, y1 - y0, SW)
        out_idx[:, y0 - int(y_min) : y1 - int(y_min)] = top_idx.reshape(K, y1 - y0, SW)
    return out_lh, out_idx


def sigmag_filtered_indices(values, sgl0, sgl1, sigmag_coeff, width):
    """The kept original indices after sigma-G filtering one value array
    (kernel_helpers.cpp:86-106)."""
    values = np.asarray(values, dtype=np.float32)
    n = len(values)
    if n == 0:
        return np.array([], dtype=int)
    order = np.argsort(values, kind="stable")
    vals = values[order]
    iL, iM, iH = sigmag_bounds_indices(n, sgl0, sgl1)
    sigma_g = sigmag_coeff * (vals[iH] - vals[iL])
    min_value = vals[iM] - width * sigma_g
    max_value = vals[iM] + width * sigma_g
    start = 0
    while start < iM and vals[start] < min_value:
        start += 1
    end = iM + 1
    while end < n and vals[end] <= max_value:
        end += 1
    return np.sort(order[start:end])


def merge_topk(top_lh, top_idx, k_results):
    """Merge stacked per-shard top-K maps (M, SH, SW) into the global top-K
    (port of the JAX package's ops/search.py:896): a per-pixel stable sort
    by descending lh, so equal lh keep their shard order. Shards hold
    ascending candidate ranges and each ranks its ties by ascending index,
    so the merged maps rank by (lh desc, index asc) and equal a search of
    every candidate at once slot for slot."""
    k = int(k_results)
    lh, order = torch.sort(top_lh, dim=0, descending=True, stable=True)
    return lh[:k].contiguous(), top_idx.gather(0, order[:k]).contiguous()


# ----------------------------------------------------------------------
# Orchestration: full core search producing a struct-of-arrays result set
# ----------------------------------------------------------------------

def _fetch_topk(top_lh, top_idx):
    """Bring (K, SH, SW) top-K maps to the host as dense numpy arrays.

    Empty slots (idx == -1, lh == -FLT_MAX) usually dominate after gating,
    so on a card the filled slots are compacted there with torch.nonzero
    and only they cross to the host; the dense maps are rebuilt there.
    Exactly equivalent to a dense copy.
    """
    shape = tuple(top_lh.shape)
    total = top_lh.numel()
    if top_lh.device.type == "cpu":
        return top_lh.numpy(), top_idx.numpy()
    pos = torch.nonzero(top_idx.reshape(-1) >= 0).reshape(-1)
    if 4 * pos.numel() >= total:
        return top_lh.cpu().numpy(), top_idx.cpu().numpy()
    lh_np = np.full(total, -FLT_MAX, dtype=np.float32)
    idx_np = np.full(total, -1, dtype=np.int32)
    pos_np = pos.cpu().numpy()
    lh_np[pos_np] = top_lh.reshape(-1)[pos].cpu().numpy()
    idx_np[pos_np] = top_idx.reshape(-1)[pos].cpu().numpy()
    return lh_np.reshape(shape), idx_np.reshape(shape)


class _Timer:
    """Stage times in milliseconds into ``timings`` (a dict, or None for no
    timing). On a card each stage ends with a synchronize, so the times are
    wall times of finished device work."""

    def __init__(self, timings, device):
        self.timings = timings
        self.device = device
        self.t0 = time.perf_counter()

    def lap(self, name):
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[name] = (now - self.t0) * 1e3
        self.t0 = now


def exact_inputs(psi, phi, valid, bounds):
    """The exact sigma-G search's planes, whole (decoded for a quantized
    stack, as the reference does), and its window and K out of a search's
    ``bounds``."""
    planes = psi.decode_full() if isinstance(psi, EncodedPlanes) else (psi, phi, valid)
    return planes, {k: bounds[k] for k in ("x_min", "x_max", "y_min", "y_max", "k_results")}


def _local_topk(psi, phi, valid, dxs, dys, *, sigmag_mode, min_obs, min_lh, sgl_L, sgl_H, sigmag_coeff,
                has_masked, **bounds):
    """The one-device top-K maps of :func:`core_search`: the exact sigma-G
    search, the encoded dispatcher (K3-K5) or K2. dxs, dys are the (C, T)
    offsets as numpy; ``bounds`` the window, ``k_results`` and the gates."""
    dev = psi.device
    if sigmag_mode == "exact":
        # Every candidate scored and gated by its clipped lh.
        planes, exact = exact_inputs(psi, phi, valid, bounds)
        return search_topk_sigmag_exact(
            *planes, torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev), min_obs, min_lh,
            sigmag_coeff, sgl_L=sgl_L, sgl_H=sgl_H, **exact,
        )
    if isinstance(psi, EncodedPlanes):
        # The quantized stack: the codes go straight through the encoded
        # kernels, which need no validity plane (code 0 is masked).
        return search_topk_encoded(psi, dxs, dys, float(min_obs), float(min_lh), **bounds)
    return search_topk(
        psi, phi, valid, torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev), float(min_obs),
        float(min_lh), has_masked=has_masked, **bounds,
    )


def core_search(
    psi, phi, valid, times, vxs, vys, x_min, x_max, y_min, y_max, results_per_pixel,
    min_obs=0, min_lh=0.0, do_sigmag=False, sgl_L=0.25, sgl_H=0.75, sigmag_coeff=-1.0,
    gate_min_obs=True, gate_min_lh=None, compact_min_lh=None, timings=None, topk_fn=None, gather=None,
):
    """Run the full top-K search and assemble per-result statistics.

    psi, phi (T, H, W) float32 zero-filled, valid (T, H, W) uint8, all on
    the search's device; or psi an :class:`EncodedPlanes` (phi and valid
    None), which runs the encoded dispatcher (kernels K3-K5) and re-scores
    the winners over the code planes. ``gate_min_lh=None`` gates top-K
    insertion at min_lh only in sigma-G mode (kernels.cu:318-320).

    Returns a dict of numpy arrays (x, y, vx, vy, lh, flux, obs_count) laid
    out pixel-major with K entries per pixel (kernels.cu:286), empty slots
    carrying lh = -FLT_MAX.

    With ``do_sigmag`` the search keeps the top ``KB_SIGMAG_TOPK_FACTOR``
    (default 4) x K per pixel by UNCLIPPED lh and re-ranks that pool by the
    reference's clipped lh; pixels whose kept membership the re-rank
    changed are re-scored against every candidate
    (:func:`exact_refine_pixels`) unless ``KB_SIGMAG_AUTO=0``. With
    ``KB_SIGMAG_MODE=exact`` every candidate is scored by its clipped lh
    (:func:`search_topk_sigmag_exact`, on decoded planes for a quantized
    stack). ``timings`` (a dict) receives the stage times "search_ms" and
    "assemble_ms". ``topk_fn`` (with :func:`_local_topk`'s signature) and
    ``gather`` (:func:`_gather_curves`'s) replace the one-device maps and
    re-scoring gathers: ``parallel.sharded.sharded_core_search`` passes
    its mesh-sharded ones.
    """
    dev = psi.device
    timer = _Timer(timings, dev)
    SH, SW = y_max - y_min, x_max - x_min
    num_cand = len(vxs)
    k = int(results_per_pixel)
    if gate_min_lh is None:
        gate_min_lh = bool(do_sigmag)
    sigmag_mode = os.environ.get("KB_SIGMAG_MODE", "overprovision") if do_sigmag else ""
    over = sigmag_pool_factor()
    k_search = min(num_cand, over * k if (do_sigmag and sigmag_mode != "exact") else k)
    k_search = max(k_search, k)
    topk_fn = topk_fn or _local_topk
    gather = gather or _gather_curves

    dxs, dys = trajectory_offsets(vxs, vys, times)
    escalate = _SigmaGEscalation(do_sigmag, sigmag_mode, over, k, num_cand)
    has_masked = not isinstance(psi, EncodedPlanes) and sigmag_mode != "exact" and bool(torch.min(valid) == 0)
    top_lh, top_idx = topk_fn(
        psi, phi, valid, dxs, dys, sigmag_mode=sigmag_mode, min_obs=min_obs, min_lh=min_lh, sgl_L=sgl_L,
        sgl_H=sgl_H, sigmag_coeff=sigmag_coeff, has_masked=has_masked,
        x_min=int(x_min), x_max=int(x_max), y_min=int(y_min), y_max=int(y_max), k_results=int(k_search),
        gate_min_obs=gate_min_obs, gate_min_lh=bool(gate_min_lh),
    )
    timer.lap("search_ms")
    dxs_t = torch.as_tensor(dxs, device=dev)
    dys_t = torch.as_tensor(dys, device=dev)
    refine_fn = None
    if escalate.enabled:
        refine_fn = partial(
            exact_refine_pixels, psi=psi, phi=phi, valid=valid, times=times,
            vxs=vxs, vys=vys, k=k, min_obs=min_obs, min_lh=min_lh,
            sgl_L=sgl_L, sgl_H=sgl_H, sigmag_coeff=sigmag_coeff, gather=gather,
        )
    results, _ = assemble_core_results(
        top_lh, top_idx, psi, phi, valid, times, vxs, vys,
        k=k, k_search=k_search, x_min=x_min, y_min=y_min, SH=SH, SW=SW,
        min_obs=min_obs, min_lh=min_lh, do_sigmag=do_sigmag,
        sgl_L=sgl_L, sgl_H=sgl_H, sigmag_coeff=sigmag_coeff,
        warn_on_churn=not escalate.enabled, refine_fn=refine_fn,
        compact_min_lh=compact_min_lh, offsets=(dxs_t, dys_t), gather=gather,
    )
    timer.lap("assemble_ms")
    return results


def assemble_core_results(
    top_lh, top_idx, psi, phi, valid, times, vxs, vys,
    *, k, k_search, x_min, y_min, SH, SW, min_obs, min_lh,
    do_sigmag=False, sgl_L=0.25, sgl_H=0.75, sigmag_coeff=-1.0,
    offsets, warn_on_churn=True, refine_fn=None, compact_min_lh=None, gather=_gather_curves,
):
    """Turn (K', SH, SW) top-K maps into the pixel-major struct-of-arrays
    result set, re-scoring the winners exactly (flux/obs and, with sigma-G,
    the clipped likelihoods + per-pixel re-rank back to K).

    ``compact_min_lh`` drops rows whose kernel likelihood fails that bound
    before assembly; with ``compact_min_lh == min_lh`` the rows that survive
    the caller's ``filter_by_likelihood(min_lh)`` are unchanged. ``offsets``
    are the (dxs, dys) (C, T) offset tables on the planes' device.
    ``gather`` gathers the winners' curves (:func:`_gather_curves`, or the
    mesh-sharded drop-in of ``parallel.sharded.make_sharded_evaluators``).

    Returns ``(results, pool_tail_frac)``, the second value being the
    sigma-G pool-boundary churn diagnostic (0.0 when no re-rank ran).
    """
    top_lh, top_idx = _fetch_topk(top_lh, top_idx)  # (K', SH, SW) numpy

    # Pixel-major layout: result[(i*SW + j)*K + k].
    kidx = np.transpose(top_idx, (1, 2, 0)).reshape(-1)
    klh = np.transpose(top_lh, (1, 2, 0)).reshape(-1)

    # The over-provisioned sigma-G re-rank needs the dense (n_pix, K')
    # pools; compaction then happens after it instead (below).
    compact_early = compact_min_lh is not None and not (do_sigmag and k_search > k)
    if compact_early:
        sel = np.nonzero((kidx >= 0) & (klh >= float(compact_min_lh)))[0]
        kidx = kidx[sel]
        klh = klh[sel]
        pix = sel // k_search
        xs_all = (pix % SW + x_min).astype(np.int32)
        ys_all = (pix // SW + y_min).astype(np.int32)
    else:
        jjg, iig = np.meshgrid(np.arange(SW), np.arange(SH))
        xs_all = np.repeat((jjg + x_min).reshape(-1), k_search).astype(np.int32)
        ys_all = np.repeat((iig + y_min).reshape(-1), k_search).astype(np.int32)

    filled = kidx >= 0
    vx_arr = np.zeros(len(kidx), dtype=np.float32)
    vy_arr = np.zeros(len(kidx), dtype=np.float32)
    vx_arr[filled] = np.asarray(vxs, dtype=np.float32)[kidx[filled]]
    vy_arr[filled] = np.asarray(vys, dtype=np.float32)[kidx[filled]]

    # Re-evaluate the winners exactly for flux / obs_count (and the sigma-G
    # clipped scores when enabled). Slots whose kernel lh already fails the
    # min_lh cut are skipped: every caller filters them out right after.
    flux = np.zeros(len(kidx), dtype=np.float32)
    obs = np.zeros(len(kidx), dtype=np.int32)
    lh = klh.copy()
    filled &= klh >= float(min_lh)
    if filled.any():
        f_idx = np.nonzero(filled)[0]
        res = _eval_by_index_chunked(
            psi, phi, valid, xs_all[f_idx], ys_all[f_idx], kidx[f_idx],
            offsets[0], offsets[1], EVAL_CHUNK, do_sigmag, len(np.asarray(times)), gather,
        )
        if do_sigmag:
            psi_v, phi_v, okg, stats = res
        else:
            stats = res
        flux[f_idx] = stats["flux"]
        obs[f_idx] = stats["obs_count"]
        if do_sigmag:
            new_lh, new_flux, _, _ = clipped_sigmag_scores(psi_v, phi_v, okg, sgl_L, sgl_H, sigmag_coeff)
            # Gates before clipping (kernels.cu:201-203): clipping only
            # applies where obs/lh passed; otherwise the score is unchanged.
            passed = (stats["obs_count"] >= min_obs) & (stats["lh"] >= min_lh)
            lh[f_idx] = np.where(passed, new_lh, lh[f_idx])
            flux[f_idx] = np.where(passed, new_flux, flux[f_idx])
            # Post-clip insertion gate (kernels.cu:318-320).
            drop = passed & (new_lh < min_lh)
            lh[f_idx] = np.where(drop, -FLT_MAX, lh[f_idx])

    results = {
        "x": xs_all,
        "y": ys_all,
        "vx": vx_arr,
        "vy": vy_arr,
        "lh": lh.astype(np.float32),
        "flux": flux,
        "obs_count": obs,
    }

    tail_frac = 0.0
    if do_sigmag and k_search > k:
        # Re-rank within each pixel by clipped lh and keep only K per pixel.
        n_pix = SH * SW
        lh_px = results["lh"].reshape(n_pix, k_search)
        order = np.argsort(-lh_px, axis=1, kind="stable")[:, :k]
        if warn_on_churn:
            tail_frac = _warn_on_pool_tail_churn(order, lh_px, k, k_search)
        else:
            tail_frac = sigmag_pool_tail_fraction(order, lh_px, k, k_search)
        kept_real = np.take_along_axis(lh_px, order, axis=1) > -FLT_MAX
        flat = (np.arange(n_pix)[:, None] * k_search + order).reshape(-1)
        results = {key: val[flat] for key, val in results.items()}
        if refine_fn is not None:
            # Re-score a pixel exactly when the pool boundary is suspect:
            # (a) the clipped re-rank CHANGED the kept top-K membership, or
            # (b) the pool is full and the kept K-th clipped lh fell below
            #     the pool's minimum unclipped lh.
            membership_changed = ((order >= k) & kept_real).any(axis=1)
            klh_px = klh.reshape(n_pix, k_search)
            real_slots = klh_px > -FLT_MAX / 2
            pool_full = real_slots.all(axis=1)
            pool_floor = np.where(real_slots, klh_px, FLT_MAX).min(axis=1)
            kept_clipped = np.take_along_axis(lh_px, order, axis=1)
            kept_floor = np.where(kept_real, kept_clipped, FLT_MAX).min(axis=1)
            inverted = pool_full & (kept_floor < pool_floor)
            flagged = np.nonzero(membership_changed | inverted)[0]
            if len(flagged):
                results = refine_fn(results, flagged)

    if compact_min_lh is not None and not compact_early:
        keepm = results["lh"] >= float(compact_min_lh)
        results = {key: val[keepm] for key, val in results.items()}

    return results, tail_frac


def sigmag_pool_tail_fraction(order, lh_px, k, k_search):
    """The fraction of kept rows that the sigma-G re-rank promoted out of
    the bottom quartile of the unclipped pool."""
    kept = order[:, :k]
    real = np.take_along_axis(lh_px, kept, axis=1) > -FLT_MAX
    n_real = int(real.sum())
    if n_real == 0:
        return 0.0
    tail_start = k_search - max(k_search // 4, 1)
    return float(((kept >= tail_start) & real).sum()) / n_real


def _warn_on_pool_tail_churn(order, lh_px, k, k_search, threshold=0.01):
    frac = sigmag_pool_tail_fraction(order, lh_px, k, k_search)
    if frac > threshold:
        logger.warning(
            "sigma-G re-rank promoted %.2f%% of kept rows from the bottom "
            "quartile of the %d-deep unclipped pool: the pool boundary is "
            "active and results may miss clipped-promoted candidates.",
            100.0 * frac,
            k_search,
        )
    return frac


class _SigmaGEscalation:
    """Gate for the sigma-G pixel-exact refinement pass: on in the
    over-provisioned mode whenever the pool is smaller than the candidate
    set (a full pool is already exact), unless ``KB_SIGMAG_AUTO=0`` (warn
    only). Pixels whose kept top-K membership the clipped re-rank changed
    are then re-scored against every candidate
    (:func:`exact_refine_pixels`)."""

    def __init__(self, do_sigmag, sigmag_mode, over, k, num_cand):
        self.enabled = (
            bool(do_sigmag)
            and sigmag_mode != "exact"
            and int(over) * int(k) < int(num_cand)
            and os.environ.get("KB_SIGMAG_AUTO", "1") != "0"
        )


def exact_refine_pixels(
    results, pix_idx, *, psi, phi, valid, times, vxs, vys, k,
    min_obs, min_lh, sgl_L, sgl_H, sigmag_coeff, max_chunk=1 << 20, gather=_gather_curves,
):
    """Re-score the flagged pixels against EVERY candidate with the
    reference-exact clipped gating (kernels.cu:184-241 semantics: clip when
    the unclipped result passes min_obs/min_lh, insert by the final lh),
    replacing their K rows in the pixel-major ``results`` dict.

    ``pix_idx`` are flat pixel indices into the (SH*SW, K) row layout;
    ``gather`` gathers the curves, as in :func:`assemble_core_results`.
    """
    vxs = np.asarray(vxs, dtype=np.float32).reshape(-1)
    vys = np.asarray(vys, dtype=np.float32).reshape(-1)
    C = len(vxs)
    xs_pix = results["x"].reshape(-1, k)[pix_idx, 0]
    ys_pix = results["y"].reshape(-1, k)[pix_idx, 0]
    logger.info(
        "sigma-G pool boundary active on %d pixels: re-scoring them "
        "against all %d candidates with exact clipping.", len(pix_idx), C,
    )

    pix_chunk = max(1, max_chunk // C)
    for lo in range(0, len(pix_idx), pix_chunk):
        chunk = pix_idx[lo : lo + pix_chunk]
        P = len(chunk)
        xs = np.repeat(xs_pix[lo : lo + pix_chunk], C)
        ys = np.repeat(ys_pix[lo : lo + pix_chunk], C)
        vx = np.tile(vxs, P)
        vy = np.tile(vys, P)
        psi_v, phi_v, ok, stats = _curves_and_stats(psi, phi, valid, times, xs, ys, vx, vy, gather=gather)
        clipped_lh, clipped_flux, _, _ = clipped_sigmag_scores(
            psi_v, phi_v, ok, sgl_L, sgl_H, sigmag_coeff
        )
        passed = (stats["obs_count"] >= min_obs) & (stats["lh"] >= min_lh)
        final_lh = np.where(passed, clipped_lh, stats["lh"])
        final_flux = np.where(passed, clipped_flux, stats["flux"])
        insertable = (stats["obs_count"] >= min_obs) & (final_lh >= min_lh)
        final_lh = np.where(insertable, final_lh, -FLT_MAX).reshape(P, C)
        # Top-K by (clipped lh desc, candidate index asc): the kernels' tie
        # order.
        order = np.argsort(-final_lh, axis=1, kind="stable")[:, :k]
        top_lh = np.take_along_axis(final_lh, order, axis=1)
        real = top_lh > -FLT_MAX
        rows = (np.asarray(chunk)[:, None] * k + np.arange(k)[None, :]).reshape(-1)
        flat_order = (np.arange(P)[:, None] * C + order).reshape(-1)
        results["lh"][rows] = top_lh.reshape(-1)
        results["flux"][rows] = np.where(real, final_flux[flat_order].reshape(P, k), 0.0).reshape(-1)
        results["vx"][rows] = np.where(real, vxs[order], 0.0).reshape(-1)
        results["vy"][rows] = np.where(real, vys[order], 0.0).reshape(-1)
        results["obs_count"][rows] = np.where(
            real, stats["obs_count"].reshape(P, C)[np.arange(P)[:, None], order], 0
        ).reshape(-1)
    return results
