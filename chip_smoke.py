#!/usr/bin/env python3
"""Run the kbmod_tpu_torch port on one CUDA card and check it end to end.

    python3 chip_smoke.py                # everything, one card
    python3 chip_smoke.py --checks-only  # build + kernel-against-twin checks

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card's name and power limit (nvidia-smi);
2. the nvcc build of every CUDA kernel, all sources compiled together;
3. kernel checks: each kernel against its plain PyTorch twin on the card
   (K1 over PSFs from 1 x 1 to 21 x 21; K2; K3, K4 and K5 over
   uint8/uint16 codes, T up to 300; K2-K5 with lists of K = 128, past the
   64 that registers hold; the grouped kernels K2, K5 and K3 at
   T = 1,000-1,500, past the T their tables once capped; dedup; K6 in
   modes A, B and C), and each redesigned kernel's ptxas registers and
   spills;
4. the float main path at full width: a 64 x 2048 x 2048 FakeDataSet stack
   (PSF sigma 1.4, 1% masked, one injected object) searched by
   ``StackSearch(..., -1).search_all`` over a 41 x 41 KBMODV1Search grid,
   then a sigma-G search over a 256-row band. The object must be the best
   result of both, every kernel must have launched, no twin may have run;
5. the quantized main path on the same stack: ``StackSearch(..., 1)`` over
   the full frame (K5), its sigma-G band (K5 at K = 32), ``StackSearch(...,
   2)`` over the band (K3) and the uint8 band over a sparse 66-candidate
   list (K4). Each search is driven with the counts at 0 and read after: it
   must find the object through its kernel, with no twin run;
6. the pipeline on the same stack: two ``SearchRunner.run_search`` runs
   with the ``SearchConfiguration`` defaults but the 41 x 41 grid (through
   ``create_trajectory_generator``), an ECSV result file and no saved
   config: P1 float (host sigma-G, the default clustering, sum coadds),
   P2 uint8 with the in-kernel sigma-G pool (K5 at K = 32) and mean,
   median and weighted coadds. Each must put the object in row 0, run
   through K1 and K2 (P1) or K1 and K5 (P2) with no twin, write a file
   that reads back with the same rows, and stay inside the port's memory
   budget (``run_search.search_memory_budget``) over ``do_core_search``;
   its phase walls and the budget against the measured peak are printed;
7. the search's switches on the same stack, each search driven with the
   counts at 0 and read after, through its kernel with no twin: the uint8
   full frame with ``KB_SNAP_ROW_ERROR=0.75`` (K5; the vy classes before
   and after, the route, K5's time; the object best within a lattice step),
   the float sigma-G band with ``KB_SIGMAG_TOPK_FACTOR=8`` and with
   ``KB_SIGMAG_AUTO=0`` (K2), the float full frame with
   ``KB_COMPACT_RESULTS=0`` (K2; the same rows as the compact layout);
8. ``KB_SIGMAG_MODE=exact`` on a 64-row float band over every candidate
   (plain PyTorch on the card, no kernel): its time and rows per second,
   every kept slot's clipped lh against the host's re-score of the same
   curves, the object best;
9. stamp vetting: P3, the float pipeline with ``cnn_filter`` on a resnet18
   state_dict drawn from ``torch.Generator(0)`` into a temporary directory
   (K1, K2, no twin; the ``cnn filtering`` phase's time); the brightness
   filter and the known-object matcher (a fake WCS, a catalog made from the
   object's path: its row must match) on P3's rows before clustering;
   ``filter_stamps_by_cnn`` alone on 4,096 random 21 x 21 stamps (resnet18)
   and 1,024 of 99 x 99 (resnet50), stamps per second, logits against the
   CPU's;
10. ckpt: a child process (this script with ``--ckpt-child``) runs the
   uint8 full-frame search (K5) checkpointed in 8 tiles of 256 rows and is
   killed with SIGKILL once two tiles are on disk; this process resumes
   it: rows bit-equal to the un-tiled search, the finished tiles loaded
   (no hidden tmp file) and only the rest computed; one code of plane 3
   (which the JAX package's 8-plane sample skips) changed must discard
   the directory; the float full frame (K2) in 8 tiles equals its
   un-tiled rows; the tiled and un-tiled walls, the fingerprint's time and
   the tiles loaded are printed;
11. sharded: a mesh of two shards on cuda:0 (every card when there are
   more), through ``StackSearch.search_all`` with KB_SHARDED=1: uint8
   candidates mode (K5 a shard; rows and maps equal to one device), float
   pixels mode (K2; rows equal), float time mode on a 32-row band over all
   1,681 candidates (plain PyTorch partial sums over candidate chunks, no
   kernel; the same rows, lh within the float64 bound), sigma-G on the
   256-row band (K2; rows equal); the u8 candidates and time runs' memory
   peaks within ``search_memory_budget``; then
   ``sharded_sigmag_exact_topk`` on a 16-row band and
   ``sharded_psi_phi_build`` (K1 a shard), each equal to one device; each
   wall beside the one-device wall;
12. profile: one P1 pipeline run with KB_PROFILE_DIR, whose Chrome trace
   must name the K1 and K2 launches;
13. K6's own path, the micro-benchmark script
   (``kbmod_tpu_torch.scripts.exactrow_microbench``), driven with the
   counts at 0 and read after;
14. each kernel's time at the main path's shapes beside its twin's, its
   bound and (K1) cuDNN's grouped convolution, as one JSON line (K2 and K5
   at both of their main-path shapes: the full frame at K = 8 and the
   sigma-G band at K = 32, each held against the twin); K2 and K3 with
   lists of K = 128 (kept in the maps) on the band; K5 through the
   dispatcher (dedup + K5 + expansion) at the JAX package's
   ``midscale_kernel`` shapes (T = 64, 2048 x 2048, C = 33,153, K = 8);
   and K6's three modes at the script's defaults and at NG = 3,015;
   launches summed over every path above;
15. as the last line, {"ok": true, "device": {...}}.

Imports nothing of the JAX package.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor
# cores; int32 from the Hopper white paper's 64 INT32 lanes per SM (132 SMs
# at the 1980 MHz boost clock). The bound of a kernel is the larger of
# bytes / rate and ops / rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Warp instructions the card issues a second (132 SMs x 4 schedulers at
# 1.98 GHz): the floor of a kernel that no fused multiply-add can shorten
# (K1).
WARP_INSTR_PER_S = 132 * 4 * 1.98e9
SOURCES = ["psi_phi_conv", "search_topk", "search_topk_encoded", "search_topk_grouped", "search_topk_encoded_grouped",
           "exactrow_microbench"]
# Sources whose kernels were redesigned for the card: their ptxas register
# and spill lines are printed on their own.
REPORTED = ("psi_phi_conv", "search_topk", "search_topk_encoded", "search_topk_grouped", "search_topk_encoded_grouped",
            "exactrow_microbench")
# The pipelines' generator: the main path's 41 x 41 grid as a configuration
# gives it.
PIPELINE_GENERATOR = {"name": "KBMODV1SearchConfig", "v_arr": [5.0, 45.0, 41], "ang_arr": [0.5, 0.5, 41],
                      "average_angle": 0.0}
# filter_stamps_by_cnn timed alone: (model, stamps, stamp radius): the
# pipeline's radius 10, and the configuration's default cnn_stamp_radius 49.
VETTING_STAMPS = (("resnet18", 4096, 10), ("resnet50", 1024, 49))
# The group count of the midscale search's uniform plan: K6 is timed there too.
K6_MIDSCALE_NG = 3015
# em of the JAX package's midscale_kernel benchmark (bench.py:176-178).
MIDSCALE_EM = np.array([-6.0, 12.0 / 254, 0.1, 4.0 / 254], dtype=np.float32)
# The ckpt phase: starting-pixel rows a tile (8 tiles of the main stack),
# the child's pause after each tile and its time limit, and the columns
# that must equal the un-tiled search (search/checkpoint.py _RESULT_KEYS).
CKPT_TILE_ROWS = 256
CKPT_CHILD_PAUSE_S = 0.5
CKPT_CHILD_TIMEOUT_S = 300
CKPT_RESULT_KEYS = ("x", "y", "vx", "vy", "lh", "flux", "obs_count")


def log(msg):
    print(msg, flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs, each timed by its
    own pair of CUDA events."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def clocks():
    """SM clock, its maximum, power draw and temperature, read right after a
    measurement (a card below its top clock runs compute-bound kernels
    slower)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log):
    """(kernel, registers, spill stores, spill loads) for every kernel in an
    nvcc -Xptxas -v log."""
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spills))
            name = None
    return rows


def bound(nbytes, nops, int_ops=0):
    """Least milliseconds for ``nbytes`` of traffic, ``nops`` float32 and
    ``int_ops`` int32 operations, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (nops / FP32_OPS_PER_S + int_ops / INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# Kernel checks
# ----------------------------------------------------------------------

def _assert_k1_equal(tag, got, ref):
    """K1 against its twin: NaN masks equal and every other value bit-equal.
    Returns the largest |kernel - twin| (0 when equal)."""
    worst = 0.0
    for g, r, what in zip(got, ref, ("psi", "phi")):
        nan = torch.isnan(r)
        if not torch.equal(torch.isnan(g), nan):
            raise AssertionError(f"K1 {tag} {what}: NaN masks differ")
        worst = max(worst, float((g[~nan] - r[~nan]).abs().max()))
        if not torch.equal(g[~nan], r[~nan]):
            raise AssertionError(f"K1 {tag} {what}: values differ from the twin by up to {worst:.3g}")
    return worst


def check_k1(dev):
    """K1 against its twin, bit for bit: the templated sizes (odd squares to
    15 x 15) and the generic kernel (3 x 5, 4 x 4, 21 x 21), on a stack whose
    width and height are multiples of neither tile."""
    from kbmod_tpu_torch.core.psf import PSF
    from kbmod_tpu_torch.ops.conv_kernel import psi_phi_conv, psi_phi_conv_plain

    rng = np.random.default_rng(11)
    T, H, W = 4, 517, 389
    sci = rng.normal(10, 2, (T, H, W)).astype(np.float32)
    var = rng.uniform(1, 4, (T, H, W)).astype(np.float32)
    sci[rng.uniform(size=sci.shape) < 0.02] = np.nan
    var[rng.uniform(size=sci.shape) < 0.01] = np.nan
    sci_d, var_d = torch.as_tensor(sci, device=dev), torch.as_tensor(var, device=dev)
    worst = 0.0
    psfs = [("sigma=%.1f" % s, PSF.make_gaussian_kernel(s)) for s in (1.0, 1.4, 2.0, 2.5, 3.5)]
    psfs.append(("1x1", np.ones((1, 1), np.float32)))
    psfs += [(f"{kh}x{kw}", rng.uniform(-0.1, 1, (kh, kw)).astype(np.float32)) for kh, kw in ((3, 5), (4, 4))]
    for name, psf in psfs:
        k = torch.as_tensor(psf, device=dev)
        got = psi_phi_conv(sci_d, var_d, k)
        ref = psi_phi_conv_plain(sci_d, var_d, k)
        torch.cuda.synchronize()
        worst = max(worst, _assert_k1_equal(name, got, ref))
        log(f"K1 check {name} psf {tuple(psf.shape)}: ok (bit-equal)")
    return worst


def _assert_k2_equal(tag, got, ref, kernel="K2"):
    """Indices equal; lh equal to one float32 ulp (both round the same way,
    so bit equality is expected)."""
    (g_lh, g_idx), (r_lh, r_idx) = got, ref
    if not torch.equal(g_idx, r_idx):
        n = int((g_idx != r_idx).sum())
        raise AssertionError(f"{kernel} {tag}: {n} indices differ from the twin")
    ulp = torch.abs(torch.nextafter(r_lh, torch.full_like(r_lh, float("inf"))) - r_lh)
    diff = (g_lh.double() - r_lh.double()).abs()
    if bool((diff > ulp.double()).any()):
        raise AssertionError(f"{kernel} {tag}: lh differs from the twin by more than 1 ulp")
    return float(diff.max()), int((diff > 0).sum())


def check_k2(dev):
    from kbmod_tpu_torch.ops.search import trajectory_offsets
    from kbmod_tpu_torch.ops.search_kernel import search_topk, search_topk_shift

    rng = np.random.default_rng(12)
    T, H, W, C = 12, 300, 257, 97
    times = np.sort(rng.uniform(0, 3.0, T))
    times[0] = 0.0
    psi = rng.normal(0, 1, (T, H, W)).astype(np.float32)
    phi = rng.uniform(0.5, 2.0, (T, H, W)).astype(np.float32)
    valid = (rng.uniform(size=(T, H, W)) >= 0.05).astype(np.uint8)
    psi[valid == 0] = 0.0
    phi[valid == 0] = 0.0
    vxs = rng.uniform(-20, 20, C).astype(np.float32)
    vys = rng.uniform(-20, 20, C).astype(np.float32)
    # Duplicated candidates: exact lh ties, where the lower index must win.
    vxs[60:64] = vxs[3]
    vys[60:64] = vys[3]
    dxs, dys = trajectory_offsets(vxs, vys, times)
    d = dict(
        psi=torch.as_tensor(psi, device=dev), phi=torch.as_tensor(phi, device=dev),
        valid=torch.as_tensor(valid, device=dev),
        dxs=torch.as_tensor(dxs, device=dev), dys=torch.as_tensor(dys, device=dev),
    )
    full = dict(x_min=0, x_max=W, y_min=0, y_max=H)
    cases = [
        ("full", full, {}),
        ("reduced", dict(x_min=20, x_max=201, y_min=31, y_max=250), {}),
        ("extended", dict(x_min=-13, x_max=W + 9, y_min=-7, y_max=H + 11), {}),
        ("no-obs-gate", full, dict(gate_min_obs=False)),
        ("min-obs", full, dict(min_obs=10.0)),
        ("min-lh", full, dict(gate_min_lh=True, min_lh=1.5, min_obs=6.0)),
        ("unmasked", full, dict(has_masked=False, unmasked=True)),
        ("padding", full, dict(pad=7)),
    ]
    worst = 0.0
    for K in (1, 8, 32):
        for tag, bounds, opt in cases:
            opt = dict(opt)
            min_obs = opt.pop("min_obs", 3.0)
            min_lh = opt.pop("min_lh", 0.0)
            pad = opt.pop("pad", 0)
            unmasked = opt.pop("unmasked", False)
            psi_d, phi_d, valid_d = d["psi"], d["phi"], d["valid"]
            dxs_d, dys_d, cand_valid = d["dxs"], d["dys"], None
            if unmasked:
                psi_d = torch.as_tensor(rng.normal(0, 1, (T, H, W)).astype(np.float32), device=dev)
                phi_d = torch.as_tensor(rng.uniform(0.5, 2.0, (T, H, W)).astype(np.float32), device=dev)
                valid_d = torch.ones((T, H, W), dtype=torch.uint8, device=dev)
            if pad:
                dxs_d = torch.cat([dxs_d, dxs_d[:pad] + 1])
                dys_d = torch.cat([dys_d, dys_d[:pad] - 1])
                cand_valid = torch.tensor([True] * C + [False] * pad, device=dev)
            kw = dict(k_results=K, cand_valid=cand_valid, **bounds, **opt)
            args = (psi_d, phi_d, valid_d, dxs_d, dys_d, min_obs, min_lh)
            got = search_topk(*args, **kw)
            ref = search_topk_shift(*args, **kw)
            torch.cuda.synchronize()
            err, nonzero = _assert_k2_equal(f"{tag} K={K}", got, ref)
            worst = max(worst, err)
            if pad:
                plain = search_topk_shift(psi_d, phi_d, valid_d, d["dxs"], d["dys"], min_obs, min_lh,
                                          k_results=K, **bounds)
                if not (torch.equal(plain[0], ref[0]) and torch.equal(plain[1], ref[1])):
                    raise AssertionError("K2 padding: padded candidates changed the result")
            if tag == "full" and K == 32:
                # Candidate 3 and its duplicates 60..63 tie exactly: where
                # several sit in one pixel's list, they appear in index order.
                idx = got[1].cpu().numpy()
                dup = np.isin(idx, [3, 60, 61, 62, 63])
                for i, j in zip(*np.nonzero(dup.sum(axis=0) > 1)):
                    col = [v for v in idx[:, i, j] if v in (3, 60, 61, 62, 63)]
                    if col != sorted(col):
                        raise AssertionError(f"K2 tie order at ({i},{j}): {col}")
            log(f"K2 check {tag:12s} K={K:2d}: ok (indices equal, max |dlh| {err:.3g}, {nonzero} slots differ)")
    # The grouped kernel's own cases: K = 64; a column spread that stages
    # one slab per member; candidate 3 copied 12 times, so its exact ties
    # span two groups; window origins outside the image with the full
    # candidate set at K = 64; lists of 128, kept in the maps.
    vd, vyd = vxs.copy(), vys.copy()
    vd[70:82], vyd[70:82] = vxs[3], vys[3]
    grouped_cases = [
        ("k64", (vxs, vys), full, 64),
        ("wide-spread", (vxs * 12, vys * 0.2), full, 8),
        ("ties-across", (vd, vyd), full, 32),
        ("extended-k64", (vxs, vys), dict(x_min=-40, x_max=W - 20, y_min=-33, y_max=H + 5), 64),
        ("k128", (vxs, vys), full, 128),
        ("ties-k128", (vd, vyd), dict(x_min=-40, x_max=W - 20, y_min=-33, y_max=H + 5), 128),
    ]
    for tag, (vx, vy), bounds, K in grouped_cases:
        dx, dy = (torch.as_tensor(a, device=dev) for a in trajectory_offsets(vx, vy, times))
        args = (d["psi"], d["phi"], d["valid"], dx, dy, 3.0, 0.0)
        kw = dict(k_results=K, **bounds)
        got = search_topk(*args, **kw)
        ref = search_topk_shift(*args, **kw)
        torch.cuda.synchronize()
        err, nonzero = _assert_k2_equal(f"{tag} K={K}", got, ref)
        worst = max(worst, err)
        log(f"K2 check {tag:12s} K={K:3d}: ok (indices equal, max |dlh| {err:.3g}, {nonzero} slots differ)")
    return worst


def _code_stack(rng, T, H, W, bits, zeros=0.05):
    dtype = np.uint8 if bits == 8 else np.uint16
    psi = rng.integers(1, 1 << bits, (T, H, W)).astype(dtype)
    phi = rng.integers(1, 1 << bits, (T, H, W)).astype(dtype)
    psi[rng.uniform(size=psi.shape) < zeros] = 0
    phi[rng.uniform(size=phi.shape) < zeros] = 0
    return psi, phi


def _planes(psi, phi, em, dev):
    """EncodedPlanes whose code planes are views into one code-pair tensor,
    as a PsiPhiArray holds them."""
    from kbmod_tpu_torch.ops.psi_phi import code_pair_views, interleave_code_pairs
    from kbmod_tpu_torch.ops.search import EncodedPlanes

    pairs = interleave_code_pairs(torch.as_tensor(psi, device=dev), torch.as_tensor(phi, device=dev))
    return EncodedPlanes(*code_pair_views(pairs, psi.shape[2]), em, pairs)


# (kernel, code bits, T, H, W, C): K3 on uint16 and on uint8 past K4's T
# limit, K4 at a short T and at its 16-bit field limit (257), K5 at the
# main path's T, at the 16-bit field limit and past it.
ENCODED_CONFIGS = [
    ("K3", 16, 12, 300, 257, 97),
    ("K3", 8, 260, 70, 83, 20),
    ("K4", 8, 12, 300, 257, 97),
    ("K4", 8, 257, 70, 83, 20),
    ("K5", 8, 64, 150, 257, 97),
    ("K5", 8, 257, 70, 83, 20),
    ("K5", 8, 258, 70, 83, 20),
    ("K5", 8, 260, 70, 83, 20),
    ("K5", 8, 300, 70, 83, 20),
]


def check_encoded(dev):
    """K3, K4 and K5 against the encoded twin over K2's cases (window,
    gates, padding candidates, duplicated candidates for exact ties) at
    K = 1, 8, 32 and 64, and the full window at K = 128 too; then dedup +
    expansion against the twin without dedup. Returns the largest
    |kernel - twin| lh per kernel."""
    from kbmod_tpu_torch.ops import search_encoded_kernel as ek
    from kbmod_tpu_torch.ops.search import trajectory_offsets
    from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
    from kbmod_tpu_torch.ops.search_plan import _plan_groups

    wrappers = {"K3": ek.search_encoded, "K4": ek.search_paired, "K5": ek.search_grouped}
    worst = {k: 0.0 for k in wrappers}
    for kernel, bits, T, H, W, C in ENCODED_CONFIGS:
        rng = np.random.default_rng(T + bits)
        psi, phi = _code_stack(rng, T, H, W, bits)
        em = MIDSCALE_EM if bits == 8 else np.array([-6.0, 12.0 / 65534, 0.1, 4.0 / 65534], np.float32)
        planes = _planes(psi, phi, em, dev)
        times = np.sort(rng.uniform(0, 3.0, T))
        times[0] = 0.0
        vxs = rng.uniform(-20, 20, C).astype(np.float32)
        vys = rng.uniform(-4, 4, C).astype(np.float32)
        # Duplicated candidates: exact lh ties, where the lower index must win.
        vxs[C - 4 :] = vxs[3]
        vys[C - 4 :] = vys[3]
        dxs, dys = trajectory_offsets(vxs, vys, times)
        full = dict(x_min=0, x_max=W, y_min=0, y_max=H)
        cases = [
            ("full", full, {}),
            ("reduced", dict(x_min=20, x_max=W - 30, y_min=11, y_max=H - 20), {}),
            ("extended", dict(x_min=-13, x_max=W + 9, y_min=-7, y_max=H + 11), {}),
            ("no-obs-gate", full, dict(gate_min_obs=False)),
            ("min-obs", full, dict(min_obs=float(T // 2))),
            ("min-lh", full, dict(gate_min_lh=True, min_lh=1.5, min_obs=float(T // 3))),
            ("padding", full, dict(pad=7)),
        ]
        long_t = T > 64
        for tag, bounds, opt in cases:
            for K in ((1, 8, 32, 64, 128) if tag == "full" else (8,) if long_t else (1, 8, 32, 64)):
                opt_k = dict(opt)
                min_obs = opt_k.pop("min_obs", 3.0)
                min_lh = opt_k.pop("min_lh", 0.0)
                pad = opt_k.pop("pad", 0)
                dx, dy, cand_valid = dxs, dys, None
                if pad:
                    dx = np.concatenate([dxs, dxs[:pad] + 1])
                    dy = np.concatenate([dys, dys[:pad] - 1])
                    cand_valid = torch.tensor([True] * C + [False] * pad, device=dev)
                kw = dict(k_results=K, cand_valid=cand_valid, **bounds, **opt_k)
                dx_t, dy_t = torch.as_tensor(dx, device=dev), torch.as_tensor(dy, device=dev)
                extra = dict(plan=_plan_groups(dy, 8, 8)) if kernel == "K5" else {}
                got = wrappers[kernel](planes, dx_t, dy_t, min_obs, min_lh, **kw, **extra)
                ref = ek.search_topk_encoded_shift(planes.psi_codes, planes.phi_codes, dx_t, dy_t,
                                                   min_obs, min_lh, em, **kw)
                torch.cuda.synchronize()
                err, nonzero = _assert_k2_equal(f"u{bits} T={T} {tag} K={K}", got, ref, kernel)
                worst[kernel] = max(worst[kernel], err)
                if tag == "full" and K == 32:
                    # Candidate 3 and its duplicates tie exactly: where several
                    # sit in one pixel's list, they appear in index order.
                    dup = [3] + list(range(C - 4, C))
                    idx = got[1].cpu().numpy()
                    for i, j in zip(*np.nonzero(np.isin(idx, dup).sum(axis=0) > 1)):
                        col = [v for v in idx[:, i, j] if v in dup]
                        if col != sorted(col):
                            raise AssertionError(f"{kernel} tie order at ({i},{j}): {col}")
                log(f"{kernel} check u{bits} T={T:3d} {tag:12s} K={K:3d}: ok "
                    f"(indices equal, max |dlh| {err:.3g}, {nonzero} slots differ)")

    # Dedup: slow candidates share offset sequences; dedup + K5/K4 +
    # expansion must equal the twin over every candidate.
    rng = np.random.default_rng(5)
    T, H, W = 12, 120, 140
    psi, phi = _code_stack(rng, T, H, W, 8)
    planes = _planes(psi, phi, MIDSCALE_EM, dev)
    g = np.linspace(-1.5, 1.5, 13, dtype=np.float32)
    vxs, vys = (a.ravel() for a in np.meshgrid(g, g))
    dxs, dys = trajectory_offsets(vxs, vys, np.linspace(0.0, 2.0, T))
    for K in (1, 8, 32):
        kw = dict(x_min=-5, x_max=W + 3, y_min=0, y_max=H, k_results=K)
        got = search_topk_encoded(planes, dxs, dys, 3.0, 0.0, **kw)
        route = search_topk_encoded.last_route
        ref = ek.search_topk_encoded_shift(planes.psi_codes, planes.phi_codes, dxs, dys, 3.0, 0.0,
                                           MIDSCALE_EM, **kw)
        torch.cuda.synchronize()
        if not route.startswith("dedup+"):
            raise AssertionError(f"dedup check: route {route} did not dedup")
        err, nonzero = _assert_k2_equal(f"dedup K={K}", got, ref, "dedup")
        log(f"dedup check ({route}, {len(vxs)} candidates) K={K:2d}: ok (indices equal, max |dlh| {err:.3g})")
    return worst


def check_long_t(dev):
    """K2 at T = 1,000, K5 at T = 1,500 and K3 (uint16) at T = 1,000 on small
    images against their twins: the grouped kernels reload their tables
    every 63 steps. Returns the largest |kernel - twin| lh per kernel."""
    from kbmod_tpu_torch.ops import search_encoded_kernel as ek
    from kbmod_tpu_torch.ops.search import trajectory_offsets
    from kbmod_tpu_torch.ops.search_kernel import search_topk, search_topk_shift
    from kbmod_tpu_torch.ops.search_plan import grouped_plan

    worst = {}
    for kernel, T in (("K2", 1000), ("K5", 1500), ("K3", 1000)):
        rng = np.random.default_rng(T)
        H, W, C = 40, 300, 21
        times = np.linspace(0.0, 2.0, T)
        vxs = rng.uniform(-20, 20, C).astype(np.float32)
        vys = rng.uniform(-2, 2, C).astype(np.float32)
        vxs[C - 4 :], vys[C - 4 :] = vxs[3], vys[3]  # exact ties
        dxs, dys = trajectory_offsets(vxs, vys, times)
        dx, dy = torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev)
        kw = dict(x_min=-7, x_max=W + 5, y_min=-3, y_max=H, k_results=8)
        min_obs = float(T // 3)
        if kernel == "K2":
            valid = (rng.uniform(size=(T, H, W)) >= 0.05).astype(np.uint8)
            psi = np.where(valid, rng.normal(0, 1, (T, H, W)), 0).astype(np.float32)
            phi = np.where(valid, rng.uniform(0.5, 2.0, (T, H, W)), 0).astype(np.float32)
            args = tuple(torch.as_tensor(a, device=dev) for a in (psi, phi, valid)) + (dx, dy, min_obs, 0.0)
            got, ref = search_topk(*args, **kw), search_topk_shift(*args, **kw)
        else:
            bits = 8 if kernel == "K5" else 16
            psi, phi = _code_stack(rng, T, H, W, bits)
            em = MIDSCALE_EM if bits == 8 else np.array([-6.0, 12.0 / 65534, 0.1, 4.0 / 65534], np.float32)
            planes = _planes(psi, phi, em, dev)
            if kernel == "K5":
                got = ek.search_grouped(planes, dx, dy, min_obs, 0.0, plan=grouped_plan(dys)[0], **kw)
            else:
                got = ek.search_encoded(planes, dx, dy, min_obs, 0.0, **kw)
            ref = ek.search_topk_encoded_shift(planes.psi_codes, planes.phi_codes, dx, dy, min_obs, 0.0, em, **kw)
        torch.cuda.synchronize()
        err, nonzero = _assert_k2_equal(f"T={T}", got, ref, kernel)
        worst[kernel] = err
        log(f"{kernel} check T={T}: ok (indices equal, max |dlh| {err:.3g}, {nonzero} slots differ)")
    return worst


def _k6_wide_table(rng, ng, T, th, rows, W4):
    """A K6 table with wrap-around shifts: any row roll, any window base,
    lane rolls past W4."""
    SL = th + 8
    return np.concatenate(
        [rng.integers(0, SL, (ng, T)), rng.integers(0, rows - SL + 1, (ng, T)), rng.integers(0, 3 * W4, (ng, T))],
        axis=1,
    ).astype(np.int32)


def check_k6(dev):
    """K6 in every mode against its twin (exact int32 equality) at the JAX
    script's defaults: its own draw and a table of wrap-around shifts."""
    from kbmod_tpu_torch.ops.exactrow_kernel import MODES, exactrow_accumulate, exactrow_accumulate_plain
    from kbmod_tpu_torch.scripts.exactrow_microbench import make_inputs

    tbl, buf = make_inputs(device=dev)
    ng, th = tbl.shape[0], 32
    wide = torch.as_tensor(_k6_wide_table(np.random.default_rng(6), ng, tbl.shape[1] // 3, th, *buf.shape),
                           device=dev)
    for tag, tb in (("script draw", tbl), ("wrap-around shifts", wide)):
        ref = exactrow_accumulate_plain(tb, buf, "A", 8, th)
        for mode in MODES:
            got = exactrow_accumulate(tb, buf, mode, 8, th)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"K6 mode {mode} {tag}: {int((got != ref).sum())} words differ from the twin")
            log(f"K6 check mode {mode} {tag}: ok (bit-equal)")
    return 0.0


def k6_path():
    """K6's own path: the micro-benchmark script, run as a user runs it, with
    the counts at 0 just before and read just after."""
    from kbmod_tpu_torch.scripts import exactrow_microbench as mb

    reset_counts()
    mb.main([])
    launches, twin_calls = read_counts()
    log(f"K6 script launches {launches}, twin calls {twin_calls}")
    if launches["exactrow_accumulate"] <= 0 or max(twin_calls.values()) != 0:
        raise AssertionError(f"K6 script did not run through its kernel alone: {launches}, {twin_calls}")
    return launches["exactrow_accumulate"]


def time_k6(dev):
    """K6's modes at the JAX script's defaults (NG = 64) and at NG = 3,015,
    the group count of midscale's uniform plan, each against the twin. The
    bound counts 3 int32 adds per (slot, word) against the bytes of buf,
    tbl and out."""
    from kbmod_tpu_torch.ops import _build, exactrow_kernel
    from kbmod_tpu_torch.ops.exactrow_kernel import MODES, exactrow_accumulate, exactrow_accumulate_plain
    from kbmod_tpu_torch.scripts.exactrow_microbench import make_inputs, time_mode

    res = {}
    for ng in (64, K6_MIDSCALE_NG):
        tbl, buf = make_inputs(ng=ng, device=dev)
        th, T = 32, tbl.shape[1] // 3
        t0 = time.perf_counter()
        ref = exactrow_accumulate_plain(tbl, buf, "A", 8, th)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        words = ng * T * 8 * th * buf.shape[1]
        bound_ms, bound_by = bound(4 * (tbl.numel() + buf.numel() + th * buf.shape[1]), 0, 3 * words)
        for mode in MODES:
            got = exactrow_accumulate(tbl, buf, mode, 8, th)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"K6 mode {mode} NG={ng}: differs from the twin")
            ms = time_mode(tbl, buf, mode, 8, th, reps=20 if ng == 64 else 5)
            res[(ng, mode)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, err=0.0,
                                   library_ms=None)
            slots = ng * T * 8
            log(f"K6 mode {mode} NG={ng}: {ms:.4f} ms, {2 * words / (ms / 1e3) / 1e11:.3f}e11 eval-steps/s, "
                f"{ms * 1e6 / slots:.2f} ns/cand-slot, bound {bound_ms:.4f} ms ({bound_by}), twin {plain_ms:.1f} ms")
        log(f"K6 timed at NG={ng}; clocks (sm, max sm, power, temperature): {clocks()}")
    lib = _build.load("exactrow_microbench", exactrow_kernel._SIGNATURES)
    log("K6 blocks per SM: " + ", ".join(f"{m} {lib.kb_exactrow_blocks_per_sm(ord(m))}" for m in MODES))
    return res


# ----------------------------------------------------------------------
# Main path at full width
# ----------------------------------------------------------------------

def _kernels():
    """The kernel wrappers, whose ``launches`` count their kernels, and the
    plain twins, whose ``calls`` count theirs."""
    from kbmod_tpu_torch.ops import search_encoded_kernel as ek
    from kbmod_tpu_torch.ops.conv_kernel import psi_phi_conv, psi_phi_conv_plain
    from kbmod_tpu_torch.ops.search_kernel import search_topk, search_topk_shift

    from kbmod_tpu_torch.ops.exactrow_kernel import exactrow_accumulate, exactrow_accumulate_plain

    kernels = {"psi_phi_conv": psi_phi_conv, "search_topk": search_topk, "search_encoded": ek.search_encoded,
               "search_paired": ek.search_paired, "search_grouped": ek.search_grouped,
               "exactrow_accumulate": exactrow_accumulate}
    twins = {"psi_phi_conv_plain": psi_phi_conv_plain, "search_topk_shift": search_topk_shift,
             "search_topk_encoded_shift": ek.search_topk_encoded_shift,
             "exactrow_accumulate_plain": exactrow_accumulate_plain}
    return kernels, twins


def reset_counts():
    kernels, twins = _kernels()
    for fn in kernels.values():
        fn.launches = 0
    for fn in twins.values():
        fn.calls = 0


def read_counts():
    kernels, twins = _kernels()
    return ({k: fn.launches for k, fn in kernels.items()}, {k: fn.calls for k, fn in twins.items()})


def _check_best(tag, b, obj, min_obs):
    if (b.x, b.y) != (obj.x, obj.y) or abs(b.vx - obj.vx) > 1e-4 or abs(b.vy - obj.vy) > 1e-4:
        raise AssertionError(f"{tag}: best result {b} is not the injected object {obj}")
    if not (np.isfinite(b.lh) and np.isfinite(b.flux) and b.obs_count >= min_obs):
        raise AssertionError(f"{tag}: best result {b} is not finite with obs >= {min_obs}")


def make_main_stack(seed, T=64, size=2048):
    """The main paths' 64 x 2048 x 2048 FakeDataSet stack with one object
    on a grid point of the 41 x 41 KBMODV1Search grid."""
    from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
    from kbmod_tpu_torch.search import Trajectory
    from kbmod_tpu_torch.trajectory_generator import KBMODV1Search

    t0 = time.perf_counter()
    times = create_fake_times(T, t0=57130.2, obs_per_day=4, intra_night_gap=0.01, inter_night_gap=1)
    ds = FakeDataSet(size, size, times, psf_val=1.4, mask_fraction=0.01, use_seed=seed)
    cands = list(KBMODV1Search(41, 5.0, 45.0, 41, -0.5, 0.5))
    obj_c = 25 * 41 + 20  # angle step 25, speed step 20 of the grid
    obj = Trajectory(x=size * 3 // 10, y=size // 2, vx=cands[obj_c].vx, vy=cands[obj_c].vy, flux=150.0)
    ds.insert_object(obj)
    stack = ds.stack_py
    log(f"main stack: fake {T}x{size}x{size}, PSF {stack.psfs[0].shape}, {len(cands)} candidates, "
        f"object {obj} (made in {time.perf_counter() - t0:.2f} s)")
    return stack, obj, cands, obj_c


def main_path(stack, obj, cands, band=256):
    """The float path: full frame, then the sigma-G band (K1, K2)."""
    from kbmod_tpu_torch.search import StackSearch

    T, H, W = len(stack.sci), *np.asarray(stack.sci[0]).shape
    reset_counts()
    wall0 = time.perf_counter()
    search = StackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, -1)
    search.set_results_per_pixel(8)
    search.set_min_obs(T // 2)
    search.set_min_lh(10.0)
    search.search_all(cands, True)
    full_t = dict(search.timings)
    full_rows = {k: np.array(v) for k, v in search.results.get_arrays().items()}
    best = search.get_results(0, 1)[0]
    n_full = search.get_number_total_results()

    y0 = obj.y - band // 2
    search.set_start_bounds_y(y0, y0 + band)
    search.enable_gpu_sigmag_filter([0.25, 0.75], 0.7413, 10.0)
    search.search_all(cands, True)
    band_t = dict(search.timings)
    best_g = search.get_results(0, 1)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall0
    launches, twin_calls = read_counts()

    log(f"float path full frame: {n_full} results, best {best}")
    log(f"float path sigma-G band y=[{y0}, {y0 + band}) at K=32: best {best_g}")
    evals = H * W * len(cands)
    log(f"float path stage walls (ms): psi/phi build {full_t['psi_phi_ms']:.1f}, "
        f"search (K2) {full_t['search_ms']:.1f}, assembly {full_t['assemble_ms']:.1f}; "
        f"band search {band_t['search_ms']:.1f}, band assembly {band_t['assemble_ms']:.1f}; "
        f"{evals / (full_t['search_ms'] / 1e3):.4g} evals/s over the search stage; "
        f"whole path {wall:.2f} s")
    log(f"float path launches {launches}, twin calls {twin_calls}")

    for tag, b in (("float full frame", best), ("float sigma-G band", best_g)):
        _check_best(tag, b, obj, T // 2)
    if min(launches["psi_phi_conv"], launches["search_topk"]) <= 0:
        raise AssertionError(f"a kernel of the float path never launched: {launches}")
    if max(twin_calls.values()) != 0:
        raise AssertionError(f"a plain twin ran on the float path: {twin_calls}")
    return search, launches, full_rows, full_t


def quantized_path(stack, obj, cands, obj_c, band=256):
    """The quantized path on the same stack: four searches, each driven
    with the counts at 0 and read after, each through its kernel."""
    from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
    from kbmod_tpu_torch.search import StackSearch

    T, H, W = len(stack.sci), *np.asarray(stack.sci[0]).shape
    y0 = obj.y - band // 2
    sparse = [cands[i] for i in range(0, len(cands), 26)] + [cands[obj_c]]
    total = {}
    walls = {}
    searches = {}

    def drive(tag, kernel, fn):
        reset_counts()
        t0 = time.perf_counter()
        s = fn()
        torch.cuda.synchronize()
        walls[tag] = (time.perf_counter() - t0) * 1e3
        launches, twin_calls = read_counts()
        route = search_topk_encoded.last_route
        best = s.get_results(0, 1)[0]
        log(f"quantized {tag}: route {route}, {s.get_number_total_results()} results, best {best}; "
            f"stage walls (ms) {', '.join(f'{k} {v:.1f}' for k, v in s.timings.items())}; "
            f"launches {launches}, twin calls {twin_calls}")
        _check_best(f"quantized {tag}", best, obj, T // 2)
        if launches[kernel] <= 0:
            raise AssertionError(f"quantized {tag}: {kernel} never launched (route {route}): {launches}")
        if max(twin_calls.values()) != 0:
            raise AssertionError(f"quantized {tag}: a plain twin ran: {twin_calls}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return s

    def u8_full():
        s = StackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, 1)
        s.set_results_per_pixel(8)
        s.set_min_obs(T // 2)
        s.set_min_lh(10.0)
        s.search_all(cands, True)
        searches["u8"] = s
        # The un-tiled, one-device rows the ckpt and sharded phases equal.
        searches["u8_rows"] = {k: np.array(v) for k, v in s.results.get_arrays().items()}
        searches["u8_t"] = dict(s.timings)
        return s

    def u8_band_sigmag():
        s = searches["u8"]
        s.set_start_bounds_y(y0, y0 + band)
        s.enable_gpu_sigmag_filter([0.25, 0.75], 0.7413, 10.0)
        s.search_all(cands, True)
        return s

    def u16_band():
        s = StackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, 2)
        s.set_results_per_pixel(8)
        s.set_min_obs(T // 2)
        s.set_min_lh(10.0)
        s.set_start_bounds_y(y0, y0 + band)
        s.search_all(cands, True)
        searches["u16"] = s
        return s

    def u8_band_sparse():
        s = searches["u8"]
        s.disable_gpu_sigmag_filter()
        s.search_all(sparse, True)
        return s

    drive("u8 full frame (K5)", "search_grouped", u8_full)
    walls_full = dict(searches["u8"].timings)
    drive(f"u8 sigma-G band y=[{y0}, {y0 + band}) K=32 (K5)", "search_grouped", u8_band_sigmag)
    drive(f"u16 band y=[{y0}, {y0 + band}) (K3)", "search_encoded", u16_band)
    drive(f"u8 band, sparse {len(sparse)} candidates (K4)", "search_paired", u8_band_sparse)
    evals = H * W * len(cands)
    log(f"quantized path: u8 full-frame search stage {walls_full['search_ms']:.1f} ms = "
        f"{evals / (walls_full['search_ms'] / 1e3):.4g} evals/s; drive walls (ms) "
        f"{', '.join(f'{k}: {v:.1f}' for k, v in walls.items())}")
    log(f"quantized path launches (all four searches) {total}")
    return searches, sparse, total


def pipeline_path(stack, obj, card, dev):
    """The pipeline on the main stack: P1 (float) and P2 (uint8, in-kernel
    sigma-G pool), each a ``SearchRunner().run_search`` with the counts at 0
    just before and read just after. Returns (launches summed over both,
    {run: phase walls}, {run: (budget, peak)})."""
    import tempfile

    from kbmod_tpu_torch.configuration import SearchConfiguration
    from kbmod_tpu_torch.results import Results
    from kbmod_tpu_torch.run_search import SearchRunner, search_memory_budget

    generator = PIPELINE_GENERATOR
    runs = {
        "P1 float": (dict(), ("psi_phi_conv", "search_topk")),
        "P2 uint8": (dict(encode_num_bytes=1, gpu_filter=True, coadds=["mean", "median", "weighted"]),
                     ("psi_phi_conv", "search_grouped")),
    }
    total, walls, memory = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, (over, kernels) in runs.items():
            path = f"{tmp}/{tag.split()[0]}.ecsv"
            config = SearchConfiguration(dict(generator_config=generator, result_filename=path, save_config=False,
                                              **over))
            runner = SearchRunner()
            core = runner.do_core_search
            mem = {}

            def measured(config, stack, trj_generator):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                out = core(config, stack, trj_generator)
                torch.cuda.synchronize()
                mem["peak"] = torch.cuda.max_memory_allocated() - base
                mem["budget"] = search_memory_budget(config, stack, len(trj_generator), dev)
                return out

            runner.do_core_search = measured
            log(f"pipeline {tag}: window: the full {stack.height} x {stack.width} frame")
            reset_counts()
            t0 = time.perf_counter()
            keep = runner.run_search(config, stack)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, twin_calls = read_counts()
            back = Results.read_table(path)
            walls[tag] = {k: (v[1] - v[0]) * 1e3 for k, v in runner.phase_times.items()}
            memory[tag] = (mem["budget"]["total"], mem["peak"])
            log(f"pipeline {tag}: {len(keep)} rows in {wall:.2f} s, row 0 (x={keep['x'][0]}, y={keep['y'][0]}, "
                f"vx={keep['vx'][0]:.4f}, vy={keep['vy'][0]:.4f}, lh={keep['likelihood'][0]:.3f}, "
                f"obs={keep['obs_count'][0]}); launches {launches}, twin calls {twin_calls}")
            log(f"pipeline {tag} phase walls (ms): "
                + ", ".join(f"{k} {v:.1f}" for k, v in walls[tag].items()) + f"; {card}")
            log(f"pipeline {tag} memory over do_core_search: budget {mem['budget']['total']} bytes "
                f"({ {k: v for k, v in mem['budget'].items() if k != 'total'} }), measured peak {mem['peak']} bytes "
                f"above the {torch.cuda.memory_allocated()} allocated before; {card}")
            row0 = (keep["x"][0], keep["y"][0])
            if row0 != (obj.x, obj.y) or abs(keep["vx"][0] - obj.vx) > 1e-4 or abs(keep["vy"][0] - obj.vy) > 1e-4:
                raise AssertionError(f"pipeline {tag}: row 0 {row0} is not the injected object {obj}")
            if min(launches[k] for k in kernels) <= 0 or max(twin_calls.values()) != 0:
                raise AssertionError(f"pipeline {tag}: not through {kernels} alone: {launches}, {twin_calls}")
            if len(back) != len(keep) or any(not np.array_equal(back[k], keep[k])
                                              for k in ("x", "y", "vx", "vy", "obs_count", "likelihood")):
                raise AssertionError(f"pipeline {tag}: the ECSV file does not read back with the same rows")
            if mem["budget"]["total"] < mem["peak"]:
                raise AssertionError(f"pipeline {tag}: peak {mem['peak']} above the budget {mem['budget']}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
    return total, walls, memory


# ----------------------------------------------------------------------
# The search's switches, the exact sigma-G mode and stamp vetting
# ----------------------------------------------------------------------

@contextmanager
def switched(**env):
    """The environment switches set for the block and restored after it,
    whether or not it raises."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def drive(tag, kernels, fn):
    """Run ``fn`` with the counts at 0 just before and read just after; it
    must launch every kernel of ``kernels`` and no plain twin. Returns
    (fn's value, launches, wall ms)."""
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches, twin_calls = read_counts()
    log(f"{tag}: launches {launches}, twin calls {twin_calls}, wall {wall:.1f} ms")
    if min((launches[k] for k in kernels), default=1) <= 0 or max(twin_calls.values()) != 0:
        raise AssertionError(f"{tag}: not through {kernels} alone: {launches}, {twin_calls}")
    return out, launches, wall


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def switch_path(search, searches, obj, cands, full_rows, full_t, band=256):
    """The five result-changing switches on the main stack, each search
    driven with the counts at 0 and read after: the uint8 full frame with
    KB_SNAP_ROW_ERROR=0.75 (K5), the float sigma-G band with
    KB_SIGMAG_TOPK_FACTOR=8 and with KB_SIGMAG_AUTO=0 (K2), the float full
    frame with KB_COMPACT_RESULTS=0 (K2; the same rows as the compact
    layout). Returns the launches summed over the four."""
    from kbmod_tpu_torch.ops import search_encoded_kernel as ek
    from kbmod_tpu_torch.ops.search import snap_vy_rows, trajectory_offsets
    from kbmod_tpu_torch.ops.search_encoded import encoded_route, search_topk_encoded
    from kbmod_tpu_torch.ops.search_plan import _dedup_plan_cached

    T, H, W = search.num_images, search.height, search.width
    times = np.asarray(search.zeroed_times)
    vxs = np.array([c.vx for c in cands], np.float32)
    vys = np.array([c.vy for c in cands], np.float32)
    total = {}

    # uint8 full frame, vy snapped to the row lattice.
    u8 = searches["u8"]
    u8.set_start_bounds_y(0, H)
    u8.disable_gpu_sigmag_filter()
    u8.set_min_lh(10.0)
    snapped, n_vy = snap_vy_rows(vys, times, 0.75)
    rows_before = len(np.unique(trajectory_offsets(vxs, vys, times)[1], axis=0))
    dxs, dys = trajectory_offsets(vxs, snapped, times)
    rows_after = len(np.unique(dys, axis=0))
    with switched(KB_SNAP_ROW_ERROR="0.75"):
        _, launches, wall = drive("switch KB_SNAP_ROW_ERROR=0.75, u8 full frame (K5)", ("search_grouped",),
                                  lambda: u8.search_all(cands, True))
    _add(total, launches)
    route = search_topk_encoded.last_route
    best = u8.get_results(0, 1)[0]
    q = 2 * 0.75 / float(times.max())
    if (best.x, best.y) != (obj.x, obj.y) or abs(best.vx - obj.vx) > 1e-4 or abs(best.vy - obj.vy) > q + 1e-5:
        raise AssertionError(f"snapped u8 search: best {best} is not the object {obj} (lattice {q})")
    dedup = _dedup_plan_cached(dxs, dys, 1.1)
    u_dxs, u_dys = (dedup[0], dedup[1]) if dedup is not None else (dxs, dys)
    planes = u8._eval_planes()[0]
    _, plan = encoded_route(planes.psi_codes.dtype, T, u_dys)
    dx_t, dy_t = torch.as_tensor(u_dxs, device=planes.device), torch.as_tensor(u_dys, device=planes.device)
    k5_ms = event_ms(lambda: ek.search_grouped(planes, dx_t, dy_t, float(T // 2), 10.0, x_min=0, x_max=W, y_min=0,
                                               y_max=H, k_results=8, gate_min_lh=True, plan=plan), 3)
    log(f"switch KB_SNAP_ROW_ERROR=0.75: {len(np.unique(vys))} vy values -> {n_vy} after snapping "
        f"({rows_before} -> {rows_after} row-offset classes of {len(cands)} candidates; {len(u_dxs)} offset "
        f"classes searched), route {route}, K5 {k5_ms:.3f} ms ({len(plan[1])} groups), search stage "
        f"{u8.timings['search_ms']:.1f} ms, assembly {u8.timings['assemble_ms']:.1f} ms; best {best}")

    # The float sigma-G band with a deeper pool, and with the refinement off.
    y0 = obj.y - band // 2
    search.set_start_bounds_y(y0, y0 + band)
    search.enable_gpu_sigmag_filter([0.25, 0.75], 0.7413, 10.0)
    for name, value in (("KB_SIGMAG_TOPK_FACTOR", "8"), ("KB_SIGMAG_AUTO", "0")):
        with switched(**{name: value}):
            _, launches, wall = drive(f"switch {name}={value}, float sigma-G band y=[{y0}, {y0 + band}) (K2)",
                                      ("search_topk",), lambda: search.search_all(cands, True))
        _add(total, launches)
        _check_best(f"switch {name}={value}", search.get_results(0, 1)[0], obj, T // 2)
        log(f"switch {name}={value}: {search.get_number_total_results()} results, search stage "
            f"{search.timings['search_ms']:.1f} ms, assembly {search.timings['assemble_ms']:.1f} ms")

    # The float full frame in the dense layout: the same rows.
    search.set_start_bounds_y(0, H)
    search.disable_gpu_sigmag_filter()
    search.set_min_lh(10.0)
    with switched(KB_COMPACT_RESULTS="0"):
        _, launches, wall = drive("switch KB_COMPACT_RESULTS=0, float full frame (K2)", ("search_topk",),
                                  lambda: search.search_all(cands, True))
    _add(total, launches)
    rows = search.results.get_arrays()
    for k, v in full_rows.items():
        if not np.array_equal(rows[k], v):
            raise AssertionError(f"KB_COMPACT_RESULTS=0: column {k} differs from the compact layout's rows")
    log(f"switch KB_COMPACT_RESULTS=0: {len(rows['x'])} rows, equal to the compact layout's; search stage "
        f"{search.timings['search_ms']:.1f} ms, assembly {search.timings['assemble_ms']:.1f} ms "
        f"(compact: {full_t['assemble_ms']:.1f} ms)")
    return total


def exact_path(search, obj, cands, card, rows=64):
    """KB_SIGMAG_MODE=exact on a ``rows``-row float band holding the object,
    over every candidate: plain PyTorch on the card (the reference runs it
    in XLA), no kernel and no twin. The object must be the best result;
    every kept slot's clipped lh must equal the host ``clipped_sigmag_scores``
    of the same curves within twice the Queue 3 float64 bound. Returns its
    ms, the rows per second and the kept slots checked."""
    from kbmod_tpu_torch.ops import search as ops

    T, H, W = search.num_images, search.height, search.width
    y0 = obj.y - rows // 2
    search.set_start_bounds_y(y0, y0 + rows)
    search.enable_gpu_sigmag_filter([0.25, 0.75], 0.7413, 10.0)
    seen = {}
    exact = ops.search_topk_sigmag_exact

    def timed(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = exact(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        seen["ms"] = start.elapsed_time(end)
        seen["maps"] = out
        seen["args"] = (args, kw)
        return out

    ops.search_topk_sigmag_exact = timed
    try:
        with switched(KB_SIGMAG_MODE="exact"):
            _, launches, wall = drive(f"exact sigma-G, float band y=[{y0}, {y0 + rows}), {len(cands)} candidates",
                                      (), lambda: search.search_all(cands, True))
    finally:
        ops.search_topk_sigmag_exact = exact
    if max(launches.values()) != 0:
        raise AssertionError(f"exact sigma-G ran a search kernel: {launches}")
    best = search.get_results(0, 1)[0]
    _check_best("exact sigma-G band", best, obj, T // 2)

    # Every kept slot against the host function on its curves.
    top_lh, top_idx = (a.cpu().numpy() for a in seen["maps"])
    (psi, phi, valid, dxs, dys, *_), kw = seen["args"]
    k, i, j = np.nonzero(top_idx >= 0)
    cidx = top_idx[k, i, j]
    psi_v, phi_v, ok, _ = ops._eval_by_index_chunked(
        psi, phi, valid, (j + kw["x_min"]).astype(np.int32), (i + kw["y_min"]).astype(np.int32), cidx,
        dxs, dys, ops.EVAL_CHUNK, True, T)
    host_lh, _, _, host_phi = ops.clipped_sigmag_scores(psi_v, phi_v, ok, 0.25, 0.75, 0.7413)
    u = 2.0 ** -24
    root = np.sqrt(np.maximum(host_phi.astype(np.float64), 1e-300))
    tol = 2 * ((T + 1) * u * np.abs(np.where(ok, psi_v, 0)).astype(np.float64).sum(axis=1) / root
               + 2 * u * np.abs(host_lh))
    gap = np.abs(top_lh[k, i, j].astype(np.float64) - host_lh)
    if not np.all(gap <= tol):
        bad = int(np.argmax(gap - tol))
        raise AssertionError(f"exact sigma-G: slot {(k[bad], i[bad], j[bad])} lh {top_lh[k[bad], i[bad], j[bad]]} "
                             f"against the host's {host_lh[bad]} (bound {tol[bad]})")
    ms = seen["ms"]
    log(f"exact sigma-G band ({rows} x {W}, C={len(cands)}, K={top_lh.shape[0]}): {ms:.1f} ms, "
        f"{rows / (ms / 1e3):.4g} rows/s, {rows * W * len(cands) / (ms / 1e3):.4g} evals/s; {len(k)} kept slots "
        f"within the bound of the host re-score (largest gap {gap.max():.3g}, {float((gap / tol).max()):.3f} "
        f"of its bound); search stage {search.timings['search_ms']:.1f} ms, assembly "
        f"{search.timings['assemble_ms']:.1f} ms; best {best}; {card}")
    return ms, rows / (ms / 1e3), len(k)


def vetting_path(stack, obj, card, dev, generator=None, timed=VETTING_STAMPS):
    """Stamp vetting on the main stack. P3: the float pipeline with
    ``cnn_filter`` on a resnet18 state_dict drawn from torch.Generator(0)
    (written to a temporary directory), cnn_stamp_radius 10 and mean
    coadds, driven with the counts at 0 (K1, K2, no twin); the brightness
    filter and the known-object matcher (a fake WCS, a catalog made from
    the object's path) on its rows before clustering, where the object's
    row must match; then ``filter_stamps_by_cnn`` alone on 4,096 random
    21 x 21 stamps (resnet18) and 1,024 of 99 x 99 (resnet50, the
    configuration's default cnn_stamp_radius of 49), with the card's logits
    held to the CPU's. Returns the launches of P3 and the times."""
    import copy
    import tempfile

    from kbmod_tpu_torch.configuration import SearchConfiguration
    from kbmod_tpu_torch.filters.brightness_filters import apply_brightness_search_filter
    from kbmod_tpu_torch.filters.known_object_filters import KnownObjsMatcher
    from kbmod_tpu_torch.filters.stamp_filters import filter_stamps_by_cnn
    from kbmod_tpu_torch.models.cnn import StampClassifier
    from kbmod_tpu_torch.results import Results
    from kbmod_tpu_torch.run_search import SearchRunner
    from kbmod_tpu_torch.table import Table
    from kbmod_tpu_torch.trajectory_utils import trajectory_predict_skypos
    from kbmod_tpu_torch.wcs_utils import make_fake_wcs

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        weights = f"{tmp}/resnet18.pt"
        torch.save(StampClassifier("resnet18", 21, seed=0, device="cpu").model.state_dict(), weights)
        config = SearchConfiguration(dict(generator_config=generator or PIPELINE_GENERATOR,
                                          result_filename=f"{tmp}/P3.ecsv",
                                          save_config=False, coadds=["mean"], cnn_filter=True, cnn_model=weights,
                                          cnn_stamp_radius=10, cnn_coadd_type="mean"))
        runner = SearchRunner()
        core = runner.do_core_search
        pre = {}

        def keep_rows(config, stack, trj_generator):
            rows = core(config, stack, trj_generator)
            pre["rows"] = copy.deepcopy(rows)
            return rows

        runner.do_core_search = keep_rows
        keep, launches, wall = drive("pipeline P3 float with cnn_filter (K1, K2)", ("psi_phi_conv", "search_topk"),
                                     lambda: runner.run_search(config, stack))
        walls = {k: (v[1] - v[0]) * 1e3 for k, v in runner.phase_times.items()}
        log(f"pipeline P3: {len(keep)} rows in {wall / 1e3:.2f} s, row 0 (x={keep['x'][0]}, y={keep['y'][0]}, "
            f"prob_real={keep['prob_real'][0]:.4f}, prob_bogus={keep['prob_bogus'][0]:.4f}, "
            f"cnn_class={keep['cnn_class'][0]}); phase walls (ms): "
            + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()) + f"; {card}")
        if (keep["x"][0], keep["y"][0]) != (obj.x, obj.y) or not np.all(np.isfinite(keep["prob_real"])):
            raise AssertionError(f"pipeline P3: row 0 is not the object or the CNN columns are not finite")
        out["cnn_phase_ms"] = walls["cnn filtering"]
        out["launches"] = launches

    # The brightness and known-object filters on the rows before clustering.
    rows = pre["rows"]
    n_rows = len(rows)
    bright = copy.deepcopy(rows)
    t0 = time.perf_counter()
    apply_brightness_search_filter(bright, stack)
    out["brightness_ms"] = (time.perf_counter() - t0) * 1e3
    kept = set(zip(np.asarray(bright["x"]).tolist(), np.asarray(bright["y"]).tolist()))
    wcs = make_fake_wcs(200.0, -7.0, stack.height, stack.width, 0.27 / 3600.0)
    sky = trajectory_predict_skypos(obj, wcs, np.asarray(stack.times))
    catalog = Table({"Name": np.array(["object"] * stack.num_times, dtype=object), "RA": sky.ra_deg,
                     "DEC": sky.dec_deg, "mjd_mid": np.asarray(stack.times)})
    t0 = time.perf_counter()
    matcher = KnownObjsMatcher(catalog, np.asarray(stack.times), "known", sep_thresh=0.5)
    matcher.match(rows, wcs)
    out["known_ms"] = (time.perf_counter() - t0) * 1e3
    at = [r for r in range(n_rows) if (rows["x"][r], rows["y"][r]) == (obj.x, obj.y)
          and abs(rows["vx"][r] - obj.vx) < 1e-4 and abs(rows["vy"][r] - obj.vy) < 1e-4]
    matched = [r for r in range(n_rows) if rows["known"][r]]
    log(f"vetting before clustering: {n_rows} rows; brightness filter kept {len(bright)} in "
        f"{out['brightness_ms']:.1f} ms (object kept: {(obj.x, obj.y) in kept}); known-object matcher "
        f"{out['known_ms']:.1f} ms, {len(matched)} rows matched; object rows {at}")
    for r in at:
        valid = np.asarray(rows["obs_valid"][r], dtype=bool)
        hits = np.asarray(rows["known"][r].get("object", [False] * len(valid)), dtype=bool)
        if not np.array_equal(hits, valid):
            raise AssertionError(f"known-object matcher: the object's row {r} matched at {hits}, valid at {valid}")
    if not at:
        raise AssertionError("known-object matcher: no row before clustering is the object")

    # filter_stamps_by_cnn alone, and the card's logits against the CPU's.
    rng = np.random.default_rng(7)
    for model_type, n, radius in timed:
        width = 2 * radius + 1
        stamps = rng.normal(0.0, 1.0, (n, width, width)).astype(np.float32)
        res = Results({"x": np.zeros(n, int), "y": np.zeros(n, int), "vx": np.zeros(n), "vy": np.zeros(n),
                       "likelihood": np.zeros(n), "flux": np.zeros(n), "obs_count": np.zeros(n, int),
                       "coadd_mean": stamps})
        filter_stamps_by_cnn(res, None, model_type=model_type, stamp_radius=radius, coadd_radius=radius)
        t0 = time.perf_counter()
        filter_stamps_by_cnn(res, None, model_type=model_type, stamp_radius=radius, coadd_radius=radius)
        call_ms = (time.perf_counter() - t0) * 1e3
        clf = StampClassifier(model_type, width, seed=0)
        net_ms = event_ms(lambda: clf.predict(stamps), 3)
        got = clf.predict(stamps[:64])
        want = StampClassifier(model_type, width, seed=0, device="cpu").predict(stamps[:64])
        tol = 1e-4 * (1.0 + np.abs(want).max())
        err = float(np.abs(got - want).max())
        if not (np.all(np.isfinite(res["prob_real"])) and err <= tol):
            raise AssertionError(f"{model_type}: card logits {err} from the CPU's (tolerance {tol})")
        out[model_type] = (call_ms, net_ms, n)
        log(f"filter_stamps_by_cnn {model_type}, {n} stamps of {width} x {width}: {call_ms:.1f} ms "
            f"({n / (call_ms / 1e3):.4g} stamps/s, normalization and weights included); predict alone "
            f"{net_ms:.1f} ms ({n / (net_ms / 1e3):.4g} stamps/s); logits within {err:.3g} of the CPU's "
            f"(tolerance {tol:.3g}); {card}")
    return out


# ----------------------------------------------------------------------
# Checkpoint/resume, the sharded search and the profiler
# ----------------------------------------------------------------------

def _configure_full(s, T, H):
    """The main path's full-frame search settings on a StackSearch."""
    s.set_start_bounds_y(0, H)
    s.disable_gpu_sigmag_filter()
    s.set_results_per_pixel(8)
    s.set_min_obs(T // 2)
    s.set_min_lh(10.0)


def _rows_equal(tag, got, want):
    """Every column of the result rows equal, in the same order."""
    for k in CKPT_RESULT_KEYS:
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{tag}: column {k} differs from the one-device, un-tiled search")


def ckpt_child(directory, seed):
    """The half of the ckpt phase that is killed: the uint8 full-frame
    search of the main stack, checkpointed in CKPT_TILE_ROWS-row tiles into
    ``directory``, each tile followed by a pause of CKPT_CHILD_PAUSE_S so
    that the kill lands mid-search. Never meant to finish."""
    from kbmod_tpu_torch.ops import search as ops
    from kbmod_tpu_torch.search import StackSearch

    stack, _, cands, _ = make_main_stack(seed)
    T, H = len(stack.sci), stack.height
    s = StackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, 1)
    _configure_full(s, T, H)
    s.enable_search_checkpointing(directory, tile_rows=CKPT_TILE_ROWS)
    search = ops.core_search

    def paced(*args, **kw):
        out = search(*args, **kw)
        time.sleep(CKPT_CHILD_PAUSE_S)
        return out

    ops.core_search = paced
    log("ckpt child: searching")
    s.search_all(cands, True)
    log("ckpt child: finished every tile")
    return 0


def ckpt_path(search, searches, stack, cands, full_rows, full_t, seed, card):
    """Checkpoint/resume on the main stack. A child process (this script
    with --ckpt-child) runs the uint8 full-frame search (K5) in 8 tiles of
    256 rows and is killed with SIGKILL once two tiles are on disk; this
    process resumes it: the rows must equal the un-tiled search's, the
    finished tiles must be loaded (no hidden tmp file) and only the rest
    computed. Then one code of plane 3, which the JAX package's 8-plane
    sample skips, is changed: the directory must be discarded. Last, the
    float full frame (K2) in 8 tiles, equal to its un-tiled rows. Returns
    the launches of the driven searches and the numbers printed."""
    import signal
    import tempfile

    from kbmod_tpu_torch.search import StackSearch

    T, H, W = len(stack.sci), stack.height, stack.width
    total, out = {}, {}
    # A search set up exactly as the child's (the quantized path's has
    # carried other settings, which the fingerprint covers).
    u8 = StackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, 1)
    _configure_full(u8, T, H)
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "u8")
        child_log = os.path.join(tmp, "child.log")
        t0 = time.perf_counter()
        with open(child_log, "w") as f:
            child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ckpt-child", ck, "--seed",
                                      str(seed)], stdout=f, stderr=subprocess.STDOUT)
        deadline = time.monotonic() + CKPT_CHILD_TIMEOUT_S
        try:
            while True:
                names = os.listdir(ck) if os.path.isdir(ck) else []
                if sum(n.startswith("tile_") and n.endswith(".npz") for n in names) >= 2:
                    child.send_signal(signal.SIGKILL)
                    break
                if child.poll() is not None or time.monotonic() > deadline:
                    with open(child_log) as f:
                        tail = f.read()[-2000:]
                    raise AssertionError(f"ckpt child ended ({child.returncode}) or timed out before two tiles:\n{tail}")
                time.sleep(0.01)
        finally:
            if child.poll() is None:
                child.kill()
            child.wait()
        names = sorted(os.listdir(ck))
        done = [n for n in names if n.startswith("tile_") and n.endswith(".npz")]
        hidden = [n for n in names if n.startswith(".")]
        log(f"ckpt: child killed (signal {-child.returncode}) after {time.perf_counter() - t0:.1f} s with "
            f"{len(done)} of {H // CKPT_TILE_ROWS} tiles on disk {done}, hidden {hidden}")
        if child.returncode != -signal.SIGKILL:
            raise AssertionError(f"ckpt child was not killed by SIGKILL: exit {child.returncode}")

        u8.enable_search_checkpointing(ck, tile_rows=CKPT_TILE_ROWS)
        loaded = []
        real_load = np.load

        def spy(path, *args, **kw):
            loaded.append(os.path.basename(path))
            return real_load(path, *args, **kw)

        np.load = spy
        try:
            _, launches, wall = drive("ckpt: u8 full frame resumed after SIGKILL (K5)", ("search_grouped",),
                                      lambda: u8.search_all(cands, True))
        finally:
            np.load = real_load
        _add(total, launches)
        _rows_equal("ckpt resumed u8 full frame", u8.results.get_arrays(), searches["u8_rows"])
        t = dict(u8.timings)
        if t["tiles_loaded"] != len(done) or sorted(loaded) != done:
            raise AssertionError(f"ckpt: loaded {sorted(loaded)} ({t['tiles_loaded']}), on disk {done}")
        if launches["search_grouped"] != H // CKPT_TILE_ROWS - len(done):
            raise AssertionError(f"ckpt: K5 launched {launches['search_grouped']} times for "
                                 f"{H // CKPT_TILE_ROWS - len(done)} tiles left")
        out["resume"] = dict(wall=wall, **t)
        log(f"ckpt: resumed, {t['tiles_loaded']} tiles loaded, {H // CKPT_TILE_ROWS - len(done)} computed; rows "
            f"bit-equal to the un-tiled search; wall {wall:.1f} ms, fingerprint {t['fingerprint_ms']:.1f} ms, "
            f"search {t['search_ms']:.1f} ms, assembly {t['assemble_ms']:.1f} ms; {card}")

        # One code of a plane the JAX package's sample (every 8th) skips.
        pairs = u8._eval_planes()[0].pairs
        py, px = H // 2 - 24, W // 2 - 24
        old = int(pairs[3, py, px, 0])
        pairs[3, py, px, 0] = old % 255 + 1
        try:
            _, launches, wall = drive("ckpt: u8 full frame, one code of plane 3 changed (K5)", ("search_grouped",),
                                      lambda: u8.search_all(cands, True))
        finally:
            pairs[3, py, px, 0] = old
        _add(total, launches)
        t = dict(u8.timings)
        if t["tiles_loaded"] != 0 or launches["search_grouped"] != H // CKPT_TILE_ROWS:
            raise AssertionError(f"ckpt: a changed plane-3 code did not discard the directory: {t}, {launches}")
        del u8, pairs
        untiled = searches["u8_t"]
        out["u8"] = dict(tiled_ms=wall, search_ms=t["search_ms"], assemble_ms=t["assemble_ms"],
                         fingerprint_ms=t["fingerprint_ms"], untiled_search_ms=untiled["search_ms"],
                         untiled_assemble_ms=untiled["assemble_ms"])
        log(f"ckpt: the changed plane-3 code discarded the directory (0 tiles loaded, 8 computed); u8 full frame "
            f"in 8 tiles: search {t['search_ms']:.1f} ms + assembly {t['assemble_ms']:.1f} ms + fingerprint "
            f"{t['fingerprint_ms']:.1f} ms (drive wall {wall:.1f} ms) against un-tiled {untiled['search_ms']:.1f} + "
            f"{untiled['assemble_ms']:.1f} ms; {card}")

        # The float full frame (K2) in 8 tiles.
        _configure_full(search, T, H)
        search.enable_search_checkpointing(os.path.join(tmp, "float"), tile_rows=CKPT_TILE_ROWS)
        _, launches, wall = drive("ckpt: float full frame in 8 tiles (K2)", ("search_topk",),
                                  lambda: search.search_all(cands, True))
        search.enable_search_checkpointing(None)
        _add(total, launches)
        _rows_equal("ckpt float full frame", search.results.get_arrays(), full_rows)
        t = dict(search.timings)
        out["float"] = dict(tiled_ms=wall, search_ms=t["search_ms"], assemble_ms=t["assemble_ms"],
                            fingerprint_ms=t["fingerprint_ms"], untiled_search_ms=full_t["search_ms"],
                            untiled_assemble_ms=full_t["assemble_ms"])
        per_tile = (t["search_ms"] + t["assemble_ms"] - full_t["search_ms"] - full_t["assemble_ms"]) / 8
        log(f"ckpt: float full frame in 8 tiles, rows bit-equal to un-tiled; search {t['search_ms']:.1f} ms + "
            f"assembly {t['assemble_ms']:.1f} ms + fingerprint {t['fingerprint_ms']:.1f} ms (drive wall "
            f"{wall:.1f} ms) against un-tiled {full_t['search_ms']:.1f} + {full_t['assemble_ms']:.1f} ms: "
            f"{per_tile:.1f} ms a tile; {card}")
    return total, out


def _f64_bound_ok(search, rows, T):
    """Whether each row's lh lies within the ROADMAP Queue 3 float64 bound
    of its own curves: |lh - lh64| <= (T + 1) u sum|psi| / sqrt(sum phi) +
    2 u |lh64|. Returns (ok, the largest gap over its bound)."""
    from kbmod_tpu_torch.search import TrajectoryList

    curves = search.get_all_psi_phi_curves(TrajectoryList({k: np.asarray(v) for k, v in rows.items()}))
    psi, phi = curves[:, :T].astype(np.float64), curves[:, T:].astype(np.float64)
    root = np.sqrt(np.maximum(phi.sum(axis=1), 1e-300))
    lh64 = psi.sum(axis=1) / root
    u = 2.0 ** -24
    bound = (T + 1) * u * np.abs(psi).sum(axis=1) / root + 2 * u * np.abs(lh64)
    ratio = np.abs(np.asarray(rows["lh"], np.float64) - lh64) / bound
    return bool(np.all(ratio <= 1.0)), float(ratio.max()) if len(ratio) else 0.0


def sharded_path(search, searches, stack, obj, cands, full_rows, card, dev, band=256):
    """The sharded search on the main stack over a mesh of two shards on
    cuda:0 (every card when there are more), each search driven through
    ``StackSearch.search_all`` with KB_SHARDED=1 and the counts at 0:
    uint8 candidates mode (K5 a shard; rows and maps equal to one device),
    float pixels mode (K2 a shard; rows equal), float time mode on a
    32-row band over all 1,681 candidates (plain PyTorch partial sums over
    candidate chunks, no kernel; the same rows, lh within the float64
    bound), sigma-G over-provisioned on the 256-row band (candidates, K2;
    rows equal); the u8 candidates and time runs' memory peaks held to
    ``run_search.search_memory_budget`` for the same search; then alone:
    ``sharded_sigmag_exact_topk`` on a 16-row band (equal to one device) and
    ``sharded_psi_phi_build`` (K1 a shard; equal to a one-shard build).
    Returns the launches and {mode: (sharded ms, one-device ms)}."""
    import kbmod_tpu_torch.parallel.sharded as sharded
    from kbmod_tpu_torch.configuration import SearchConfiguration
    from kbmod_tpu_torch.ops import search as ops
    from kbmod_tpu_torch.ops.search import trajectory_offsets
    from kbmod_tpu_torch.run_search import search_memory_budget

    T, H, W = len(stack.sci), stack.height, stack.width
    n = torch.cuda.device_count()
    devices = [dev] * 2 if n == 1 else [torch.device("cuda", i) for i in range(n)]
    mesh = sharded.build_mesh(devices=devices)
    shards = len(devices)
    total, walls = {}, {}
    vxs = np.array([c.vx for c in cands], np.float32)
    vys = np.array([c.vy for c in cands], np.float32)
    dxs, dys = trajectory_offsets(vxs, vys, stack.zeroed_times)

    def one_device(s, grid=cands):
        t0 = time.perf_counter()
        with switched(KB_SHARDED="0"):
            s.search_all(grid, True)
        torch.cuda.synchronize()
        return {k: np.array(v) for k, v in s.results.get_arrays().items()}, (time.perf_counter() - t0) * 1e3

    peaks = {}

    def measured(tag, fn):
        """fn, its device memory peak above what was allocated before kept
        under peaks[tag]."""
        def run():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = fn()
            torch.cuda.synchronize()
            peaks[tag] = torch.cuda.max_memory_allocated() - base
            return out
        return run

    def within_budget(tag, num_bytes, y0, y1, mode):
        """The search's peak against the budget of a configuration that
        runs the same search (K 8, the rows [y0, y1), the whole grid)."""
        config = SearchConfiguration(dict(encode_num_bytes=num_bytes, results_per_pixel=8, num_obs=T // 2,
                                          lh_level=10.0, y_pixel_bounds=[y0, y1], save_config=False))
        with switched(KB_SHARDED="1", KB_SHARD_MODE=mode):
            budget = search_memory_budget(config, stack, len(cands), dev)
        log(f"sharded {tag} memory: peak {peaks[tag]} bytes, budget {budget['total']} bytes "
            f"(shards term {budget['shards']}); {card}")
        if peaks[tag] > budget["total"]:
            raise AssertionError(f"sharded {tag}: the peak {peaks[tag]} exceeds the budget {budget['total']}")

    real_build = sharded.build_mesh
    sharded.build_mesh = lambda: mesh
    try:
        # uint8 full frame, candidates mode: K5 a shard with its own plan.
        u8 = searches["u8"]
        _configure_full(u8, T, H)
        with switched(KB_SHARDED="1", KB_SHARD_MODE="candidates"):
            _, launches, wall = drive(f"sharded u8 full frame, candidates mode, {mesh} (K5 a shard)",
                                      ("search_grouped",), measured("u8 candidates", lambda: u8.search_all(cands, True)))
        _add(total, launches)
        within_budget("u8 candidates", 1, 0, H, "candidates")
        if launches["search_grouped"] != shards:
            raise AssertionError(f"sharded u8: K5 launched {launches['search_grouped']} times for {shards} shards")
        _rows_equal("sharded u8 candidates", u8.results.get_arrays(), searches["u8_rows"])
        u8_t = searches["u8_t"]
        walls["u8 candidates (K5)"] = (wall, u8_t["search_ms"] + u8_t["assemble_ms"])
        planes = u8._eval_planes()[0]
        kw = dict(x_min=0, x_max=W, y_min=0, y_max=H, k_results=8, gate_min_obs=True, gate_min_lh=True)
        one = ops._local_topk(planes, None, None, dxs, dys, sigmag_mode="", min_obs=float(T // 2), min_lh=10.0,
                              sgl_L=0.25, sgl_H=0.75, sigmag_coeff=0.7413, has_masked=False, **kw)
        two = sharded.sharded_search_topk(planes, None, None, dxs, dys, mesh, min_obs=float(T // 2), min_lh=10.0,
                                          **kw)
        if not (torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])):
            raise AssertionError("sharded u8: the merged K5 maps differ from the one-device maps")
        del one, two
        log(f"sharded u8 candidates: rows and (8, {H}, {W}) maps bit-equal to one device; wall {wall:.1f} ms "
            f"against one device's search + assembly {walls['u8 candidates (K5)'][1]:.1f} ms; {card}")

        # The float full frame, pixels mode: K2 a shard.
        _configure_full(search, T, H)
        with switched(KB_SHARDED="1", KB_SHARD_MODE="pixels"):
            _, launches, wall = drive("sharded float full frame, pixels mode (K2 a shard)", ("search_topk",),
                                      lambda: search.search_all(cands, True))
        _add(total, launches)
        if launches["search_topk"] != shards:
            raise AssertionError(f"sharded float pixels: K2 launched {launches['search_topk']} times")
        _rows_equal("sharded float pixels", search.results.get_arrays(), full_rows)
        _, ms_one = one_device(search)
        walls["float pixels (K2)"] = (wall, ms_one)
        log(f"sharded float pixels: rows bit-equal to one device; wall {wall:.1f} ms against {ms_one:.1f} ms; {card}")

        # Time mode on a 32-row band over the whole grid: plain PyTorch, no
        # kernel and no twin.
        y0 = obj.y - 16
        search.set_start_bounds_y(y0, y0 + 32)
        rows_one, ms_one = one_device(search)
        reset_counts()
        t0 = time.perf_counter()
        with switched(KB_SHARDED="1", KB_SHARD_MODE="time"):
            measured("float time", lambda: search.search_all(cands, True))()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches, twin_calls = read_counts()
        log(f"sharded float time mode, band y=[{y0}, {y0 + 32}), {len(cands)} candidates: launches {launches}, "
            f"twin calls {twin_calls}, wall {wall:.1f} ms")
        if max(launches.values()) != 0 or max(twin_calls.values()) != 0:
            raise AssertionError(f"sharded time mode: a kernel or a twin ran: {launches}, {twin_calls}")
        within_budget("float time", -1, y0, y0 + 32, "time")
        rows = {k: np.array(v) for k, v in search.results.get_arrays().items()}
        key = ("x", "y", "vx", "vy", "obs_count")
        if sorted(zip(*(rows[k].tolist() for k in key))) != sorted(zip(*(rows_one[k].tolist() for k in key))):
            raise AssertionError("sharded time mode: the rows differ from the one-device search's")
        ok_t, worst_t = _f64_bound_ok(search, rows, T)
        ok_1, worst_1 = _f64_bound_ok(search, rows_one, T)
        if not (ok_t and ok_1):
            raise AssertionError(f"sharded time mode: lh outside the float64 bound ({worst_t}, one device {worst_1})")
        _check_best("sharded time mode", search.get_results(0, 1)[0], obj, T // 2)
        walls[f"float time, 32 rows, {len(cands)} candidates (plain)"] = (wall, ms_one)
        log(f"sharded float time mode: {len(rows['x'])} rows, the one-device rows; lh within the float64 bound "
            f"(largest gap {worst_t:.3f} of it; one device {worst_1:.3f}); max |lh diff| "
            f"{float(np.abs(np.sort(rows['lh']) - np.sort(rows_one['lh'])).max()):.3g}; wall {wall:.1f} ms against "
            f"K2's {ms_one:.1f} ms; {card}")

        # sigma-G, over-provisioned pool, on the 256-row band: candidates, K2.
        y0 = obj.y - band // 2
        search.set_start_bounds_y(y0, y0 + band)
        search.enable_gpu_sigmag_filter([0.25, 0.75], 0.7413, 10.0)
        rows_one, ms_one = one_device(search)
        with switched(KB_SHARDED="1", KB_SHARD_MODE="candidates"):
            _, launches, wall = drive(f"sharded float sigma-G band y=[{y0}, {y0 + band}), candidates (K2 a shard)",
                                      ("search_topk",), lambda: search.search_all(cands, True))
        _add(total, launches)
        _rows_equal("sharded sigma-G band", search.results.get_arrays(), rows_one)
        _check_best("sharded sigma-G band", search.get_results(0, 1)[0], obj, T // 2)
        walls["float sigma-G band (K2)"] = (wall, ms_one)
        log(f"sharded sigma-G band: rows bit-equal to one device; wall {wall:.1f} ms against {ms_one:.1f} ms; {card}")
        search.disable_gpu_sigmag_filter()
    finally:
        sharded.build_mesh = real_build

    # The exact sigma-G search over candidates, 16 rows.
    psi, phi, valid = search._eval_planes()
    y0 = obj.y - 8
    ex = dict(x_min=0, x_max=W, y_min=y0, y_max=y0 + 16, k_results=8, sgl_L=0.25, sgl_H=0.75)
    dev = psi.device
    times = {}
    t0 = time.perf_counter()
    one = ops.search_topk_sigmag_exact(psi, phi, valid, torch.as_tensor(dxs, device=dev),
                                       torch.as_tensor(dys, device=dev), T // 2, 10.0, 0.7413, **ex)
    torch.cuda.synchronize()
    times["one"] = (time.perf_counter() - t0) * 1e3
    reset_counts()
    t0 = time.perf_counter()
    two = sharded.sharded_sigmag_exact_topk(psi, phi, valid, dxs, dys, mesh, min_obs=T // 2, min_lh=10.0,
                                            sigmag_coeff=0.7413, **ex)
    torch.cuda.synchronize()
    times["two"] = (time.perf_counter() - t0) * 1e3
    launches, twin_calls = read_counts()
    if max(launches.values()) != 0 or max(twin_calls.values()) != 0:
        raise AssertionError(f"sharded exact sigma-G ran a kernel or twin: {launches}, {twin_calls}")
    if not (torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])):
        raise AssertionError("sharded exact sigma-G: the maps differ from the one-device exact search")
    walls["exact sigma-G, 16 rows (plain)"] = (times["two"], times["one"])
    log(f"sharded exact sigma-G, 16 rows: maps equal to one device; {times['two']:.1f} ms against "
        f"{times['one']:.1f} ms; {card}")
    del one, two

    # The psi/phi build, the time axis split over the shards: K1 a shard.
    sci, var = stack.stacked_sci(), stack.stacked_var()
    psf = np.asarray(stack.psfs[0], np.float32)
    reset_counts()
    t0 = time.perf_counter()
    two = sharded.sharded_psi_phi_build(sci, var, psf, mesh)
    torch.cuda.synchronize()
    ms_two = (time.perf_counter() - t0) * 1e3
    launches, twin_calls = read_counts()
    log(f"sharded psi/phi build: launches {launches}, twin calls {twin_calls}, wall {ms_two:.1f} ms")
    if launches["psi_phi_conv"] != shards or max(twin_calls.values()) != 0:
        raise AssertionError(f"sharded build: not K1 once a shard: {launches}, {twin_calls}")
    _add(total, launches)
    t0 = time.perf_counter()
    one = sharded.sharded_psi_phi_build(sci, var, psf, sharded.build_mesh(devices=devices[:1]))
    torch.cuda.synchronize()
    ms_one = (time.perf_counter() - t0) * 1e3
    if not all(torch.equal(a, b) for a, b in zip(one, two)):
        raise AssertionError("sharded build: psi, phi or the validity plane differ from the one-shard build")
    walls["psi/phi build (K1)"] = (ms_two, ms_one)
    log(f"sharded psi/phi build ({T} x {H} x {W}): psi, phi and validity bit-equal to the one-shard build "
        f"({int(one[2].numel() - one[2].sum())} invalid); {ms_two:.1f} ms against {ms_one:.1f} ms (host copies "
        f"included); {card}")
    del one, two
    log("sharded walls (ms, sharded against one device): "
        + "; ".join(f"{k}: {a:.1f} / {b:.1f}" for k, (a, b) in walls.items()) + f"; {shards} shards; {card}")
    return total, walls


def profile_path(stack, obj, card):
    """One P1 pipeline run with KB_PROFILE_DIR set, driven with the counts at
    0 (K1, K2): one Chrome trace must be written, naming the K1 and K2
    launches (their ``record_function`` labels); the device kernels it
    holds are counted. Returns the launches."""
    import glob
    import tempfile

    from kbmod_tpu_torch.configuration import SearchConfiguration
    from kbmod_tpu_torch.run_search import SearchRunner

    with tempfile.TemporaryDirectory() as tmp:
        config = SearchConfiguration(dict(generator_config=PIPELINE_GENERATOR, save_config=False))
        with switched(KB_PROFILE_DIR=tmp):
            keep, launches, wall = drive("profile: pipeline P1 float with KB_PROFILE_DIR (K1, K2)",
                                         ("psi_phi_conv", "search_topk"),
                                         lambda: SearchRunner().run_search(config, stack))
        if (keep["x"][0], keep["y"][0]) != (obj.x, obj.y):
            raise AssertionError("profile: row 0 of the profiled P1 is not the object")
        traces = glob.glob(os.path.join(tmp, "kbmod_trace_*.json"))
        if len(traces) != 1:
            raise AssertionError(f"profile: {len(traces)} trace files written, not one")
        size = os.path.getsize(traces[0])
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
    names = [str(e.get("name", "")) for e in events]
    labels = {k: sum(n == k for n in names) for k in ("kbmod K1 psi_phi_conv", "kbmod K2 search_topk")}
    kernels = [n for e, n in zip(events, names) if e.get("cat") == "kernel"]
    device = {"K1": sum("conv_tiled" in n or "conv_generic" in n for n in kernels),
              "K2": sum("search_topk_kernel" in n for n in kernels)}
    log(f"profile: trace of {size} bytes, {len(events)} events; launch labels {labels} (launches {launches}); "
        f"{len(kernels)} device kernel events, of them K1 {device['K1']}, K2 {device['K2']}; profiled P1 wall "
        f"{wall:.1f} ms; {card}")
    if min(labels.values()) < 1:
        raise AssertionError(f"profile: the trace does not name the K1 and K2 launches: {labels}")
    if min(device.values()) < 1:
        log("profile: warning: the trace holds no device kernel events for K1 or K2 (CUPTI)")
    return launches


# ----------------------------------------------------------------------
# Kernel times at the main path's shapes
# ----------------------------------------------------------------------

def time_k1(stack, dev):
    from kbmod_tpu_torch.ops.conv_kernel import psi_phi_conv, psi_phi_conv_plain

    sci = torch.as_tensor(stack.stacked_sci(), device=dev)
    var = torch.as_tensor(stack.stacked_var(), device=dev)
    k = torch.as_tensor(np.asarray(stack.psfs[0], np.float32), device=dev)
    T, H, W = sci.shape
    kh, kw = k.shape
    got = psi_phi_conv(sci, var, k)
    ms = event_ms(lambda: psi_phi_conv(sci, var, k), 21)
    log(f"K1 timed; clocks (sm, max sm, power, temperature): {clocks()}")
    ref = psi_phi_conv_plain(sci, var, k)
    plain_ms = event_ms(lambda: psi_phi_conv_plain(sci, var, k), 1)
    err = _assert_k1_equal("main-path shapes", got, ref)
    del got, ref
    from kbmod_tpu_torch.ops.conv_kernel import _lib as _k1_lib

    # Issue floors: 8 instructions a tap and pixel with no fused multiply-add
    # at all; 6 with the mask terms fused (their products are exact).
    taps = T * H * W * kh * kw
    log(f"K1 ({kh}x{kw}): {_k1_lib().kb_psi_phi_conv_blocks_per_sm(kh, kw)} blocks per SM; issue floor "
        f"{8 * taps / 32 / WARP_INSTR_PER_S * 1e3:.3f} ms at 8 instructions a tap, "
        f"{6 * taps / 32 / WARP_INSTR_PER_S * 1e3:.3f} ms at 6")
    # Library yardstick: cuDNN's grouped convolution of the four derived
    # planes, TF32 off. Timed only; the port never calls it.
    valid = torch.isfinite(sci) & torch.isfinite(var) & (var > 0)
    zero = torch.zeros((), device=dev)
    planes = torch.stack(
        [torch.where(valid, sci / var, zero), torch.where(valid, 1.0 / var, zero),
         valid.float(), valid.float()], dim=1)
    weight = torch.stack([k, k * k, k, k * k])[:, None]
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        conv = lambda: torch.nn.functional.conv2d(planes, weight, padding=(kh // 2, kw // 2), groups=4)
        conv()
        library_ms = event_ms(conv, 21)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    del planes, valid
    bound_ms, bound_by = bound(16 * T * H * W + 4 * (kh * kw + 2), 8 * kh * kw * T * H * W)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, err=err, shape=f"T={T} {H}x{W} psf {kh}x{kw}")


def _valid_samples(valid, ox, oy, SH, SW):
    """Exact count of in-bounds valid (pixel, candidate, time) samples, from
    per-plane summed-area tables of the validity plane."""
    T, H, W = valid.shape
    sat = torch.zeros((T, H + 1, W + 1), dtype=torch.int64, device=valid.device)
    sat[:, 1:, 1:] = valid.to(torch.int64).cumsum(1).cumsum(2)
    r0, r1 = oy.clamp(0, H), (oy + SH).clamp(0, H)
    c0, c1 = ox.clamp(0, W), (ox + SW).clamp(0, W)
    t = torch.arange(T, device=valid.device)[None, :].expand_as(ox)
    s = sat[t, r1, c1] - sat[t, r0, c1] - sat[t, r1, c0] + sat[t, r0, c0]
    return int(s.sum())


def _staged_traffic(lay, px_bytes, SH, SW, tile_rows, tile_cols, ms):
    """The bytes a grouped kernel copies into shared memory in one search,
    from its window layout (every block stages every (group, t) step), and
    the rate that is over the kernel's time."""
    blocks = -(-SH // tile_rows) * -(-SW // tile_cols)
    staged = int((lay[..., 0].astype(np.int64) * lay[..., 1] * lay[..., 2]).sum()) * px_bytes * blocks
    slabs = float((lay[..., 0] > 1).mean())
    return (f"{staged / 1e12:.3f} TB staged ({staged / (ms / 1e3) / 1e12:.2f} TB/s over the kernel's time; "
            f"{slabs:.1%} of (group, t) steps stage one slab per member)")


def time_k2(search, cands, dev, bounds=None, K=8, twin_rows=None):
    """K2 at a float search's shapes and settings (min_obs T/2, min_lh 10
    with the insertion gated on it, as the full-frame search with
    results_per_pixel 8 and the sigma-G band search with its pool of 4 x 8
    run): median of 3 launches by CUDA events, the twin once, the bound.
    ``bounds`` defaults to the full frame; ``twin_rows`` holds the kernel to
    the twin on that many rows of the window only (a long list makes the
    twin slow)."""
    from kbmod_tpu_torch.ops.search import trajectory_offsets
    from kbmod_tpu_torch.ops.search_kernel import _lib as _k2_lib
    from kbmod_tpu_torch.ops.search_kernel import k2_staging, search_topk, search_topk_shift

    psi, phi, valid = search.psi_phi_array.decoded_psi_phi()
    T, H, W = psi.shape
    bounds = bounds or dict(x_min=0, x_max=W, y_min=0, y_max=H)
    SH, SW = bounds["y_max"] - bounds["y_min"], bounds["x_max"] - bounds["x_min"]
    vxs = np.array([c.vx for c in cands], np.float32)
    vys = np.array([c.vy for c in cands], np.float32)
    dxs, dys = trajectory_offsets(vxs, vys, search.zeroed_times)
    dxs, dys = torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev)
    C = len(cands)
    kw = dict(k_results=K, gate_min_lh=True, **bounds)
    args = (psi, phi, valid, dxs, dys, float(T // 2), 10.0)
    got = search_topk(*args, **kw)
    ms = event_ms(lambda: search_topk(*args, **kw), 3)
    log(f"K2 timed ({SH}x{SW}, K={K}); clocks (sm, max sm, power, temperature): {clocks()}")
    if twin_rows:
        kw = dict(kw, y_max=bounds["y_min"] + twin_rows)
        got = search_topk(*args, **kw)
    t0 = time.perf_counter()
    ref = search_topk_shift(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rows = kw["y_max"] - kw["y_min"]
    err, _ = _assert_k2_equal(f"main-path shapes {SH}x{SW} K={K} (twin over {rows} rows)", got, ref)
    st = k2_staging(dxs.cpu().numpy(), dys.cpu().numpy(), bounds["x_min"], bounds["y_min"])
    log(f"K2 ({SH}x{SW}, K={K}): {len(st['starts'])} groups, {st['smem_bytes']} bytes of shared memory, "
        f"{_k2_lib().kb_search_topk_blocks_per_sm(K, st['smem_bytes'])} blocks per SM; "
        + _staged_traffic(st["lay"], 9, SH, SW, 4, 256, ms))
    n_samples = _valid_samples(valid, dxs + bounds["x_min"], dys + bounds["y_min"], SH, SW)
    nbytes = (4 + 4 + 1) * T * H * W + 8 * C * T + 8 * K * SH * SW
    # 3 adds per valid sample; a sqrt, a divide and K compares per
    # (pixel, candidate).
    nops = 3 * n_samples + (2 + K) * SH * SW * C
    bound_ms, bound_by = bound(nbytes, nops)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                err=err, shape=f"T={T} {SH}x{SW} window, C={C}, K={K}, {n_samples} valid samples",
                evals_per_s=SH * SW * C / (ms / 1e3))


def _default_survey_grid(C, n_vel_default=257):
    """A copy of the JAX package's ``default_survey_grid`` (bench.py:133-143):
    257 speeds x 129 angles about the ecliptic, in px per time unit."""
    n_vel = n_vel_default if C == 257 * 129 else max(1, int(np.sqrt(C)))
    n_ang = C // n_vel + (1 if C % n_vel else 0)
    vel = np.linspace(92.0, 526.0, n_vel) / 86.0
    ang = np.linspace(-np.pi / 15, np.pi / 15, n_ang)
    vv, aa = np.meshgrid(vel, ang)
    vxs = (np.cos(aa) * vv).reshape(-1)[:C].astype(np.float32)
    vys = (np.sin(aa) * vv).reshape(-1)[:C].astype(np.float32)
    return vxs, vys


def _both_valid(planes):
    from kbmod_tpu_torch.ops.psi_phi import _codes_as_int

    return ((_codes_as_int(planes.psi_codes) > 0) & (_codes_as_int(planes.phi_codes) > 0)).to(torch.uint8)


def _encoded_bound(planes, dx_t, dy_t, bounds, K):
    """Bound of one encoded search: the codes read once (2 or 4 bytes a
    pixel and time), the offsets, the maps written once; per valid
    in-window sample three int32 adds (psi code, phi code, count), or 1.5
    where the sums fit 16 bits (uint8 with T * 255 <= 65535), since then one
    add sums two columns as the two 16-bit fields of a register, as K4
    does; and per (pixel, candidate) the decode (6 float ops), a sqrt, a
    divide and K compares."""
    T, H, W = planes.shape
    SH, SW = bounds["y_max"] - bounds["y_min"], bounds["x_max"] - bounds["x_min"]
    C = dx_t.shape[0]
    n_samples = _valid_samples(_both_valid(planes), dx_t + bounds["x_min"], dy_t + bounds["y_min"], SH, SW)
    code_bytes = 2 * planes.psi_codes.element_size()
    nbytes = code_bytes * T * H * W + 8 * C * T + 8 * K * SH * SW
    adds = 1.5 if planes.psi_codes.dtype == torch.uint8 and T * 255 <= 65535 else 3
    return bound(nbytes, (8 + K) * SH * SW * C, adds * n_samples), n_samples


def time_encoded(kernel, planes, times, cands, bounds, K, min_obs, min_lh, dev, twin_rows=None):
    """One encoded kernel at a main-path search's shapes and settings
    (gate on min_lh, as those searches run): median of 3 launches by CUDA
    events, the twin once (on ``twin_rows`` rows of the window only, when
    given), the bound."""
    from kbmod_tpu_torch.ops import _build
    from kbmod_tpu_torch.ops import search_encoded_kernel as ek
    from kbmod_tpu_torch.ops.search import trajectory_offsets
    from kbmod_tpu_torch.ops.search_encoded import encoded_route

    T = planes.shape[0]
    vxs = np.array([c.vx for c in cands], np.float32)
    vys = np.array([c.vy for c in cands], np.float32)
    dxs, dys = trajectory_offsets(vxs, vys, times)
    dx_t, dy_t = torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev)
    wrapper = {"K3": ek.search_encoded, "K4": ek.search_paired, "K5": ek.search_grouped}[kernel]
    kw = dict(k_results=K, gate_min_lh=True, **bounds)
    extra = dict(plan=encoded_route(planes.psi_codes.dtype, T, dys)[1]) if kernel == "K5" else {}
    run = lambda: wrapper(planes, dx_t, dy_t, min_obs, min_lh, **kw, **extra)  # noqa: E731
    got = run()
    ms = event_ms(run, 3)
    log(f"{kernel} timed; clocks (sm, max sm, power, temperature): {clocks()}")
    kw_twin = kw
    if twin_rows:
        kw_twin = dict(kw, y_max=bounds["y_min"] + twin_rows)
        got = wrapper(planes, dx_t, dy_t, min_obs, min_lh, **kw_twin, **extra)
    t0 = time.perf_counter()
    ref = ek.search_topk_encoded_shift(planes.psi_codes, planes.phi_codes, dx_t, dy_t, min_obs, min_lh,
                                       planes.em, **kw_twin)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, _ = _assert_k2_equal("main-path shapes", got, ref, kernel)
    SH, SW = bounds["y_max"] - bounds["y_min"], bounds["x_max"] - bounds["x_min"]
    groups = "groups"
    if kernel == "K4":
        lib = _build.load("search_topk_encoded", ek._PAIRED_SIGNATURES)
        st = ek.k4_staging(dxs, dys, bounds["x_min"], bounds["y_min"])
        ngroups, bpsm = len(st["starts"]), lib.kb_search_paired_blocks_per_sm(K, st["smem_bytes"])
        px, tile, groups = 2, (ek.K4_TILE_ROWS, ek.K4_TILE_COLS), "batches in index order"
    elif kernel == "K5":
        lib = _build.load("search_topk_grouped", ek._GRP_SIGNATURES)
        st = ek.k5_staging(dxs, dys, bounds["x_min"], bounds["y_min"], extra["plan"])
        ngroups, bpsm = len(extra["plan"][1]), lib.kb_search_grouped_blocks_per_sm(K, st["smem_bytes"])
        px, tile = 2, (ek.K5_TILE_ROWS, ek.K5_TILE_COLS)
    else:
        lib = _build.load("search_topk_encoded_grouped", ek._K3_SIGNATURES)
        bits = 8 * planes.psi_codes.element_size()
        st = ek.k3_staging(dxs, dys, bounds["x_min"], bounds["y_min"], bits)
        ngroups, bpsm = len(st["starts"]), lib.kb_search_encoded_blocks_per_sm(bits, K, st["smem_bytes"])
        px, tile = bits // 4, (ek.K3_TILE_ROWS, ek.K3_TILE_COLS)
    log(f"{kernel} (K={K}): {ngroups} {groups}, {st['smem_bytes']} bytes of shared memory, {bpsm} blocks per SM; "
        + _staged_traffic(st["lay"], px, SH, SW, *tile, ms))
    (bound_ms, bound_by), n_samples = _encoded_bound(planes, dx_t, dy_t, bounds, K)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by, err=err,
                shape=f"u{8 * planes.psi_codes.element_size()} T={T} {SH}x{SW} window, C={len(cands)}, "
                      f"K={K}, {n_samples} valid samples",
                evals_per_s=SH * SW * len(cands) / (ms / 1e3))


def time_midscale(dev, T=64, size=2048, C=257 * 129, K=8):
    """K5 through the dispatcher (dedup + K5 + expansion) at the JAX
    package's midscale_kernel shapes: random uint8 codes, times linspace(0,
    4, 64), the default survey grid, K = 8, min_obs 10. A 256-row band when
    one search over the full frame takes over 60 s."""
    from kbmod_tpu_torch.ops import search_encoded_kernel as ek
    from kbmod_tpu_torch.ops.search import trajectory_offsets
    from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
    from kbmod_tpu_torch.ops.search_plan import _dedup_plan_cached

    rng = np.random.default_rng(42)
    psi = rng.integers(0, 256, (T, size, size), dtype=np.uint8)
    phi = rng.integers(1, 256, (T, size, size), dtype=np.uint8)
    planes = _planes(psi, phi, MIDSCALE_EM, dev)
    del psi, phi
    vxs, vys = _default_survey_grid(C)
    dxs, dys = trajectory_offsets(vxs, vys, np.linspace(0.0, 4.0, T))
    kw = dict(x_min=0, x_max=size, y_min=0, y_max=size, k_results=K)
    ek.search_grouped.launches = 0
    t0 = time.perf_counter()
    lh, idx = search_topk_encoded(planes, dxs, dys, 10.0, 0.0, **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    cut = None
    if first_s > 60:
        kw["y_max"] = 256
        cut = f"256-row band (one full-frame search took {first_s:.1f} s)"
    route = search_topk_encoded.last_route
    run = lambda: search_topk_encoded(planes, dxs, dys, 10.0, 0.0, **kw)  # noqa: E731
    ms = event_ms(run, 3)
    log(f"midscale timed; clocks (sm, max sm, power, temperature): {clocks()}")
    lh, idx = run()
    filled = idx >= 0
    if not (bool(torch.isfinite(lh[filled]).all()) and int(idx.max()) < C and bool(filled[0].any())):
        raise AssertionError("midscale: top-K maps are not finite, in range and filled")
    dedup = _dedup_plan_cached(dxs, dys, 1.1)
    u_dxs, u_dys = (dxs, dys) if dedup is None else dedup[:2]
    bounds = {k: kw[k] for k in ("x_min", "x_max", "y_min", "y_max")}
    (bound_ms, bound_by), n_samples = _encoded_bound(
        planes, torch.as_tensor(u_dxs, device=dev), torch.as_tensor(u_dys, device=dev), bounds, K)
    SH = kw["y_max"] - kw["y_min"]
    evals = SH * size * C
    log(f"midscale (dedup + K5 + expansion): route {route}, {len(u_dxs)} offset classes of {C} candidates, "
        f"{ms:.3f} ms per search over {SH}x{size} (first search {first_s:.2f} s, "
        f"{ek.search_grouped.launches} K5 launches in all), {evals / (ms / 1e3):.4g} evals/s, "
        f"bound {bound_ms:.3f} ms ({bound_by}, {n_samples} valid samples of the classes)"
        + (f"; cut to a {cut}" if cut else ""))
    return dict(ms=ms, evals_per_s=evals / (ms / 1e3), bound_ms=bound_ms, route=route, cut=cut)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checks-only", action="store_true", help="build and check the kernels, then stop")
    ap.add_argument("--seed", type=int, default=20261016, help="seed of the main path's fake data")
    ap.add_argument("--ckpt-child", metavar="DIR",
                    help="run the ckpt phase's checkpointed search into DIR (the ckpt phase starts and kills it)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.ckpt_child:
        return ckpt_child(args.ckpt_child, args.seed)
    from kbmod_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = gpu_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"clocks at start (sm, max sm, power, temperature): {clocks()}")

    t0 = time.perf_counter()
    logs = _build.build(SOURCES)
    for name, text in logs.items():
        log(f"nvcc {name}.cu:\n{text.strip() or '(already built)'}")
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name in REPORTED:
        for fn, regs, st, ld in ptxas_summary(logs[name]):
            log(f"ptxas {name}.cu {fn}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")

    t0 = time.perf_counter()
    err_k1 = check_k1(dev)
    err_k2 = check_k2(dev)
    err_enc = check_encoded(dev)
    err_long = check_long_t(dev)
    err_k6 = check_k6(dev)
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")
    if args.checks_only:
        log(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

    stack, obj, cands, obj_c = make_main_stack(args.seed)
    search, launches_f, full_rows, full_t = main_path(stack, obj, cands)
    searches, sparse, launches_q = quantized_path(stack, obj, cands, obj_c)
    launches_p, _, _ = pipeline_path(stack, obj, card, dev)
    launches_s = switch_path(search, searches, obj, cands, full_rows, full_t)
    exact_path(search, obj, cands, card)
    vetting = vetting_path(stack, obj, card, dev)
    launches_c, _ = ckpt_path(search, searches, stack, cands, full_rows, full_t, args.seed, card)
    launches_sh, _ = sharded_path(search, searches, stack, obj, cands, full_rows, card, dev)
    launches_prof = profile_path(stack, obj, card)
    launches_k6 = k6_path()
    k1 = time_k1(stack, dev)
    T, H, W = len(stack.sci), *np.asarray(stack.sci[0]).shape
    y0 = obj.y - 128
    full = dict(x_min=0, x_max=W, y_min=0, y_max=H)
    band = dict(x_min=0, x_max=W, y_min=y0, y_max=y0 + 256)
    k2 = time_k2(search, cands, dev)
    # The sigma-G band search's K2 launch: a pool of 4 x 8, the same gates.
    k2_band = time_k2(search, cands, dev, band, 32)
    # Lists of 128, kept in the maps, on the band with the same gates.
    k2_long = time_k2(search, cands, dev, band, 128, twin_rows=16)
    del search
    u8 = searches["u8"]._eval_planes()[0]
    u16 = searches["u16"]._eval_planes()[0]
    times = stack.zeroed_times
    k5 = time_encoded("K5", u8, times, cands, full, 8, float(T // 2), 10.0, dev)
    # The sigma-G band search's K5 launch: K = 32, the same gates.
    k5_band = time_encoded("K5", u8, times, cands, band, 32, float(T // 2), 10.0, dev)
    k3 = time_encoded("K3", u16, times, cands, band, 8, float(T // 2), 10.0, dev)
    k3_long = time_encoded("K3", u16, times, cands, band, 128, float(T // 2), 10.0, dev, twin_rows=16)
    k4 = time_encoded("K4", u8, times, sparse, band, 8, float(T // 2), 10.0, dev)
    del searches, u8, u16
    torch.cuda.empty_cache()
    mid = time_midscale(dev)
    k6 = time_k6(dev)
    for name, r in (("K1 psi_phi_conv", k1), ("K2 search_topk", k2), ("K2 search_topk, band", k2_band),
                    ("K2 search_topk, band, K = 128", k2_long), ("K3 search_encoded", k3),
                    ("K3 search_encoded, band, K = 128", k3_long), ("K4 search_paired", k4),
                    ("K5 search_grouped", k5), ("K5 search_grouped, band", k5_band)):
        log(f"{name} at {r['shape']}: {r['ms']:.3f} ms, twin {r['plain_ms']:.1f} ms, "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), library {r['library_ms']}"
            + (f", {r['evals_per_s']:.4g} evals/s" if "evals_per_s" in r else ""))
    log(f"K5 midscale through the dispatcher: {mid['ms']:.3f} ms, {mid['evals_per_s']:.4g} evals/s")

    def entry(name, src, replaces, launches, err, r):
        return dict(name=name, route="cuda", source=f"kbmod_tpu_torch/csrc/{src}",
                    replaces=replaces if replaces.startswith("scripts/") else f"kbmod_tpu/ops/{replaces}",
                    launches=launches, max_abs_err=max(err, r["err"]),
                    ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"])

    launches = {k: launches_f[k] + launches_q[k] + launches_p.get(k, 0) + launches_s.get(k, 0)
                + vetting["launches"].get(k, 0) + launches_c.get(k, 0) + launches_sh.get(k, 0)
                + launches_prof.get(k, 0) for k in launches_f}
    entries = [
        entry("psi_phi_conv", "psi_phi_conv.cu", "conv_pallas.py:32", launches["psi_phi_conv"], err_k1, k1),
        entry("search_topk", "search_topk.cu", "search_pallas.py:182", launches["search_topk"],
              max(err_k2, k2_band["err"], k2_long["err"], err_long["K2"]), k2),
        entry("search_encoded", "search_topk_encoded_grouped.cu", "search_pallas.py:505", launches["search_encoded"],
              max(err_enc["K3"], k3_long["err"], err_long["K3"]), k3),
        entry("search_paired", "search_topk_encoded.cu", "search_pallas.py:916", launches["search_paired"],
              err_enc["K4"], k4),
        entry("search_grouped", "search_topk_grouped.cu", "search_pallas.py:1493", launches["search_grouped"],
              max(err_enc["K5"], k5_band["err"], err_long["K5"]), k5),
        # K6 at midscale's group count, in mode C (K5's inner loop); its
        # launches are those of its own path, the micro-benchmark script.
        entry("exactrow_accumulate", "exactrow_microbench.cu", "scripts/exactrow_microbench.py:49", launches_k6,
              err_k6, k6[(K6_MIDSCALE_NG, "C")]),
    ]
    print(json.dumps({"kernels": entries}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
