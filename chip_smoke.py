#!/usr/bin/env python3
"""Run the kbmod_tpu_torch port on one CUDA card and check it end to end.

    python3 chip_smoke.py                # everything, one card
    python3 chip_smoke.py --checks-only  # build + kernel-against-twin checks

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card's name and power limit (nvidia-smi);
2. the nvcc build of every CUDA kernel, all sources compiled together, and
   the g++ build of the native host library;
3. kernel checks: each kernel against its plain PyTorch twin on the card
   (K1 over PSFs from 1 x 1 to 21 x 21, and the twin run on the CPU
   against K1 for each, bit for bit; K2; K3, K4 and K5 over
   uint8/uint16 codes, T up to 300; K2-K5 with lists of K = 128, past the
   64 that registers hold; the grouped kernels K2, K5 and K3 at
   T = 1,000-1,500, past the T their tables once capped; dedup; K6 in
   modes A, B and C; K7 against the exact sigma-G twin on the card, lh
   within 1e-5 relative, also past T = 128 and K = 32), and each redesigned
   kernel's ptxas registers and spills;
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
   (K7, no other kernel and no twin): its time and rows per second,
   every kept slot's clipped lh against the host's re-score of the same
   curves, the object best, the memory peak within ``search_memory_budget``;
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
   ``sharded_sigmag_exact_topk`` on a 16-row band (K7 a shard) and
   ``sharded_psi_phi_build`` (K1 a shard), each equal to one device; each
   wall beside the one-device wall;
12. profile: one P1 pipeline run with KB_PROFILE_DIR, whose Chrome trace
   must name the K1 and K2 launches (the tracer's ``kbmod:kernel.*``
   ranges) and whose stage file must hold the build, search and phases;
13. K6's own path, the micro-benchmark script
   (``kbmod_tpu_torch.scripts.exactrow_microbench``), driven with the
   counts at 0 and read after;
14. workunit: the main stack as a WorkUnit, every image under one WCS
   (0.2 arcsec pixels), reprojected on the card onto a common WCS shifted by
   (3.3, 2.7) pixels and rotated by 0.2 degrees (``reproject_work_unit``,
   adaptive; the host coordinates, the card's resampling and the whole call
   timed; every NaN must lie in the uncovered border or within the
   stencil's reach of a masked pixel); ``run_search_from_work_unit`` on it
   with the pipelines' configuration (K1, K2, no twin): row 0 within a grid
   step of the object's trajectory mapped into the common frame (the
   positions at the mean observation time, the speed and angle), its
   ``global_ra``/``global_dec`` no further from the object's true sky path
   than row 0's own pixel path plus half a pixel; the WorkUnit through
   ``to_fits``/``from_fits`` (every layer equal) and the ``kbmod_search``
   command in a child process on the card (its row 0 equal); then the
   tools on that file and the child's results, in this process through
   their ``main(argv)``: ``kbmod_stats``, ``kbmod_strip_results`` (the
   curves and obs_valid dropped), ``kbmod_filter --workunit --sigma_g_bnds
   25,75 --device cuda`` (one K1 launch, driven with the counts at 0; the
   rebuilt curves bit-equal to the child's, obs_valid equal, row 0 still
   the best row), ``kbmod_stamps``
   (mean, median and sum coadds on the card, the sum equal to the child's),
   ``Visualizer.generate_all_stamps`` on the card and ``kbmod_version
   --full`` in a child, which must name the card; each tool's wall; a
   native RICE_1 round trip and a sharded one of four layers;
15. discovery: the main stack as 64 KBMODV1 exposures on disk (four
   pointings a whole number of pixels apart, NO_DATA borders, BAD masked
   pixels, times through DATE-AVG), a collection from the
   ``kbmod_build_ic`` command in a child and from ``fromDir`` here (equal
   tables; ``toWorkUnit`` equal to the stack with the shifts undone,
   times within 1e-8 d; ``grow_mask`` timed alone beside a file's read),
   ``RegionSearch`` naming the 2,040-pixel patch centred on the field by
   the object's ephemeris and the ``region_searcher`` command exporting
   it with 64 rows, the patch's WorkUnit reprojected on the card, 16
   objects injected (magnitudes 20.9-21.6, more than 60 pixels apart),
   ``run_search_from_work_unit`` (K1, K2, no twin) recovering them and the
   main object (``match_injection_results``), ``refine_all_results`` on
   the 17 rows (one K1 build, K2 at K = 1 over 101 x 101 windows; each
   row within 2 pixels and 1 px/d of its object, one row an object),
   ``evaluate_around_linear_trajectory`` (K2 with K = 615, the list in
   the maps), ``evaluate_linear_trajectory`` and
   ``core.shift_and_stack.generate_psi_phi_images`` (K1, equal to the
   search's plane 0), and K2 at both new shapes against its twin;
16. survey: the ported entry-point scripts' functions
   (``kbmod_tpu_torch/scripts/``): the reference's regression
   configuration at full size (``regression.run``: 20 x 1024 x 512, 20
   objects, 2 starting off the chip, the 26 x 52 EclipticCenteredSearch
   grid, the default sigma-G pool, ``run_search_from_work_unit``; K1, K2,
   no twin; all 20 recovered and the file's metadata read back); the
   pipeline gate (``survey_pipeline_gate.run``) at T = 100 and the full
   33,153-candidate grid on a 2048 x 2048 frame (the script's 4096 cut for
   time), row tiles, uint8 (K1, K5, no twin; 20 of 20 in the final file,
   the route, the phase walls, the peak RSS, the device peak within
   ``search_memory_budget``); ``survey_scale.run`` at the same size over
   the 12-day default lattice, its 64 x 64 centre window bit-equal to the
   twin;
17. examples: the port's worked examples (``kbmod_tpu_torch/examples/``)
   through their default device, the card, with their own asserts: 01-06,
   09, 10, 12 and 13 (07, 08 and 11 plot with matplotlib, which the card's
   machine lacks: CPU tests only), each driven with the counts at 0 and read
   after (01, 03 and 05 through K1 and K2, 12 and 13 through K2; no twin
   anywhere), each wall; then the five search examples again on the host
   with ``DEVICE="cpu"`` in this process: x, y, vx, vy, obs_count and the
   row order as the card's (rows whose lh lie within each other's rounding
   may trade places), lh and flux within twice ROADMAP Queue 3's float32
   bound of the row's sums;
18. each kernel's time at the main path's shapes beside its twin's, its
   bound and (K1) cuDNN's grouped convolution, as one JSON line (K2 and K5
   at both of their main-path shapes: the full frame at K = 8 and the
   sigma-G band at K = 32, each held against the twin); K2 and K3 with
   lists of K = 128 (kept in the maps) on the band; K5 through the
   dispatcher (dedup + K5 + expansion) at the JAX package's
   ``midscale_kernel`` shapes (T = 64, 2048 x 2048, C = 33,153, K = 8);
   K5 at the benchmark's band cell's shapes (100 x 256 x 4096 random uint8
   codes over 1.35 days, the 257 x 129 EclipticCenteredSearch grid of
   33,153 candidates, its grouping plan, K = 8, min_obs 10, the min_lh gate
   at 10) beside its twin on 8 rows and its bound, with the tracer's
   counts of its steps on each path and its launches counted;
   K6's three modes at the script's defaults and at NG = 3,015; and K7 at
   the regression's shapes (20 x 1024 x 512 planes, the 1,044 x 532
   window of its pixel buffers, its 1,352 candidates, K = 8, min_obs 15,
   lh_level 25) beside its twin on the card and its bound;
   launches summed over every path above;
19. as the last line, {"ok": true, "device": {...}}.

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
           "exactrow_microbench", "sigmag_exact_topk"]
# Sources whose kernels were redesigned for the card: their ptxas register
# and spill lines are printed on their own.
REPORTED = ("psi_phi_conv", "search_topk", "search_topk_encoded", "search_topk_grouped", "search_topk_encoded_grouped",
            "exactrow_microbench", "sigmag_exact_topk")
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
    width and height are multiples of neither tile; and against the twin run
    on the CPU, which reads the same host-built tap table."""
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
    sci_h, var_h = torch.as_tensor(sci), torch.as_tensor(var)
    for name, psf in psfs:
        k = torch.as_tensor(psf, device=dev)
        got = psi_phi_conv(sci_d, var_d, k)
        ref = psi_phi_conv_plain(sci_d, var_d, k)
        torch.cuda.synchronize()
        worst = max(worst, _assert_k1_equal(name, got, ref))
        # The twin on the host reads the same tap table: the CPU's build is
        # the card's, bit for bit.
        host = psi_phi_conv_plain(sci_h, var_h, psf)
        worst = max(worst, _assert_k1_equal(f"{name} (the CPU's twin)", [g.cpu() for g in got], host))
        log(f"K1 check {name} psf {tuple(psf.shape)}: ok (bit-equal to the twin on the card and on the CPU)")
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
    from kbmod_tpu_torch.ops.search import EncodedPlanes, trajectory_offsets
    from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
    from kbmod_tpu_torch.ops.search_plan import _plan_groups

    wrappers = {"K3": ek.search_encoded, "K4": ek.search_paired, "K5": ek.search_grouped}
    worst = {k: 0.0 for k in wrappers}
    for kernel, bits, T, H, W, C in ENCODED_CONFIGS:
        rng = np.random.default_rng(T + bits)
        psi, phi = _code_stack(rng, T, H, W, bits)
        em = MIDSCALE_EM if bits == 8 else np.array([-6.0, 12.0 / 65534, 0.1, 4.0 / 65534], np.float32)
        planes = EncodedPlanes.from_codes(psi, phi, em, dev)
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
    planes = EncodedPlanes.from_codes(psi, phi, MIDSCALE_EM, dev)
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
    from kbmod_tpu_torch.ops.search import EncodedPlanes, trajectory_offsets
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
            planes = EncodedPlanes.from_codes(psi, phi, em, dev)
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


def _k7_against_twin(tag, args, kw):
    """K7 (``search_topk_sigmag_exact`` on the card) against its plain twin
    on the card (the dispatch held to the twin): the same slots filled, lh
    within 1e-5 * max(1, |lh|) at every slot (the sums run in another order;
    where the indices differ, the two candidates' lh tie within that).
    Returns (K7's maps, the twin's, its ms, the largest gap over its
    bound, the slots whose indices differ)."""
    from kbmod_tpu_torch.ops import search as ops

    got = ops.search_topk_sigmag_exact(*args, **kw)
    route = ops.k7_route
    ops.k7_route = lambda device: "twin"
    try:
        t0 = time.perf_counter()
        ref = ops.search_topk_sigmag_exact(*args, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ops.k7_route = route
    (g_lh, g_idx), (r_lh, r_idx) = ([a.cpu().numpy() for a in m] for m in (got, ref))
    if not np.array_equal(g_idx < 0, r_idx < 0):
        raise AssertionError(f"K7 {tag}: {int(((g_idx < 0) != (r_idx < 0)).sum())} slots filled on one side only")
    filled = r_idx >= 0
    bound_ = 1e-5 * np.maximum(1.0, np.abs(r_lh[filled].astype(np.float64)))
    gap = np.abs(g_lh[filled].astype(np.float64) - r_lh[filled]) / bound_
    worst = float(gap.max()) if gap.size else 0.0
    if worst > 1.0:
        raise AssertionError(f"K7 {tag}: lh {worst:.3g} times the bound from the twin's")
    return got, ref, plain_ms, worst, int((g_idx != r_idx).sum())


def check_k7(dev):
    """K7 against its twin on the card: T = 20, 12 and 150 (past the 128
    samples whose curves K7 sorts in local memory, so they are walked) over a
    64 x 96 window starting at negative x and y, 60 candidates (a third
    leaving the frame, two copies of candidate 3 for exact ties), 5% masked
    samples, spikes of both signs for the clipping to cut, K = 8, 1 and 40
    (past the 32 held in registers, so the list stays in the maps), both
    signs of the coefficient, a non-zero cand_offset. Returns the largest lh
    gap over its bound."""
    from kbmod_tpu_torch.ops.search import trajectory_offsets

    worst = 0.0
    for T, K, coeff in ((20, 8, 0.7413), (12, 1, -0.7413), (150, 40, 0.7413)):
        rng = np.random.default_rng(T)
        H, W, C = 64, 96, 60
        valid = (rng.uniform(size=(T, H, W)) > 0.05).astype(np.uint8)
        psi = rng.normal(1.0, 0.5, (T, H, W))
        hit = rng.random((T, H, W)) < 0.05
        psi[hit] = rng.choice([-30.0, 30.0], int(hit.sum()))
        planes = [torch.as_tensor(a, device=dev) for a in (
            np.where(valid, psi, 0).astype(np.float32),
            np.where(valid, rng.uniform(0.5, 2.0, (T, H, W)), 0).astype(np.float32), valid)]
        speed = np.where(np.arange(C) % 3 == 0, 12.0, 3.0)
        dxs, dys = trajectory_offsets(rng.uniform(-1, 1, C) * speed, rng.uniform(-1, 1, C) * speed,
                                      np.arange(T) * 0.3 * min(1.0, 20 / T))
        dxs[[10, 40]], dys[[10, 40]] = dxs[3], dys[3]
        kw = dict(x_min=-3, x_max=93, y_min=-2, y_max=62, k_results=K, sgl_L=0.25, sgl_H=0.75, cand_offset=500)
        args = (*planes, torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev), T // 2, 0.5, coeff)
        got, _, _, gap, differ = _k7_against_twin(f"T={T} K={K}", args, kw)
        idx = got[1].cpu().numpy()
        for s in np.nonzero((idx == 503).any(axis=0).ravel() & (idx == 510).any(axis=0).ravel())[0]:
            col = list(idx.reshape(K, -1)[:, s])
            if col.index(503) > col.index(510):
                raise AssertionError(f"K7 T={T}: exact tie ranked against the index at slot column {s}")
        worst = max(worst, gap)
        log(f"K7 against its twin, T={T} K={K} coeff {coeff}: lh within {gap:.3f} of the bound, {differ} slots "
            f"with another index (ties)")
    return worst


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

def reset_counts():
    """Every kernel's launch count and every twin's call count set to 0
    (scripts/_common, by function name)."""
    from kbmod_tpu_torch.scripts._common import reset_counts as reset

    reset()


def read_counts():
    """({kernel: launches}, {twin: calls}) since :func:`reset_counts`."""
    from kbmod_tpu_torch.scripts._common import read_counts as read

    return read()


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
    over every candidate: K7 on the card (the reference runs it in XLA), no
    other kernel and no twin. The object must be the best result;
    every kept slot's clipped lh must equal the host ``clipped_sigmag_scores``
    of the same curves within twice the Queue 3 float64 bound; the memory
    peak over ``search_all`` must stay inside ``search_memory_budget`` of the
    same search. Returns its launches."""
    from types import SimpleNamespace

    from kbmod_tpu_torch.configuration import SearchConfiguration
    from kbmod_tpu_torch.ops import search as ops
    from kbmod_tpu_torch.run_search import search_memory_budget

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
    config = SearchConfiguration(dict(results_per_pixel=8, gpu_filter=True, y_pixel_bounds=[y0, y0 + rows]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    try:
        with switched(KB_SIGMAG_MODE="exact"):
            _, launches, wall = drive(f"exact sigma-G, float band y=[{y0}, {y0 + rows}), {len(cands)} candidates",
                                      ("sigmag_exact_topk",), lambda: search.search_all(cands, True))
            budget = search_memory_budget(config, SimpleNamespace(num_times=T, height=H, width=W), len(cands),
                                          torch.device("cuda"))
    finally:
        ops.search_topk_sigmag_exact = exact
    peak = torch.cuda.max_memory_allocated() - base
    log(f"exact sigma-G band memory over search_all: budget {budget['total']} bytes "
        f"({ {k: v for k, v in budget.items() if k != 'total'} }), measured peak {peak} bytes above the {base} "
        f"allocated before; {card}")
    if budget["total"] < peak:
        raise AssertionError(f"exact sigma-G band: peak {peak} above the budget {budget}")
    if launches["sigmag_exact_topk"] != 1 or sum(launches.values()) != 1:
        raise AssertionError(f"exact sigma-G: not one K7 launch alone: {launches}")
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
    return launches


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
    if (launches["sigmag_exact_topk"] != len(list(mesh.local_shards())) or sum(launches.values())
            != launches["sigmag_exact_topk"] or max(twin_calls.values()) != 0):
        raise AssertionError(f"sharded exact sigma-G: not one K7 launch a shard alone: {launches}, {twin_calls}")
    _add(total, launches)
    if not (torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])):
        raise AssertionError("sharded exact sigma-G: the maps differ from the one-device exact search")
    walls["exact sigma-G, 16 rows (K7)"] = (times["two"], times["one"])
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
    launches (the tracer's ``kbmod:kernel.*`` ranges), and one stage file
    beside it with the build, search and phase spans; the device kernels
    the trace holds are counted. Returns the launches."""
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
        stage_files = glob.glob(os.path.join(tmp, "kbmod_stages_*.json"))
        if len(traces) != 1 or len(stage_files) != 1:
            raise AssertionError(f"profile: {len(traces)} trace and {len(stage_files)} stage files written, not one each")
        size = os.path.getsize(traces[0])
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        with open(stage_files[0]) as f:
            stages = json.load(f)
    names = [str(e.get("name", "")) for e in events]
    labels = {k: sum(n == k for n in names) for k in ("kbmod:kernel.K1.psi_phi_conv", "kbmod:kernel.K2.search_topk")}
    kernels = [n for e, n in zip(events, names) if e.get("cat") == "kernel"]
    device = {"K1": sum("conv_tiled" in n or "conv_generic" in n for n in kernels),
              "K2": sum("search_topk_kernel" in n for n in kernels)}
    log(f"profile: trace of {size} bytes, {len(events)} events; launch labels {labels} (launches {launches}); "
        f"{len(kernels)} device kernel events, of them K1 {device['K1']}, K2 {device['K2']}; {len(stages)} stage "
        f"names, build {stages.get('build', {}).get('seconds', 0.0) * 1e3:.1f} ms, search "
        f"{stages.get('search', {}).get('seconds', 0.0) * 1e3:.1f} ms; profiled P1 wall {wall:.1f} ms; {card}")
    if min(labels.values()) < 1:
        raise AssertionError(f"profile: the trace does not name the K1 and K2 launches: {labels}")
    missing = {"KBMOD", "build", "build.conv", "search", "search.topk", "load_and_filter_results"} - set(stages)
    if missing:
        raise AssertionError(f"profile: the stage file lacks {sorted(missing)}")
    if min(device.values()) < 1:
        log("profile: warning: the trace holds no device kernel events for K1 or K2 (CUPTI)")
    return launches


# ----------------------------------------------------------------------
# The WorkUnit path: reprojection, search with sky positions, files, CLI
# ----------------------------------------------------------------------

# The WorkUnit phase: the images' WCS (0.2 arcsec pixels, Rubin's scale) and
# the common WCS's offset from it: CRPIX + (3.3, 2.7) and 0.2 degrees of
# rotation at the same scale.
WU_CENTER = (200.0, -7.0)
WU_DEG_PP = 0.2 / 3600.0
WU_SHIFT = (3.3, 2.7)
WU_ROTATION_DEG = 0.2
# Layers written to the WorkUnit file the command-line child searches.
WU_FILE_LAYERS = 64
# Layers of the native RICE_1 and sharded round trips.
WU_RICE_LAYERS = 4
WU_CHILD_TIMEOUT_S = 300


def _wu_wcses(H, W):
    """(the images' WCS, the common WCS, the affine map image pixel ->
    common pixel as (A, b)): both share CRVAL and the TAN projection, so the
    map between their pixel grids is exactly affine."""
    from kbmod_tpu_torch.geom.wcs import WCS
    from kbmod_tpu_torch.wcs_utils import make_fake_wcs

    img = make_fake_wcs(*WU_CENTER, H, W, WU_DEG_PP)
    c, s = np.cos(np.radians(WU_ROTATION_DEG)), np.sin(np.radians(WU_ROTATION_DEG))
    rot = np.array([[c, -s], [s, c]])
    common = WCS(img.crpix + np.array(WU_SHIFT), img.crval, img.cd @ rot, shape=(H, W))
    A = np.linalg.inv(rot)
    # 0-based pixels: p_c = A (p_i + 1 - crpix_i) + crpix_c - 1.
    b = -A @ (img.crpix - 1.0) + (common.crpix - 1.0)
    return img, common, A, b


def _nan_outside_allowed(layer, coords, invalid, radius, dev):
    """Output NaNs that neither the uncovered border nor a masked source
    pixel explains: a NaN is allowed where the rounded source coordinate
    lies within ``radius`` of the image edge or of an invalid source pixel
    (the stencil's reach). Counted on the card."""
    H, W = invalid.shape
    near = torch.nn.functional.max_pool2d(torch.as_tensor(invalid, device=dev, dtype=torch.float32)[None, None],
                                          2 * radius + 1, stride=1, padding=radius)[0, 0] > 0
    cy = torch.as_tensor(np.asarray(coords[0], np.float32), device=dev)
    cx = torch.as_tensor(np.asarray(coords[1], np.float32), device=dev)
    finite = torch.isfinite(cy) & torch.isfinite(cx)
    yc = torch.round(torch.where(finite, cy, torch.zeros_like(cy))).long()
    xc = torch.round(torch.where(finite, cx, torch.zeros_like(cx))).long()
    edge = ~finite | (yc < radius) | (yc >= H - radius) | (xc < radius) | (xc >= W - radius)
    allowed = edge | near[yc.clamp(0, H - 1), xc.clamp(0, W - 1)]
    nan = torch.isnan(torch.as_tensor(layer, device=dev))
    return int((nan & ~allowed).sum()), int(nan.sum()), int((nan & edge).sum())


def run_child(tag, args, timeout):
    """Run ``python -m`` args as a child process that imports this
    checkout; raise on a non-zero exit. Returns (stdout, seconds)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [os.path.dirname(os.path.abspath(__file__)),
                                                                     os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True, env=env, timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"{tag}: {args[0]} exited {out.returncode}:\n{out.stderr[-4000:]}")
    return out.stdout, time.perf_counter() - t0


def reproject_timed(work, common, dev):
    """``reproject_work_unit`` on the card (adaptive, frame "original") with
    the host coordinates and ``resample_layer`` timed apart: (the
    reprojected WorkUnit, the whole call's seconds, {"coords": s,
    "resample": s} summed over the layers)."""
    from kbmod_tpu_torch import reprojection

    spent = {"coords": 0.0, "resample": 0.0}
    real_coords, real_resample = reprojection.compute_source_coordinates, reprojection.resample_layer

    def timed(key, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[key] += time.perf_counter() - t0
            return out
        return call

    reprojection.compute_source_coordinates = timed("coords", real_coords)
    reprojection.resample_layer = timed("resample", real_resample)
    try:
        t0 = time.perf_counter()
        reproj = reprojection.reproject_work_unit(work, common, frame="original", device=dev)
        whole = time.perf_counter() - t0
    finally:
        reprojection.compute_source_coordinates, reprojection.resample_layer = real_coords, real_resample
    return reproj, whole, spent


def card_resample_ms(sci, var, coords, radius, dev):
    """The card's adaptive resampling alone of one layer's two planes: the
    median of 3 runs by CUDA events."""
    from kbmod_tpu_torch.ops import reproject

    ok = np.isfinite(sci) & np.isfinite(var)
    planes = torch.as_tensor(np.stack([np.where(ok, sci, 0), np.where(ok, var, 0)]).astype(np.float32), device=dev)
    val = torch.as_tensor(ok.astype(np.float32), device=dev)
    cy, cx = (torch.as_tensor(np.asarray(c, np.float32), device=dev) for c in coords)
    sigma = reproject.DEFAULT_KERNEL_WIDTH / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    trunc = 0.5 * reproject.DEFAULT_KERNEL_WIDTH * reproject.DEFAULT_SAMPLE_REGION_WIDTH
    return event_ms(lambda: reproject._adaptive_resample(planes, val, cy, cx, radius, sigma * sigma,
                                                         trunc * trunc, False), 3)


def workunit_path(stack, obj, card, dev):
    """The WorkUnit path at full width: reproject the main stack's 64 layers
    on the card onto a common WCS, search the result with
    ``run_search_from_work_unit`` (K1, K2, sky positions), write it to a
    file and search that with the ``kbmod_search`` command in a child
    process, then the native RICE_1 and sharded round trips. Returns the
    launches of the search."""
    import tempfile

    from kbmod_tpu_torch import native, reprojection
    from kbmod_tpu_torch.configuration import SearchConfiguration
    from kbmod_tpu_torch.core.image_stack_py import ImageStackPy
    from kbmod_tpu_torch.geom.wcs import SkyCoordLite
    from kbmod_tpu_torch.ops import reproject
    from kbmod_tpu_torch.results import Results
    from kbmod_tpu_torch.run_search import SearchRunner
    from kbmod_tpu_torch.work_unit import WorkUnit

    T, H, W = len(stack.sci), stack.height, stack.width
    img_wcs, common, A, b = _wu_wcses(H, W)
    config = SearchConfiguration(dict(generator_config=PIPELINE_GENERATOR))
    work = WorkUnit(im_stack=stack, config=config, per_image_wcs=[img_wcs] * T)

    # 1-2. Reprojection on the card, the host coordinates and the card's
    # resampling timed apart.
    reproj, whole, spent = reproject_timed(work, common, dev)
    coords = reprojection.compute_source_coordinates(img_wcs, common, (H, W))
    radius = reproject._stencil_radius(coords, 0.5 * reproject.DEFAULT_KERNEL_WIDTH
                                       * reproject.DEFAULT_SAMPLE_REGION_WIDTH)
    bad = nan_total = nan_edge = 0
    for t in range(T):
        invalid = ~(np.isfinite(stack.sci[t]) & np.isfinite(stack.var[t]))
        n_bad, n_nan, n_edge = _nan_outside_allowed(reproj.im_stack.sci[t], coords, invalid, radius, dev)
        bad, nan_total, nan_edge = bad + n_bad, nan_total + n_nan, nan_edge + n_edge
    device_ms = card_resample_ms(stack.sci[0], stack.var[0], coords, radius, dev)
    log(f"workunit: reprojected {T} layers of {H} x {W} on the card (adaptive, stencil radius {radius}) in "
        f"{whole:.2f} s: host coordinates {spent['coords'] / T * 1e3:.1f} ms a layer, resample_layer (host to "
        f"card, resampling, back; synchronized) {spent['resample'] / T * 1e3:.1f} ms a layer, the card's "
        f"resampling alone {device_ms:.2f} ms a layer (CUDA events); {nan_total} NaN pixels, {nan_edge} of them "
        f"in the uncovered border, {bad} unexplained; {card}")
    if bad:
        raise AssertionError(f"workunit: {bad} NaN pixels outside the border and the masked pixels' reach")
    if nan_total > 0.5 * T * H * W:
        raise AssertionError(f"workunit: {nan_total} of {T * H * W} reprojected pixels are NaN")

    # 3. The search from the WorkUnit on the card, with sky positions.
    runner = SearchRunner()
    keep, launches, wall = drive("workunit: run_search_from_work_unit (K1, K2)", ("psi_phi_conv", "search_topk"),
                                 lambda: runner.run_search_from_work_unit(reproj))
    walls = {k: (v[1] - v[0]) * 1e3 for k, v in runner.phase_times.items()}
    log("workunit: search phase walls (ms): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()) + f"; {card}")
    x_exp, y_exp = A @ np.array([obj.x, obj.y], dtype=np.float64) + b
    vx_exp, vy_exp = A @ np.array([obj.vx, obj.vy], dtype=np.float64)
    row = {k: keep[k][0] for k in ("x", "y", "vx", "vy", "likelihood", "obs_count")}
    speed, angle = np.hypot(row["vx"], row["vy"]), np.arctan2(row["vy"], row["vx"])
    speed_step = (PIPELINE_GENERATOR["v_arr"][1] - PIPELINE_GENERATOR["v_arr"][0]) / (PIPELINE_GENERATOR["v_arr"][2] - 1)
    angle_step = sum(PIPELINE_GENERATOR["ang_arr"][:2]) / (PIPELINE_GENERATOR["ang_arr"][2] - 1)
    d_angle = abs((angle - np.arctan2(vy_exp, vx_exp) + np.pi) % (2 * np.pi) - np.pi)
    # Positions compared at the mean observation time, where the stack pins
    # a trajectory (a velocity a fraction of a step off moves the best start
    # pixel the other way).
    dt = np.asarray(reproj.im_stack.zeroed_times)
    t_mid = float(np.mean(dt))
    dx_mid = row["x"] + row["vx"] * t_mid - (x_exp + vx_exp * t_mid)
    dy_mid = row["y"] + row["vy"] * t_mid - (y_exp + vy_exp * t_mid)
    log(f"workunit: {len(keep)} rows, row 0 {row}; expected in the common frame x={x_exp:.3f}, y={y_exp:.3f}, "
        f"vx={vx_exp:.4f}, vy={vy_exp:.4f}; at the mean time {t_mid:.3f} d row 0 is off by ({dx_mid:.3f}, "
        f"{dy_mid:.3f}) pixels, its speed by {speed - np.hypot(vx_exp, vy_exp):.4f} (step {speed_step}), its angle "
        f"by {d_angle:.5f} rad (step {angle_step})")
    if (abs(dx_mid) > 1 or abs(dy_mid) > 1 or abs(speed - np.hypot(vx_exp, vy_exp)) > speed_step
            or d_angle > angle_step):
        raise AssertionError(f"workunit: row 0 {row} is not within a grid step of the object's trajectory")
    # The sky positions against the object's true sky path (through the
    # images' WCS): off by no more than row 0's own distance from the
    # expected trajectory plus half a pixel.
    true = SkyCoordLite(*img_wcs.pixel_to_world_values(obj.x + obj.vx * dt, obj.y + obj.vy * dt))
    sep = true.separation_deg(SkyCoordLite(np.asarray(keep["global_ra"][0]), np.asarray(keep["global_dec"][0])))
    off_px = np.hypot(row["x"] + row["vx"] * dt - (x_exp + vx_exp * dt), row["y"] + row["vy"] * dt
                      - (y_exp + vy_exp * dt))
    sep_px = sep / WU_DEG_PP
    log(f"workunit: row 0's sky path against the truth: at most {sep.max() * 3600:.4f} arcsec "
        f"({sep_px.max():.3f} pixels); row 0's pixel path off the expected one by at most {off_px.max():.3f} "
        f"pixels; sky minus pixel error at most {np.max(sep_px - off_px):.4f} pixels")
    if np.any(sep_px > off_px + 0.5):
        raise AssertionError("workunit: global_ra/global_dec stray more than half a pixel past row 0's own path")

    with tempfile.TemporaryDirectory() as tmp:
        # 4. The WorkUnit through a file and the command line, on the card.
        n = min(WU_FILE_LAYERS, T)
        if n < T:
            raise AssertionError("workunit: the file step must take every layer to compare with row 0")
        path = os.path.join(tmp, "wu.fits")
        t0 = time.perf_counter()
        reproj.to_fits(path)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = WorkUnit.from_fits(path)
        t_read = time.perf_counter() - t0
        same = all(np.array_equal(back.im_stack.sci[t], reproj.im_stack.sci[t], equal_nan=True) for t in range(T))
        out = os.path.join(tmp, "res.ecsv")
        stdout, t_child = run_child("workunit", ["kbmod_tpu_torch.cmdline.kbmod_search", "--workunit", path,
                                                 "--outfile", out], WU_CHILD_TIMEOUT_S)
        res = Results.read_table(out)
        log(f"workunit: to_fits of {T} layers {t_write:.2f} s ({os.path.getsize(path) / 1e6:.1f} MB, GZIP_1), "
            f"from_fits {t_read:.2f} s (layers equal: {same}); kbmod_search child {t_child:.2f} s: "
            f"{stdout.strip()}; its row 0 (x={res['x'][0]}, y={res['y'][0]}, vx={res['vx'][0]:.4f}, "
            f"vy={res['vy'][0]:.4f}, lh={res['likelihood'][0]:.4f})")
        if not same:
            raise AssertionError("workunit: the WorkUnit file does not read back with the same layers")
        for k in ("x", "y", "vx", "vy", "likelihood", "obs_count"):
            if res[k][0] != keep[k][0]:
                raise AssertionError(f"workunit: the child's row 0 {k}={res[k][0]} is not {keep[k][0]}")
        if not np.array_equal(np.asarray(res["global_ra"][0]), np.asarray(keep["global_ra"][0])):
            raise AssertionError("workunit: the child's global_ra of row 0 differs")

        # 4b. The command-line tools on the child's file and results.
        launches = dict(launches)
        _add(launches, tools_path(path, out, reproj.im_stack, keep, card, dev))

        # 5. Native RICE_1 (quantized) and the sharded form, four layers.
        if not native.available():
            raise AssertionError("workunit: the native library did not build")
        sub = ImageStackPy(times=list(stack.times[:WU_RICE_LAYERS]), sci=[stack.sci[t] for t in range(WU_RICE_LAYERS)],
                           var=[stack.var[t] for t in range(WU_RICE_LAYERS)],
                           psfs=[stack.psfs[t] for t in range(WU_RICE_LAYERS)])
        small = WorkUnit(im_stack=sub, config=config, wcs=common)
        calls = {"n": 0}
        real_encode = native.rice_encode

        def counted(*args):
            calls["n"] += 1
            return real_encode(*args)

        native.rice_encode = counted
        try:
            t0 = time.perf_counter()
            small.to_fits(os.path.join(tmp, "rice.fits"), compression_type="RICE_1")
            t_rice_w = time.perf_counter() - t0
        finally:
            native.rice_encode = real_encode
        t0 = time.perf_counter()
        rice = WorkUnit.from_fits(os.path.join(tmp, "rice.fits"))
        t_rice_r = time.perf_counter() - t0
        worst = 0.0
        for t in range(WU_RICE_LAYERS):
            for a, b_ in ((rice.im_stack.sci[t], sub.sci[t]), (rice.im_stack.var[t], sub.var[t])):
                masked = ~(np.isfinite(sub.sci[t]) & np.isfinite(sub.var[t]))
                if not np.array_equal(np.isnan(a), masked):
                    raise AssertionError("workunit: the RICE_1 file's masks differ")
                worst = max(worst, float(np.max(np.abs(a[~masked] - b_[~masked]))))
        t0 = time.perf_counter()
        small.to_sharded_fits("wu.fits", os.path.join(tmp, "shards"))
        t_sh_w = time.perf_counter() - t0
        t0 = time.perf_counter()
        sharded = WorkUnit.from_sharded_fits("wu.fits", os.path.join(tmp, "shards"))
        t_sh_r = time.perf_counter() - t0
        sh_same = all(np.array_equal(sharded.im_stack.sci[t], sub.sci[t], equal_nan=True)
                      and np.array_equal(sharded.im_stack.var[t], sub.var[t], equal_nan=True)
                      for t in range(WU_RICE_LAYERS))
        log(f"workunit: native RICE_1 round trip of {WU_RICE_LAYERS} layers ({calls['n']} native encodes): write "
            f"{t_rice_w:.2f} s, read {t_rice_r:.2f} s, max |error| {worst:.5f} (half a 0.01 quantum); sharded "
            f"round trip write {t_sh_w:.2f} s, read {t_sh_r:.2f} s, equal: {sh_same}")
        if calls["n"] == 0 or worst > 0.0051:
            raise AssertionError(f"workunit: RICE_1 round trip: {calls['n']} native encodes, max error {worst}")
        if not sh_same:
            raise AssertionError("workunit: the sharded round trip changed the layers")
    return launches


# ----------------------------------------------------------------------
# The command-line tools on the workunit phase's file
# ----------------------------------------------------------------------

TOOLS_SIGMA_G = "25,75"
TOOLS_COADDS = ("mean", "median", "sum")
TOOLS_CHILD_TIMEOUT_S = 120


def tools_path(wu_path, res_path, stack, keep, card, dev):
    """The tools on the workunit phase's WorkUnit file (``wu_path``, GZIP_1)
    and the ``kbmod_search`` child's results (``res_path``), each called
    in this process through its ``main(argv)``: ``kbmod_stats``;
    ``kbmod_strip_results`` drops the curves and obs_valid (its default
    columns); ``kbmod_filter --workunit --sigma_g_bnds 25,75`` rebuilds the
    curves with one K1 launch on the card (driven with the counts at 0),
    bit-equal to the curves the child stored (the same file, card and
    kernel), clips them to the child's obs_valid, row 0 still the object's
    row and the best; ``kbmod_stamps`` makes mean, median and sum coadds on the card,
    the sum equal to the child's own coadd. Then ``Visualizer(stack,
    keep, device=dev).generate_all_stamps()`` on the card (its stamps summed over the
    valid times near the in-memory search's coadd), and ``kbmod_version
    --full`` as one ``python -m`` child, which must name the card. Each
    tool's wall is logged. Returns the launches of ``kbmod_filter``."""
    from kbmod_tpu_torch.analysis.visualizer import Visualizer
    from kbmod_tpu_torch.cmdline import kbmod_filter, kbmod_stamps, kbmod_stats, kbmod_strip_results
    from kbmod_tpu_torch.results import Results

    tmp = os.path.dirname(res_path)
    stripped, filtered, stamped = (os.path.join(tmp, f"{name}.ecsv") for name in ("stripped", "filtered", "stamped"))
    walls = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    timed("kbmod_stats", lambda: kbmod_stats.main([f"--input={res_path}"]))
    # The default columns: the curves and obs_valid go, so that kbmod_filter
    # clips the rebuilt curves afresh, as the search clipped its own.
    timed("kbmod_strip_results", lambda: kbmod_strip_results.main([f"--input={res_path}", f"--outfile={stripped}"]))
    if {"psi_curve", "phi_curve", "obs_valid"} & set(Results.read_table(stripped).colnames):
        raise AssertionError("tools: kbmod_strip_results kept a curve or obs_valid")
    _, launches, wall = drive("tools: kbmod_filter --workunit --sigma_g_bnds (K1)", ("psi_phi_conv",),
                              lambda: kbmod_filter.main([f"--input={stripped}", f"--outfile={filtered}",
                                                         f"--workunit={wu_path}", f"--sigma_g_bnds={TOOLS_SIGMA_G}",
                                                         "--device", dev.type]))
    walls["kbmod_filter"] = wall / 1e3
    stored, rebuilt = Results.read_table(res_path), Results.read_table(filtered)
    if len(rebuilt) != len(stored):
        raise AssertionError(f"tools: kbmod_filter kept {len(rebuilt)} of {len(stored)} rows")
    for col in ("psi_curve", "phi_curve"):
        a, b = np.asarray(rebuilt[col], np.float32), np.asarray(stored[col], np.float32)
        if a.shape != b.shape or not np.array_equal(a.view(np.int32), b.view(np.int32)):
            raise AssertionError(f"tools: the rebuilt {col} is not bit-equal to the search's")
    if not np.array_equal(np.asarray(rebuilt["obs_valid"]), np.asarray(stored["obs_valid"])):
        raise AssertionError("tools: kbmod_filter's sigma-G kept other samples than the search's")
    row0 = {k: rebuilt[k][0] for k in ("x", "y", "vx", "vy", "obs_count", "likelihood")}
    if any(rebuilt[k][0] != stored[k][0] for k in ("x", "y", "vx", "vy")):
        raise AssertionError(f"tools: the filtered row 0 {row0} is not the search's row 0")
    if int(np.argmax(np.asarray(rebuilt["likelihood"]))) != 0:
        raise AssertionError(f"tools: after sigma-G row 0 {row0} is not the best row")

    timed("kbmod_stamps", lambda: kbmod_stamps.main([f"--input={filtered}", f"--outfile={stamped}",
                                                      f"--workunit={wu_path}", f"--coadds={','.join(TOOLS_COADDS)}",
                                                      "--device", dev.type]))
    stamps = Results.read_table(stamped)
    for kind in TOOLS_COADDS:
        c = np.asarray(stamps[f"coadd_{kind}"])
        if c.shape != (len(stamps), 21, 21) or not np.isfinite(c).all():
            raise AssertionError(f"tools: coadd_{kind} of shape {c.shape} is not finite")
    if not np.array_equal(np.asarray(stamps["coadd_sum"]), np.asarray(stored["coadd_sum"])):
        raise AssertionError("tools: kbmod_stamps' coadd_sum differs from the search's own")

    vis = Visualizer(stack, keep, device=dev)
    timed("Visualizer.generate_all_stamps", vis.generate_all_stamps)
    cube = np.asarray(keep["all_stamps"])
    valid = np.asarray(keep["obs_valid"], bool)
    summed = np.where(valid[:, :, None, None], np.nan_to_num(cube), 0.0).sum(axis=1)
    coadd = np.asarray(keep["coadd_sum"])
    worst = float(np.max(np.abs(summed - coadd) / np.maximum(np.abs(coadd), 1.0)))
    if cube.shape != (len(keep), len(stack.sci), 21, 21) or worst > 1e-4:
        raise AssertionError(f"tools: Visualizer's all_stamps {cube.shape} sum to the coadd within {worst:.3g}")

    stdout, walls["kbmod_version child"] = run_child("tools", ["kbmod_tpu_torch.cmdline.kbmod_version", "--full"],
                                                     TOOLS_CHILD_TIMEOUT_S)
    if torch.cuda.get_device_name(0) not in stdout:
        raise AssertionError(f"tools: kbmod_version --full does not name the card:\n{stdout}")
    log(f"tools: {len(rebuilt)} rows; the rebuilt curves bit-equal to the search's, obs_valid equal; row 0 {row0}; coadds "
        f"{list(TOOLS_COADDS)}, the sum equal to the search's; Visualizer's all_stamps {cube.shape}, summed over "
        f"the valid times within {worst:.3g} of the coadd; kbmod_version: {' | '.join(stdout.strip().splitlines())}")
    log("tools: walls (s, host clock): " + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
        + f"; K1 launches in kbmod_filter {launches['psi_phi_conv']}; {card}")
    return launches


# ----------------------------------------------------------------------
# The discovery path: raw exposures to injected objects recovered and refined
# ----------------------------------------------------------------------

# Visit i of the discovery phase points at DISC_POINTINGS[i % 4]: whole-pixel
# offsets of the main stack's plane, so every file images the same sky.
DISC_POINTINGS = ((0, 0), (24, 17), (-19, 31), (13, -22))
DISC_EXPREQ = 30.0
# Rubin mask bits of KBMODV1Config.bit_flag_map.
DISC_BAD, DISC_NO_DATA = 2**0, 2**8
# The standardizers' settings: no grown masks (the 1% scattered masked
# pixels grown by 10 x 10 would mask most of each image), the stack's PSF.
DISC_STD_CONFIG = {"grow_mask": False, "psf_std": 1.4}
# A full-width patch: 8 pixels narrower than the exposures at 0.2 arcsec
# pixels (6.8 arcmin, 2,040 pixels a side for the main stack), in a 3 x 3
# grid whose middle patch is centred on the field.
DISC_PIXEL_SCALE = 0.2
DISC_PATCH_MARGIN_PX = 8
# The region_searcher command takes whole arcminutes on a whole-sky grid:
# 90 arcmin puts the field well inside one patch (ra 199.5-201, dec -7.5 to -6).
DISC_CLI_PATCH_ARCMIN = 90
# Injected objects: 16 of magnitude 20.9-21.6 at zero point 27 (flux
# 150-290), drawn from a seeded catalog of DISC_POOL moving retrograde
# along the ecliptic, which in this WCS lies inside the search grid's
# angles; kept in catalog order while the path stays DISC_EDGE_PX inside
# the patch, its pixel velocity inside the grid and every position more
# than DISC_MIN_SEP_PX from the objects kept before and the main object.
DISC_N_INJECT = 16
DISC_POOL = 400
DISC_SEED = 20261017
DISC_EDGE_PX = 40
DISC_MIN_SEP_PX = 60
DISC_CHILD_TIMEOUT_S = 300


def _disc_covered(px, py, H, W):
    """(y0, y1, x0, x1): the part of a file at pointing (px, py) that the
    main stack's plane covers (file pixel (x, y) is plane pixel
    (x + px, y + py))."""
    return max(0, -py), min(H, H - py), max(0, -px), min(W, W - px)


def write_exposures(stack, base_wcs, directory):
    """The main stack as 64 KBMODV1-style files (PRIMARY with the Rubin
    keys, IMAGE, MASK and VARIANCE, each with its TAN WCS), uncompressed.
    DATE-AVG is the visit's time less KBMODV1's offset to mid-exposure,
    the uncovered border is NO_DATA and the stack's masked pixels BAD.
    Returns the paths."""
    from kbmod_tpu_torch.geom.time_utils import mjd_to_datetime
    from kbmod_tpu_torch.geom.wcs import WCS
    from kbmod_tpu_torch.io import fits_io

    T, H, W = len(stack.sci), stack.height, stack.width
    paths = []
    for i in range(T):
        px, py = DISC_POINTINGS[i % len(DISC_POINTINGS)]
        y0, y1, x0, x1 = _disc_covered(px, py, H, W)
        window = (slice(y0 + py, y1 + py), slice(x0 + px, x1 + px))
        sci, var = stack.sci[i][window], stack.var[i][window]
        good = np.isfinite(sci) & np.isfinite(var)
        image = np.zeros((H, W), np.float32)
        variance = np.ones((H, W), np.float32)
        mask = np.full((H, W), DISC_NO_DATA, np.int32)
        image[y0:y1, x0:x1] = np.where(good, sci, 0.0)
        variance[y0:y1, x0:x1] = np.where(good, var, 1.0)
        mask[y0:y1, x0:x1] = np.where(good, 0, DISC_BAD)
        wcs_header = WCS(base_wcs.crpix - np.array([px, py], dtype=float), base_wcs.crval, base_wcs.cd,
                         shape=(H, W)).to_header()
        start = float(stack.times[i]) - (DISC_EXPREQ + 0.5) / 2.0 / 86400.0
        primary = fits_io.ImageHDU(name="PRIMARY")
        primary.header.update({
            "ZTENSION": "IMAGE", "ZPCOUNT": 0, "ZGCOUNT": 1, "CCDNUM": 42,
            "DATE-AVG": mjd_to_datetime(start).strftime("%Y-%m-%dT%H:%M:%S.%f"), "EXPREQ": DISC_EXPREQ,
            "OBS-LONG": -70.7494, "OBS-LAT": -30.2444, "OBS-ELEV": 2650.0, "FILTER": "r", "EXPID": 1000 + i,
        })
        hdus = [primary]
        for data, name in ((image, "IMAGE"), (mask, "MASK"), (variance, "VARIANCE")):
            hdu = fits_io.ImageHDU(data, name=name)
            hdu.header.update(wcs_header)
            hdus.append(hdu)
        path = os.path.join(directory, f"visit_{i:03d}.fits")
        fits_io.write_fits(path, hdus)
        paths.append(path)
    return paths


def _tables_equal(a, b):
    """Equal column names, rows and values (objects compared as strings,
    floats with NaN equal to NaN)."""
    if list(a.colnames) != list(b.colnames) or len(a) != len(b):
        return False
    for col in a.colnames:
        x, y = np.asarray(a[col]), np.asarray(b[col])
        if x.dtype == object or y.dtype == object or x.dtype.kind in "US":
            if [str(v) for v in x] != [str(v) for v in y]:
                return False
        elif not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
            return False
    return True


def _touched_pixels(dxs, dys, bounds, T, H, W):
    """Distinct in-image pixels the search window reads over all candidates
    and times: per time, the union of the window shifted by every
    candidate's offset (counted with a 2-D difference array on the card)."""
    SH, SW = bounds["y_max"] - bounds["y_min"], bounds["x_max"] - bounds["x_min"]
    total = 0
    for t in range(T):
        y0 = (dys[:, t] + bounds["y_min"]).clamp(0, H)
        y1 = (dys[:, t] + bounds["y_min"] + SH).clamp(0, H)
        x0 = (dxs[:, t] + bounds["x_min"]).clamp(0, W)
        x1 = (dxs[:, t] + bounds["x_min"] + SW).clamp(0, W)
        keep = (y1 > y0) & (x1 > x0)
        diff = torch.zeros((H + 1, W + 1), dtype=torch.int32, device=dxs.device)
        one = torch.ones(int(keep.sum()), dtype=torch.int32, device=dxs.device)
        for yy, xx, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1), (y1, x1, 1)):
            diff.index_put_((yy[keep].long(), xx[keep].long()), sign * one, accumulate=True)
        total += int((diff.cumsum(0).cumsum(1)[:H, :W] > 0).sum())
    return total


def time_k2_window(tag, planes, times, cands, bounds, K, min_obs, min_lh, gate_min_lh, dev):
    """K2 at one of the explorer's shapes on its planes: held to the twin
    once, bit for bit, timed (median of 3 by CUDA events), with the bound
    of the work: the distinct pixels the window reads (9 bytes each), the
    offsets and the (K, SH, SW) outputs; 3 operations a valid sample and
    2 + K a (pixel, candidate)."""
    from kbmod_tpu_torch.ops.search import trajectory_offsets
    from kbmod_tpu_torch.ops.search_kernel import search_topk, search_topk_shift

    psi, phi, valid = planes
    T, H, W = psi.shape
    SH, SW = bounds["y_max"] - bounds["y_min"], bounds["x_max"] - bounds["x_min"]
    vxs = np.array([c.vx for c in cands], np.float32)
    vys = np.array([c.vy for c in cands], np.float32)
    dxs, dys = (torch.as_tensor(a, device=dev) for a in trajectory_offsets(vxs, vys, times))
    C = len(cands)
    kw = dict(k_results=K, gate_min_lh=gate_min_lh, **bounds)
    args = (psi, phi, valid, dxs, dys, float(min_obs), float(min_lh))
    got = search_topk(*args, **kw)
    t0 = time.perf_counter()
    ref = search_topk_shift(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, nonzero = _assert_k2_equal(f"{tag} {SH}x{SW} K={K}", got, ref)
    ms = event_ms(lambda: search_topk(*args, **kw), 3)
    touched = _touched_pixels(dxs, dys, bounds, T, H, W)
    n_samples = _valid_samples(valid, dxs + bounds["x_min"], dys + bounds["y_min"], SH, SW)
    nbytes = 9 * touched + 8 * C * T + 8 * K * SH * SW
    nops = 3 * n_samples + (2 + K) * SH * SW * C
    bound_ms, bound_by = bound(nbytes, nops)
    log(f"K2 {tag} (T={T}, {SH}x{SW} window, C={C}, K={K}): {ms:.4f} ms, twin {plain_ms:.1f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; {touched} pixels read, {n_samples} valid samples), bit-equal to the "
        f"twin (max |dlh| {err:.3g}, {nonzero} slots differ); clocks {clocks()}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, err=err)


def discovery_path(stack, obj, card, dev):
    """The discovery path at full width and depth, as a survey user drives
    it: the main stack as 64 raw exposures on disk (four pointings), a
    collection (``kbmod_build_ic`` in a child and ``fromDir`` here), a
    region search naming the field's patch (and ``region_searcher`` in a
    child), the patch's WorkUnit reprojected on the card, 16 objects
    injected, the search (K1, K2) recovering them and the main object, and
    the explorer refining them (K2 at K = 1 over 101 x 101 windows, one K1
    build) and sweeping a pencil around row 0 (K2 with the list in the
    maps). Returns the launches of every driven call."""
    import tempfile

    from kbmod_tpu_torch.configuration import SearchConfiguration
    from kbmod_tpu_torch.core.shift_and_stack import generate_psi_phi_images
    from kbmod_tpu_torch.image_collection import ImageCollection
    from kbmod_tpu_torch.injection import generate_injection_catalog, inject_sources_into_work_unit
    from kbmod_tpu_torch.injection import match_injection_results
    from kbmod_tpu_torch.io import fits_io
    from kbmod_tpu_torch.ops import reproject
    from kbmod_tpu_torch.region_search import Ephems, RegionSearch
    from kbmod_tpu_torch.run_search import SearchRunner
    from kbmod_tpu_torch.standardizers import KBMODV1
    from kbmod_tpu_torch.table import Table, vstack
    from kbmod_tpu_torch.trajectory_explorer import TrajectoryExplorer, refine_all_results
    from kbmod_tpu_torch.trajectory_generator import PencilSearch, VelocityGridSearch
    from kbmod_tpu_torch.wcs_utils import make_fake_wcs

    T, H, W = len(stack.sci), stack.height, stack.width
    base = make_fake_wcs(*WU_CENTER, H, W, WU_DEG_PP)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        # 1. Raw exposures on disk.
        exp_dir = os.path.join(tmp, "exposures")
        os.makedirs(exp_dir)
        t0 = time.perf_counter()
        paths = write_exposures(stack, base, exp_dir)
        t_write = time.perf_counter() - t0
        size = sum(os.path.getsize(p) for p in paths)
        log(f"discovery: wrote {T} KBMODV1 exposures of {H} x {W} ({size / 1e9:.2f} GB, uncompressed) in "
            f"{t_write:.2f} s")

        # 2. The collection: the command in a child, fromDir here.
        ic_file = os.path.join(tmp, "survey.ecsv")
        out, t_child = run_child("discovery", ["kbmod_tpu_torch.cmdline.kbmod_build_ic", "--dir", exp_dir,
                                               "--outfile", ic_file], DISC_CHILD_TIMEOUT_S)
        t0 = time.perf_counter()
        ic = ImageCollection.fromDir(exp_dir, config=DISC_STD_CONFIG)
        t_std = time.perf_counter() - t0
        own_file = os.path.join(tmp, "in_process.ecsv")
        ic.write(own_file)
        child_ic = ImageCollection.read(ic_file)
        same_table = _tables_equal(child_ic.data, ImageCollection.read(own_file).data)
        with open(ic_file, "rb") as a, open(own_file, "rb") as b:
            same_bytes = a.read() == b.read()
        log(f"discovery: kbmod_build_ic child {t_child:.2f} s ({out.strip()}); fromDir {t_std:.2f} s, {len(ic)} "
            f"rows ({t_std / T * 1e3:.1f} ms an exposure); the child's table equal: {same_table}, its file "
            f"byte-equal: {same_bytes}")
        if len(ic) != T or not same_table:
            raise AssertionError("discovery: the child's collection differs from fromDir's")

        config = SearchConfiguration(dict(generator_config=PIPELINE_GENERATOR))
        t0 = time.perf_counter()
        wu0 = ic.toWorkUnit(config)
        t_wu = time.perf_counter() - t0
        times = np.asarray(wu0.im_stack.times)
        dt_err = float(np.max(np.abs(times - np.asarray(stack.times))))
        mismatched = 0
        for i in range(T):
            px, py = DISC_POINTINGS[i % len(DISC_POINTINGS)]
            y0, y1, x0, x1 = _disc_covered(px, py, H, W)
            window = (slice(y0 + py, y1 + py), slice(x0 + px, x1 + px))
            good = np.isfinite(stack.sci[i][window]) & np.isfinite(stack.var[i][window])
            for got_plane, want_plane in ((wu0.im_stack.sci[i], stack.sci[i]), (wu0.im_stack.var[i], stack.var[i])):
                want = np.full((H, W), np.nan, np.float32)
                want[y0:y1, x0:x1] = np.where(good, want_plane[window], np.nan)
                mismatched += int((~((got_plane == want) | (np.isnan(got_plane) & np.isnan(want)))).sum())
        psf_same = all(np.array_equal(wu0.im_stack.psfs[i], stack.psfs[i]) for i in range(T))
        log(f"discovery: toWorkUnit {t_wu:.2f} s ({t_wu / T * 1e3:.1f} ms a layer); layers against the stack "
            f"with the shift undone: {mismatched} pixels differ; times within {dt_err:.3g} d; PSFs equal: "
            f"{psf_same}")
        if mismatched or dt_err > 1e-8:
            raise AssertionError(f"discovery: toWorkUnit differs from the stack ({mismatched} pixels, "
                                 f"times {dt_err:.3g} d)")
        del wu0
        # grow_mask alone on one exposure, beside the read of that file
        # (scipy.signal imported first, so that its import is not timed).
        import scipy.signal  # noqa: F401

        t0 = time.perf_counter()
        fits_io.read_fits(paths[1])
        t_read = time.perf_counter() - t0
        grown_std = KBMODV1(paths[1])
        t0 = time.perf_counter()
        grown = grown_std._standardizeMask()
        t_grow = time.perf_counter() - t0
        plain = KBMODV1(paths[1], config=DISC_STD_CONFIG)._standardizeMask()
        log(f"discovery: grow_mask alone on one {H} x {W} exposure {t_grow * 1e3:.1f} ms (scipy convolve2d with "
            f"a 10 x 10 box; {plain.mean():.2%} of pixels masked before, {grown.mean():.2%} after), the file's "
            f"read {t_read * 1e3:.1f} ms")
        del grown_std, grown, plain

        # 3. The region search.
        t0 = time.perf_counter()
        rs = RegionSearch(ic)
        side_px = H - DISC_PATCH_MARGIN_PX
        side = side_px * DISC_PIXEL_SCALE / 3600.0
        ra_c, dec_c = WU_CENTER
        patches = rs.generate_patches(side * 60.0, pixel_scale=DISC_PIXEL_SCALE,
                                      ra_range=(ra_c - 1.5 * side, ra_c + 1.5 * side),
                                      dec_range=(dec_c - 1.5 * side, dec_c + 1.5 * side))
        patch = min(patches, key=lambda p: np.hypot(p.ra - ra_c, p.dec - dec_c))
        matches = rs.match_ic_to_patches()
        path_ra, path_dec = base.pixel_to_world_values(obj.x + obj.vx * (times - times[0]),
                                                       obj.y + obj.vy * (times - times[0]))
        ephems = Ephems(Table({"ra": path_ra, "dec": path_dec, "mjd": times}), "ra", "dec", "mjd")
        found = rs.search_patches_by_ephems(ephems)
        ic_patch = rs.get_image_collection_from_patch(patch)
        t_rs = time.perf_counter() - t0
        log(f"discovery: RegionSearch {len(patches)} patches of {patch.width_px} x {patch.height_px} pixels, "
            f"patch {patch.id} at ({patch.ra:.9f}, {patch.dec:.9f}); chips matched {{patch: rows}} "
            f"{ {k: len(v) for k, v in matches.items()} }; the object's ephemeris names {found}; the patch's "
            f"collection {len(ic_patch)} rows; {t_rs * 1e3:.1f} ms on the host")
        if (patch.width_px, patch.height_px) != (side_px, side_px) or abs(patch.ra - ra_c) > 1e-9 \
                or abs(patch.dec - dec_c) > 1e-9:
            raise AssertionError(f"discovery: the middle patch {patch} is not a {side_px}-pixel patch on the field")
        if found != [patch.id] or len(ic_patch) != T or len(matches.get(patch.id, [])) != T:
            raise AssertionError(f"discovery: the region search did not name patch {patch.id} with every row")
        out_dir = os.path.join(tmp, "patches")
        out, t_rs_child = run_child("discovery", [
            "kbmod_tpu_torch.cmdline.region_searcher", "--ic-path", ic_file, "--guess-distances", "0.0",
            "--patch-side-len", str(DISC_CLI_PATCH_ARCMIN), "--pixel-scale", str(DISC_PIXEL_SCALE),
            "--out-dir", out_dir], DISC_CHILD_TIMEOUT_S)
        tag_dir = os.path.join(out_dir, f"0.0_{DISC_CLI_PATCH_ARCMIN}X{DISC_CLI_PATCH_ARCMIN}")
        exported = sorted(f for f in os.listdir(tag_dir) if f.endswith(".collection"))
        sub = ImageCollection.read(os.path.join(tag_dir, exported[0])) if len(exported) == 1 else None
        log(f"discovery: region_searcher child ({DISC_CLI_PATCH_ARCMIN} arcmin patches over the sky) "
            f"{t_rs_child:.2f} s: exported {exported}, "
            f"{len(sub) if sub is not None else 'n/a'} rows, patch centre "
            f"{sub.data.meta.get('patch_center') if sub is not None else 'n/a'}")
        if sub is None or len(sub) != T:
            raise AssertionError(f"discovery: region_searcher exported {exported}, not one patch of {T} rows")
        lo = np.asarray(sub.data.meta["patch_center"]) - 0.5 * np.asarray(sub.data.meta["patch_size_deg"])
        hi = lo + np.asarray(sub.data.meta["patch_size_deg"])
        if not (lo[0] < ra_c < hi[0] and lo[1] < dec_c < hi[1]):
            raise AssertionError("discovery: region_searcher's patch does not hold the field")
        t0 = time.perf_counter()
        work = ic_patch.toWorkUnit(config)
        t_wu_patch = time.perf_counter() - t0
        del ic, ic_patch, rs, child_ic, sub

    # 4. The patch's WorkUnit reprojected on the card, then the injection.
    pw = patch.to_wcs()
    reproj, whole, spent = reproject_timed(work, pw, dev)
    PH, PW = pw.array_shape
    coords = reproject.compute_source_coordinates(work.get_wcs(0), pw, (PH, PW))
    radius = reproject._stencil_radius(coords, 0.5 * reproject.DEFAULT_KERNEL_WIDTH
                                       * reproject.DEFAULT_SAMPLE_REGION_WIDTH)
    device_ms = card_resample_ms(work.im_stack.sci[0], work.im_stack.var[0], coords, radius, dev)
    del work, coords
    nan_frac = float(np.mean([np.isnan(s).mean() for s in reproj.im_stack.sci]))
    log(f"discovery: the patch's toWorkUnit {t_wu_patch:.2f} s; reprojected {T} layers onto the patch's "
        f"{PH} x {PW} WCS on the card in {whole:.2f} s: host coordinates {spent['coords'] / T * 1e3:.1f} ms a "
        f"layer, resample_layer {spent['resample'] / T * 1e3:.1f} ms a layer, the card's resampling alone "
        f"{device_ms:.2f} ms a layer (CUDA events); {nan_frac:.3%} of pixels NaN; {card}")

    zeroed = times - times[0]
    t_mid = float(np.mean(zeroed))

    def to_patch(x, y):
        return pw.world_to_pixel_values(*base.pixel_to_world_values(x, y))

    main_px = np.stack(to_patch(obj.x + obj.vx * zeroed, obj.y + obj.vy * zeroed), axis=1)
    t0 = time.perf_counter()
    spread = 0.45 * PW * DISC_PIXEL_SCALE / 3600.0
    pool = generate_injection_catalog(DISC_POOL, ra_c, dec_c, float(times[0]), ra_spread_deg=spread,
                                      dec_spread_deg=spread, vel_min=-8.6, vel_max=-1.2, mag_min=20.9, mag_max=21.6,
                                      angle_jitter=0.1, seed=DISC_SEED)
    ra0, dec0 = np.asarray(pool["ra"]), np.asarray(pool["dec"])
    vra, vdec = np.asarray(pool["v_ra"]), np.asarray(pool["v_dec"])
    x0, y0 = pw.world_to_pixel_values(ra0, dec0)
    x1, y1 = pw.world_to_pixel_values(ra0 + vra, dec0 + vdec)
    speed_lo, speed_hi = PIPELINE_GENERATOR["v_arr"][0] + 1.0, PIPELINE_GENERATOR["v_arr"][1] - 2.0
    ang_hi = PIPELINE_GENERATOR["ang_arr"][1] - 0.04
    kept_paths, chosen = [main_px], []
    for k in range(DISC_POOL):
        vx, vy = x1[k] - x0[k], y1[k] - y0[k]
        path = np.stack([np.round(x0[k]) + vx * zeroed, np.round(y0[k]) + vy * zeroed], axis=1)
        inside = np.all((path >= DISC_EDGE_PX) & (path < np.array([PW, PH]) - DISC_EDGE_PX))
        in_grid = speed_lo <= np.hypot(vx, vy) <= speed_hi and abs(np.arctan2(vy, vx)) <= ang_hi
        apart = all(np.min(np.hypot(*(path - other).T)) > DISC_MIN_SEP_PX for other in kept_paths)
        if inside and in_grid and apart:
            chosen.append(k)
            kept_paths.append(path)
            if len(chosen) == DISC_N_INJECT:
                break
    if len(chosen) < DISC_N_INJECT:
        raise AssertionError(f"discovery: only {len(chosen)} of {DISC_POOL} catalog objects fit the patch")
    catalog = pool[chosen]
    catalog["object_id"] = np.arange(DISC_N_INJECT)
    injected = inject_sources_into_work_unit(reproj, catalog)
    t_inject = time.perf_counter() - t0
    # The main object as a catalog row, for the same matching.
    m_ra, m_dec = base.pixel_to_world_values(float(obj.x), float(obj.y))
    m_ra1, m_dec1 = base.pixel_to_world_values(float(obj.x + obj.vx), float(obj.y + obj.vy))
    main_row = Table({"object_id": np.array([DISC_N_INJECT]), "ra": np.array([float(m_ra)]),
                      "dec": np.array([float(m_dec)]), "v_ra": np.array([float(m_ra1 - m_ra)]),
                      "v_dec": np.array([float(m_dec1 - m_dec)]),
                      "mag": np.array([27.0 - 2.5 * np.log10(obj.flux)]), "mjd0": np.array([float(times[0])])})
    full_cat = vstack([catalog, main_row])
    truth = [(float(t.x), float(t.y), float(t.vx), float(t.vy)) for t in injected]
    m_v = (main_px[-1] - main_px[0]) / zeroed[-1]
    truth.append((float(main_px[0, 0]), float(main_px[0, 1]), float(m_v[0]), float(m_v[1])))
    log(f"discovery: injected {len(injected)} objects (fluxes {min(t.flux for t in injected):.1f}-"
        f"{max(t.flux for t in injected):.1f}, pixel speeds "
        f"{min(np.hypot(t.vx, t.vy) for t in injected):.2f}-{max(np.hypot(t.vx, t.vy) for t in injected):.2f} "
        f"px/d) from {chosen[-1] + 1} catalog draws in {t_inject * 1e3:.1f} ms on the host")

    # 5. The search and the recovery.
    runner = SearchRunner()
    keep, got, wall = drive("discovery: run_search_from_work_unit (K1, K2)", ("psi_phi_conv", "search_topk"),
                            lambda: runner.run_search_from_work_unit(reproj))
    _add(launches, got)
    walls = {k: (v[1] - v[0]) * 1e3 for k, v in runner.phase_times.items()}
    t0 = time.perf_counter()
    match = match_injection_results(full_cat, keep, reproj)
    t_match = time.perf_counter() - t0
    recovered = int(np.sum(np.asarray(match["recovered"])))
    log(f"discovery: search phase walls (ms): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
        + f"; {len(keep)} rows; recovered {recovered} of {len(full_cat)} (16 injected and the main object) "
        f"within 5 pixels, matched rows {list(np.asarray(match['match_idx']))}; match_injection_results "
        f"{t_match * 1e3:.1f} ms; {card}")
    if recovered != len(full_cat):
        rows = [tuple(round(float(keep[c][i]), 3) for c in ("x", "y", "vx", "vy", "likelihood", "obs_count"))
                for i in range(min(len(keep), 20))]
        raise AssertionError(f"discovery: recovered {recovered} of {len(full_cat)}; truth (x, y, vx, vy) "
                             f"{[tuple(round(v, 3) for v in t) for t in truth]}; rows {rows}")
    n_obj = len(full_cat)
    if sorted(int(i) for i in match["match_idx"]) != list(range(n_obj)):
        raise AssertionError(f"discovery: the objects are not the top {n_obj} rows")

    # 6. The explorer on the card.
    refined, got, w_ref = drive(f"discovery: refine_all_results on the top {n_obj} rows (K1 once, K2 at K = 1)",
                                ("psi_phi_conv", "search_topk"),
                                lambda: refine_all_results(keep[list(range(n_obj))], reproj.im_stack, reproj.config,
                                                           device=dev))
    _add(launches, got)
    if got["psi_phi_conv"] != 1 or got["search_topk"] < n_obj:
        raise AssertionError(f"discovery: refine_all_results launched {got}, not K1 once and K2 a row")
    worst_pos = worst_v = 0.0
    owners = []
    for i in range(len(refined)):
        r = [float(refined[c][i]) for c in ("x", "y", "vx", "vy")]
        d = [np.hypot(r[0] + r[2] * t_mid - (tx + tvx * t_mid), r[1] + r[3] * t_mid - (ty + tvy * t_mid))
             for tx, ty, tvx, tvy in truth]
        k = int(np.argmin(d))
        owners.append(k)
        worst_pos = max(worst_pos, d[k])
        worst_v = max(worst_v, abs(r[2] - truth[k][2]), abs(r[3] - truth[k][3]))
    log(f"discovery: refined {len(refined)} rows in {w_ref:.1f} ms; each within {worst_pos:.3f} pixels of its "
        f"object's path at the mean time {t_mid:.3f} d and {worst_v:.3f} px/d of its velocity per axis; "
        f"objects {sorted(owners)}")
    if sorted(owners) != list(range(n_obj)) or worst_pos > 2.0 or worst_v > 1.0:
        raise AssertionError("discovery: the refined rows are not one a object within 2 pixels and 1 px/d")

    explorer = TrajectoryExplorer(reproj.im_stack, reproj.config, preload_data=True, device=dev)
    x0, y0, vx0, vy0 = (refined[c][0] for c in ("x", "y", "vx", "vy"))
    x0, y0, vx0, vy0 = int(x0), int(y0), float(vx0), float(vy0)
    pencil = PencilSearch(vx0, vy0)
    around, got, w_ar = drive(f"discovery: evaluate_around_linear_trajectory on row 0 (K2, K = {len(pencil)})",
                              ("search_topk",), lambda: explorer.evaluate_around_linear_trajectory(x0, y0, vx0, vy0))
    _add(launches, got)
    b = {c: float(around[c][0]) for c in ("x", "y", "vx", "vy")}
    d_speed = abs(np.hypot(b["vx"], b["vy"]) - np.hypot(vx0, vy0))
    d_ang = abs(np.arctan2(b["vy"], b["vx"]) - np.arctan2(vy0, vx0))
    d_pos = np.hypot(b["x"] + b["vx"] * t_mid - (x0 + vx0 * t_mid), b["y"] + b["vy"] * t_mid - (y0 + vy0 * t_mid))
    log(f"discovery: evaluate_around returned {len(around)} rows (121 x {len(pencil)}) in {w_ar:.1f} ms; best "
        f"{b}, against row 0 ({x0}, {y0}, {vx0:.4f}, {vy0:.4f}): speed {d_speed:.4f} (step 0.5), angle "
        f"{d_ang:.4f} (step 0.035), {d_pos:.3f} pixels apart at the mean time")
    if len(around) != 121 * len(pencil) or d_speed > 0.5 + 1e-6 or d_ang > 0.035 + 1e-6 or d_pos > 1.5:
        raise AssertionError("discovery: evaluate_around's best row is not row 0's trajectory within a step")
    lin, got, w_lin = drive("discovery: evaluate_linear_trajectory on row 0", (),
                            lambda: explorer.evaluate_linear_trajectory(x0, y0, vx0, vy0))
    _add(launches, got)
    cols = ("coadd_sum", "coadd_mean", "coadd_median", "sigma_g_res")
    log(f"discovery: evaluate_linear_trajectory {w_lin:.1f} ms, lh {float(lin['likelihood'][0]):.4f}, "
        f"columns present: {[c for c in cols if c in lin.colnames]}")
    if any(c not in lin.colnames for c in cols) or not np.all(np.isfinite(np.asarray(lin["coadd_mean"]))):
        raise AssertionError("discovery: evaluate_linear_trajectory lacks its coadds or sigma_g_res")
    (psi1, phi1), got, w_sas = drive("discovery: core.shift_and_stack.generate_psi_phi_images on layer 0 (K1)",
                                     ("psi_phi_conv",), lambda: generate_psi_phi_images(
                                         reproj.im_stack.sci[0], reproj.im_stack.var[0], reproj.im_stack.psfs[0],
                                         device=dev))
    _add(launches, got)
    planes = explorer.search.psi_phi_array.decoded_psi_phi()
    ok0 = planes[2][0] > 0
    same = (torch.equal(torch.isnan(psi1), ~ok0) and torch.equal(psi1[ok0], planes[0][0][ok0])
            and torch.equal(phi1[ok0], planes[1][0][ok0]))
    log(f"discovery: generate_psi_phi_images on layer 0 equals plane 0 of the explorer's build bit for bit: {same}")
    if not same:
        raise AssertionError("discovery: generate_psi_phi_images differs from the search's plane 0")

    # K2 at its two new shapes, on the explorer's planes: refine's first
    # search (pipeline row 0, its 101 x 101 window and 441 velocities) and
    # the pencil around refined row 0.
    cfg = reproj.config
    r = {c: keep[c][0] for c in ("x", "y", "vx", "vy")}
    rx, ry = int(r["x"]), int(r["y"])
    grid = list(VelocityGridSearch(21, r["vx"] - 10.0, r["vx"] + 10.0, 21, r["vy"] - 10.0, r["vy"] + 10.0))
    k2_refine = time_k2_window("refine", planes, explorer.search.zeroed_times, grid,
                               dict(x_min=rx - 50, x_max=rx + 51, y_min=ry - 50, y_max=ry + 51), 1,
                               cfg["num_obs"], cfg["lh_level"], cfg["lh_level"] > 0, dev)
    k2_around = time_k2_window("evaluate_around", planes, explorer.search.zeroed_times, list(pencil),
                               dict(x_min=x0 - 5, x_max=x0 + 6, y_min=y0 - 5, y_max=y0 + 6), len(pencil),
                               1, -1e25, False, dev)
    return launches, dict(refine=k2_refine, around=k2_around)


# ----------------------------------------------------------------------
# The regression and survey-scale entry points
# ----------------------------------------------------------------------

# The survey phase's frame and depth: the pipeline gate and survey_scale
# at T = 100 and the full 33,153-candidate grid on a 2048 x 2048 frame (the
# scripts' own default, 4096 x 4096, runs in calls of its own: about four
# minutes, which this script's time limit does not hold).
SURVEY_T = 100
SURVEY_FRAME = 2048


def survey_path(card, dev):
    """The port's regression and survey entry points, through the ported
    scripts' functions: the reference's regression configuration at full
    size (20 x 1024 x 512, the 26 x 52 grid, the default sigma-G pool) via
    ``run_search_from_work_unit`` (K1, K2; every object recovered, the
    metadata read back); the pipeline gate at T = 100 and the full grid on
    the survey frame (K1, K5; 20 of 20 in the final file, the device peak
    within the budget); survey_scale's full-frame search over the 12-day
    lattice at the same size, its centre window bit-equal to the twin. Each
    is driven with the counts at 0 just before and read just after (the
    window's twin after the search's launches are read). Returns the
    launches of the driven calls."""
    import tempfile

    from kbmod_tpu_torch.ops.search import search_depth
    from kbmod_tpu_torch.scripts import regression, survey_pipeline_gate, survey_scale
    from kbmod_tpu_torch.scripts._common import phase_walls

    total = {}

    def add(tag, launches, twin_calls, kernels):
        if min(launches[k] for k in kernels) <= 0 or max(twin_calls.values()) != 0:
            raise AssertionError(f"survey {tag}: not through {kernels} alone: {launches}, {twin_calls}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    stack = regression.make_stack()
    times, _ = regression.times_and_psf_sigmas()
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        t0 = time.perf_counter()
        runner, results, loaded = regression.run(stack, f"{tmp}/regression.ecsv", regression.FULL_VELOCITIES, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, twin_calls = read_counts()
        missing = regression.check(loaded, stack, times)
    walls = ", ".join(f"{k} {v:.2f}" for k, v in phase_walls(runner).items())
    log(f"survey regression (20x1024x512, 26 x 52 grid, sigma-G pool K'={search_depth(True, 8, 26 * 52)[1]}): "
        f"{len(results)} rows in {wall:.2f} s, {len(regression.TRJS) - len(missing)} of {len(regression.TRJS)} "
        f"recovered; launches {launches}, twin calls {twin_calls}; phase walls (s): {walls}; {card}")
    if missing:
        raise AssertionError(f"survey regression: objects {missing} not recovered")
    add("regression", launches, twin_calls, ("psi_phi_conv", "search_topk"))
    del stack, runner, results, loaded

    reset_counts()
    gate = survey_pipeline_gate.run(T=SURVEY_T, hw=SURVEY_FRAME, device=dev, log=log)
    launches, twin_calls = read_counts()
    log(f"survey pipeline gate (T={SURVEY_T}, {SURVEY_FRAME}x{SURVEY_FRAME}, C=33153; the scripts' 4096 frame cut "
        f"to {SURVEY_FRAME}): route {gate['route']}, {gate['recovered']} of {gate['objects']} recovered, "
        f"build {gate['t_build']} s, pipeline {gate['t_pipeline']} s, peak RSS {gate['peak_rss_gib']} GiB, "
        f"device peak {gate['device_peak_gib']} GiB against the budget {gate['budget_gib']} GiB; "
        f"launches {launches}; {card}")
    if not gate["mem"]:
        raise AssertionError("survey pipeline gate: the device peak was not measured")
    add("pipeline gate", launches, twin_calls, ("psi_phi_conv", "search_grouped"))
    del gate
    torch.cuda.empty_cache()

    reset_counts()
    sc = survey_scale.run(T=SURVEY_T, HW=SURVEY_FRAME, C=257 * 129, grid="default", device=dev, log=log)
    route_kernel = {"grouped": "search_grouped", "paired": "search_paired"}.get(sc["route"].split("+")[-1],
                                                                                 "search_encoded")
    add("survey_scale", sc["launches"], sc["twin_calls"], (route_kernel,))
    log(f"survey_scale ({SURVEY_FRAME}x{SURVEY_FRAME}, T={SURVEY_T}, C={sc['C']}): route {sc['route']}, "
        f"{sc['run_s']:.3f} s a search (first {sc['first_s']:.3f} s), {sc['evals_per_s']:.4g} evals/s; window "
        f"bit-equal to the twin ({sc['filled']} slots filled, twin {sc['twin_s']:.2f} s); {card}")
    torch.cuda.empty_cache()
    return total


# ----------------------------------------------------------------------
# The worked examples
# ----------------------------------------------------------------------

# The port's worked examples (kbmod_tpu_torch/examples/) this phase runs on
# the card, with the kernels each search example must launch; the others run
# no kernel. 07, 08 and 11 plot with matplotlib, which the card's machine
# lacks: they run in the CPU tests only.
EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kbmod_tpu_torch", "examples")
EXAMPLES_ON_CARD = {
    "01_kbmod_demo.py": ("psi_phi_conv", "search_topk"),
    "02_create_fake_data.py": (),
    "03_trajectory_explorer.py": ("psi_phi_conv", "search_topk"),
    "04_reprojection_demo.py": (),
    "05_results_and_filtering.py": ("psi_phi_conv", "search_topk"),
    "06_region_search.py": (),
    "09_clustering_evaluation.py": (),
    "10_known_objects.py": (),
    "12_multichip_sharding.py": ("search_topk",),
    "13_checkpoint_resume.py": ("search_topk",),
}
EXAMPLES_CPU_ONLY = ("07_visualization.py", "08_fake_analysis.py", "11_results_rater.py")
ROW_KEY = ("x", "y", "vx", "vy", "obs_count")


def run_example(name, device=None):
    """The example's globals after it ran as a script, on ``device`` (None:
    its default, the card), its printed lines kept out of this log."""
    import contextlib
    import io
    import runpy

    init = {} if device is None else {"DEVICE": device}
    with contextlib.redirect_stdout(io.StringIO()):
        return runpy.run_path(os.path.join(EXAMPLES_DIR, name), init_globals=init, run_name="__main__")


def _row_bounds(rows, T, sums):
    """Twice ROADMAP Queue 3's float32 bound of each row's lh and flux from
    its sums (sum|psi|, sum phi): (T + 1) u sum|psi| / sqrt(sum phi) + 2 u |lh|
    and (T + 1) u (sum|psi| / sum phi + |flux|) + 2 u |flux|."""
    abs_psi, phi_sum = sums
    u = 2.0 ** -24
    lh, flux = np.abs(rows["lh"]), np.abs(rows["flux"])
    phi_sum = np.maximum(phi_sum, 1e-300)
    return (2 * ((T + 1) * u * abs_psi / np.sqrt(phi_sum) + 2 * u * lh),
            2 * ((T + 1) * u * (abs_psi / phi_sum + flux) + 2 * u * flux))


def _plane_sums(rows, planes, times):
    """(sum|psi|, sum phi) of each row over the samples it reads from the
    float planes (psi, phi zero where invalid)."""
    from kbmod_tpu_torch.ops.search import trajectory_offsets

    psi, phi, valid = (np.asarray(p.cpu() if torch.is_tensor(p) else p) for p in planes)
    T, H, W = psi.shape
    dxs, dys = trajectory_offsets(rows["vx"], rows["vy"], times)
    px, py = rows["x"].astype(np.int64)[:, None] + dxs, rows["y"].astype(np.int64)[:, None] + dys
    ok = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    tt = np.broadcast_to(np.arange(T), px.shape)
    px, py = np.clip(px, 0, W - 1), np.clip(py, 0, H - 1)
    ok &= valid[tt, py, px] > 0
    return (np.where(ok, np.abs(psi[tt, py, px].astype(np.float64)), 0.0).sum(axis=1),
            np.where(ok, phi[tt, py, px].astype(np.float64), 0.0).sum(axis=1))


def _curve_sums(table, valid_only):
    """(sum|psi|, sum phi) of each row over its curves, every finite sample
    or only those of ``obs_valid``."""
    psi, phi = (np.asarray(table[c], np.float64) for c in ("psi_curve", "phi_curve"))
    ok = np.isfinite(psi) & np.isfinite(phi)
    if valid_only:
        ok &= np.asarray(table["obs_valid"], bool)
    return np.where(ok, np.abs(psi), 0.0).sum(axis=1), np.where(ok, phi, 0.0).sum(axis=1)


def _as_rows(rows):
    """x, y, vx, vy, obs_count, lh and flux as numpy arrays from a core
    search's dict, a Results table or a list of Trajectory."""
    if isinstance(rows, dict):
        return {k: np.asarray(rows[k]) for k in ROW_KEY + ("lh", "flux")}
    if isinstance(rows, list):
        return {k: np.array([getattr(t, k) for t in rows]) for k in ROW_KEY + ("lh", "flux")}
    out = {k: np.asarray(rows[k]) for k in ROW_KEY + ("flux",)}
    out["lh"] = np.asarray(rows["likelihood"])
    return out


def example_rows(name, env):
    """{label: rows} of a search example's outputs (:func:`_as_rows`)."""
    labels = {"01_kbmod_demo.py": ("results",), "03_trajectory_explorer.py": ("row", "grid", "refined"),
              "05_results_and_filtering.py": ("trjs", "results"),
              "12_multichip_sharding.py": ("res_single", "res_sharded", "res_pix"),
              "13_checkpoint_resume.py": ("res1", "res2", "res3")}[name]
    return {label: _as_rows(env[label]) for label in labels}


def example_sums(name, env, label, rows):
    """(T, [(sum|psi|, sum phi) per row, ...]): the sums a row set's lh and
    flux may be built from, from the example's own planes or curves (its
    bound is the largest over them)."""
    sums = []
    if label in ("results", "row"):
        table = env[label]
        sums += [_curve_sums(table, True), _curve_sums(table, False)]
        T = np.asarray(table["psi_curve"]).shape[1]
    if name.startswith(("03", "05")):
        arr = (env["explorer"].search if name.startswith("03") else env["search"]).psi_phi_array
        sums.append(_plane_sums(rows, (arr.psi, arr.phi, arr.valid), np.asarray(arr.times)))
        T = arr.psi.shape[0]
    elif name.startswith(("12", "13")):
        psi = env["psi_changed"] if label == "res3" else env["psi"]
        sums.append(_plane_sums(rows, (psi, env["phi"], env["valid"]), env["times"]))
        T = psi.shape[0]
    return T, sums


def rows_agree(tag, card_rows, cpu_rows, T, sums):
    """The card's rows against the host's: x, y, vx, vy, obs_count and the
    row order exact, but inside a run of rows whose lh lie within each
    other's bound (the two devices' row sums round apart, so such rows may
    trade places); lh and flux within twice Queue 3's bound. Returns (rows,
    rows that traded places, the largest lh gap over its bound)."""
    n = len(cpu_rows["x"])
    if len(card_rows["x"]) != n:
        raise AssertionError(f"examples {tag}: {len(card_rows['x'])} rows on the card, {n} on the host")
    bounds = [_row_bounds(cpu_rows, T, s) for s in sums]
    lh_b = np.max([b[0] for b in bounds], axis=0)
    flux_b = np.max([b[1] for b in bounds], axis=0)
    order_c = np.arange(n)
    order_g = np.arange(n)
    key_c = np.stack([cpu_rows[k].astype(np.float64) for k in ROW_KEY], axis=1)
    key_g = np.stack([card_rows[k].astype(np.float64) for k in ROW_KEY], axis=1)
    moved = 0
    if not np.array_equal(key_c, key_g):
        lh = cpu_rows["lh"].astype(np.float64)
        start = 0
        for i in range(1, n + 1):
            if i < n and abs(lh[i] - lh[i - 1]) <= lh_b[i] + lh_b[i - 1]:
                continue
            if not np.array_equal(key_c[start:i], key_g[start:i]):
                oc = start + np.lexsort(key_c[start:i].T[::-1])
                og = start + np.lexsort(key_g[start:i].T[::-1])
                if not np.array_equal(key_c[oc], key_g[og]):
                    raise AssertionError(f"examples {tag}: rows {start}..{i - 1} differ between the card and "
                                         f"the host")
                order_c[start:i], order_g[start:i] = oc, og
                moved += i - start
            start = i
    gap = 0.0
    for k, b in (("lh", lh_b), ("flux", flux_b)):
        a, c = card_rows[k][order_g].astype(np.float64), cpu_rows[k][order_c].astype(np.float64)
        finite = np.isfinite(c)
        if not np.array_equal(finite, np.isfinite(a)) or np.any(a[~finite] != c[~finite]):
            raise AssertionError(f"examples {tag}: {k} not finite in the same rows")
        over = np.abs(a[finite] - c[finite]) / np.maximum(b[order_c][finite], 1e-300)
        if np.any(over > 1.0):
            raise AssertionError(f"examples {tag}: {k} apart by {over.max():.3g} times the bound")
        if k == "lh" and over.size:
            gap = max(gap, float(over.max()))
    return n, moved, gap


def examples_path(card):
    """The port's worked examples on the card, each through its default
    device: its own asserts, its wall, its launches (driven with the counts
    at 0 and read after; the search examples through their kernels, no twin
    anywhere); then each search example again on the host in this process,
    its rows held to the card's (:func:`rows_agree`). Returns the launches
    of the card runs."""
    import shutil

    log(f"examples: {', '.join(EXAMPLES_CPU_ONLY)}: CPU tests only: matplotlib")
    total = {}
    for name, kernels in EXAMPLES_ON_CARD.items():
        reset_counts()
        t0 = time.perf_counter()
        env = run_example(name)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, twin_calls = read_counts()
        if any(launches[k] <= 0 for k in kernels) or max(twin_calls.values()) != 0:
            raise AssertionError(f"examples {name}: not through {kernels} alone: {launches}, {twin_calls}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        line = f"examples {name}: card {wall:.2f} s, launches {({k: v for k, v in launches.items() if v})}"
        if kernels:
            t0 = time.perf_counter()
            host = run_example(name, "cpu")
            host_wall = time.perf_counter() - t0
            card_rows = example_rows(name, env)
            checks = []
            for label, rows in example_rows(name, host).items():
                n, moved, gap = rows_agree(f"{name} {label}", card_rows[label], rows,
                                           *example_sums(name, host, label, rows))
                checks.append(f"{label} {n} rows ({moved} traded places), lh gap {gap:.3g} of the bound")
            line += f"; host {host_wall:.2f} s, the same rows: {'; '.join(checks)}"
            if host.get("workdir"):
                shutil.rmtree(host["workdir"], ignore_errors=True)
        if env.get("workdir"):
            shutil.rmtree(env["workdir"], ignore_errors=True)
        log(f"{line}; {card}")
        del env
    torch.cuda.empty_cache()
    return total


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
        share = st["share"]
        groups = (f"groups, group-steps prepared {share['steps_shared']} and per member {share['steps_own']}, "
                  f"each staged pixel read {share['pixels_read'] / share['pixels_staged']:.3f} times")
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
    from kbmod_tpu_torch.ops.search import EncodedPlanes, trajectory_offsets
    from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
    from kbmod_tpu_torch.ops.search_plan import _dedup_plan_cached

    rng = np.random.default_rng(42)
    psi = rng.integers(0, 256, (T, size, size), dtype=np.uint8)
    phi = rng.integers(1, 256, (T, size, size), dtype=np.uint8)
    planes = EncodedPlanes.from_codes(psi, phi, MIDSCALE_EM, dev)
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


def time_band_cell(dev, seed=25):
    """K5 at the survey band cell's shapes (BENCHMARK.json
    ``survey_u8.band256``): random uint8 codes with about 2% zeros, times
    linspace(0, 1.35, 100), KBMOD's default grid, K = 8; ``time_encoded``
    with the twin on 8 rows, then one traced launch for the tracer's K5
    counters (steps prepared and per member, pixels staged and read); its
    launches counted (6)."""
    from torch.profiler import ProfilerActivity, profile

    from kbmod_tpu_torch import tracing
    from kbmod_tpu_torch.ops import search_encoded_kernel as ek
    from kbmod_tpu_torch.ops.search import EncodedPlanes, trajectory_offsets
    from kbmod_tpu_torch.ops.search_encoded import encoded_route
    from kbmod_tpu_torch.trajectory_generator import EclipticCenteredSearch

    rng = np.random.default_rng(seed)
    psi, phi = _code_stack(rng, 100, 256, 4096, 8, zeros=0.01)
    planes = EncodedPlanes.from_codes(psi, phi, MIDSCALE_EM, dev)
    del psi, phi
    cands = list(EclipticCenteredSearch(velocities=[92.0, 526.0, 257], angles=[-np.pi / 15, np.pi / 15, 129],
                                        angle_units="radian", given_ecliptic=0.0))
    times = np.linspace(0.0, 1.35, 100)
    bounds = dict(x_min=0, x_max=4096, y_min=0, y_max=256)
    before = ek.search_grouped.launches
    r = time_encoded("K5", planes, times, cands, bounds, 8, 10.0, 10.0, dev, twin_rows=8)
    dxs, dys = trajectory_offsets(np.array([c.vx for c in cands], np.float32),
                                  np.array([c.vy for c in cands], np.float32), times)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        ek.search_grouped(planes, torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev), 10.0, 10.0,
                          plan=encoded_route(torch.uint8, 100, dys)[1], k_results=8, gate_min_lh=True, **bounds)
        torch.cuda.synchronize()
    k5 = {k: v for k, v in tracing.totals().items() if k.startswith("k5.")}
    log(f"band cell: K5 counters {k5}, each staged pixel read "
        f"{k5['k5.pixels.read'] / k5['k5.pixels.staged']:.3f} times")
    if ek.search_grouped.launches != before + 6:
        raise AssertionError(f"band cell: K5 launched {ek.search_grouped.launches - before} times, not 6")
    if k5["k5.steps.shared"] < 100 * k5["k5.steps.own"]:
        raise AssertionError(f"band cell: K5 prepared too few steps: {k5}")
    return r


def time_k7(dev, seed=1001):
    """K7 at the regression cell's shapes: the reference's 20 x 1024 x 512
    stack (``scripts.regression.make_stack``), the 1,044 x 532 window of its
    10-pixel buffers, its 26 x 52 EclipticCenteredSearch grid, K = 8,
    min_obs 15, lh_level 25, sigma-G 25-75: median of 3 launches by CUDA
    events, the twin once on the card (held to K7 as ``_k7_against_twin``),
    the pairs clipped (the counter ``exact.clipped`` of a traced launch) and
    the bound: the planes (psi, phi, validity) and offsets read once, the
    maps written once; three float adds a valid sample and a sqrt, a divide
    and K compares a pair."""
    from torch.profiler import ProfilerActivity, profile

    from kbmod_tpu_torch import tracing
    from kbmod_tpu_torch.filters.sigma_g_filter import SigmaGClipping
    from kbmod_tpu_torch.ops import search as ops
    from kbmod_tpu_torch.ops.search import trajectory_offsets
    from kbmod_tpu_torch.scripts import regression as reg
    from kbmod_tpu_torch.search import StackSearch
    from kbmod_tpu_torch.trajectory_generator import create_trajectory_generator

    stack = reg.make_stack(seed)
    search = StackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, -1, device=dev)
    psi, phi, valid = search.psi_phi_array.decoded_psi_phi()
    T, H, W = psi.shape
    cands = list(create_trajectory_generator(reg.config_dict()["generator_config"]))
    dxs, dys = trajectory_offsets(np.array([c.vx for c in cands], np.float32),
                                  np.array([c.vy for c in cands], np.float32), search.zeroed_times)
    dxs, dys = torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev)
    C, K = len(cands), 8
    bounds = dict(x_min=-10, x_max=W + 10, y_min=-10, y_max=H + 10)
    SH, SW = H + 20, W + 20
    args = (psi, phi, valid, dxs, dys, 15, 25.0, SigmaGClipping.find_sigma_g_coeff(25, 75))
    kw = dict(k_results=K, sgl_L=0.25, sgl_H=0.75, **bounds)
    ops.search_topk_sigmag_exact(*args, **kw)
    ms = event_ms(lambda: ops.search_topk_sigmag_exact(*args, **kw), 3)
    log(f"K7 timed ({SH}x{SW}, C={C}, K={K}); clocks (sm, max sm, power, temperature): {clocks()}")
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        ops.search_topk_sigmag_exact(*args, **kw)
    clipped = tracing.totals().get("exact.clipped", 0)
    _, _, plain_ms, gap, differ = _k7_against_twin("at the regression's shapes", args, kw)
    n_samples = _valid_samples(valid, dxs + bounds["x_min"], dys + bounds["y_min"], SH, SW)
    nbytes = (4 + 4 + 1) * T * H * W + 8 * C * T + 8 * K * SH * SW
    bound_ms, bound_by = bound(nbytes, 3 * n_samples + (2 + K) * SH * SW * C)
    log(f"K7 at the regression's shapes: {clipped} of {SH * SW * C} pairs clipped "
        f"({clipped / (SH * SW * C):.3g}); lh within {gap:.3f} of the bound from the twin's, {differ} slots with "
        f"another index (ties)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by, err=gap,
                shape=f"T={T} {SH}x{SW} window, C={C}, K={K}, {n_samples} valid samples, {clipped} pairs clipped",
                evals_per_s=SH * SW * C / (ms / 1e3))


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
    # The host library (native/, g++) is built here too, so that no timed
    # phase pays for its first use.
    from kbmod_tpu_torch import native

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native library (kbmod_tpu_torch/native) did not build")
    log(f"native library: {native.library_path().name} in {time.perf_counter() - t0:.2f} s")
    for name in REPORTED:
        for fn, regs, st, ld in ptxas_summary(logs[name]):
            log(f"ptxas {name}.cu {fn}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")

    t0 = time.perf_counter()
    err_k1 = check_k1(dev)
    err_k2 = check_k2(dev)
    err_enc = check_encoded(dev)
    err_long = check_long_t(dev)
    err_k6 = check_k6(dev)
    err_k7 = check_k7(dev)
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")
    if args.checks_only:
        log(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

    walls = {}

    def phase(name, fn, *fn_args):
        """Run one path and keep its wall (host clock) for the summary."""
        t0 = time.perf_counter()
        out = fn(*fn_args)
        walls[name] = time.perf_counter() - t0
        return out

    stack, obj, cands, obj_c = phase("main stack", make_main_stack, args.seed)
    search, launches_f, full_rows, full_t = phase("float path", main_path, stack, obj, cands)
    searches, sparse, launches_q = phase("quantized path", quantized_path, stack, obj, cands, obj_c)
    launches_p, _, _ = phase("pipelines", pipeline_path, stack, obj, card, dev)
    launches_s = phase("switches", switch_path, search, searches, obj, cands, full_rows, full_t)
    launches_x = phase("exact sigma-G", exact_path, search, obj, cands, card)
    vetting = phase("vetting", vetting_path, stack, obj, card, dev)
    launches_c, _ = phase("ckpt", ckpt_path, search, searches, stack, cands, full_rows, full_t, args.seed, card)
    launches_sh, _ = phase("sharded", sharded_path, search, searches, stack, obj, cands, full_rows, card, dev)
    launches_prof = phase("profile", profile_path, stack, obj, card)
    launches_k6 = phase("K6 path", k6_path)
    launches_wu = phase("workunit and tools", workunit_path, stack, obj, card, dev)
    launches_disc, k2_disc = phase("discovery", discovery_path, stack, obj, card, dev)
    launches_survey = phase("survey", survey_path, card, dev)
    launches_ex = phase("examples", examples_path, card)
    t_timing = time.perf_counter()
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
    k5_cell = time_band_cell(dev)
    k6 = time_k6(dev)
    k7 = time_k7(dev)
    for name, r in (("K1 psi_phi_conv", k1), ("K2 search_topk", k2), ("K2 search_topk, band", k2_band),
                    ("K2 search_topk, band, K = 128", k2_long), ("K3 search_encoded", k3),
                    ("K3 search_encoded, band, K = 128", k3_long), ("K4 search_paired", k4),
                    ("K5 search_grouped", k5), ("K5 search_grouped, band", k5_band),
                    ("K5 search_grouped, band cell", k5_cell),
                    ("K7 sigmag_exact_topk, regression", k7)):
        log(f"{name} at {r['shape']}: {r['ms']:.3f} ms, twin {r['plain_ms']:.1f} ms, "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), library {r['library_ms']}"
            + (f", {r['evals_per_s']:.4g} evals/s" if "evals_per_s" in r else ""))
    log(f"K5 midscale through the dispatcher: {mid['ms']:.3f} ms, {mid['evals_per_s']:.4g} evals/s")
    for name, r in (("K2 search_topk, refine (K = 1)", k2_disc["refine"]),
                    ("K2 search_topk, evaluate_around (K in the maps)", k2_disc["around"])):
        log(f"{name}: {r['ms']:.4f} ms, twin {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    def entry(name, src, replaces, launches, err, r):
        return dict(name=name, route="cuda", source=f"kbmod_tpu_torch/csrc/{src}",
                    replaces=replaces if replaces.startswith("scripts/") else f"kbmod_tpu/ops/{replaces}",
                    launches=launches, max_abs_err=max(err, r["err"]),
                    ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"])

    launches = {k: launches_f[k] + launches_q[k] + launches_p.get(k, 0) + launches_s.get(k, 0) + launches_x.get(k, 0)
                + vetting["launches"].get(k, 0) + launches_c.get(k, 0) + launches_sh.get(k, 0)
                + launches_prof.get(k, 0) + launches_wu.get(k, 0) + launches_disc.get(k, 0)
                + launches_survey.get(k, 0) + launches_ex.get(k, 0) for k in launches_f}
    entries = [
        entry("psi_phi_conv", "psi_phi_conv.cu", "conv_pallas.py:32", launches["psi_phi_conv"], err_k1, k1),
        entry("search_topk", "search_topk.cu", "search_pallas.py:182", launches["search_topk"],
              max(err_k2, k2_band["err"], k2_long["err"], err_long["K2"], k2_disc["refine"]["err"],
                  k2_disc["around"]["err"]), k2),
        entry("search_encoded", "search_topk_encoded_grouped.cu", "search_pallas.py:505", launches["search_encoded"],
              max(err_enc["K3"], k3_long["err"], err_long["K3"]), k3),
        entry("search_paired", "search_topk_encoded.cu", "search_pallas.py:916", launches["search_paired"],
              err_enc["K4"], k4),
        entry("search_grouped", "search_topk_grouped.cu", "search_pallas.py:1493", launches["search_grouped"],
              max(err_enc["K5"], k5_band["err"], k5_cell["err"], err_long["K5"]), k5),
        # K6 at midscale's group count, in mode C (K5's inner loop); its
        # launches are those of its own path, the micro-benchmark script.
        entry("exactrow_accumulate", "exactrow_microbench.cu", "scripts/exactrow_microbench.py:49", launches_k6,
              err_k6, k6[(K6_MIDSCALE_NG, "C")]),
        # K7 replaces no Pallas kernel: the JAX package runs this search in
        # XLA. Its error is the largest lh gap over its bound (1e-5 relative).
        entry("sigmag_exact_topk", "sigmag_exact_topk.cu", "search.py search_topk_sigmag_exact (XLA)",
              launches["sigmag_exact_topk"], err_k7, k7),
    ]
    walls["kernel timings"] = time.perf_counter() - t_timing
    log("phase walls (s, host clock): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()) + f"; {card}")
    print(json.dumps({"kernels": entries}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
