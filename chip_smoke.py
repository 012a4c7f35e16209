#!/usr/bin/env python3
"""Run the kbmod_tpu_torch port on one CUDA card and check it end to end.

    python3 chip_smoke.py                # everything, one card
    python3 chip_smoke.py --checks-only  # build + kernel-against-twin checks

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card's name and power limit (nvidia-smi);
2. the nvcc build of every CUDA kernel, all sources compiled together;
3. kernel checks: each kernel against its plain PyTorch twin on the card
   (K1 over PSFs from 1 x 1 to 21 x 21; K2; K3, K4 and K5 over
   uint8/uint16 codes, T up to 300; the grouped kernels K2, K5 and K3 at
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
6. K6's own path, the micro-benchmark script
   (``kbmod_tpu_torch.scripts.exactrow_microbench``), driven with the
   counts at 0 and read after;
7. each kernel's time at the main path's shapes beside its twin's, its
   bound and (K1) cuDNN's grouped convolution, as one JSON line (K2 and K5
   at both of their main-path shapes: the full frame at K = 8 and the
   sigma-G band at K = 32, each held against the twin); K5 through the
   dispatcher (dedup + K5 + expansion) at the JAX package's
   ``midscale_kernel`` shapes (T = 64, 2048 x 2048, C = 33,153, K = 8);
   and K6's three modes at the script's defaults and at NG = 3,015;
8. as the last line, {"ok": true, "device": {...}}.

Imports nothing of the JAX package.
"""

import argparse
import json
import re
import subprocess
import sys
import time

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
# The group count of the midscale search's uniform plan: K6 is timed there too.
K6_MIDSCALE_NG = 3015
# em of the JAX package's midscale_kernel benchmark (bench.py:176-178).
MIDSCALE_EM = np.array([-6.0, 12.0 / 254, 0.1, 4.0 / 254], dtype=np.float32)


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
    # candidate set at K = 64.
    vd, vyd = vxs.copy(), vys.copy()
    vd[70:82], vyd[70:82] = vxs[3], vys[3]
    grouped_cases = [
        ("k64", (vxs, vys), full, 64),
        ("wide-spread", (vxs * 12, vys * 0.2), full, 8),
        ("ties-across", (vd, vyd), full, 32),
        ("extended-k64", (vxs, vys), dict(x_min=-40, x_max=W - 20, y_min=-33, y_max=H + 5), 64),
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
        log(f"K2 check {tag:12s} K={K:2d}: ok (indices equal, max |dlh| {err:.3g}, {nonzero} slots differ)")
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
    K = 1, 8 and 32; then dedup + expansion against the twin without
    dedup. Returns the largest |kernel - twin| lh per kernel."""
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
            for K in ((1, 8, 32, 64) if tag == "full" or not long_t else (8,)):
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
                log(f"{kernel} check u{bits} T={T:3d} {tag:12s} K={K:2d}: ok "
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
    return search, launches


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


def time_k2(search, cands, dev, bounds=None, K=8):
    """K2 at a float search's shapes and settings (min_obs T/2, min_lh 10
    with the insertion gated on it, as the full-frame search with
    results_per_pixel 8 and the sigma-G band search with its pool of 4 x 8
    run): median of 3 launches by CUDA events, the twin once, the bound.
    ``bounds`` defaults to the full frame."""
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
    t0 = time.perf_counter()
    ref = search_topk_shift(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, _ = _assert_k2_equal(f"main-path shapes {SH}x{SW} K={K}", got, ref)
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


def time_encoded(kernel, planes, times, cands, bounds, K, min_obs, min_lh, dev):
    """One encoded kernel at a main-path search's shapes and settings
    (gate on min_lh, as those searches run): median of 3 launches by CUDA
    events, the twin once, the bound."""
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
    t0 = time.perf_counter()
    ref = ek.search_topk_encoded_shift(planes.psi_codes, planes.phi_codes, dx_t, dy_t, min_obs, min_lh,
                                       planes.em, **kw)
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
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
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
    search, launches_f = main_path(stack, obj, cands)
    searches, sparse, launches_q = quantized_path(stack, obj, cands, obj_c)
    launches_k6 = k6_path()
    k1 = time_k1(stack, dev)
    T, H, W = len(stack.sci), *np.asarray(stack.sci[0]).shape
    y0 = obj.y - 128
    full = dict(x_min=0, x_max=W, y_min=0, y_max=H)
    band = dict(x_min=0, x_max=W, y_min=y0, y_max=y0 + 256)
    k2 = time_k2(search, cands, dev)
    # The sigma-G band search's K2 launch: a pool of 4 x 8, the same gates.
    k2_band = time_k2(search, cands, dev, band, 32)
    del search
    u8 = searches["u8"]._eval_planes()[0]
    u16 = searches["u16"]._eval_planes()[0]
    times = stack.zeroed_times
    k5 = time_encoded("K5", u8, times, cands, full, 8, float(T // 2), 10.0, dev)
    # The sigma-G band search's K5 launch: K = 32, the same gates.
    k5_band = time_encoded("K5", u8, times, cands, band, 32, float(T // 2), 10.0, dev)
    k3 = time_encoded("K3", u16, times, cands, band, 8, float(T // 2), 10.0, dev)
    k4 = time_encoded("K4", u8, times, sparse, band, 8, float(T // 2), 10.0, dev)
    del searches, u8, u16
    torch.cuda.empty_cache()
    mid = time_midscale(dev)
    k6 = time_k6(dev)
    for name, r in (("K1 psi_phi_conv", k1), ("K2 search_topk", k2), ("K2 search_topk, band", k2_band),
                    ("K3 search_encoded", k3), ("K4 search_paired", k4), ("K5 search_grouped", k5),
                    ("K5 search_grouped, band", k5_band)):
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

    launches = {k: launches_f[k] + launches_q[k] for k in launches_f}
    entries = [
        entry("psi_phi_conv", "psi_phi_conv.cu", "conv_pallas.py:32", launches["psi_phi_conv"], err_k1, k1),
        entry("search_topk", "search_topk.cu", "search_pallas.py:182", launches["search_topk"],
              max(err_k2, k2_band["err"], err_long["K2"]), k2),
        entry("search_encoded", "search_topk_encoded_grouped.cu", "search_pallas.py:505", launches["search_encoded"],
              max(err_enc["K3"], err_long["K3"]), k3),
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
