"""The plain reference against brute-force loops at tiny sizes."""

import math

import numpy as np
import pytest
import torch

from benchmarks import generator
from benchmarks.reference import core, judge

F64 = torch.float64


def _stack(seed=3, T=3, H=9, W=11):
    rng = np.random.default_rng(seed)
    sci = rng.normal(0, 2, (T, H, W))
    var = rng.uniform(1, 5, (T, H, W))
    sci[0, 2, 3] = np.nan
    var[1, 4, 4] = -1.0
    psfs = [generator.gaussian_psf(s) for s in (0.5, 1.0, 0.7)][:T]
    return sci, var, psfs


def test_build_against_a_loop():
    sci, var, psfs = _stack()
    psi, phi = core.build(torch.tensor(sci), torch.tensor(var), psfs)
    T, H, W = sci.shape
    for t in range(T):
        k = psfs[t].astype(np.float64)
        r = k.shape[0] // 2
        valid = np.isfinite(sci[t]) & np.isfinite(var[t]) & (var[t] > 0)
        for y in range(H):
            for x in range(W):
                if not valid[y, x]:
                    assert math.isnan(psi[t, y, x]) and math.isnan(phi[t, y, x])
                    continue
                a = b = m1 = m2 = 0.0
                for i in range(-r, r + 1):
                    for j in range(-r, r + 1):
                        yy, xx = y + i, x + j
                        if 0 <= yy < H and 0 <= xx < W and valid[yy, xx]:
                            w = k[i + r, j + r]
                            a += w * sci[t, yy, xx] / var[t, yy, xx]
                            b += w * w / var[t, yy, xx]
                            m1 += w
                            m2 += w * w
                assert psi[t, y, x].item() == pytest.approx(a * k.sum() / m1, rel=1e-12)
                assert phi[t, y, x].item() == pytest.approx(b * (k * k).sum() / m2, rel=1e-12)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_against_a_loop(bits):
    plane = torch.tensor([[0.0, 1.0, np.nan], [2.5, -3.0, 7.0]], dtype=F64)
    decoded, codes = core.quantize(plane, bits)
    lo, hi = -3.0, 7.0
    scale = (hi - lo) / (2**bits - 1)
    for v, c, d in zip(plane.flatten().tolist(), codes.flatten().tolist(), decoded.flatten().tolist()):
        if math.isnan(v):
            assert c == 0 and math.isnan(d)
            continue
        want = min(int(math.floor((v - lo) / scale)) + 1, 2**bits - 1)
        assert c == want and d == pytest.approx((want - 1) * scale + lo, rel=1e-15)


def _loop_curves(psi, phi, x, y, vx, vy, times):
    T, H, W = psi.shape
    out = []
    for t in range(T):
        px = x + int(math.floor(float(np.float32(vx)) * times[t] + 0.5))
        py = y + int(math.floor(float(np.float32(vy)) * times[t] + 0.5))
        ok = 0 <= px < W and 0 <= py < H and math.isfinite(psi[t, py, px])
        out.append((psi[t, py, px] if ok else 0.0, phi[t, py, px] if ok else 0.0, ok))
    return out


def test_curves_and_raw_scores_against_a_loop():
    sci, var, psfs = _stack()
    psi, phi = core.build(torch.tensor(sci), torch.tensor(var), psfs)
    times = np.array([0.0, 0.7, 1.9])
    vxs, vys = np.float32([1.3, -2.2, 0.0]), np.float32([0.4, 1.1, -3.6])
    dxs, dys = core.offsets(vxs, vys, times, "cpu")
    xs, ys = torch.tensor([2, 9, 5]), torch.tensor([1, 3, 8])
    pv, fv, ok = core.curves(psi, phi, xs, ys, dxs, dys)
    lh, obs, flux = core.raw_scores(pv, fv, ok)
    for n in range(3):
        ref = _loop_curves(psi.numpy(), phi.numpy(), int(xs[n]), int(ys[n]), vxs[n], vys[n], times)
        ps, fs = sum(r[0] for r in ref), sum(r[1] for r in ref)
        assert obs[n].item() == sum(r[2] for r in ref)
        assert lh[n].item() == pytest.approx(ps / math.sqrt(fs) if fs > 0 else -1.0, rel=1e-12)
        assert flux[n].item() == pytest.approx(ps / fs if fs > 0 else -1.0, rel=1e-12)


def _loop_kernel_clip(psi, phi, ok, lo, hi, coeff):
    vals = [(psi[t] / phi[t] if phi[t] != 0 else 0.0, t) for t in range(len(psi)) if ok[t]]
    vals.sort(key=lambda v: v[0])
    n = len(vals)
    if n == 0:
        return -1.0

    def pct(q):
        return min(max(int(math.ceil(n * q) + 0.001) - 1, 0), n - 1)

    v = [a for a, _ in vals]
    i_lo, i_mid, i_hi = pct(lo), pct(0.5), pct(hi)
    sg = coeff * (v[i_hi] - v[i_lo])
    start = 0
    while start < i_mid and v[start] < v[i_mid] - 2 * sg:
        start += 1
    end = i_mid + 1
    while end < n and v[end] <= v[i_mid] + 2 * sg:
        end += 1
    kept = [t for _, t in vals[start:end]]
    ps, fs = sum(psi[t] for t in kept), sum(phi[t] for t in kept)
    return ps / math.sqrt(fs) if fs > 0 else -1.0


def test_kernel_clip_against_a_loop():
    rng = np.random.default_rng(7)
    psi = rng.normal(1, 2, (40, 13))
    psi[:5, 3] = 60.0  # outliers the clip drops
    phi = rng.uniform(0.2, 1.0, (40, 13))
    ok = rng.uniform(size=(40, 13)) > 0.2
    psi, phi = np.where(ok, psi, 0.0), np.where(ok, phi, 0.0)
    coeff = core.sigma_g_coeff(25, 75)
    lh, _ = core.kernel_clip(torch.tensor(psi), torch.tensor(phi), torch.tensor(ok), 0.25, 0.75, coeff)
    for n in range(40):
        assert lh[n].item() == pytest.approx(_loop_kernel_clip(psi[n], phi[n], ok[n], 0.25, 0.75, coeff), rel=1e-12)


@pytest.mark.parametrize("clip_negative", [False, True])
def test_host_clip_against_a_loop(clip_negative):
    rng = np.random.default_rng(8)
    psi = rng.normal(0.5, 2, (30, 17))
    psi[:, 4] += 40.0
    phi = rng.uniform(0.5, 1.0, (30, 17))
    phi[rng.uniform(size=phi.shape) < 0.1] = 0.0
    kept = core.host_clip(torch.tensor(psi), torch.tensor(phi), {"sigmaG_lims": [25, 75], "clip_negative": clip_negative})
    coeff = core.sigma_g_coeff(25, 75)
    for n in range(30):
        lh = np.where(phi[n] != 0, psi[n] / np.sqrt(np.where(phi[n] != 0, phi[n], 1.0)), np.nan)
        pool = lh[np.isfinite(lh) & (lh > 0)] if clip_negative else lh[np.isfinite(lh)]
        p_lo, med, p_hi = np.percentile(pool, [25, 50, 75])
        reach = 2 * coeff * max(p_hi - p_lo, 1e-5)
        want = np.isfinite(lh) & (lh > med - reach) & (lh < med + reach)
        assert np.array_equal(kept[n].numpy(), want)


def test_coadds_against_a_loop():
    rng = np.random.default_rng(9)
    sci = rng.normal(0, 1, (4, 12, 10))
    xs, ys = np.array([1, 8]), np.array([2, 11])
    vxs, vys = np.array([2.0, -1.5]), np.array([0.5, -3.0])
    times = np.array([0.0, 0.5, 1.0, 1.5])
    kept = torch.tensor([[True, True, False, True], [True, False, True, True]])
    win = core.stamps(torch.tensor(sci), xs, ys, vxs, vys, times, 2)
    got = core.coadds(win, kept, ["sum", "mean", "median"])
    for n in range(2):
        for i in range(5):
            for j in range(5):
                vals = []
                for t in range(4):
                    cx, cy = int(xs[n] + vxs[n] * times[t] + 0.5), int(ys[n] + vys[n] * times[t] + 0.5)
                    r, c = cy + i - 2, cx + j - 2
                    if kept[n, t] and 0 <= r < 12 and 0 <= c < 10:
                        vals.append(sci[t, r, c])
                assert got["sum"][n, i, j].item() == pytest.approx(sum(vals), abs=1e-12)
                assert got["mean"][n, i, j].item() == pytest.approx(sum(vals) / len(vals) if vals else 0.0, abs=1e-12)
                med = sorted(vals)[(len(vals) - 1) // 2] if vals else 0.0
                assert got["median"][n, i, j].item() == med


def test_search_numbers_see_a_missing_candidate():
    """At a pixel where the reference's best candidate is left out of the
    program's list, the rank gap reads its shortfall; the full list reads 0."""
    sci, var, psfs = _stack(T=3, H=9, W=11)
    sci[:, 4, 5] += 30.0
    stack = generator.Stack(times=np.array([0.0, 0.5, 1.0]), sci=sci.astype(np.float32),
                            var=list(var.astype(np.float32)), psfs=psfs, objects=[])
    grid = (np.float32([0.0, 1.0, 2.0]), np.float32([0.0, 0.0, 1.0]))
    settings = {"num_obs": 1, "lh_level": -1e9, "encode_num_bytes": -1}
    ref = judge.ReferenceStack(stack, settings, grid, "cpu")
    gated, _, valid = ref.pixel_scores(5, 4, settings, 0.7413)
    order = torch.argsort(gated, descending=True).numpy()
    full = (order, gated.numpy()[order], valid.numpy()[order])
    numbers, bad = judge.search_numbers([ref], lambda s: 0, {(0, 5, 4): full}, settings, 3)
    assert numbers == {"search_lh_gap": 0.0, "search_rank_gap": 0.0} and bad == 0
    short = tuple(a[1:] for a in full)
    numbers, _ = judge.search_numbers([ref], lambda s: 0, {(0, 5, 4): short}, settings, 3)
    assert numbers["search_rank_gap"] > 0.01
