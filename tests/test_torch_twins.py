"""The kernels' plain twins, chunked over candidates, against the loop over
candidates and times that they replace (kept here as the reference).

``search_topk_shift`` (K2's twin) and ``search_topk_encoded_shift`` (the
twin of K3, K4 and K5) gather a chunk of candidates' windows at a time from
planes cropped to what the windows reach (``twin_window_sums``: one
indexing op a step on a card, a slice a candidate on the host; both are
run here) and merge each chunk into the lists with a stable sort. The loop
versions below are those functions as they were: one candidate at a time,
one time step at a time, out-of-image steps skipped. Tolerance: exact,
lh and indices bit for bit, including the order of exact ties (the planes
hold few distinct values, so ties are common), over windows that start off
the image, masked pixels, gates, padding candidates, a candidate offset,
K above and below C, and chunks of one, several and all candidates.
"""

import numpy as np
import pytest
import torch

from kbmod_tpu_torch.ops import search_kernel
from kbmod_tpu_torch.ops.psi_phi import _codes_as_int, _f32
from kbmod_tpu_torch.ops.search_encoded_kernel import search_topk_encoded_shift
from kbmod_tpu_torch.ops.search_kernel import FLT_MAX, search_topk_shift


def _insert(top, topi, new, newi, kidx):
    p = (top >= new[None]).sum(dim=0)[None]
    shifted = torch.cat([top[:1], top[:-1]])
    shiftedi = torch.cat([topi[:1], topi[:-1]])
    at_p, below = kidx == p, kidx > p
    return (torch.where(at_p, new[None], torch.where(below, shifted, top)),
            torch.where(at_p, newi, torch.where(below, shiftedi, topi)))


def loop_k2_twin(psi, phi, valid, dxs, dys, min_obs, min_lh, *, x_min, x_max, y_min, y_max, k_results,
                 gate_min_obs=True, gate_min_lh=False, has_masked=True, cand_valid=None, cand_offset=0):
    T, H, W = psi.shape
    SH, SW, K = y_max - y_min, x_max - x_min, int(k_results)
    oy = (dys.to(torch.int64) + int(y_min)).numpy()
    ox = (dxs.to(torch.int64) + int(x_min)).numpy()
    c_ok = np.ones(len(ox), bool) if cand_valid is None else np.asarray(cand_valid, bool)
    top = torch.full((K, SH, SW), -FLT_MAX, dtype=torch.float32)
    topi = torch.full((K, SH, SW), -1, dtype=torch.int32)
    kidx = torch.arange(K)[:, None, None]
    for c in range(len(ox)):
        psi_s = torch.zeros((SH, SW), dtype=torch.float32)
        phi_s = torch.zeros_like(psi_s)
        obs = torch.zeros_like(psi_s)
        for t in range(T):
            i0, i1 = max(0, -oy[c, t]), min(SH, H - oy[c, t])
            j0, j1 = max(0, -ox[c, t]), min(SW, W - ox[c, t])
            if i0 >= i1 or j0 >= j1:
                continue
            rows = slice(oy[c, t] + i0, oy[c, t] + i1)
            cols = slice(ox[c, t] + j0, ox[c, t] + j1)
            ps, fs = psi[t, rows, cols], phi[t, rows, cols]
            if has_masked:
                ok = valid[t, rows, cols] != 0
                ps, fs, mf = torch.where(ok, ps, 0.0), torch.where(ok, fs, 0.0), ok.to(torch.float32)
            else:
                mf = torch.ones_like(ps)
            psi_s[i0:i1, j0:j1] += ps
            phi_s[i0:i1, j0:j1] += fs
            obs[i0:i1, j0:j1] += mf
        lh = torch.where(phi_s > 0, psi_s / torch.sqrt(phi_s.double()).float(), -1.0)
        ok = torch.full((SH, SW), bool(c_ok[c]))
        if gate_min_obs:
            ok &= obs >= float(min_obs)
        if gate_min_lh:
            ok &= lh >= float(min_lh)
        top, topi = _insert(top, topi, torch.where(ok, lh, float("-inf")), int(cand_offset) + c, kidx)
    return top, topi


def loop_encoded_twin(psi_codes, phi_codes, dxs, dys, min_obs, min_lh, em, *, x_min, x_max, y_min, y_max,
                      k_results, gate_min_obs=True, gate_min_lh=False, cand_valid=None, cand_offset=0):
    T, H, W = psi_codes.shape
    SH, SW, K = y_max - y_min, x_max - x_min, int(k_results)
    oy = (dys.to(torch.int64) + int(y_min)).numpy()
    ox = (dxs.to(torch.int64) + int(x_min)).numpy()
    c_ok = np.ones(len(ox), bool) if cand_valid is None else np.asarray(cand_valid, bool)
    pc, fc = _codes_as_int(psi_codes), _codes_as_int(phi_codes)
    both = (pc > 0) & (fc > 0)
    pc, fc, ob = torch.where(both, pc, 0), torch.where(both, fc, 0), both.to(torch.int32)
    em = np.asarray(em, np.float32)
    s_psi, d_psi = _f32(em[1], "cpu"), _f32(em[0] - em[1], "cpu")
    s_phi, d_phi = _f32(em[3], "cpu"), _f32(em[2] - em[3], "cpu")
    top = torch.full((K, SH, SW), -FLT_MAX, dtype=torch.float32)
    topi = torch.full((K, SH, SW), -1, dtype=torch.int32)
    kidx = torch.arange(K)[:, None, None]
    for c in range(len(ox)):
        sp = torch.zeros((SH, SW), dtype=torch.int32)
        sf, so = torch.zeros_like(sp), torch.zeros_like(sp)
        for t in range(T):
            i0, i1 = max(0, -oy[c, t]), min(SH, H - oy[c, t])
            j0, j1 = max(0, -ox[c, t]), min(SW, W - ox[c, t])
            if i0 >= i1 or j0 >= j1:
                continue
            rows = slice(oy[c, t] + i0, oy[c, t] + i1)
            cols = slice(ox[c, t] + j0, ox[c, t] + j1)
            sp[i0:i1, j0:j1] += pc[t, rows, cols]
            sf[i0:i1, j0:j1] += fc[t, rows, cols]
            so[i0:i1, j0:j1] += ob[t, rows, cols]
        obs = so.to(torch.float32)
        psi_s = s_psi * sp.to(torch.float32) + d_psi * obs
        phi_s = s_phi * sf.to(torch.float32) + d_phi * obs
        lh = torch.where(phi_s > 0, psi_s / torch.sqrt(phi_s.double()).float(), -1.0)
        ok = torch.full((SH, SW), bool(c_ok[c]))
        if gate_min_obs:
            ok &= obs >= float(min_obs)
        if gate_min_lh:
            ok &= lh >= float(min_lh)
        top, topi = _insert(top, topi, torch.where(ok, lh, float("-inf")), int(cand_offset) + c, kidx)
    return top, topi


def _offsets(rng, C, T, reach):
    """(C, T) int32 offsets of straight paths, some leaving the image."""
    t = np.arange(T)[None, :]
    vx, vy = rng.uniform(-reach, reach, (2, C, 1))
    return (torch.as_tensor(np.floor(vx * t + 0.5).astype(np.int32)),
            torch.as_tensor(np.floor(vy * t + 0.5).astype(np.int32)))


# (window, K, C, chunk pairs): a window inside the image, one reaching past
# every edge, K above C; chunks of one candidate, several, all.
CASES = [
    (dict(x_min=0, x_max=24, y_min=0, y_max=20), 4, 9, 1),
    (dict(x_min=-5, x_max=29, y_min=-4, y_max=23), 3, 12, 700),
    (dict(x_min=6, x_max=14, y_min=3, y_max=9), 16, 7, 1 << 20),
]


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("masked", [True, False])
def test_k2_twin_equals_loop(monkeypatch, case, masked, batched):
    bounds, K, C, chunk = CASES[case]
    monkeypatch.setitem(search_kernel.TWIN_CHUNK_PAIRS, "cpu", chunk)
    monkeypatch.setitem(search_kernel.TWIN_BATCHED, "cpu", batched)
    rng = np.random.default_rng(10 + case)
    T, H, W = 6, 19, 23
    # Few distinct values, so that exact lh ties occur.
    psi = torch.as_tensor(rng.integers(-2, 4, (T, H, W)).astype(np.float32) * 0.5)
    phi = torch.as_tensor(rng.integers(1, 4, (T, H, W)).astype(np.float32))
    valid = torch.as_tensor((rng.random((T, H, W)) > (0.1 if masked else 0.0)).astype(np.uint8))
    dxs, dys = _offsets(rng, C, T, 3.0)
    cand_valid = rng.random(C) > 0.2
    for kw in (dict(), dict(gate_min_lh=True, cand_valid=cand_valid, cand_offset=5), dict(gate_min_obs=False)):
        args = (psi, phi, valid, dxs, dys, 3.0, 0.5)
        got = search_topk_shift(*args, k_results=K, has_masked=masked, **bounds, **kw)
        want = loop_k2_twin(*args, k_results=K, has_masked=masked, **bounds, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), kw
        assert int((want[1] >= 0).sum()) > 0


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16])
def test_encoded_twin_equals_loop(monkeypatch, case, dtype, batched):
    bounds, K, C, chunk = CASES[case]
    monkeypatch.setitem(search_kernel.TWIN_CHUNK_PAIRS, "cpu", chunk)
    monkeypatch.setitem(search_kernel.TWIN_BATCHED, "cpu", batched)
    rng = np.random.default_rng(20 + case)
    T, H, W = 6, 19, 23
    hi = 256 if dtype == torch.uint8 else 65536
    codes = [rng.integers(0, 5, (T, H, W)) * (hi // 8) for _ in range(2)]
    if dtype == torch.uint8:
        psi_c, phi_c = (torch.as_tensor(c.astype(np.uint8)) for c in codes)
    else:
        psi_c, phi_c = (torch.as_tensor(c.astype(np.uint16).view(np.int16)).view(torch.uint16) for c in codes)
    em = np.array([-6.0, 12.0 / (hi - 2), 0.1, 4.0 / (hi - 2)], np.float32)
    dxs, dys = _offsets(rng, C, T, 3.0)
    cand_valid = rng.random(C) > 0.2
    for kw in (dict(), dict(gate_min_lh=True, cand_valid=cand_valid, cand_offset=3), dict(gate_min_obs=False)):
        args = (psi_c, phi_c, dxs, dys, 3.0, 0.0, em)
        got = search_topk_encoded_shift(*args, k_results=K, **bounds, **kw)
        want = loop_encoded_twin(*args, k_results=K, **bounds, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), kw
        assert int((want[1] >= 0).sum()) > 0
