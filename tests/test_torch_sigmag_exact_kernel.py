"""K7, the exact sigma-G search's CUDA kernel, on the CPU: what surrounds it.

- The percentile table ``search_topk_sigmag_exact`` hands the kernel (built
  by the twin's own ``_percentile_indices``) against the host's scalar
  ``sigmag_bounds_indices``.
- The dispatch rule (``k7_route``: the kernel on a card, the twin elsewhere)
  as a pure function, and ``search_topk_sigmag_exact`` taking the route it
  names with every argument handed through.
- The kernel's algorithm replayed in numpy (:func:`k7_replay`: the unclipped
  gate in time order, the clipped curve either sorted by stable insertion
  or walked in sorted order without being held, the keep window, the
  rank-insert at ``#(top >= new)``) against the twin, over the cases the
  card test runs (tests/test_torch_kernels_gpu.py imports :data:`CASES`,
  :func:`exact_case` and :func:`assert_maps_match`).

Tolerances: the maps' lh within 1e-5 * max(1, |lh|) (ROADMAP Queue 3: the
sums run in another order than the twin's PyTorch reductions); indices equal
except where the two candidates' own clipped lh tie within twice that.
"""

import numpy as np
import pytest
import torch

from kbmod_tpu_torch import tracing
from kbmod_tpu_torch.ops import search as ops
from kbmod_tpu_torch.ops import sigmag_exact_kernel as k7
from kbmod_tpu_torch.ops.search import sigmag_bounds_indices, trajectory_offsets

FLT_MAX = float(np.finfo(np.float32).max)
# Each case of the card test: T and K (within and past the curve the kernel
# sorts in local memory, 128 samples, and the list it keeps in registers, 32),
# masked samples, a window starting at negative x and y, candidates that
# leave the frame, a negative coefficient, candidates with identical offsets
# (exact ties the index decides) and a non-zero cand_offset.
CASES = {
    "T5": dict(T=5),
    "T12": dict(),
    "T20": dict(T=20),
    "T-past-limit": dict(T=130, H=12, W=16, dt=0.005, masked=0.01),
    "K1": dict(K=1),
    "K8": dict(K=8),
    "K-past-limit": dict(K=33, C=40),
    "masked": dict(masked=0.3, min_obs=3.0),
    "negative-window": dict(x_min=-5, y_min=-4),
    "leaving-frame": dict(fast=8.0),
    "negative-coeff": dict(coeff=-0.7413),
    "ties": dict(ties=True),
    "cand-offset": dict(cand_offset=1000),
}


def exact_case(T=12, K=4, H=24, W=40, C=30, masked=0.05, x_min=-2, y_min=0, fast=0.0, coeff=0.7413,
               ties=False, cand_offset=0, min_obs=None, dt=0.3, seed=31):
    """Planes (numpy), offsets and keyword arguments of one exact search: a
    noisy psi with spikes of both signs (so clipping keeps and drops
    samples), uniform phi; times ``dt`` apart, half the candidates at up to
    ``fast`` pixels a time unit (0: all within 3)."""
    rng = np.random.default_rng(seed)
    valid = (rng.uniform(size=(T, H, W)) > masked).astype(np.uint8)
    psi = rng.normal(1.0, 0.5, (T, H, W))
    hit = rng.random((T, H, W)) < 0.05
    psi[hit] = rng.choice([-30.0, 30.0], int(hit.sum()))
    psi = np.where(valid, psi, 0).astype(np.float32)
    phi = np.where(valid, rng.uniform(0.5, 2.0, (T, H, W)), 0).astype(np.float32)
    vx, vy = rng.uniform(-3, 3, C), rng.uniform(-3, 3, C)
    if fast:
        vx[::2], vy[::2] = rng.uniform(-fast, fast, (C + 1) // 2), rng.uniform(-fast, fast, (C + 1) // 2)
    dxs, dys = trajectory_offsets(vx, vy, np.arange(T) * dt)
    if ties:
        dxs[[5, C - 1]], dys[[5, C - 1]] = dxs[2], dys[2]
    kw = dict(x_min=x_min, x_max=x_min + W, y_min=y_min, y_max=y_min + H, k_results=K, sgl_L=0.25, sgl_H=0.75,
              cand_offset=cand_offset)
    gates = (float(min(4, T - 1)) if min_obs is None else min_obs, 0.5, coeff)
    return (psi, phi, valid), dxs, dys, gates, kw


def own_maps(planes, dxs, dys, gates, kw):
    """Each candidate's own clipped lh map (its K = 1 search by the twin)."""
    own = dict(kw, k_results=1, cand_offset=0)
    planes = [torch.as_tensor(p) for p in planes]
    return [ops.search_topk_sigmag_exact(*planes, dxs[c:c + 1], dys[c:c + 1], *gates, **own)[0][0].numpy()
            for c in range(len(dxs))]


def assert_maps_match(got, ref, own, cand_offset=0, filled=0.5):
    """(lh, idx) maps ``got`` against the twin's ``ref``: the same slots
    filled (more than ``filled`` of them), lh within 1e-5 * max(1, |lh|),
    indices equal but where the two candidates' own lh (``own``, by local
    index) tie within twice that."""
    (g_lh, g_idx), (r_lh, r_idx) = got, ref
    bound = 1e-5 * np.maximum(1.0, np.abs(r_lh))
    assert np.array_equal(g_idx < 0, r_idx < 0) and (g_idx >= 0).sum() > filled * g_idx.size
    same = g_idx == r_idx
    kept = same & (g_idx >= 0)
    assert np.all(np.abs(g_lh[kept] - r_lh[kept]) <= bound[kept])
    for k, i, j in np.argwhere(~same):
        a, b = g_idx[k, i, j] - cand_offset, r_idx[k, i, j] - cand_offset
        assert abs(own[a][i, j] - own[b][i, j]) <= 2 * bound[k, i, j]


def _lh(ps, fs):
    return np.float32(ps / np.sqrt(fs)) if fs > 0 else np.float32(-1.0)


def _table(T, sgl_L, sgl_H):
    """The percentile table ``search_topk_sigmag_exact`` hands the kernel."""
    return torch.stack(ops._percentile_indices(torch.arange(T + 1), sgl_L, sgl_H), 1).int()


def _window_sums(vals, pairs, iL, iM, iH, coeff):
    """The keep window of a sorted curve and its psi and phi summed in sorted
    order: ``vals[k]`` and ``pairs(k)`` (psi, phi) at sorted position k."""
    n = len(vals)
    reach = np.float32(2) * (coeff * (vals[iH] - vals[iL]))
    lo, hi = vals[iM] - reach, vals[iM] + reach
    start = min(sum(v < lo for v in vals), iM)
    end = next((k for k in range(iM + 1, n) if vals[k] > hi), n)
    ps = fs = np.float32(0)
    for k in range(start, end):
        p, f = pairs(k)
        ps, fs = ps + p, fs + f
    return _lh(ps, fs)


def _clipped_local(samples, pct, coeff):
    """A pair's clipped lh as K7 forms it up to 128 samples: each sample
    inserted after every equal value into the curve held in local memory."""
    curve = []
    for p, f in samples:
        v = p / f if f != 0 else np.float32(0)
        at = len(curve)
        while at > 0 and curve[at - 1][0] > v:
            at -= 1
        curve.insert(at, (v, p, f))
    return _window_sums([e[0] for e in curve], lambda k: curve[k][1:], *pct[len(samples)], coeff)


def _clipped_walk(samples, pct, coeff):
    """A pair's clipped lh as K7 forms it past 128 samples: the curve is not
    held; each step in sorted order is one pass over the samples in time
    order for the least (value, time) after the last, the first such on an
    equal value."""
    curve = [(p / f if f != 0 else np.float32(0), p, f) for p, f in samples]

    def walk():
        vc, tc = np.float32(-np.inf), -1
        while True:
            tn = -1
            for t, (v, _, _) in enumerate(curve):
                if (v > vc or (v == vc and t > tc)) and (tn < 0 or v < curve[tn][0]):
                    tn = t
            if tn < 0:
                return
            vc, tc = curve[tn][0], tn
            yield curve[tn]

    order = list(walk())
    assert len(order) == len(curve)
    return _window_sums([e[0] for e in order], lambda k: order[k][1:], *pct[len(samples)], coeff)


def k7_replay(planes, dxs, dys, gates, kw, local_t=128):
    """K7's arithmetic for one launch, in numpy float32 scalars: for each
    start pixel the candidates in index order, the sums in time order, the
    unclipped gate, then for a pair that passes its clipped lh with the
    percentile indices from the host table, by the local sort up to
    ``local_t`` samples and by the walk past it, and the rank-insert at
    p = #(top >= new)."""
    psi, phi, valid = planes
    min_obs, min_lh, coeff = (np.float32(g) for g in gates)
    T, H, W = psi.shape
    K, x0, y0 = kw["k_results"], kw["x_min"], kw["y_min"]
    SH, SW = kw["y_max"] - y0, kw["x_max"] - x0
    pct = _table(T, kw["sgl_L"], kw["sgl_H"]).numpy()
    clipped_lh = _clipped_local if T <= local_t else _clipped_walk
    top_lh = np.full((K, SH, SW), -FLT_MAX, np.float32)
    top_idx = np.full((K, SH, SW), -1, np.int32)
    for i in range(SH):
        for j in range(SW):
            top = [(np.float32(-FLT_MAX), -1)] * K
            for c in range(len(dxs)):
                ys, xs = y0 + i + dys[c], x0 + j + dxs[c]
                samples = [(psi[t, ys[t], xs[t]], phi[t, ys[t], xs[t]]) for t in range(T)
                           if 0 <= ys[t] < H and 0 <= xs[t] < W and valid[t, ys[t], xs[t]]]
                ps = fs = np.float32(0)
                for p, f in samples:
                    ps, fs = ps + p, fs + f
                n = len(samples)
                if n == 0 or np.float32(n) < min_obs or not _lh(ps, fs) >= min_lh:
                    continue
                lh = clipped_lh(samples, pct, coeff)
                if lh >= min_lh:
                    p_at = sum(t[0] >= lh for t in top)
                    if p_at < K:
                        top = top[:p_at] + [(lh, kw["cand_offset"] + c)] + top[p_at:K - 1]
            for k, (lh, idx) in enumerate(top):
                top_lh[k, i, j], top_idx[k, i, j] = lh, idx
    return top_lh, top_idx


def _handed_to_kernel(monkeypatch, planes, dxs, dys, gates, kw, **extra):
    """What ``search_topk_sigmag_exact`` hands the kernel when the route
    names it: its positional and keyword arguments."""
    seen = {}

    def kernel(*args, **kwargs):
        seen["args"], seen["kwargs"] = args, kwargs
        return "maps"

    monkeypatch.setattr(ops, "k7_route", lambda device: "kernel")
    monkeypatch.setattr(ops, "sigmag_exact_topk", kernel)
    assert ops.search_topk_sigmag_exact(*planes, dxs, dys, *gates, **extra, **kw) == "maps"
    return seen["args"], seen["kwargs"]


@pytest.mark.parametrize("lims", [(0.25, 0.75), (0.0, 1.0), (0.1, 0.9), (0.5, 0.5)])
@pytest.mark.parametrize("T", [1, 5, 20, 100, 130])
def test_percentile_table_matches_the_scalar_indices(monkeypatch, T, lims):
    planes = [torch.zeros((T, 2, 3)), torch.ones((T, 2, 3)), torch.ones((T, 2, 3), dtype=torch.uint8)]
    kw = dict(x_min=0, x_max=3, y_min=0, y_max=2, k_results=1, sgl_L=lims[0], sgl_H=lims[1])
    offsets = np.zeros((4, T), np.int32)
    _, handed = _handed_to_kernel(monkeypatch, planes, offsets, offsets, (0.0, 0.0, 0.7413), kw)
    table = handed["pct_idx"]
    assert tuple(table.shape) == (T + 1, 3) and table.dtype == torch.int32
    assert tuple(table[0].tolist()) == (0, 0, 0)
    for n in range(1, T + 1):
        assert tuple(table[n].tolist()) == sigmag_bounds_indices(n, *lims)


@pytest.mark.parametrize("device,route", [
    ("cpu", "twin"),
    ("cuda", "kernel"),
    ("mps", "twin"),
    ("meta", "twin"),
    ("xpu", "twin"),
])
def test_k7_route(device, route):
    assert k7.k7_route(device) == route


def test_the_cpu_runs_the_twin(monkeypatch):
    planes, dxs, dys, gates, kw = exact_case(T=5, H=8, W=10, C=6)

    def refuse(*args, **kwargs):
        raise AssertionError("K7 launched for CPU tensors")

    monkeypatch.setattr(ops, "sigmag_exact_topk", refuse)
    lh, idx = ops.search_topk_sigmag_exact(*(torch.as_tensor(p) for p in planes), dxs, dys, *gates, **kw)
    assert lh.shape == idx.shape == (kw["k_results"], 8, 10) and (idx >= 0).any()


def test_the_kernel_route_hands_every_argument_through(monkeypatch):
    planes, dxs, dys, gates, kw = exact_case(T=5, H=8, W=10, C=6, x_min=-3, y_min=-1, cand_offset=17)
    planes = [torch.as_tensor(p) for p in planes]
    args, handed = _handed_to_kernel(monkeypatch, planes, dxs, dys, gates, kw, row_tile=3)
    assert args[:3] == tuple(planes) and args[5:] == gates
    assert np.array_equal(args[3], dxs) and np.array_equal(args[4], dys)
    table = handed.pop("pct_idx")
    assert torch.equal(table, _table(5, kw["sgl_L"], kw["sgl_H"]))
    assert handed == {k: v for k, v in kw.items() if k not in ("sgl_L", "sgl_H")}


@pytest.mark.parametrize("curve", ["local", "walk"])
@pytest.mark.parametrize("case", ["T5", "masked", "negative-window", "leaving-frame", "negative-coeff", "ties",
                                  "cand-offset", "K8", "K-past-limit"])
def test_k7_replay_matches_the_twin(case, curve):
    spec = dict(dict(H=7, W=9, C=12), **CASES[case])
    planes, dxs, dys, gates, kw = exact_case(**spec)
    got = k7_replay(planes, dxs, dys, gates, kw, local_t=128 if curve == "local" else 0)
    ref = [a.numpy() for a in ops.search_topk_sigmag_exact(*(torch.as_tensor(p) for p in planes), dxs, dys, *gates,
                                                           **kw)]
    assert_maps_match(got, ref, own_maps(planes, dxs, dys, gates, kw), kw["cand_offset"], filled=0.3)
    if spec.get("ties"):
        # Candidate 2 and its copy 5 tie exactly: the lower index first.
        col = got[1].reshape(got[1].shape[0], -1)
        for s in np.nonzero((col == 2).any(axis=0) & (col == 5).any(axis=0))[0]:
            assert list(col[:, s]).index(2) < list(col[:, s]).index(5)


def test_k7_replay_walks_a_curve_past_the_local_sort():
    """T = 130, past the 128 samples K7 sorts in local memory, on a small
    window: the walk the kernel takes there, over curves of 129 and 130
    samples (min_obs 129 gates out the shorter)."""
    planes, dxs, dys, gates, kw = exact_case(**dict(CASES["T-past-limit"], H=5, W=6, C=4, K=2, x_min=0,
                                                       min_obs=129.0))
    got = k7_replay(planes, dxs, dys, gates, kw)
    ref = [a.numpy() for a in ops.search_topk_sigmag_exact(*(torch.as_tensor(p) for p in planes), dxs, dys, *gates,
                                                           **kw)]
    assert_maps_match(got, ref, own_maps(planes, dxs, dys, gates, kw), kw["cand_offset"], filled=0.3)
