"""The comparison that decides ``correct``: the program's answers against
the plain reference (``core.py``), number by number, each against the
limit its traffic file states.

Numbers (each the worst over what was compared, counts the most in one
window stack but ``violations``, summed; a limit of 0 is exact):

- ``search_lh_gap``: the grid search's per-pixel top-K, as ``search_all``
  left it: each listed row's likelihood against the reference's score of
  the same candidate at that pixel, |got - ref| / max(|ref|, 1).
- ``search_rank_gap``: at the same pixels, the reference's k-th best gated
  score against the k-th listed likelihood (lh_level where the list is
  shorter), (ref_k - got_k) / max(|ref_k|, 1), floored at 0: a candidate
  the search should have listed and did not.
- ``rescore_gap``: each final row's likelihood and flux against the
  reference's sums over the times the row keeps (its obs_valid), relative.
- ``obs_flips``: (row, time) samples whose kept flag differs from the
  reference's sigma-G filter of the reference's own light curve.
- ``coadd_gap``: each final row's coadds against the reference's over its
  kept times, the largest difference over the largest |value| of the
  reference's stamp.
- ``violations``: guarantees of the results path broken: a row below
  num_obs or lh_level, obs_count not its kept count, a velocity off the
  grid, a start outside the bounds, two rows in one near-duplicate bin or
  within the clustering's eps, more rows than max_results, a listed
  search row whose valid count differs from the reference's, a results
  file that does not read back as the table.
- ``missed``: injected objects that no final row represents, within
  ``cluster_eps`` of the object in the clustering's space.
"""

import math

import numpy as np
import torch

from benchmarks.reference import core

SEARCH_CHUNK = 1 << 23  # (candidate, time) samples a pixel batch gathers at most


class ReferenceStack:
    """One distinct stack's reference planes and candidate offsets.
    The planes are quantized as the configuration encodes them (8 bits for
    uint8 codes), else float64. The control asks for less: ``plane_bits``
    codes in place of the configuration's, or planes rounded to
    ``plane_dtype``, and science images rounded to ``sci_dtype`` for the
    stamps."""

    def __init__(self, stack, settings, grid, device, plane_bits=None, plane_dtype=None, sci_dtype=None):
        sci = torch.as_tensor(stack.sci, device=device)
        var = torch.as_tensor(np.stack(stack.var), device=device)
        psi, phi = core.build(sci, var, stack.psfs)
        del var
        nb = int(settings.get("encode_num_bytes", -1))
        bits = plane_bits or (8 * nb if nb in (1, 2) else None)
        if bits:
            psi, _ = core.quantize(psi, bits)
            phi, _ = core.quantize(phi, bits)
        if plane_dtype is not None:
            psi, phi = psi.to(plane_dtype).to(core.F64), phi.to(plane_dtype).to(core.F64)
        if sci_dtype is not None:
            sci = sci.to(sci_dtype)
        self.psi, self.phi, self.sci = psi, phi, sci
        self.zeroed = np.asarray(stack.zeroed_times, dtype=np.float64)
        self.objects = stack.objects
        self.vxs, self.vys = grid
        self.dxs, self.dys = core.offsets(self.vxs, self.vys, self.zeroed, device)
        self.device = device

    def pixel_scores(self, x, y, settings, coeff):
        """(gated, ungated, valid count) of every candidate at start pixel
        (x, y)."""
        C, T = self.dxs.shape
        xs = torch.full((C,), int(x), dtype=torch.int64, device=self.device)
        ys = torch.full((C,), int(y), dtype=torch.int64, device=self.device)
        out = []
        step = max(1, SEARCH_CHUNK // T)
        for lo in range(0, C, step):
            hi = min(C, lo + step)
            pv, fv, ok = core.curves(self.psi, self.phi, xs[lo:hi], ys[lo:hi], self.dxs[lo:hi], self.dys[lo:hi])
            out.append(core.ranking(pv, fv, ok, settings, coeff))
        return tuple(torch.cat([o[i] for o in out]) for i in range(3))

    def row_curves(self, rows):
        """(psi, phi, ok) (N, T) curves of final rows (x, y, vx, vy)."""
        dev = self.device
        dxs, dys = core.offsets(rows["vx"], rows["vy"], self.zeroed, dev)
        xs = torch.as_tensor(np.asarray(rows["x"], dtype=np.int64), device=dev)
        ys = torch.as_tensor(np.asarray(rows["y"], dtype=np.int64), device=dev)
        return core.curves(self.psi, self.phi, xs, ys, dxs, dys)


def grid_index(grid):
    """{(vx, vy) float32 bit patterns: first candidate index}."""
    vxs, vys = (np.asarray(g, dtype=np.float32) for g in grid)
    index = {}
    for i, key in enumerate(zip(vxs.view(np.int32).tolist(), vys.view(np.int32).tolist())):
        index.setdefault(key, i)
    return index


def candidate_indices(index, vx, vy):
    """Grid indices of float32 velocities; -1 where a velocity is off the
    grid."""
    vx = np.asarray(vx, dtype=np.float32).view(np.int32).tolist()
    vy = np.asarray(vy, dtype=np.float32).view(np.int32).tolist()
    return np.array([index.get(k, -1) for k in zip(vx, vy)], dtype=np.int64)


def sample_pixels(raws, n_listed, n_any, bounds, seed):
    """The (stack, x, y) pixels whose top-K lists are compared: the pixels
    of ``n_listed`` rows drawn from the seed among every row the searches
    listed (a pixel drawn twice counts once), and ``n_any`` pixels anywhere
    in the start bounds. ``raws`` holds each window stack's listed rows."""
    rng = np.random.default_rng(seed)
    ends = np.cumsum([len(raw["x"]) for raw in raws])
    picks = []
    if len(ends) and ends[-1]:
        for row in rng.integers(ends[-1], size=n_listed):
            s = int(np.searchsorted(ends, row, side="right"))
            i = int(row - (ends[s - 1] if s else 0))
            pick = (s, int(raws[s]["x"][i]), int(raws[s]["y"][i]))
            if pick not in picks:
                picks.append(pick)
    (x0, x1), (y0, y1) = bounds
    for _ in range(n_any):
        picks.append((int(rng.integers(len(raws))), int(rng.integers(x0, x1)), int(rng.integers(y0, y1))))
    return picks


def pixel_lists(raw, picks_in_stack, index):
    """{(x, y): (candidate indices, lh, valid counts)} of the rows a search
    listed at the picked pixels, best first."""
    out = {}
    xs, ys = np.asarray(raw["x"]), np.asarray(raw["y"])
    for x, y in picks_in_stack:
        sel = np.nonzero((xs == x) & (ys == y))[0]
        lh = np.asarray(raw["lh"], dtype=np.float64)[sel]
        order = np.argsort(-lh, kind="stable")
        sel = sel[order]
        cand = candidate_indices(index, np.asarray(raw["vx"])[sel], np.asarray(raw["vy"])[sel])
        out[(x, y)] = (cand, lh[order], np.asarray(raw["obs_count"])[sel])
    return out


def search_numbers(refs, stack_of, lists_by_pixel, settings, k):
    """search_lh_gap, search_rank_gap and the violations among the listed
    rows (off the grid, or a valid count the reference does not give).
    ``lists_by_pixel``: {(window stack, x, y): (cand, lh, obs)};
    ``stack_of``: the window stack's distinct stack."""
    lo, hi = settings.get("sigmaG_lims") or [25, 75]
    coeff = core.sigma_g_coeff(lo, hi)
    floor = float(settings["lh_level"])
    lh_gap = rank_gap = 0.0
    bad = 0
    for (s, x, y), (cand, lh, obs) in lists_by_pixel.items():
        gated, ungated, valid = refs[stack_of(s)].pixel_scores(x, y, settings, coeff)
        on = cand >= 0
        bad += int((~on).sum())
        if on.any():
            ref = ungated[torch.as_tensor(cand[on], device=ungated.device)].cpu().numpy()
            lh_gap = max(lh_gap, float(np.max(np.abs(lh[on] - ref) / np.maximum(np.abs(ref), 1.0))))
            ref_obs = valid[torch.as_tensor(cand[on], device=valid.device)].cpu().numpy()
            bad += int(np.sum(ref_obs != obs[on]))
        best = torch.topk(gated, min(k, gated.numel())).values.cpu().numpy()
        best = best[np.isfinite(best)]
        for j, r in enumerate(best):
            got = lh[j] if j < len(lh) else floor
            rank_gap = max(rank_gap, max(0.0, float(r - got)) / max(abs(float(r)), 1.0))
    return {"search_lh_gap": lh_gap, "search_rank_gap": rank_gap}, bad


def kept_scores(pv, fv, kept):
    """(likelihood, flux) of rows from their psi and phi curves summed over
    the kept times, as numpy; 0 where phi sums to 0."""
    ps = torch.where(kept, pv, 0.0).sum(1)
    fs = torch.where(kept, fv, 0.0).sum(1)
    good = fs != 0
    lh = torch.where(good, ps / torch.sqrt(torch.where(good, fs, 1.0)), 0.0)
    flux = torch.where(good, ps / torch.where(good, fs, 1.0), 0.0)
    return lh.cpu().numpy(), flux.cpu().numpy()


def final_numbers(ref, rows, settings, kinds, radius):
    """rescore_gap, obs_flips and coadd_gap of one window stack's final rows
    (a dict of arrays with x, y, vx, vy, likelihood, flux, obs_valid and
    coadd_<kind>) against its distinct stack's reference."""
    out = {"rescore_gap": 0.0, "obs_flips": 0, "coadd_gap": 0.0}
    n = len(rows["x"])
    if n == 0:
        return out
    pv, fv, ok = ref.row_curves(rows)
    kept = torch.as_tensor(kept_times(rows, len(ref.zeroed)), device=ref.device)
    own = core.host_clip(pv, fv, settings)
    out["obs_flips"] = int((own != kept).sum())
    lh, flux = kept_scores(pv, fv, kept)
    for got, want in ((rows["likelihood"], lh), (rows["flux"], flux)):
        gap = np.abs(np.asarray(got, dtype=np.float64) - want) / np.maximum(np.abs(want), 1.0)
        out["rescore_gap"] = max(out["rescore_gap"], float(gap.max()))
    windows = core.stamps(ref.sci, rows["x"], rows["y"], rows["vx"], rows["vy"], ref.zeroed, radius)
    want = core.coadds(windows, kept, kinds)
    for kind, w in want.items():
        got = torch.as_tensor(np.asarray(rows[f"coadd_{kind}"], dtype=np.float64), device=ref.device)
        scale = w.abs().flatten(1).amax(1).clamp_min(1e-6)
        out["coadd_gap"] = max(out["coadd_gap"], float(((got - w).abs().flatten(1).amax(1) / scale).max()))
    return out


def _close_pairs(points, eps):
    """Pairs of rows within ``eps`` of each other (Euclidean), float64."""
    p = np.asarray(points, dtype=np.float64)
    if len(p) < 2:
        return 0
    d = np.sqrt(((p[:, None, :] - p[None, :, :]) ** 2).sum(-1))
    iu = np.triu_indices(len(p), 1)
    return int(np.sum(d[iu] <= eps * (1 - 1e-9)))


def _bins(x, y, vx, vy, width, dt, end=True):
    """Bin keys int(x / width), int(y / width) and, with ``end``, those of
    the position after ``dt``."""
    keys = [np.trunc(x / width), np.trunc(y / width)]
    if end:
        keys += [np.trunc((x + dt * vx) / width), np.trunc((y + dt * vy) / width)]
    return np.stack(keys, 1).astype(np.int64)


def _duplicate_keys(keys):
    return len(keys) - len(np.unique(keys, axis=0)) if len(keys) else 0


def cluster_points(rows, settings, zeroed):
    """(N, D) points of rows in the clustering's space: position and
    velocity (scaled by ``cluster_v_scale``) for ``all``/``pos_vel``, else
    the positions at the clustering's times (the start, the middle, or the
    start and end of the span)."""
    kind = settings.get("cluster_type", "all")
    x, y = np.asarray(rows["x"], np.float64), np.asarray(rows["y"], np.float64)
    vx, vy = np.asarray(rows["vx"], np.float64), np.asarray(rows["vy"], np.float64)
    if kind in ("all", "pos_vel"):
        s = float(settings.get("cluster_v_scale", 1.0))
        return np.stack([x, y, vx * s, vy * s], 1)
    times = {"mid_position": [float(np.median(zeroed))], "start_end_position": [0.0, float(zeroed[-1])],
             "nn_start_end": [0.0, float(zeroed[-1])], "grid_start_end": [0.0, float(zeroed[-1])]}.get(kind, [0.0])
    return np.stack([x + vx * t for t in times] + [y + vy * t for t in times], 1)


def cluster_violations(rows, settings, zeroed):
    """Pairs the clustering should have merged: rows within ``cluster_eps``
    in the clustering's space, or sharing a bin for the grid kinds."""
    if not settings.get("do_clustering", True) or len(rows["x"]) < 2:
        return 0
    kind = settings.get("cluster_type", "all")
    eps = float(settings.get("cluster_eps", 20.0))
    if kind.startswith("grid_"):
        x, y = np.asarray(rows["x"], np.float64), np.asarray(rows["y"], np.float64)
        vx, vy = np.asarray(rows["vx"], np.float64), np.asarray(rows["vy"], np.float64)
        return _duplicate_keys(_bins(x, y, vx, vy, math.ceil(eps), float(zeroed[-1]), end=kind == "grid_start_end"))
    return _close_pairs(cluster_points(rows, settings, zeroed), eps)


def kept_times(rows, num_times):
    """(N, T) bool: a table's obs_valid, or every time where it has none."""
    if "obs_valid" in rows:
        return np.asarray(rows["obs_valid"], dtype=bool)
    return np.ones((len(rows["x"]), num_times), dtype=bool)


def row_violations(rows, settings, index, bounds, zeroed):
    """The final table's guarantees broken, counted (see the module's
    ``violations``)."""
    n = len(rows["x"])
    if n == 0:
        return 0
    ov = kept_times(rows, len(zeroed))
    bad = int(np.sum(np.asarray(rows["obs_count"]) != ov.sum(1)))
    bad += int(np.sum(np.asarray(rows["obs_count"]) < int(settings["num_obs"])))
    if settings.get("sigmaG_filter", True) and float(settings["lh_level"]) > 0:
        bad += int(np.sum(np.asarray(rows["likelihood"]) < float(settings["lh_level"])))
    bad += int(np.sum(candidate_indices(index, rows["vx"], rows["vy"]) < 0))
    (x0, x1), (y0, y1) = bounds
    x, y = np.asarray(rows["x"]), np.asarray(rows["y"])
    bad += int(np.sum((x < x0) | (x >= x1) | (y < y0) | (y >= y1)))
    thresh = settings.get("near_dup_thresh", 10)
    if thresh and thresh > 0:
        keys = _bins(x.astype(np.float64), y.astype(np.float64), np.asarray(rows["vx"], np.float64),
                     np.asarray(rows["vy"], np.float64), float(thresh), float(zeroed[-1] - zeroed[0]))
        bad += _duplicate_keys(keys)
    bad += cluster_violations(rows, settings, zeroed)
    limit = int(settings.get("max_results", 100_000))
    if limit > -1 and n > limit:
        bad += n - limit
    return bad


def missed_objects(rows, objects, settings, zeroed):
    """Injected objects that no final row represents: none lies within
    ``cluster_eps`` of the object's own trajectory in the clustering's
    space. Which row of an object's cluster survives depends on the noise
    (a bright object that starts off the frame can lose its best row to
    sigma-G and num_obs), so the row may be any of the cluster's."""
    if not objects:
        return 0
    obj = {k: np.array([o[i] for o in objects], np.float64) for i, k in enumerate(("x", "y", "vx", "vy"))}
    eps = float(settings.get("cluster_eps", 20.0))
    if len(rows["x"]) == 0:
        return len(objects)
    got = cluster_points(rows, settings, zeroed)
    want = cluster_points(obj, settings, zeroed)
    d = np.sqrt(((want[:, None, :] - got[None, :, :]) ** 2).sum(-1))
    return int(np.sum(d.min(1) > eps))


def file_mismatches(path, rows, columns):
    """Rows of the results file (the program's comma-separated ECSV: '#'
    header lines, then the column names, then one line a row) that do not
    read back as ``rows`` in ``columns``, plus the difference in row
    counts; a missing file counts one."""
    import csv

    try:
        with open(path, newline="") as f:
            lines = [line for line in f if not line.startswith("#")]
    except FileNotFoundError:
        return 1
    table = list(csv.reader(lines))
    if not table:
        return 1
    names, body = table[0], table[1:]
    n = len(rows["x"])
    bad = abs(len(body) - n)
    try:
        cols = [names.index(c) for c in columns]
    except ValueError:
        return max(bad, 1) + n
    for i, line in enumerate(body[:n]):
        for c, j in zip(columns, cols):
            if float(line[j]) != float(np.asarray(rows[c])[i]):
                bad += 1
                break
    return bad
