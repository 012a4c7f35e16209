"""The whole ``SearchRunner`` pipeline at survey scale: a 100 x 4096 x 4096
stack with 20 injected objects, searched as uint8 codes over the
reference's default grid (EclipticCenteredSearch, 257 speeds in [92, 526]
px/day x 129 angles in +-pi/15: 33,153 candidates), then the near-duplicate
grid filter, host sigma-G, ``nn_start_end`` clustering, mean, median and sum
coadds and the results file; every injected object must be in the final
file.

    python -m kbmod_tpu_torch.scripts.survey_pipeline_gate [--device cuda|cpu]

The port of the JAX package's scripts/survey_pipeline_gate.py, with its
helpers (``make_objects``, ``inject_objects``, ``recovered``,
``_dump_neighborhood``, here with the frame size as a parameter) and its
environment: ``KB_GATE_T`` (100), ``KB_GATE_HW`` (4096),
``KB_GATE_GRID_SCALE`` (thins both grid axes by n; rehearsals only),
``KB_GATE_RESULTS`` (the results file; default a temporary directory's),
``KB_GATE_DEBUG=1`` (keep the filtered rows and print a missed object's
neighbourhood). At frames of 2048 or more the search runs in checkpointed
row tiles (``KB_SEARCH_CKPT_DIR``, a temporary directory unless it is set),
as the production path does. The observation span is 1.35 days, so the
fastest candidate moves 710 pixels.

On the card the build runs K1 and the search K5 (or the route the
dispatcher prints); the script prints the route, the launches, the phase
walls, the peak resident set, and the search's device peak against the
port's budget (``run_search.search_memory_budget``), which must not be
lower. The var planes share one array (every image has the same flat
variance), which keeps 6.7 GB off the host at 4096.
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np

SPAN_DAYS = 1.35  # the fastest candidate's reach: 526 * 1.35 = 710 px
NOISE = 2.0  # sci ~ N(0, NOISE); var = NOISE^2
PSF_SIGMA = 1.0
N_BRIGHT, N_FAINT = 12, 8
FLUX_BRIGHT, FLUX_FAINT = 350.0, 220.0


def cluster_eps(hw):
    """The clustering scale: 20 px on the 4096 frame, scaled down for
    rehearsal frames that pack the same 20 objects into a smaller area."""
    return max(3.0, 20.0 * hw / 4096.0)


def inject_objects(sci, zeroed_times, psf_kernel, objects, hw):
    """Add flux * psf_kernel at each object's snapped per-time position (a
    (2r+1)^2 patch add: the fake-data creator's delta convolved with the
    PSF, for objects that stay r pixels inside every edge)."""
    r = psf_kernel.shape[0] // 2
    for x, y, vx, vy, flux in objects:
        for idx, dt in enumerate(zeroed_times):
            ix = int(np.floor(x + vx * dt + 0.5))
            iy = int(np.floor(y + vy * dt + 0.5))
            assert r <= ix < hw - r and r <= iy < hw - r, "object leaves the interior"
            sci[idx][iy - r : iy + r + 1, ix - r : ix + r + 1] += flux * psf_kernel


def make_objects(rng, hw):
    """20 objects inside the default grid, in two flux tiers, each (start,
    end) point at least 6 * cluster_eps from every other object's in the 4D
    clustering space, so that no two distinct injections can be merged."""
    objects = []
    pts4 = []
    margin = 16
    # Frames smaller than 4096 cap the speeds so that paths stay inside.
    speed_hi = min(500.0, (hw - 2 * margin - 24) / SPAN_DAYS)
    speed_lo = min(110.0, 0.6 * speed_hi)
    min_sep = 6.0 * cluster_eps(hw)
    while len(objects) < N_BRIGHT + N_FAINT:
        speed = rng.uniform(speed_lo, speed_hi)
        ang = rng.uniform(-np.pi / 16, np.pi / 16)
        vx, vy = speed * np.cos(ang), speed * np.sin(ang)
        reach_x, reach_y = vx * SPAN_DAYS, vy * SPAN_DAYS
        x = rng.uniform(margin, hw - margin - reach_x)
        y = rng.uniform(margin + max(0.0, -reach_y), hw - margin - max(0.0, reach_y))
        p = np.array([x, x + reach_x, y, y + reach_y])
        if pts4 and min(np.linalg.norm(p - q) for q in pts4) < min_sep:
            continue
        pts4.append(p)
        flux = FLUX_BRIGHT if len(objects) < N_BRIGHT else FLUX_FAINT
        objects.append((float(x), float(y), float(vx), float(vy), flux))
    return objects


def recovered(results, obj, zeroed_times, tol_end=4.0, cluster_eps=0.0):
    """Whether some row matches the object's track at both ends of the
    span: the start within max(2, tol_end / 3) pixels and the end within
    tol_end, each widened by the clustering's displacement (nn_start_end
    keeps a neighbourhood's likelihood maximum, which may start a few
    pixels off with a compensating velocity)."""
    x, y, vx, vy, _ = obj
    dt = float(zeroed_times[-1])
    rx = np.asarray(results["x"], dtype=float)
    ry = np.asarray(results["y"], dtype=float)
    rvx = np.asarray(results["vx"], dtype=float)
    rvy = np.asarray(results["vy"], dtype=float)
    tol_start = max(2.0, tol_end / 3.0) + cluster_eps
    tol_end = tol_end + cluster_eps
    close_start = (np.abs(rx - x) <= tol_start) & (np.abs(ry - y) <= tol_start)
    close_end = (np.abs((rx + rvx * dt) - (x + vx * dt)) <= tol_end) & (
        np.abs((ry + rvy * dt) - (y + vy * dt)) <= tol_end
    )
    return bool(np.any(close_start & close_end))


def _dump_neighborhood(obj, results, zeroed_times, radius=25.0, top=6):
    """The highest-lh rows near a missed object's start pixel in the final
    table and in every tracked filtered table (``KB_GATE_DEBUG=1``)."""
    x, y = obj[0], obj[1]
    dt = float(zeroed_times[-1])
    tables = [("FINAL", results)] + list(results.filtered.items())
    for label, tbl in tables:
        if len(tbl) == 0:
            continue
        rx = np.asarray(tbl["x"], dtype=float)
        ry = np.asarray(tbl["y"], dtype=float)
        near = np.where((np.abs(rx - x) <= radius) & (np.abs(ry - y) <= radius))[0]
        if len(near) == 0:
            continue
        lh = np.asarray(tbl["likelihood"], dtype=float)[near]
        order = near[np.argsort(-lh)][:top]
        print(f"  [{label}] {len(near)} rows within {radius:.0f}px of start:")
        for i in order:
            ex = float(tbl["x"][i]) + float(tbl["vx"][i]) * dt
            ey = float(tbl["y"][i]) + float(tbl["vy"][i]) * dt
            print(
                f"    x={int(tbl['x'][i])} y={int(tbl['y'][i])} "
                f"vx={float(tbl['vx'][i]):.2f} vy={float(tbl['vy'][i]):.2f} "
                f"end=({ex:.1f},{ey:.1f}) lh={float(tbl['likelihood'][i]):.2f} "
                f"obs={int(tbl['obs_count'][i])}"
            )


def make_stack(T, hw, seed=17):
    """(stack, objects, zeroed times): the gate's noise, one shared var
    plane and the injected objects, from ``default_rng(seed)``."""
    from kbmod_tpu_torch.core.image_stack_py import ImageStackPy
    from kbmod_tpu_torch.core.psf import PSF

    rng = np.random.default_rng(seed)
    times = 57130.0 + np.linspace(0.0, SPAN_DAYS, T)
    psf_kernel = PSF.make_gaussian_kernel(PSF_SIGMA)
    sci = [rng.normal(0.0, NOISE, (hw, hw)).astype(np.float32) for _ in range(T)]
    var = np.full((hw, hw), NOISE * NOISE, dtype=np.float32)
    objects = make_objects(rng, hw)
    zeroed = times - times[0]
    inject_objects(sci, zeroed, psf_kernel, objects, hw)
    return ImageStackPy(times, sci, [var] * T, psfs=[psf_kernel] * T), objects, zeroed


def grid_steps(thin):
    """(speeds, angles) of the default lattice thinned by ``thin``."""
    return max(2, 257 // thin), max(2, 129 // thin)


def make_config(hw, thin, out_path, debug=False):
    from kbmod_tpu_torch.configuration import SearchConfiguration

    n_vel, n_ang = grid_steps(thin)
    config = SearchConfiguration()
    config.set("generator_config", {
        "name": "EclipticCenteredSearch",
        "velocities": [92.0, 526.0, n_vel],
        "angles": [-np.pi / 15, np.pi / 15, n_ang],
        "angle_units": "radian",
        "given_ecliptic": 0.0,
    })
    config.set("encode_num_bytes", 1)
    config.set("lh_level", 10.0)
    config.set("num_obs", 10)
    # The defaults are kept: host sigma-G, near_dup_thresh 10, max_results
    # 100k. nn_start_end is the production clustering for large grids.
    config.set("cluster_type", "nn_start_end")
    config.set("cluster_eps", cluster_eps(hw))
    config.set("coadds", ["mean", "median", "sum"])
    config.set("stamp_radius", 10)
    config.set("result_filename", str(out_path))
    config.set("save_config", False)
    if debug:
        config.set("track_filtered", True)
    return config


def _ckpt_dir(hw, tmp):
    """Row tiles for frames of 2048 or more: the caller's
    KB_SEARCH_CKPT_DIR, or a fresh directory under ``tmp``."""
    prev = os.environ.get("KB_SEARCH_CKPT_DIR")
    return prev or (os.path.join(tmp, "ckpt") if hw >= 2048 else None)


def run(T=100, hw=4096, thin=1, device=None, out_path=None, debug=False, log=print):
    """Make the stack, run the pipeline, check every object in the final
    file. Returns a dict of what it printed (walls in seconds)."""
    from kbmod_tpu_torch.device import resolve_device
    from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
    from kbmod_tpu_torch.results import Results
    from kbmod_tpu_torch.run_search import SearchRunner
    from kbmod_tpu_torch.scripts._common import check_memory, device_line, measure_core_search, peak_rss_gib, \
        phase_walls, read_counts, reset_counts, scoped_env, sync

    dev = resolve_device(device)
    t0 = time.perf_counter()
    stack, objects, zeroed = make_stack(T, hw)
    t_build = time.perf_counter() - t0
    log(f"build {t_build:.1f}s ({T}x{hw}x{hw}, {len(objects)} objects)")
    with tempfile.TemporaryDirectory() as tmp, scoped_env(KB_SEARCH_CKPT_DIR=_ckpt_dir(hw, tmp)):
        ckpt = os.environ.get("KB_SEARCH_CKPT_DIR")
        path = out_path or os.path.join(tmp, "survey_pipeline_results.ecsv")
        config = make_config(hw, thin, path, debug)
        runner = SearchRunner(device=dev)
        mem = measure_core_search(runner, dev)
        search_topk_encoded.last_route = None
        reset_counts()
        t1 = time.perf_counter()
        results = runner.run_search(config, stack)
        sync(dev)
        t_pipeline = time.perf_counter() - t1
        launches, twins = read_counts()
        loaded_rows = len(Results.read_table(path))
    route = search_topk_encoded.last_route
    phases = {k: round(v, 2) for k, v in phase_walls(runner).items()}
    rss = peak_rss_gib()
    n_vel, n_ang = grid_steps(thin)
    log(f"pipeline {t_pipeline:.1f}s -> {len(results)} final rows; grid {n_vel} x {n_ang} = {n_vel * n_ang}; "
        f"route {route}; row tiles {'in ' + ckpt if ckpt else 'off'}; launches {launches}, twin calls {twins}; "
        f"{device_line(dev)}")
    log("PHASES " + json.dumps(phases))
    log(f"peak RSS {rss:.1f} GiB")
    log(check_memory("pipeline gate", mem))

    speed_step = (526.0 - 92.0) / (n_vel - 1)
    tol_end = max(4.0, 0.55 * speed_step * float(zeroed[-1]))
    eps = cluster_eps(hw)
    missed = [obj for obj in objects if not recovered(results, obj, zeroed, tol_end, cluster_eps=eps)]
    for obj in missed:
        log(f"MISSED object x={obj[0]:.0f} y={obj[1]:.0f} vx={obj[2]:.1f} vy={obj[3]:.1f} flux={obj[4]}")
        if debug and results.track_filtered:
            for label, tbl in results.filtered.items():
                if len(tbl) and recovered(tbl, obj, zeroed, tol_end, cluster_eps=eps):
                    log(f"  -> present in rows filtered by: {label}")
            _dump_neighborhood(obj, results, zeroed)
    if missed:
        raise AssertionError(f"{len(missed)}/{len(objects)} injected objects missing from the final results")
    if "coadd_mean" not in results.colnames or "stamp" not in results.colnames:
        raise AssertionError("the coadd columns are missing")
    if loaded_rows != len(results):
        raise AssertionError(f"the results file reads back {loaded_rows} rows, not {len(results)}")
    state = {
        "t_build": round(t_build, 1), "t_pipeline": round(t_pipeline, 1), "phases": phases,
        "rows_final": len(results), "objects": len(objects), "recovered": len(objects) - len(missed),
        "peak_rss_gib": round(rss, 1), "route": route,
        "device_peak_gib": round(mem["peak"] / 2**30, 3) if mem else None,
        "budget_gib": round(mem["budget"]["total"] / 2**30, 3) if mem else None,
    }
    log("PIPELINE GATE PASSED " + json.dumps(state))
    return dict(state, launches=launches, twins=twins, results=results, injected=objects, mem=mem)


def main(argv=None):
    import logging

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run(T=int(os.environ.get("KB_GATE_T", 100)), hw=int(os.environ.get("KB_GATE_HW", 4096)),
        thin=max(1, int(os.environ.get("KB_GATE_GRID_SCALE", "1"))), device=args.device,
        out_path=os.environ.get("KB_GATE_RESULTS"), debug=os.environ.get("KB_GATE_DEBUG") == "1",
        log=lambda msg: print(msg, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
