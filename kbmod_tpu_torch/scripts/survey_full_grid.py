"""The sustained full-grid survey search with a kill and a resume: the
reference's default 33,153-candidate grid (257 speeds in [92, 526] px/day x
129 angles in +-pi/15) over a 100 x 4096 x 4096 uint8 stack, searched in
checkpointed row tiles by ``checkpointed_core_search`` over ``core_search``
(EncodedPlanes re-scoring on the card, compacted assembly, the background
tile writer). A worker process is killed with SIGKILL after 3/8 of the
tiles and a second worker resumes. Random codes as the JAX script's:
psi in [0, 256), phi in [1, 256) from ``default_rng(11)``.

    python -m kbmod_tpu_torch.scripts.survey_full_grid [--device cuda|cpu]

The port of the JAX package's scripts/survey_full_grid.py. The parent runs
two workers (``python -m kbmod_tpu_torch.scripts.survey_full_grid --worker``):
the first kills itself right after a tile's search, before that tile is
written; the resumed one must load the tiles on disk and compute only the
rest (``--rows-out FILE`` saves its rows). Each worker prints the walls, the steady evals/s over its computed
tiles, the checkpoint overhead (the search's wall outside the tile
searches), the gaps, the peak resident set and the device peak against the
port's budget; the resumed one also holds a 64 x 64 window of starting
pixels of the dispatcher over the whole grid against the kernels' plain
twin, bit for bit (the JAX script checks 1,024 of the candidates against
XLA). The JAX script waits 30 s between the workers for the TPU's remote
runtime to settle; the card needs no wait.

Environment: ``KB_GATE_DIR`` (the checkpoint directory; default a
temporary directory), ``KB_GATE_TILE_ROWS`` (512), and for rehearsals
``KB_GATE_T`` (100), ``KB_GATE_HW`` (4096) and ``KB_GATE_GRID_SCALE``
(thins both grid axes by n).
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

K = 8
MIN_LH = 10.0
SPAN_DAYS = 1.35
# A worker pauses this long before it kills itself, so that the tiles it
# handed to the writer thread before the killed one are on disk.
KILL_PAUSE_S = 0.5
WORKER_TIMEOUT_S = 3600


def sizes():
    """(T, HW, tile rows, grid thinning) from the environment."""
    return (int(os.environ.get("KB_GATE_T", 100)), int(os.environ.get("KB_GATE_HW", 4096)),
            int(os.environ.get("KB_GATE_TILE_ROWS", "512")), max(1, int(os.environ.get("KB_GATE_GRID_SCALE", "1"))))


def worker(ckpt_dir, device=None, rows_out=None):
    import torch

    from kbmod_tpu_torch.device import resolve_device
    from kbmod_tpu_torch.ops.search import EncodedPlanes, core_search
    from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
    from kbmod_tpu_torch.scripts._common import EM, check_window, default_grid, device_line, \
        peak_rss_gib, random_codes, read_counts, reset_counts, scoped_env, search_budget, sync, timed
    from kbmod_tpu_torch.search.checkpoint import checkpointed_core_search

    dev = resolve_device(device)
    T, HW, tile_rows, thin = sizes()
    vxs, vys = default_grid(max(2, 257 // thin), max(2, 129 // thin))
    C = len(vxs)
    times = np.linspace(0.0, SPAN_DAYS, T)
    t0 = time.perf_counter()
    psi_c, phi_c = random_codes(11, T, HW, HW)
    t_codes = time.perf_counter() - t0
    planes, t_stage = timed(dev, lambda: EncodedPlanes.from_codes(psi_c, phi_c, EM, dev))
    del psi_c, phi_c
    print(f"codes {t_codes:.1f}s, staged on the card {t_stage:.1f}s (T={T} {HW}x{HW} u8, C={C})", flush=True)

    tile_times, tile_marks = [], []
    kill_after = int(os.environ.get("KB_GATE_SELFKILL_AFTER", "0"))

    def tile_search(psi_, phi_, valid_, times_, vxs_, vys_, x0, x1, y0, y1, rpp_, **kw):
        t1 = time.perf_counter()
        part = core_search(psi_, phi_, valid_, times_, vxs_, vys_, x0, x1, y0, y1, rpp_, **kw)
        sync(dev)
        dt = time.perf_counter() - t1
        tile_times.append(dt)
        tile_marks.append((t1, time.perf_counter()))
        print(f"tile y=[{y0},{y1}) {dt:.2f}s  {C * (y1 - y0) * HW / dt / 1e9:.3f}e9 evals/s  "
              f"kept={len(part['lh'])}  route {search_topk_encoded.last_route}", flush=True)
        # The kill, right after a tile's search: that tile is not yet
        # handed to the writer, so the resume must compute it again.
        if kill_after and len(tile_times) >= kill_after:
            time.sleep(KILL_PAUSE_S)
            print(f"[worker] self-SIGKILL after {len(tile_times)} tiles", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        return part

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    reset_counts()
    t0 = time.perf_counter()
    res = checkpointed_core_search(
        planes, None, None, times, vxs, vys, 0, HW, 0, HW, K,
        checkpoint_dir=ckpt_dir, tile_rows=tile_rows, search_fn=tile_search,
        min_obs=10, min_lh=MIN_LH, gate_min_obs=True, gate_min_lh=True, compact_min_lh=MIN_LH,
    )
    t_search = time.perf_counter() - t0
    launches, twins = read_counts()
    n_done = len(tile_times)
    with scoped_env(KB_SEARCH_CKPT_DIR=ckpt_dir, KB_SEARCH_CKPT_TILE_ROWS=tile_rows):
        budget = search_budget(T, HW, HW, C, dev, num_obs=10, lh_level=MIN_LH)["total"]
    peak = (torch.cuda.max_memory_allocated(dev) - base) if dev.type == "cuda" else None
    state = {
        "t_codes": t_codes, "t_stage": t_stage, "t_search_wall": t_search,
        "tiles_computed": n_done, "tiles_total": -(-HW // tile_rows), "tile_times": tile_times,
        "steady_evals_per_s": (C * tile_rows * HW * (n_done - 1) / sum(tile_times[1:]) if n_done > 1 else None),
        "ckpt_overhead_frac": (t_search - sum(tile_times)) / t_search if n_done else 0.0,
        "gap_before_first": round(tile_marks[0][0] - t0, 3) if n_done else None,
        "gaps_between": [round(tile_marks[i + 1][0] - tile_marks[i][1], 3) for i in range(n_done - 1)],
        "gap_after_last": round(t0 + t_search - tile_marks[-1][1], 3) if n_done else None,
        "rows": len(res["lh"]), "kept": int((res["lh"] > MIN_LH).sum()),
        "route": search_topk_encoded.last_route, "launches": launches, "twin_calls": twins,
        "peak_rss_gib": round(peak_rss_gib(), 2),
        "device_peak_gib": None if peak is None else round(peak / 2**30, 3), "budget_gib": round(budget / 2**30, 3),
    }
    print(device_line(dev), flush=True)
    print("WORKER DONE " + json.dumps(state), flush=True)
    if rows_out:
        np.savez(rows_out, **res)
    if peak is not None and peak > budget:
        raise AssertionError(f"device peak {peak} above the budget {budget}")

    # A window of the dispatcher over the whole grid against the twin.
    from kbmod_tpu_torch.ops.search import trajectory_offsets

    dxs, dys = trajectory_offsets(vxs, vys, times)
    w = min(64, HW)
    x0 = y0 = min(HW // 2, HW - w)
    bounds = dict(x_min=x0, x_max=x0 + w, y_min=y0, y_max=y0 + w, k_results=K)
    lh, idx = search_topk_encoded(planes, dxs, dys, 10.0, MIN_LH, gate_min_lh=True, **bounds)
    twin_s = check_window(planes, dxs, dys, 10.0, MIN_LH, lh, idx, (x0, x0 + w, y0, y0 + w), K,
                          origin=(x0, y0), gate_min_lh=True)
    print(f"WINDOW EXACT ({w}x{w} at ({x0}, {y0}) over {C} candidates; twin {twin_s:.2f} s)", flush=True)


def run_worker(args, extra_env=None, rows_out=None):
    cmd = [sys.executable, "-m", "kbmod_tpu_torch.scripts.survey_full_grid", "--worker", "--dir", args.dir]
    if args.device:
        cmd += ["--device", args.device]
    if rows_out:
        cmd += ["--rows-out", rows_out]
    # From the directory that holds the package, so that -m finds it.
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=root,
                          env=dict(os.environ, **(extra_env or {})), timeout=WORKER_TIMEOUT_S)


def parent(args):
    os.makedirs(args.dir, exist_ok=True)
    for name in os.listdir(args.dir):
        os.remove(os.path.join(args.dir, name))
    T, HW, tile_rows, _ = sizes()
    n_tiles = -(-HW // tile_rows)

    print("=== phase 1: run + kill ===", flush=True)
    kill_after = max(2, n_tiles * 3 // 8)
    proc = run_worker(args, {"KB_GATE_SELFKILL_AFTER": str(kill_after)})
    print(proc.stdout[-4000:], flush=True)
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"expected a SIGKILL death, rc={proc.returncode}")
    n_after_kill = len([f for f in os.listdir(args.dir) if f.startswith("tile_") and f.endswith(".npz")])
    print(f"[parent] worker died by SIGKILL; {n_after_kill} tiles survive on disk", flush=True)
    if not 1 <= n_after_kill <= kill_after - 1:
        raise AssertionError(f"{n_after_kill} tiles on disk after a kill after {kill_after}")

    print("=== phase 2: resume ===", flush=True)
    t0 = time.perf_counter()
    out2 = run_worker(args, rows_out=args.rows_out)
    print(out2.stdout[-6000:], flush=True)
    if out2.returncode != 0:
        raise AssertionError("the resume failed")
    done = json.loads(out2.stdout.split("WORKER DONE ", 1)[1].splitlines()[0])
    if done["tiles_computed"] != done["tiles_total"] - n_after_kill:
        raise AssertionError(f"resume computed {done['tiles_computed']} tiles, not {n_tiles - n_after_kill}")
    if "WINDOW EXACT" not in out2.stdout:
        raise AssertionError("the resume's window check did not pass")
    print(f"[parent] resume completed in {time.perf_counter() - t0:.0f}s; {n_after_kill} tiles loaded, "
          f"{done['tiles_computed']} computed; GATE PASSED", flush=True)
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--worker", action="store_true", help="run one worker (the parent starts two)")
    ap.add_argument("--dir", default=os.environ.get("KB_GATE_DIR"), help="the checkpoint directory")
    ap.add_argument("--rows-out", default=None,
                    help="a worker (the parent's resumed one) saves its rows here (.npz)")
    args = ap.parse_args(argv)
    from kbmod_tpu_torch.device import resolve_device

    resolve_device(args.device)
    if args.worker:
        worker(args.dir, args.device, args.rows_out)
        return 0
    if args.dir:
        parent(args)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        args.dir = tmp
        parent(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
