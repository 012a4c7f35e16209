"""Readings that the limits of ``correct`` are set from, for one cell, all
in one process:

    python3 -m benchmarks.control --workload <name> --seeds <n> [<n> ...] [--env KEY=VALUE ...]

For each seed it runs the program's timed path on that seed's stacks (one
stack, judged as a run's window is), then prints one JSON line
with two sets of the compared numbers: ``program``, the program's answers
against the plain reference, and ``control``, the control's against the
same reference. The control is the reference put in the program's place,
one precision below what the configuration states: 4-bit codes for uint8
codes, bfloat16 planes for float32 planes (the search adds, it does not
multiply matrices, so TF32 does not apply), and bfloat16 science images
for the coadds. It answers at the same pixels and for the same final rows
as the program: its own top-K lists there, and its own sigma-G, sums and
coadds along the program's final rows. Not run by the benchmark's runs.
"""

import argparse
import json
import sys

import numpy as np
import torch

from benchmarks.reference import core, judge


def control_precision(settings):
    """The ReferenceStack keywords of the control of a configuration."""
    nb = int(settings.get("encode_num_bytes", -1))
    if nb == 1:
        return {"plane_bits": 4, "sci_dtype": torch.bfloat16}
    if nb in (-1, 4):
        return {"plane_dtype": torch.bfloat16, "sci_dtype": torch.bfloat16}
    raise ValueError(f"no control for encode_num_bytes {nb}")


def control_lists(run, lows, picks, k):
    """The control's top-K lists at the picked (window stack, x, y)."""
    lo, hi = run.settings.get("sigmaG_lims") or [25, 75]
    coeff = core.sigma_g_coeff(lo, hi)
    out = {}
    for s, x, y in picks:
        gated, _, valid = lows[run.records[s]["stack"]].pixel_scores(x, y, run.settings, coeff)
        top = torch.topk(gated, min(k, gated.numel()))
        keep = torch.isfinite(top.values)
        cand = top.indices[keep]
        out[(s, x, y)] = (cand.cpu().numpy(), top.values[keep].cpu().numpy().astype(np.float64),
                          valid[cand].cpu().numpy())
    return out


def control_finals(run, lows):
    """The control's final rows: the program's (x, y, vx, vy) with the
    control's kept times, likelihood, flux, counts and coadds."""
    kinds = sorted(set(run.settings.get("coadds", [])) | {run.settings.get("stamp_type", "sum")})
    radius = int(run.settings.get("stamp_radius", 10))
    finals = []
    for record in run.records:
        rows = dict(record["final"])
        low = lows[record["stack"]]
        if len(rows["x"]):
            pv, fv, _ = low.row_curves(rows)
            kept = core.host_clip(pv, fv, run.settings)
            rows["likelihood"], rows["flux"] = judge.kept_scores(pv, fv, kept)
            rows["obs_valid"] = kept.cpu().numpy()
            rows["obs_count"] = rows["obs_valid"].sum(1)
            windows = core.stamps(low.sci, rows["x"], rows["y"], rows["vx"], rows["vy"], low.zeroed, radius)
            for kind, stamp in core.coadds(windows, kept, kinds).items():
                rows[f"coadd_{kind}"] = stamp.cpu().numpy()
        finals.append(rows)
    return finals


def readings(run, seconds=0.0):
    """(program numbers, control numbers) of one seed's run."""
    run.setup(warm=False)
    run.window(seconds)
    run.release()
    refs = run.reference_stacks()
    lists = run.search_answers()
    program = run.numbers(refs, lists=lists)
    lows = run.reference_stacks(**control_precision(run.settings))
    k = int(run.settings.get("results_per_pixel", 8))
    control = run.numbers(refs, lists=control_lists(run, lows, list(lists), k), finals=control_finals(run, lows))
    return program, control


def main(argv=None):
    from benchmarks.run import loop_class, load_cell

    ap = argparse.ArgumentParser(description="Readings of the program and its control, seed by seed.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--env", nargs="*", default=[], metavar="KEY=VALUE",
                    help="set in place of the configuration's environment, e.g. KB_SIGMAG_MODE=overprovision")
    args = ap.parse_args(argv)
    _, cell, config, traffic = load_cell(args.workload)
    config["environment"] = dict(config.get("environment", {}), **dict(kv.split("=", 1) for kv in args.env))
    for seed in args.seeds:
        run = loop_class(traffic)(cell, config, traffic, seed, args.device)
        program, control = readings(run)
        print(json.dumps({"workload": cell["name"], "seed": seed, "program": program, "control": control}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
