"""Readings that the limits of ``correct`` are set from, for one cell, all
in one process:

    python3 -m benchmarks.control --workload <name> --seeds <n> [<n> ...] [--env KEY=VALUE ...]

For each seed it hands a run of that seed to the ``control_readings`` of the
cell's loop module (``benchmarks/loops/<loop>.py``), which runs the
program's timed path and its control, and prints one JSON line with two sets
of the compared numbers: ``program``, the program's answers against the
plain reference, and ``control``, the control's against the same reference.
The control is the reference put in the program's place, one precision
below what the configuration states; each loop says what its control is.
Not run by the benchmark's runs.
"""

import argparse
import json
import sys


def main(argv=None):
    from benchmarks.run import load_cell, loop_module

    ap = argparse.ArgumentParser(description="Readings of the program and its control, seed by seed.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--env", nargs="*", default=[], metavar="KEY=VALUE",
                    help="set in place of the configuration's environment, e.g. KB_SIGMAG_MODE=overprovision")
    args = ap.parse_args(argv)
    _, cell, config, traffic = load_cell(args.workload)
    loop = loop_module(traffic)
    readings = getattr(loop, "control_readings", None)
    if readings is None:
        raise SystemExit(f"the loop {traffic['loop']!r} ({loop.__name__}) defines no control_readings(run, seconds)")
    config["environment"] = dict(config.get("environment", {}), **dict(kv.split("=", 1) for kv in args.env))
    for seed in args.seeds:
        run = loop.Cell(cell, config, traffic, seed, args.device)
        program, control = readings(run)
        print(json.dumps({"workload": cell["name"], "seed": seed, "program": program, "control": control}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
