"""Faults planted in the program underneath a run, for the check that
``correct`` comes out false. Each cell's loop module
(``benchmarks/loops/<loop>.py``) holds its own: ``FAULTS``, which its tests
plant at a tiny size, and ``CELL_SIZE_FAULTS``, seen only at the cell's own
size (either may be empty but ``FAULTS``).

    python3 -m benchmarks.faults --workload <name> --seeds <n> [<n> ...] [--faults <name> ...]

reads every fault's numbers of the cell's loop at the cell's own size on the
card, one JSON line a fault and seed: the upper readings of the numbers
that the control leaves at 0. Each fault takes an object with
``setattr(target, name, value)``, as pytest's monkeypatch fixture is.
"""

import argparse
import json
import sys


class Patcher:
    """setattr that remembers the old values; ``undo`` puts them back."""

    def __init__(self):
        self._old = []

    def setattr(self, target, name, value):
        self._old.append((target, name, getattr(target, name)))
        setattr(target, name, value)

    def undo(self):
        while self._old:
            target, name, value = self._old.pop()
            setattr(target, name, value)


def main(argv=None):
    from benchmarks.run import load_cell, loop_module

    ap = argparse.ArgumentParser(description="The program's numbers with each planted fault, seed by seed.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", help="the faults to plant, by name (default: all)")
    args = ap.parse_args(argv)
    _, cell, config, traffic = load_cell(args.workload)
    loop = loop_module(traffic)
    for fault, plant in dict(loop.FAULTS, **loop.CELL_SIZE_FAULTS).items():
        if args.faults and fault not in args.faults:
            continue
        for seed in args.seeds:
            patcher = Patcher()
            plant(patcher)
            run = loop.Cell(cell, config, traffic, seed, "cuda")
            try:
                run.setup(warm=False)
                run.window(0)
                run.release()
                numbers = run.numbers(run.reference_stacks())
            except ValueError as exc:  # the run ends with no result
                numbers = {"error": repr(exc)[:200]}
            finally:
                patcher.undo()
            print(json.dumps({"workload": cell["name"], "fault": fault, "seed": seed, "program": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
