"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmarks.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json``; its configuration file
(``benchmarks/configs/<config>.json``) and traffic file
(``benchmarks/traffic/<config>.<traffic>.json``) are found by their names,
the traffic file names the loop (``benchmarks/loops/<loop>.py``, which
declares its compared numbers, its control and its faults) and
each per-layer metric has its reader (``benchmarks/metrics/<name>.py``, or
that of its name up to the first dot, for a quantity split by cell).
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a torch.profiler trace of
the window kept in memory. Every run judges what its window produced
against the plain reference, prints each compared number beside its limit
(the last lines of standard error, and the last key of the result), and
prints the result as one JSON line, last on standard output.

Exits non-zero, printing no result, without enough CUDA cards, or when
JAX or the JAX package is loaded once the window has closed.
"""

import time


def _process_age():
    """Seconds since this process started (Linux /proc), else 0."""
    try:
        import os

        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_T0 = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from benchmarks import trace as tr  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kbmod_tpu")


def load_cell(name, root=ROOT):
    """(benchmark, cell, configuration, traffic) of the workload ``name``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((root / "benchmarks" / "traffic" / f"{cell['config']}.{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def loop_module(traffic):
    """The module of the traffic file's ``loop``, ``benchmarks/loops/<loop>.py``:
    its ``Cell``, the ``NUMBERS`` it compares, its ``control_readings`` and
    its ``FAULTS`` and ``CELL_SIZE_FAULTS``."""
    return importlib.import_module(f"benchmarks.loops.{traffic['loop']}")


def loop_class(traffic):
    return loop_module(traffic).Cell


def quantity(metric_name):
    """What a metric measures: its name up to the first dot. A quantity
    split by cell (``<quantity>.<cell>``, each entry with its own bound or
    ``moves``) is one quantity with one reader."""
    return metric_name.split(".", 1)[0]


def reader(metric_name, root=ROOT):
    """The ``read(ctx)`` of ``benchmarks/metrics/<metric_name>.py``, else of
    the file of its quantity."""
    metrics = root / "benchmarks" / "metrics"
    path = metrics / f"{metric_name}.py"
    if not path.is_file():
        path = metrics / f"{quantity(metric_name)}.py"
    spec = importlib.util.spec_from_file_location(f"benchmarks.metrics._{metric_name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def per_layer_metrics(bench, cell_name, ctx, root=ROOT):
    """{name: {"value", "unit"}} of the per-layer metrics that list this
    cell (or list none), each from its reader; a reader that finds nothing
    leaves its metric out."""
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and cell_name not in m["workloads"]:
            continue
        value = reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def checks(numbers, limits):
    """({name: {"value", "limit"}}, correct): every compared number beside
    its limit; a number without a limit fails."""
    table = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(t["limit"] is not None and t["value"] <= t["limit"] for t in table.values())
    return table, ok


def main(argv=None):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench, cell, config, traffic = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA card(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = loop_class(traffic)(cell, config, traffic, args.seed, "cuda", traced=bool(args.trace))
    result = measure(run, bench, cell, args.seconds, bool(args.trace))
    if result is None:
        return 3
    for name, t in result["checks"].items():
        print(f"check {name} {t['value']!r} limit {t['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def measure(run, bench, cell, seconds, traced):
    """Set-up, the window (profiled when ``traced``), the check for JAX, the
    device peak, then the reference's judgement. Returns the result dict,
    or None when JAX or the JAX package was loaded."""
    import torch

    run.setup()
    setup_s = time.perf_counter() - _T0
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        cuda = [ProfilerActivity.CUDA] if run.device.type == "cuda" else []
        prof = profile(activities=[ProfilerActivity.CPU, *cuda])
        prof.start()
    window_s, attempted = run.window(seconds)
    trace = None
    if prof is not None:
        prof.stop()
        trace = tr.collect(prof)
        del prof
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return None
    peak = run.memory_peak()
    dev = run.device
    on_card = dev.type == "cuda"
    device = {"platform": "gpu" if on_card else "cpu", "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
              "count": 1, "memory_peak_bytes": peak}
    completed = len(run.records)
    ctx = SimpleNamespace(records=run.records, trace=trace, settings=run.settings, traffic=run.traffic,
                          peak_bytes=peak, window_s=window_s, device_name=device["kind"], evals=run.evals)
    if traced:
        metrics = per_layer_metrics(bench, cell["name"], ctx)
        lo, hi = trace.window()
        device["busy_s"] = tr.busy_seconds(trace)
        device["window_s"] = hi - lo
    else:
        values = dict(run.end_to_end(window_s), setup_s=setup_s)
        metrics = {m["name"]: {"value": values.get(m["name"], values.get(quantity(m["name"]))), "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if (m["name"] in values or quantity(m["name"]) in values)
                   and cell["name"] in m.get("workloads", [cell["name"]])}
    run.release()
    t_ref = time.perf_counter()
    numbers = run.numbers(run.reference_stacks())
    print(f"{completed} stacks in {window_s:.3f} s; set-up {setup_s:.3f} s; the reference judged them in "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    print("per stack: " + json.dumps(run.stack_summary()), file=sys.stderr)
    table, ok = checks(numbers, run.traffic["limits"])
    result = {"correct": bool(ok and run.failed == 0 and completed > 0), "attempted": attempted,
              "failed": run.failed, "metrics": metrics, "device": device}
    if traced:
        result["breakdown"] = tr.breakdown(trace)
    result["checks"] = table
    return result


if __name__ == "__main__":
    raise SystemExit(main())
