"""The whole-stack search loop: a closed loop of
``SearchRunner().run_search_from_work_unit(work)`` calls, one stack after
another, as a survey processes its CCDs.

Set-up makes the cell's distinct stacks from the seed (on the device, then
to host numpy once) and runs one warm-up stack of the same shapes. The
window then runs whole stacks until ``seconds`` have passed; it is timed
from the first stack's start to the last one's end. Each stack builds a
fresh WorkUnit over the same host arrays and ends with its Results on the
host and its file written, at one path under the temporary directory.

The benchmark wraps the program's public methods it calls into
(``StackSearch.__init__``, ``StackSearch.search_all``) to keep, per stack,
the search's per-pixel top-K rows, its stage timings and the spans, and
opens a ``bench:<span>`` profiler range around each in the traced run.
After the window, the reference judges what the window produced
(``benchmarks/reference/judge.py``) on stacks it makes again from the seed.

What the loop declares to the harness: ``Cell``; ``NUMBERS``, the names
``Cell.numbers`` returns, each with a limit in the traffic file;
``control_readings``, the program's numbers and its control's, for
``benchmarks.control``; and ``FAULTS`` and ``CELL_SIZE_FAULTS``
(``stack_search_faults.py``), for the tests and ``benchmarks.faults``.

The control is the reference put in the program's place, one precision
below what the configuration states: 4-bit codes for uint8 codes, bfloat16
planes for float32 planes (the search adds, it does not multiply matrices,
so TF32 does not apply), and bfloat16 science images for the coadds. It
answers at the same pixels and for the same final rows as the program: its
own top-K lists there, and its own sigma-G, sums and coadds along the
program's final rows.
"""

import contextlib
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from benchmarks import generator
from benchmarks.loops.stack_search_faults import CELL_SIZE_FAULTS, FAULTS  # noqa: F401 (the loop's faults)
from benchmarks.reference import core, judge
from benchmarks.trace import SPAN_PREFIX

NUMBERS = ("search_lh_gap", "search_rank_gap", "rescore_gap", "obs_flips", "coadd_gap", "violations", "missed")
FINAL_COLUMNS = ("x", "y", "vx", "vy", "likelihood", "flux", "obs_count", "obs_valid")
FILE_COLUMNS = ("x", "y", "vx", "vy", "likelihood", "flux", "obs_count")


class Spans:
    """The benchmark's hooks on the program: per-stack records of spans
    (host clock), the search's listed rows and stage timings; profiler
    ranges when ``traced``."""

    def __init__(self, traced):
        self.traced = traced
        self.current = None
        self._undo = []

    @contextlib.contextmanager
    def span(self, name):
        rf = torch.profiler.record_function(SPAN_PREFIX + name) if self.traced else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        if self.current is not None:
            self.current.setdefault("spans", []).append((name, t0, time.perf_counter()))

    def install(self):
        from kbmod_tpu_torch.search import StackSearch

        init, search_all = StackSearch.__init__, StackSearch.search_all
        hooks = self

        def build(search, *args, **kwargs):
            with hooks.span("build"):
                init(search, *args, **kwargs)

        def search(search_obj, *args, **kwargs):
            with hooks.span("search"):
                out = search_all(search_obj, *args, **kwargs)
            if hooks.current is not None:
                # The listed rows as the program left them (millions in the
                # survey band): kept by reference, not copied, inside the
                # window; the program makes new arrays each search.
                hooks.current["raw"] = dict(search_obj.results.get_arrays())
                hooks.current["timings"] = dict(search_obj.timings)
            return out

        StackSearch.__init__, StackSearch.search_all = build, search
        self._undo.append(lambda: setattr(StackSearch, "__init__", init))
        self._undo.append(lambda: setattr(StackSearch, "search_all", search_all))

    def remove(self):
        while self._undo:
            self._undo.pop()()


class StackSearchCell:
    """One cell of the whole-stack search: set-up, window and judgement."""

    def __init__(self, cell, config, traffic, seed, device, traced=False):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device, self.traced = int(seed), torch.device(device), traced
        self.settings = dict(config["search"])
        # As the runner does: num_obs -1, or past the usable (here: all)
        # exposures, means every exposure.
        T = len(generator.exposure_times(traffic["stack"]["times"]))
        num_obs = int(self.settings.get("num_obs", 10))
        if num_obs == -1 or num_obs >= T:
            self.settings["num_obs"] = T
        for key in ("height", "width"):
            if key in config and int(config[key]) != int(traffic["stack"][key]):
                raise ValueError(f"the traffic's {key} {traffic['stack'][key]} is not the configuration's {config[key]}")
        self.grid = generator.candidate_grid(traffic["grid"])
        self.bounds = generator.start_bounds(self.settings, int(traffic["stack"]["height"]), int(traffic["stack"]["width"]))
        self.evals = generator.evals_per_stack(self.settings, traffic)
        name = cell["name"].replace(".", "_")
        self.result_path = os.path.join(tempfile.gettempdir(), f"kbmod_bench_{name}.ecsv")
        self.hooks = Spans(traced)
        self.records = []
        self.failed = 0

    # --- the program's side ---

    def search_config(self):
        from kbmod_tpu_torch.configuration import SearchConfiguration

        config = SearchConfiguration.from_dict(dict(self.settings, generator_config=dict(self.traffic["grid"])))
        config.set("result_filename", self.result_path)
        return config

    def run_stack(self, index):
        """One whole stack through ``run_search_from_work_unit``; returns its
        record (spans, the search's rows and timings, the final rows)."""
        from kbmod_tpu_torch.core.image_stack_py import ImageStackPy
        from kbmod_tpu_torch.run_search import SearchRunner
        from kbmod_tpu_torch.work_unit import WorkUnit

        data = self.stacks[index % len(self.stacks)]
        record = {"stack": index % len(self.stacks)}
        self.hooks.current = record
        with self.hooks.span("stack"):
            work = WorkUnit(im_stack=ImageStackPy(data.times, list(data.sci), list(data.var), psfs=data.psfs),
                            config=self.search_config())
            runner = SearchRunner(device=self.device)
            results = runner.run_search_from_work_unit(work)
        self.hooks.current = None
        record["final"] = {c: np.array(results.table[c]) for c in results.colnames
                           if c in FINAL_COLUMNS or c.startswith("coadd_")}
        return record

    def setup(self, warm=True):
        self.stacks = generator.make_stacks(self.traffic, self.seed, self.device)
        # The program's own switches that make it run as the configuration
        # states (the configuration file's ``environment``), until release.
        env = self.config.get("environment", {})
        self._env_before = {k: os.environ.get(k) for k in env}
        os.environ.update({k: str(v) for k, v in env.items()})
        self.hooks.install()
        if warm:
            self.run_stack(0)  # the cell's own shapes: every kernel built and loaded
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def window(self, seconds):
        """Whole stacks until ``seconds`` have passed. Returns (window
        seconds, stacks started); a stack that raised is counted in
        ``failed`` and has no record."""
        t0 = time.perf_counter()
        i = 0
        with self.hooks.span("window"):
            while True:
                try:
                    self.records.append(self.run_stack(i))
                except Exception:  # a failed stack is counted and reported, the loop goes on
                    traceback.print_exc(file=sys.stderr)
                    self.failed += 1
                    self.hooks.current = None
                i += 1
                t1 = time.perf_counter()
                if t1 - t0 >= seconds:
                    break
        return t1 - t0, i

    def end_to_end(self, window_s):
        """The end-to-end metrics this loop measures: start pixels x
        candidates of every stack completed, over the window's seconds."""
        return {"stack_evals_per_s": self.evals * len(self.records) / window_s}

    def stack_summary(self):
        """Per window stack: its seconds, the rows the search listed and the
        final rows (host clock), for the run's log."""
        spans = [sum(e - s for n, s, e in r.get("spans", []) if n == "stack") for r in self.records]
        return {"seconds": [round(s, 4) for s in spans], "listed": [len(r["raw"]["x"]) for r in self.records if "raw" in r],
                "final": [len(r["final"]["x"]) for r in self.records]}

    def memory_peak(self):
        if self.device.type != "cuda":
            return 0
        torch.cuda.synchronize(self.device)
        return int(torch.cuda.max_memory_allocated(self.device))

    def release(self):
        """Take the hooks out and free what the program left on the device,
        before the reference runs."""
        self.hooks.remove()
        for k, v in getattr(self, "_env_before", {}).items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        self.stacks = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    # --- the judgement ---

    def reference_stacks(self, **precision):
        data = generator.make_stacks(self.traffic, self.seed, self.device)
        return [judge.ReferenceStack(s, self.settings, self.grid, self.device, **precision) for s in data]

    def search_answers(self):
        """The sampled pixels and the program's top-K lists there."""
        check = self.traffic["check"]
        raws = [r["raw"] for r in self.records]
        picks = judge.sample_pixels(raws, int(check["listed_pixels"]), int(check["any_pixels"]), self.bounds, self.seed)
        index = judge.grid_index(self.grid)
        lists = {}
        for s, raw in enumerate(raws):
            here = [(x, y) for ps, x, y in picks if ps == s]
            for (x, y), v in judge.pixel_lists(raw, here, index).items():
                lists[(s, x, y)] = v
        return lists

    def numbers(self, refs, lists=None, finals=None):
        """Every compared number of the window's records (or of the
        answers given in their place) against ``refs``."""
        index = judge.grid_index(self.grid)
        lists = self.search_answers() if lists is None else lists
        k = int(self.settings.get("results_per_pixel", 8))
        out, bad = judge.search_numbers(refs, lambda s: self.records[s]["stack"], lists, self.settings, k)
        out.update({"rescore_gap": 0.0, "obs_flips": 0, "coadd_gap": 0.0})
        kinds = sorted(set(self.settings.get("coadds", [])) | {self.settings.get("stamp_type", "sum")})
        radius = int(self.settings.get("stamp_radius", 10))
        missed = 0
        for i, record in enumerate(self.records):
            rows = record["final"] if finals is None else finals[i]
            ref = refs[record["stack"]]
            got = judge.final_numbers(ref, rows, self.settings, kinds, radius)
            out["rescore_gap"] = max(out["rescore_gap"], got["rescore_gap"])
            out["obs_flips"] = max(out["obs_flips"], got["obs_flips"])
            out["coadd_gap"] = max(out["coadd_gap"], got["coadd_gap"])
            bad += judge.row_violations(rows, self.settings, index, self.bounds, ref.zeroed)
            missed = max(missed, judge.missed_objects(rows, ref.objects, self.settings, ref.zeroed))
        if finals is None and self.records:
            bad += judge.file_mismatches(self.result_path, self.records[-1]["final"], FILE_COLUMNS)
        if not self.records:
            bad += 1
        out["violations"] = bad
        out["missed"] = missed
        return out


Cell = StackSearchCell


# --- the control ---


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


def control_readings(run, seconds=0.0):
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
