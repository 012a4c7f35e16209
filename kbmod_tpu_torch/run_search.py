"""SearchRunner: the top-level KBMOD search pipeline of the port.

Port of the JAX package's run_search.py (API-compatible with the reference's
kbmod.run_search): image QA, candidate generation, the core device search,
sigma-G filtering, clustering, stamp generation, results file writing, with
per-phase wall-time/memory stats and a soft timeout.

``SearchRunner(config=None, device=None)`` runs on CUDA unless the caller
asks for the CPU (``device="cpu"``, here or in ``run_search``); its resolved
device is where the search, the sigma-G clipping and the coadds run.
``config["cpu_only"]`` keeps the reference's meaning: the search's CPU-path
semantics (``search_all(..., on_gpu=False)``), not a choice of device.

``cnn_filter`` vets the stamps with the port's ResNet; it needs a weights
file (``cnn_model``), and the repository ships none.

``KB_SEARCH_CKPT_DIR`` (with ``KB_SEARCH_CKPT_TILE_ROWS``, default 256)
checkpoints the search per row tile, so that a killed run resumes
mid-search; ``KB_PROFILE_DIR`` traces the whole run with ``torch.profiler``
(CPU and CUDA activities) into a Chrome trace file there, in which the port's
tracer (``kbmod_tpu_torch.tracing``) draws every phase and stage as a
``kbmod:<name>`` range, and writes beside it a JSON file of those stages'
counts, seconds, self seconds and counters (:func:`profiled`).

A WorkUnit (``run_search(..., workunit=...)``, ``run_search_from_work_unit``)
adds the QA cut on the WorkUnit, the ecliptic angle from its WCS and RA/Dec
output (``append_positions_to_results``, host numpy). Where ``color_scale``
is set, ``run_search_from_work_unit`` applies it with
``WorkUnit.apply_color_scale``; the JAX package calls a method its image
stack lacks there and raises AttributeError.
"""

import json
import logging
import os
import time
from contextlib import contextmanager

import numpy as np
import torch

try:
    import psutil
except ImportError:  # pragma: no cover
    psutil = None

from kbmod_tpu_torch import tracing
from kbmod_tpu_torch.device import device_free_bytes, resolve_device
from kbmod_tpu_torch.filters.clustering_filters import apply_clustering
from kbmod_tpu_torch.filters.clustering_grid import apply_trajectory_grid_filter
from kbmod_tpu_torch.filters.sigma_g_filter import SigmaGClipping, apply_clipped_sigma_g
from kbmod_tpu_torch.filters.sns_filters import peak_offset_filter, predictive_line_cluster
from kbmod_tpu_torch.filters.stamp_filters import append_all_stamps, append_coadds, filter_stamps_by_cnn
from kbmod_tpu_torch.ops.psi_phi import build_bytes, planes_bytes
from kbmod_tpu_torch.ops.search import exact_bytes, gathers_bytes, maps_bytes, search_depth
from kbmod_tpu_torch.ops.search_kernel import padding_bytes
from kbmod_tpu_torch.ops.search_plan import expand_bytes, layouts_bytes
from kbmod_tpu_torch.parallel.sharded import shards_bytes
from kbmod_tpu_torch.results import Results, write_results_to_files_destructive
from kbmod_tpu_torch.search import StackSearch, TrajectoryList
from kbmod_tpu_torch.search.checkpoint import checkpoint_bytes
from kbmod_tpu_torch.trajectory_generator import create_trajectory_generator
from kbmod_tpu_torch.trajectory_utils import predict_pixel_locations

logger = logging.getLogger("kbmod.run_search")

# Rows of psi/phi curves load_and_filter_results gathers and clips at once.
RESULTS_BATCH = 100_000
# Device bytes one curve sample holds while torch.nanquantile sorts it.
QUANTILE_BYTES_PER_SAMPLE = 64


def _resolve_start_bounds(config, axis, image_extent):
    """Starting-pixel bounds along one axis, or None for the image default.

    Explicit ``{x,y}_pixel_bounds`` win; otherwise a positive
    ``{x,y}_pixel_buffer`` widens the image extent symmetrically so
    trajectories may start off-chip and drift on.
    """
    bounds = config[f"{axis}_pixel_bounds"]
    if bounds and len(bounds) == 2:
        return int(bounds[0]), int(bounds[1])
    buffer = config[f"{axis}_pixel_buffer"]
    if buffer and buffer > 0:
        return -int(buffer), image_extent + int(buffer)
    return None


def configure_kb_search_stack(search, config):
    """Push a SearchConfiguration's filtering, bounds, and in-kernel
    sigma-G settings into a StackSearch (binding surface of the reference's
    run_search.py:25-72), and the per-row-tile checkpointing of
    ``KB_SEARCH_CKPT_DIR`` (tiles of ``KB_SEARCH_CKPT_TILE_ROWS`` rows)."""
    search.set_min_obs(int(config["num_obs"]))
    search.set_min_lh(config["lh_level"])
    search.set_results_per_pixel(config["results_per_pixel"])

    x_bounds = _resolve_start_bounds(config, "x", search.get_image_width())
    if x_bounds is not None:
        search.set_start_bounds_x(*x_bounds)
    y_bounds = _resolve_start_bounds(config, "y", search.get_image_height())
    if y_bounds is not None:
        search.set_start_bounds_y(*y_bounds)

    if config["sigmaG_filter"] and config["gpu_filter"]:
        lo, hi = config["sigmaG_lims"]
        logger.debug(f"In-kernel sigma-G enabled (percentiles [{lo}, {hi}]).")
        search.enable_gpu_sigmag_filter(
            np.array([lo, hi]) / 100.0,
            SigmaGClipping.find_sigma_g_coeff(lo, hi),
            config["lh_level"],
        )
    else:
        search.disable_gpu_sigmag_filter()

    # Per-row-tile checkpoints, so that a killed pipeline resumes mid-search
    # (the JAX package's run_search.py:81-90; env-gated to keep the
    # configuration's schema the reference's).
    ckpt = search_checkpointing()
    if ckpt:
        search.enable_search_checkpointing(ckpt[0], tile_rows=ckpt[1])
    search.clear_results()


def search_checkpointing():
    """(``KB_SEARCH_CKPT_DIR``, rows a tile: ``KB_SEARCH_CKPT_TILE_ROWS`` or
    256), or None without a directory."""
    ckpt_dir = os.environ.get("KB_SEARCH_CKPT_DIR")
    return (ckpt_dir, int(os.environ.get("KB_SEARCH_CKPT_TILE_ROWS", "256"))) if ckpt_dir else None


def search_memory_budget(config, stack, num_candidates, device):
    """The most device memory, in bytes, the port allocates for
    ``do_core_search`` on this configuration and stack, term by term (each
    an upper bound; "total" is their sum). The module that allocates a term
    computes and describes it as ``<term>_bytes``: planes, build in ``ops.psi_phi``;
    padding (float) in ``ops.search_kernel``; expand (quantized), layouts in
    ``ops.search_plan``; maps, gathers, exact in ``ops.search``; checkpoint in
    ``search.checkpoint``; shards in ``parallel.sharded``. Curves, a curve gather of
    RESULTS_BATCH rows and its sigma-G quantiles, are the pipeline's. A checkpointed
    search counts one tile of rows. K' is ``ops.search.search_depth``'s."""
    T, H, W = stack.num_times, stack.height, stack.width
    C = int(num_candidates)
    nb = int(config["encode_num_bytes"])
    quantized = nb in (1, 2)

    def extent(axis, image_extent):
        bounds = _resolve_start_bounds(config, axis, image_extent)
        return image_extent if bounds is None else bounds[1] - bounds[0]

    SH, SW = extent("y", H), extent("x", W)
    ckpt = search_checkpointing()
    # The rows whose maps one search holds at a time.
    rows = min(SH, ckpt[1]) if ckpt else SH
    on_gpu = not config["cpu_only"]
    k = int(config["results_per_pixel"]) if on_gpu else min(int(config["results_per_pixel"]), C)
    mode, ks, _ = search_depth(on_gpu and config["sigmaG_filter"] and config["gpu_filter"], k, C)
    curve_rows = min(RESULTS_BATCH, ks * SH * SW)
    terms = {
        "planes": planes_bytes(nb, T, H, W),
        "build": build_bytes(nb, T, H, W, device),
        "padding": 0 if quantized else padding_bytes(T, H, W),
        "expand": expand_bytes(ks, rows, SW) if quantized else 0,
        "maps": maps_bytes(ks, rows, SW),
        "layouts": layouts_bytes(C, T),
        "gathers": gathers_bytes(ks * rows * SW, T),
        "curves": gathers_bytes(ks * SH * SW, T, chunk=RESULTS_BATCH) + QUANTILE_BYTES_PER_SAMPLE * curve_rows * T,
        "exact": exact_bytes(device.type, quantized, C, T, H, W, ks, rows, SW) if mode == "exact" else 0,
        "checkpoint": checkpoint_bytes(H, W) if ckpt else 0,
        "shards": shards_bytes(device, ks, rows, SW, C),
    }
    terms["total"] = sum(terms.values())
    return terms


def check_gpu_memory(config, stack, trj_generator=None, device=None):
    """Whether the search fits the card's free memory, by the port's own
    budget (:func:`search_memory_budget`), which counts what the port
    allocates. The JAX package budgets its TPU word stream instead."""
    dev = resolve_device(device)
    num_candidates = 0 if trj_generator is None else len(trj_generator)
    budget = search_memory_budget(config, stack, num_candidates, dev)
    free = device_free_bytes(dev)
    logger.debug(
        f"Device memory check: need {budget['total'] / 2**30:.2f} GiB "
        f"({ {kk: round(vv / 2**30, 2) for kk, vv in budget.items()} }), free {free / 2**30:.2f} GiB"
    )
    return free > budget["total"]


@contextmanager
def profiled(profile_dir, device):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA on a
    card) into a Chrome trace ``kbmod_trace_<pid>_<ms>.json`` under
    ``profile_dir``; no tracing when ``profile_dir`` is empty or None. While
    the profiler runs, the port's tracer (``kbmod_tpu_torch.tracing``) is on:
    its spans are the trace's ``kbmod:<stage>`` ranges, and
    ``kbmod_stages_<pid>_<ms>.json`` beside the trace holds, per span name,
    its count, seconds, self seconds and counter totals. Both files are
    written in a ``finally``, so a failing run still leaves them."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=activities)
    t0 = time.perf_counter()
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        stem = f"{os.getpid()}_{int(time.time() * 1e3)}.json"
        path = os.path.join(profile_dir, f"kbmod_trace_{stem}")
        prof.export_chrome_trace(path)
        stages = tracing.stages([r for r in tracing.records() if r.start >= t0])
        with open(os.path.join(profile_dir, f"kbmod_stages_{stem}"), "w") as f:
            json.dump(stages, f, indent=1, sort_keys=True)
        logger.info(f"Profile trace written to {path}.")


def stat_gpu_memory_mb(device):
    """Human-readable device memory stats."""
    if device.type != "cuda":
        return "No CUDA device in use."
    used = torch.cuda.memory_allocated(device) / (1024.0 * 1024.0)
    total = torch.cuda.get_device_properties(device).total_memory / (1024.0 * 1024.0)
    return f"Device memory: {used:.2f} MB allocated of {total:.2f} MB total."


class SearchRunner:
    """Runs the KBMOD grid search with per-phase stats and soft timeout.

    ``device``: where the search, the sigma-G clipping and the coadds run;
    None means CUDA (raising without a card when a run starts), "cpu" runs
    the kernels' plain twins. ``run_search(..., device=...)`` overrides it.
    """

    def __init__(self, config=None, device=None):
        self.phase_times = {}
        self.phase_memory = {}
        self._phase_spans = {}
        self.timeout = None
        self.debug = False
        self.config = None
        self._device = device
        self.device = None if device is None else resolve_device(device)
        self.apply_config(config)

    def apply_config(self, config):
        if config is None:
            return
        config.validate()
        self.config = config
        if config["debug"]:
            logging.basicConfig(level=logging.DEBUG)
            self.debug = True
        if self.timeout is None and config["timeout_hours"] is not None:
            self.timeout = time.time() + config["timeout_hours"] * 3600.0
            logger.debug(f"Search will timeout at {time.ctime(self.timeout)}.")

    def _check_timeout(self):
        """Soft timeout, checked only between phases."""
        if self.timeout is not None and time.time() > self.timeout:
            self.display_phase_stats()
            raise TimeoutError("Search has exceeded the maximum allowed time.")

    def _rss(self):
        if psutil is None:
            return 0
        return psutil.Process().memory_info().rss

    def _start_phase(self, phase_name):
        """Open the phase's tracer span; ``phase_times`` holds its [start,
        end] in seconds on the monotonic clock, anchored to Unix time."""
        self._check_timeout()
        logger.debug(f"Starting {phase_name}.")
        self._phase_spans[phase_name] = tracing.span(phase_name).__enter__()
        self.phase_times[phase_name] = [tracing.unix_seconds(time.perf_counter()), None]
        self.phase_memory[phase_name] = [self._rss(), None]

    def _end_phase(self, phase_name):
        self._check_timeout()
        if phase_name not in self.phase_times:
            raise KeyError(f"Phase {phase_name} has not been started.")
        self.phase_times[phase_name][1] = tracing.unix_seconds(time.perf_counter())
        self._phase_spans.pop(phase_name).__exit__(None, None, None)
        delta_t = self.phase_times[phase_name][1] - self.phase_times[phase_name][0]
        logger.debug(f"Finished {phase_name} in {delta_t} seconds.")
        self.phase_memory[phase_name][1] = self._rss()

    def _close_phases(self):
        """Close the spans of phases an error left open, innermost first."""
        while self._phase_spans:
            self._phase_spans.popitem()[1].__exit__(None, None, None)

    def display_phase_stats(self):
        for phase in self.phase_times:
            print(f"{phase}:")
            if self.phase_times[phase][1] is not None:
                print(f"    Time (sec) = {self.phase_times[phase][1] - self.phase_times[phase][0]}")
            else:
                print("    Time (sec) = Unfinished")
            print(f"    Memory Start (mb) = {self.phase_memory[phase][0] / (1024.0 * 1024.0)}")
            if self.phase_memory[phase][1] is not None:
                print(f"    Memory End (mb) = {self.phase_memory[phase][1] / (1024.0 * 1024.0)}")
            else:
                print("    Memory End (mb) = Unfinished")

    def load_and_filter_results(self, search, config, batch_size=RESULTS_BATCH):
        """Compile raw search results into a Results table, attaching
        psi/phi curves and applying sigma-G + stats refiltering in batches
        (reference run_search.py:251-337). The clipping runs on the
        runner's device, or the search's when the runner has none yet."""
        self._start_phase("load_and_filter_results")
        num_times = search.get_num_images()

        bnds = config["sigmaG_lims"] if config["sigmaG_lims"] is not None else [25, 75]
        clipper = SigmaGClipping(bnds[0], bnds[1], 2, config["clip_negative"], device=self.device or search.device)

        keep = Results(track_filtered=config["track_filtered"])

        result_list = search.results  # TrajectoryList (struct of arrays)
        num_raw = len(result_list)
        logger.info(f"Device search produced {num_raw} raw trajectories.")
        if num_raw < 1:
            self._end_phase("load_and_filter_results")
            return keep
        arrays = result_list.get_arrays()
        logger.info(f"Raw likelihood range: [{arrays['lh'][-1]}, {arrays['lh'][0]}]")

        # Near-duplicate prefilter on the raw trajectories (vectorized grid).
        if config["near_dup_thresh"] is not None and config["near_dup_thresh"] > 0:
            self._start_phase("near duplicate removal")
            bin_width = config["near_dup_thresh"]
            zt = np.asarray(search.zeroed_times)
            max_dt = float(np.max(zt) - np.min(zt))
            arrays, _ = apply_trajectory_grid_filter(arrays, bin_width, max_dt)
            logger.info(
                f"Near-duplicate grid prefilter (bin={bin_width}px, dt={max_dt}): "
                f"{len(arrays['x'])} of {num_raw} kept."
            )
            tracing.count("rows.near_dup", len(arrays["x"]))
            self._end_phase("near duplicate removal")

        num_kept = len(arrays["x"])
        batches = []
        batch_start = 0
        while batch_start < num_kept:
            self._check_timeout()
            batch_end = min(batch_start + batch_size, num_kept)
            with tracing.span("results.batch"):
                batch = {k: v[batch_start:batch_end] for k, v in arrays.items()}
                batch_results = Results.from_trajectories(TrajectoryList(batch),
                                                          track_filtered=config["track_filtered"])

                if config["generate_psi_phi"]:
                    with tracing.span("results.curves"):
                        psi_phi_batch = search.get_all_psi_phi_curves(TrajectoryList(batch))
                        batch_results.add_psi_phi_data(psi_phi_batch[:, :num_times], psi_phi_batch[:, num_times:])

                if config["sigmaG_filter"]:
                    if not config["generate_psi_phi"]:
                        raise ValueError("Unable to do sigma-G filtering without psi and phi curves.")
                    with tracing.span("results.sigmag"):
                        apply_clipped_sigma_g(clipper, batch_results)
                    with tracing.span("results.filter"):
                        row_mask = np.asarray(batch_results["obs_count"]) >= config["num_obs"]
                        if config["lh_level"] > 0.0:
                            row_mask = row_mask & (np.asarray(batch_results["likelihood"]) >= config["lh_level"])
                        batch_results.filter_rows(row_mask, "sigma-g")
                    logger.debug(f"After sigma-G filtering, batch size = {len(batch_results)}")
                    tracing.count("rows.sigmag", len(batch_results))

            batches.append(batch_results)
            batch_start += batch_size

        # One vstack for the whole loop: per-batch extend() is quadratic
        # in total rows.
        with tracing.span("results.extend"):
            keep.extend_batches(batches)
        self._end_phase("load_and_filter_results")
        return keep

    def do_core_search(self, config, stack, trj_generator):
        """Build the psi/phi array, run the device search, and load the
        filtered results (reference run_search.py:339-394). On a card the
        port's memory budget must fit first."""
        self._start_phase("do_core_search")
        if self.device is None:
            self.device = resolve_device(self._device)

        use_gpu = not config["cpu_only"]
        with tracing.span("runner.memory_check"):
            fits = not (use_gpu and self.device.type == "cuda") or check_gpu_memory(
                config, stack, trj_generator, self.device
            )
        if not fits:
            raise ValueError("Insufficient device memory to conduct the search.")

        search = StackSearch(
            stack.sci,
            stack.var,
            stack.psfs,
            stack.zeroed_times,
            config["encode_num_bytes"],
            device=self.device,
        )
        configure_kb_search_stack(search, config)

        self._start_phase("grid search")
        logger.debug(f"Trajectory Generator: {trj_generator}")
        vxs, vys = trj_generator.velocity_arrays()
        candidates = TrajectoryList(
            {
                "x": np.zeros(len(vxs), dtype=np.int32),
                "y": np.zeros(len(vxs), dtype=np.int32),
                "vx": vxs,
                "vy": vys,
                "lh": np.zeros(len(vxs), dtype=np.float32),
                "flux": np.zeros(len(vxs), dtype=np.float32),
                "obs_count": np.zeros(len(vxs), dtype=np.int32),
            }
        )
        logger.debug(f"Using {len(candidates)} candidates per pixel.")
        try:
            search.search_all(candidates, use_gpu)
        except Exception:
            logger.error("Error during grid search. Cleaning up memory.")
            del search
            raise
        self._end_phase("grid search")

        keep = self.load_and_filter_results(search, config)
        del search
        self._end_phase("do_core_search")
        return keep

    def _truncate_to_max_results(self, keep, config):
        """Cap the row count at config max_results (best likelihood first),
        after all trajectory-space filtering and before stamps are attached
        (reference run_search.py:482-490 for the ordering contract)."""
        limit = config["max_results"]
        if limit <= -1 or len(keep) <= limit:
            return
        self._start_phase("max_results")
        logger.info(f"Keeping the {limit} highest-likelihood of {len(keep)} rows.")
        keep.sort("likelihood", descending=True)
        keep.filter_rows(np.arange(limit), "max_results")
        self._end_phase("max_results")

    def _stamp_phase(self, keep, config, stack):
        """Attach coadd stamps, then run every stamp-space vetting step.

        One umbrella phase wraps four config-gated sub-steps; the set of
        steps and their order is the reference's pipeline contract
        (run_search.py:492-531): coadds (always, plus the legacy "stamp"
        alias), peak-offset veto, predictive line clustering, CNN vetting
        (not ported yet: it raises), and optionally the full per-time stamp
        cube.
        """
        radius = config["stamp_radius"]
        legacy = config["stamp_type"]
        self._start_phase("stamp generation")

        self._start_phase("appending co-adds")
        append_coadds(keep, stack, set(config["coadds"]) | {legacy}, radius,
                      nightly=config["nightly_coadds"], device=self.device)
        if f"coadd_{legacy}" in keep.colnames:
            keep.table["stamp"] = keep.table[f"coadd_{legacy}"]
        self._end_phase("appending co-adds")

        if config["peak_offset_max"] is not None:
            self._start_phase("peak_offset_filtering")
            peak_offset_filter(keep, peak_offset_max=config["peak_offset_max"])
            self._end_phase("peak_offset_filtering")

        if config["pred_line_cluster"]:
            params = config["pred_line_params"]
            if len(params) != 3:
                raise ValueError(f"pred_line_params needs [dist_lim, min_samples, proc_dist], got {params}")
            self._start_phase("predictive_line_clustering")
            predictive_line_cluster(keep, stack.times, *params)
            self._end_phase("predictive_line_clustering")

        if config["cnn_filter"]:
            if config["cnn_model"] is None:
                raise ValueError("cnn_filter requires cnn_model.")
            self._start_phase("cnn filtering")
            filter_stamps_by_cnn(
                keep,
                config["cnn_model"],
                model_type=config["cnn_model_type"],
                coadd_type=config["cnn_coadd_type"],
                stamp_radius=config["cnn_stamp_radius"],
                coadd_radius=radius,
                device=self.device,
            )
            self._end_phase("cnn filtering")

        if config["save_all_stamps"]:
            append_all_stamps(keep, stack, radius, device=self.device)
        self._end_phase("stamp generation")

    def run_search(self, config, stack, trj_generator=None, workunit=None, extra_meta=None, device=None):
        """The highest-level entry: search an ImageStackPy with a
        SearchConfiguration (reference run_search.py:396-593) on
        ``device`` (default: the runner's, else CUDA). With a ``workunit``
        (whose ``im_stack`` is ``stack``) the QA cut filters the WorkUnit,
        the results carry its WCS and, with ``compute_ra_dec``, sky
        positions. With ``KB_PROFILE_DIR`` set the whole run is traced
        (:func:`profiled`)."""
        if device is not None:
            self._device = device
        self.device = resolve_device(self._device)
        with profiled(os.environ.get("KB_PROFILE_DIR"), self.device):
            try:
                return self._run_search(config, stack, trj_generator, workunit, extra_meta)
            finally:
                self._close_phases()

    def _run_search(self, config, stack, trj_generator, workunit, extra_meta):
        self.apply_config(config)
        if self.debug:
            logger.debug(f"Device: {self.device}, CUDA available: {torch.cuda.is_available()}")
            logger.debug(stat_gpu_memory_mb(self.device))
            logger.debug(str(config))

        with tracing.span("runner.qa"):
            # Image QA: drop overly-masked images.
            if config["max_masked_pixels"] < 1.0:
                keep_mask = stack.get_masked_fractions() <= config["max_masked_pixels"]
                if workunit is not None:
                    workunit.filter_images(keep_mask)
                    stack = workunit.im_stack
                else:
                    stack.filter_images(keep_mask)
            logger.debug(f"Searching over {stack.num_times} images after the obs-validity cut.")

            # num_obs can never exceed the number of usable (<90% masked)
            # images; -1 means "derive it from the stack".
            usable = int(np.count_nonzero(stack.get_masked_fractions() < 0.9))
        if usable == 0:
            raise ValueError("No valid images in input.")
        if config["num_obs"] == -1 or config["num_obs"] >= usable:
            logger.info(f"num_obs={config['num_obs']} capped to the {usable} usable images.")
            config.set("num_obs", usable)

        self._start_phase("KBMOD")

        trj_generator = trj_generator or create_trajectory_generator(config, work_unit=None)
        keep = self.do_core_search(config, stack, trj_generator)

        if config["do_clustering"] and len(keep) > 1:
            self._start_phase("clustering")
            cluster_params = {
                key: config[key] for key in ("cluster_type", "cluster_eps", "cluster_v_scale")
            }
            cluster_params["times"] = np.asarray(stack.times)
            apply_clustering(keep, cluster_params)
            self._end_phase("clustering")

        self._truncate_to_max_results(keep, config)
        self._stamp_phase(keep, config, stack)

        # Sky-coordinate output from the WorkUnit's WCS information.
        if workunit is not None:
            keep.wcs = workunit.wcs
            if config["compute_ra_dec"]:
                self._start_phase("append_positions_to_results")
                append_positions_to_results(workunit, keep)
                self._end_phase("append_positions_to_results")

        # Save results + metadata.
        tracing.count("rows.final", len(keep))
        self._start_phase("write results")
        meta_to_save = dict(extra_meta) if extra_meta is not None else {}
        if workunit is not None:
            meta_to_save.update(
                workunit.get_constituent_meta(["visit", "filter", "data_loc", "dataId", "color_scale"])
            )
        meta_to_save["num_img"] = stack.num_times
        meta_to_save["dims"] = (stack.width, stack.height)
        keep.set_mjd_utc_mid(np.array(stack.times))

        if config["result_filename"] is not None:
            write_results_to_files_destructive(
                config["result_filename"],
                keep,
                extra_meta=meta_to_save,
                separate_col_files=config["separate_col_files"],
                drop_columns=config["drop_columns"],
                overwrite=True,
            )
            if config["save_config"]:
                # The run's exact config goes to a <stem>_provenance/ dir
                # next to the results file (the layout the reference's
                # readers expect; run_search.py:575-585). Needs PyYAML.
                from pathlib import Path

                result_path = Path(config["result_filename"])
                stem = result_path.name
                for ext in keep._supported_formats:
                    if stem.endswith(ext):
                        stem = stem[: -len(ext)]
                        break
                provenance = result_path.parent / f"{stem}_provenance"
                provenance.mkdir(parents=True, exist_ok=True)
                config.to_file(str(provenance / f"{stem}_config.yaml"), overwrite=True)
        self._end_phase("write results")

        self._end_phase("KBMOD")
        if config["debug"]:
            self.display_phase_stats()
        return keep

    def run_search_from_work_unit(self, work, device=None):
        """Run a search from a WorkUnit on ``device`` (default: the
        runner's, else CUDA): the trajectory generator's ecliptic angle
        comes from the WCS, and ``color_scale``, where set, scales the
        images through ``WorkUnit.apply_color_scale``."""
        trj_generator = create_trajectory_generator(work.config, work_unit=work)
        if work.config["color_scale"] is not None:
            work.apply_color_scale(work.config["color_scale"])
        return self.run_search(work.config, work.im_stack, trj_generator=trj_generator, workunit=work,
                               device=device)


def append_positions_to_results(workunit, results):
    """Append predicted pixel and (RA, Dec) positions per time to the
    results (reference run_search.py:620-689): global_ra/global_dec from
    the common WCS and img_ra/img_dec in the original frame (inverting the
    EBD parallax correction when the WorkUnit is reprojected there), or
    from each image's own WCS when there is no common one. Host numpy."""
    from kbmod_tpu_torch.geom.wcs import SkyCoordLite
    from kbmod_tpu_torch.reprojection_utils import invert_correct_parallax_vectorized

    num_results = len(results)
    if num_results == 0:
        return

    num_times = workunit.im_stack.num_times
    times = workunit.im_stack.zeroed_times

    xp = predict_pixel_locations(times, results["x"], results["vx"], as_int=False, centered=False)
    yp = predict_pixel_locations(times, results["y"], results["vy"], as_int=False, centered=False)
    results.table["pred_x"] = xp
    results.table["pred_y"] = yp

    all_ra = np.zeros((num_results, num_times))
    all_dec = np.zeros((num_results, num_times))

    if workunit.wcs is not None:
        logger.info("Common WCS present - computing global_ra/global_dec for every result row.")
        ra, dec = workunit.wcs.pixel_to_world_values(xp, yp)
        results.table["global_ra"] = ra
        results.table["global_dec"] = dec

        if workunit.reprojected and workunit.reprojection_frame != "ebd":
            logger.warning("WorkUnit was not reprojected to EBD space; per-image img_ra/img_dec are omitted.")
            all_ra = ra
            all_dec = dec
        elif workunit.reprojected:
            obstimes = workunit.get_all_obstimes()
            for time_idx in range(num_times):
                coords = SkyCoordLite(ra[:, time_idx], dec[:, time_idx])
                coords.distance_au = np.full(num_results, workunit.barycentric_distance)
                original = invert_correct_parallax_vectorized(
                    coords, obstimes=obstimes[time_idx], point_on_earth=workunit.observatory
                )
                all_ra[:, time_idx] = original.ra_deg
                all_dec[:, time_idx] = original.dec_deg
        else:
            all_ra = ra
            all_dec = dec
    else:
        logger.info("No common WCS found. Computing img_ra/img_dec from per-image WCSes.")
        for time_idx in range(num_times):
            wcs = workunit.get_wcs(time_idx)
            if wcs is not None:
                ra, dec = wcs.pixel_to_world_values(xp[:, time_idx], yp[:, time_idx])
                all_ra[:, time_idx] = ra
                all_dec[:, time_idx] = dec

    results.table["img_ra"] = all_ra
    results.table["img_dec"] = all_dec
