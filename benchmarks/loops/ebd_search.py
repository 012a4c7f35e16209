"""The reflex-corrected WorkUnit search loop: a closed loop of what a KBMOD
user does with a night's exposures. Each WorkUnit holds whole CCDs with
their own WCSes; ``reproject_work_unit(work, common_wcs, frame="ebd")``
fits each CCD's barycentric ("EBD") WCS at the guessed distance, resamples
it onto one common patch and mosaics the CCDs of one exposure into one
layer; ``SearchRunner().run_search_from_work_unit`` then searches the
layers and ends with the Results on the host (sky positions of every row
at every time included) and the results file written.

Set-up makes the cell's distinct WorkUnits from the seed (the noise on the
device, then to host numpy once; the pointings, dithers and objects from
the plain reference's geometry) and runs one warm-up WorkUnit. The window
runs whole WorkUnits until ``seconds`` have passed, each a fresh WorkUnit
over the same host arrays.

The traffic file gives the searched frame as ``stack`` (the patch's
``height`` and ``width``, the exposures' ``times``, ``noise``,
``variance``, ``psf_sigmas``), the sky as ``field`` (``center``, the EBD
direction of the patch's centre; ``distance_au``; ``pixel_arcsec``;
``site``, the observatory's geodetic latitude, longitude and height) and
the focal plane as ``ccd`` (``height`` and ``width`` of a CCD, the ``gap``
in pixels between a CCD and its neighbour in x, ``patch_origin``, the
pixel of CCD A under the patch's first pixel before a dither, and
``dither_px``, the largest dither on each axis). Objects move linearly in
the common (EBD) frame and are planted in each exposure through the
reference's inverse parallax and that exposure's WCS.

After the window each stage is judged against the plain reference
(``benchmarks/reference/ebd.py``, ``judge.py``), given the stage before it
as the program left it, on the host arrays the window searched:

- ``observer_gap`` (arcsec): the program's barycentric observer positions
  at the exposures' times (its ephemeris and site) against the
  reference's, as the angle the difference turns a line of sight to a
  point at the assumed distance.
- ``ebd_wcs_gap`` (arcsec): every constituent's fitted EBD WCS (the WCS the
  reprojection used) against the reference's correction of its own WCS
  from the program's observer, at ``check["wcs_pixels"]`` seeded pixels of
  the CCD.
- ``layer_gap`` (noise sigmas) and ``mask_flips`` (pixels): every layer
  against the reference's resampling and mosaic through the program's EBD
  WCSes, at ``check["layer_pixels"]`` seeded pixels of the layer, half of
  them on the edges of the program's mask: the largest gap of the science
  layer over the noise's sigma and of the variance over its level, and the
  pixels masked in one and not in the other.
- the stack search's numbers (``stack_search``, ``judge.py``) on the
  program's layers, but ``missed``: the objects that the reference's
  results path (``reference_rows``: near-duplicates, its own sigma-G and
  filters, DBSCAN) keeps a row for from the search's listed rows, and no
  final row of the program represents. At KBMOD's eps of 20 the DBSCAN
  chains objects through their one-night trajectories, so which objects
  a final row can represent is the reference's to say.
- ``position_gap`` (arcsec): every final row's ``global_ra``/``global_dec``
  and ``img_ra``/``img_dec`` at every time against the reference's common
  WCS and its inverse parallax from the program's observer.

The control is the reference one precision below the configuration's
float64 geometry and float32 planes: float32 coordinates, times and
observer positions, and bfloat16 planes (the stack search's control for
its numbers).
"""

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from benchmarks import generator
from benchmarks.loops import stack_search
from benchmarks.loops.ebd_search_faults import CELL_SIZE_FAULTS, FAULTS  # noqa: F401 (the loop's faults)
from benchmarks.reference import core, ebd, judge

NUMBERS = ("ebd_wcs_gap", "layer_gap", "mask_flips", "search_lh_gap", "search_rank_gap", "rescore_gap", "obs_flips",
           "coadd_gap", "violations", "missed", "position_gap", "observer_gap")
POSITION_COLUMNS = ("global_ra", "global_dec", "img_ra", "img_dec")
STAMP_RADIUS = 5  # planted stamps: a Gaussian of the PSF's sigma over (2 r + 1)^2 pixels
ROWS_CHUNK = 1 << 16  # listed rows whose curves the reference gathers at once


@dataclass
class Exposure:
    """One CCD of one exposure: its time and its TAN WCS (crpix 1-based,
    crval, cd) as data."""

    time: float
    ccd: int
    crpix: tuple
    crval: tuple
    cd: tuple


@dataclass
class Unit:
    """One distinct WorkUnit's host inputs."""

    exposures: list  # Exposure per constituent image
    sci: list  # (H, W) float32 CCDs
    var: list  # one shared flat plane
    psfs: list
    objects: list  # (x, y, vx, vy, flux) in the common frame


def site(traffic):
    s = traffic["field"]["site"]
    return ebd.site_vector(float(s["lat"]), float(s["lon"]), float(s["height_m"]))


def common_tan(traffic, dtype=ebd.F64, device=None):
    """The common (EBD) frame's TAN WCS of the patch: north up, east left."""
    spec, field = traffic["stack"], traffic["field"]
    step = float(field["pixel_arcsec"]) / 3600.0
    crpix = (int(spec["width"]) / 2.0 + 0.5, int(spec["height"]) / 2.0 + 0.5)
    return ebd.Tan(crpix, field["center"], ((-step, 0.0), (0.0, step)), dtype, device)


def _unit_rng(seed, index):
    return np.random.default_rng(generator.sub_seed(seed, index))


def exposures_of(traffic, seed, index):
    """The CCDs of each exposure of distinct WorkUnit ``index``, dithered by
    up to ``dither_px`` on each axis (``pointings``)."""
    times = generator.exposure_times(traffic["stack"]["times"])
    rng = _unit_rng(seed, 2 * index)
    return pointings(traffic, rng.uniform(-1.0, 1.0, size=(len(times), 2)) * float(traffic["ccd"]["dither_px"]))


def pointings(traffic, dithers):
    """The CCDs of each exposure: each exposure points at the patch's centre
    as observed from the site (the reference's inverse parallax), moved by
    its (dx, dy) dither in pixels, and gives CCD A and, where its pixels
    reach the patch, its neighbour B."""
    spec, field, ccd = traffic["stack"], traffic["field"], traffic["ccd"]
    times = generator.exposure_times(spec["times"])
    H, W = int(spec["height"]), int(spec["width"])
    ch, cw, gap = int(ccd["height"]), int(ccd["width"]), int(ccd["gap"])
    ox, oy = (float(v) for v in ccd["patch_origin"])
    step = float(field["pixel_arcsec"]) / 3600.0
    cd = ((-step, 0.0), (0.0, step))
    distance, here = float(field["distance_au"]), site(traffic)
    common = common_tan(traffic)
    corners = common.pixel_to_vec(torch.tensor([0.0, W - 1.0, 0.0, W - 1.0, (W - 1) / 2.0], dtype=ebd.F64),
                                  torch.tensor([0.0, 0.0, H - 1.0, H - 1.0, (H - 1) / 2.0], dtype=ebd.F64))
    seen = ebd.invert(corners.expand(len(times), 5, 3), torch.as_tensor(times)[:, None].expand(-1, 5), distance, here)
    ra, dec = ebd.radec(seen[:, 4])
    out = []
    for i, (t, (dx, dy)) in enumerate(zip(times, dithers)):
        # The patch's centre lies at A's pixel (ox + (W - 1) / 2 + dx, oy + (H - 1) / 2 + dy).
        crval = (float(ra[i]), float(dec[i]))
        crpix_a = (ox + (W - 1) / 2.0 + float(dx) + 1.0, oy + (H - 1) / 2.0 + float(dy) + 1.0)
        out.append(Exposure(float(t), 0, crpix_a, crval, cd))
        crpix_b = (crpix_a[0] - cw - gap, crpix_a[1])
        bx, by = ebd.Tan(crpix_b, crval, cd).vec_to_pixel(seen[i, :4])
        if float(bx.max()) > -0.5 and float(bx.min()) < cw - 0.5 and float(by.max()) > -0.5 and float(by.min()) < ch - 0.5:
            out.append(Exposure(float(t), 1, crpix_b, crval, cd))
    return out


def plant(sci, exposures, traffic, objects):
    """Add each object's flux, a Gaussian of the PSF's sigma centred where
    the object is seen, to every CCD whose pixels hold that centre."""
    spec, field = traffic["stack"], traffic["field"]
    sigmas = spec["psf_sigmas"]
    times = np.array([e.time for e in exposures])
    t0 = float(generator.exposure_times(spec["times"])[0])
    common = common_tan(traffic)
    obj = np.array([o[:4] for o in objects], dtype=np.float64)
    flux = np.array([o[4] for o in objects], dtype=np.float64)
    z = times - t0
    px = obj[:, None, 0] + obj[:, None, 2] * z[None]
    py = obj[:, None, 1] + obj[:, None, 3] * z[None]
    dirs = common.pixel_to_vec(torch.as_tensor(px), torch.as_tensor(py))
    seen = ebd.invert(dirs, torch.as_tensor(times).expand(len(objects), -1), float(field["distance_au"]), site(traffic))
    r = STAMP_RADIUS
    d = np.arange(-r, r + 1, dtype=np.float64)
    for i, e in enumerate(exposures):
        tan = ebd.Tan(e.crpix, e.crval, e.cd)
        xs, ys = (v.numpy() for v in tan.vec_to_pixel(seen[:, i]))
        img = sci[i]
        h, w = img.shape
        sigma = float(sigmas[i % len(sigmas)])
        for j in range(len(objects)):
            ix, iy = int(math.floor(xs[j] + 0.5)), int(math.floor(ys[j] + 0.5))
            if not (0 <= ix < w and 0 <= iy < h):
                continue
            gy = np.exp(-0.5 * ((iy + d - ys[j]) / sigma) ** 2)
            gx = np.exp(-0.5 * ((ix + d - xs[j]) / sigma) ** 2)
            stamp = np.outer(gy, gx)
            stamp = (flux[j] * stamp / stamp.sum()).astype(np.float32)
            y0, x0 = iy - r, ix - r
            ys0, xs0, ye, xe = max(0, y0), max(0, x0), min(h, y0 + 2 * r + 1), min(w, x0 + 2 * r + 1)
            img[ys0:ye, xs0:xe] += stamp[ys0 - y0:ye - y0, xs0 - x0:xe - x0]


def unit_objects(traffic, seed, index):
    """The objects of distinct WorkUnit ``index``."""
    spec = traffic["stack"]
    span = float(np.ptp(generator.exposure_times(spec["times"])))
    return generator.random_objects(_unit_rng(seed, 2 * index + 1), traffic["objects"]["random"], int(spec["height"]),
                                    int(spec["width"]), span)


def make_unit(traffic, seed, index, device, exposures=None):
    """Distinct WorkUnit ``index`` of a run with ``seed``: each CCD's noise
    drawn on ``device`` by a torch.Generator of its own, then brought to the
    host once; the objects planted on the host. ``exposures`` replaces the
    seed's pointings."""
    spec, ccd = traffic["stack"], traffic["ccd"]
    exposures = exposures_of(traffic, seed, index) if exposures is None else exposures
    ch, cw = int(ccd["height"]), int(ccd["width"])
    sci = []
    for i in range(len(exposures)):
        gen = torch.Generator(device=device)
        gen.manual_seed(generator.sub_seed(seed, 1_000 * (index + 1) + i))
        noise = torch.randn((ch, cw), generator=gen, device=device, dtype=torch.float32)
        noise.mul_(float(spec["noise"]))
        sci.append(noise.cpu().numpy())
        del noise
    objects = unit_objects(traffic, seed, index)
    plant(sci, exposures, traffic, objects)
    sigmas = spec["psf_sigmas"]
    psfs = [generator.gaussian_psf(float(sigmas[i % len(sigmas)])) for i in range(len(exposures))]
    var = [np.full((ch, cw), float(spec["variance"]), dtype=np.float32)] * len(exposures)
    return Unit(exposures=exposures, sci=sci, var=var, psfs=psfs, objects=objects)


def _wcs_data(wcs):
    return tuple(float(v) for v in wcs.crpix), tuple(float(v) for v in wcs.crval), tuple(map(tuple, np.asarray(wcs.cd)))


class EbdSearchCell(stack_search.StackSearchCell):
    """One cell of the reflex-corrected WorkUnit search: set-up, window and
    judgement (the stack search's, with the reprojection's stages before
    it and the positions after it)."""

    def __init__(self, cell, config, traffic, seed, device, traced=False):
        super().__init__(cell, config, traffic, seed, device, traced=traced)
        self.distance = float(traffic["field"]["distance_au"])
        self.site_m = tuple(float(v) * ebd.AU_M for v in site(traffic))
        self.units = None
        self._expected = {}
        if (int(config["patch_rows"]), int(config["patch_columns"])) != (int(traffic["stack"]["height"]),
                                                                         int(traffic["stack"]["width"])):
            raise ValueError("the traffic's patch is not the configuration's")

    # --- the program's side ---

    def common_wcs(self):
        from kbmod_tpu_torch.geom.wcs import WCS

        c = common_tan(self.traffic)
        spec = self.traffic["stack"]
        return WCS(c.crpix.tolist(), self.traffic["field"]["center"], c.cd.tolist(),
                   shape=(int(spec["height"]), int(spec["width"])))

    def run_stack(self, index):
        """One whole WorkUnit: built with its CCDs' WCSes, reprojected in the
        EBD frame, searched; returns its record (spans, the search's rows and
        timings, the layers, the EBD WCSes, the final rows and positions)."""
        from kbmod_tpu_torch import reprojection
        from kbmod_tpu_torch.core.image_stack_py import ImageStackPy
        from kbmod_tpu_torch.geom.wcs import WCS
        from kbmod_tpu_torch.run_search import SearchRunner
        from kbmod_tpu_torch.work_unit import WorkUnit

        u = index % len(self.stacks)
        data = self.stacks[u]
        record = {"stack": u}
        self.hooks.current = record
        ch, cw = data.sci[0].shape
        with self.hooks.span("stack"):
            wcses = [WCS(e.crpix, e.crval, e.cd, shape=(ch, cw)) for e in data.exposures]
            work = WorkUnit(im_stack=ImageStackPy([e.time for e in data.exposures], data.sci, data.var, psfs=data.psfs),
                            config=self.search_config(), per_image_wcs=wcses, barycentric_distance=self.distance,
                            observatory=self.site_m)
            with self.hooks.span("reproject"):
                layers = reprojection.reproject_work_unit(work, self.common_wcs(), frame="ebd", device=self.device)
            # What the reprojection left, before the search's image QA may
            # drop a layer.
            fitted = [w if w is not None else wcses[i] for i, w in enumerate(layers.org_img_meta["ebd_wcs"])]
            stack = layers.im_stack
            record["layers"] = (list(stack.sci), list(stack.var), np.asarray(stack.times), list(stack.psfs),
                                [list(g) for g in layers._per_image_indices])
            runner = SearchRunner(device=self.device)
            results = runner.run_search_from_work_unit(layers)
        self.hooks.current = None
        record["ebd_wcs"] = [_wcs_data(w) for w in fitted]
        stack = layers.im_stack
        record["searched"] = (list(stack.sci), list(stack.var), np.asarray(stack.times), list(stack.psfs))
        record["final"] = {c: np.array(results.table[c]) for c in results.colnames
                           if c in stack_search.FINAL_COLUMNS or c.startswith("coadd_")}
        record["positions"] = {c: np.array(results.table[c]) for c in results.colnames if c in POSITION_COLUMNS}
        return record

    def setup(self, warm=True):
        self.stacks = [make_unit(self.traffic, self.seed, i, self.device)
                       for i in range(int(self.traffic.get("distinct_stacks", 1)))]
        self.units = self.stacks
        env = self.config.get("environment", {})
        self._env_before = {k: os.environ.get(k) for k in env}
        os.environ.update({k: str(v) for k, v in env.items()})
        self.hooks.install()
        if warm:
            self.run_stack(0)  # the cell's own shapes: every kernel built and loaded
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def stack_summary(self):
        out = super().stack_summary()
        out["layers"] = [len(r["layers"][0]) for r in self.records]
        out["images"] = [len(r["ebd_wcs"]) for r in self.records]
        return out

    # --- the judgement ---
    # The judge reads the host arrays the window searched (``units``, kept
    # past ``release``): the program reads its inputs and writes new arrays.

    def reference_stacks(self, **precision):
        """Per distinct WorkUnit: the stack judge's reference on the program's
        layers (those of the first window record of that WorkUnit), or None
        where the window ran none."""
        refs = []
        for u, unit in enumerate(self.units):
            rec = next((r for r in self.records if r["stack"] == u), None)
            if rec is None:
                refs.append(None)
                continue
            sci, var, times, psfs = rec["searched"]
            stack = generator.Stack(times=times, sci=np.stack(sci), var=var, psfs=psfs, objects=unit.objects)
            refs.append(judge.ReferenceStack(stack, self.settings, self.grid, self.device, **precision))
        return refs

    def numbers(self, refs, lists=None, finals=None, low=False):
        """Every compared number of the window's records against ``refs``;
        with ``low`` (and the control's ``lists`` and ``finals``) the
        control's answers in the program's place at every stage. ``missed``
        counts the objects that the reference's results path finds from the
        search's listed rows (``reference_rows``) and no final row
        represents."""
        out = super().numbers(refs, lists=lists, finals=finals)
        missed = 0
        for i, rec in enumerate(self.records):
            ref = refs[rec["stack"]]
            if i not in self._expected:
                kept = reference_rows(ref, rec.get("raw"), self.settings)
                self._expected[i] = [o for o in ref.objects
                                     if judge.missed_objects(kept, [o], self.settings, ref.zeroed) == 0]
            rows = rec["final"] if finals is None else finals[i]
            missed = max(missed, judge.missed_objects(rows, self._expected[i], self.settings, ref.zeroed))
        out["missed"] = missed
        out.update(self.stage_numbers(low=low))
        return out

    def observers(self, times):
        """(program, reference) barycentric observer positions (N, 3) in AU at
        the MJDs: the program's from its own ephemeris and site, as its
        reprojection and positions take them."""
        from kbmod_tpu_torch import reprojection_utils

        times = np.asarray(times, dtype=np.float64)
        program = torch.as_tensor(reprojection_utils.observer_position_equatorial(times, self.site_m),
                                  dtype=ebd.F64, device=self.device).reshape(len(times), 3)
        return program, ebd.observer(torch.as_tensor(times), site(self.traffic)).to(self.device)

    def stage_numbers(self, low=False):
        """ebd_wcs_gap, layer_gap, mask_flips, position_gap and observer_gap
        of the window's records, the program's (or with ``low`` the
        control's). The EBD WCSes and the positions are judged given the
        program's observer, which ``observer_gap`` judges against the
        reference's."""
        out = {"ebd_wcs_gap": 0.0, "layer_gap": 0.0, "mask_flips": 0, "position_gap": 0.0, "observer_gap": 0.0}
        dev = self.device
        rng = np.random.default_rng(self.seed)
        for u in sorted({r["stack"] for r in self.records}):
            recs = [r for r in self.records if r["stack"] == u]
            unit = self.units[u]
            seen_from, truth = self.observers([e.time for e in unit.exposures])
            if low:
                got = ebd.observer(torch.as_tensor([e.time for e in unit.exposures], dtype=torch.float32),
                                   site(self.traffic).to(torch.float32), torch.float32).to(dev, ebd.F64)
            else:
                got = seen_from
            out["observer_gap"] = max(out["observer_gap"], self.observer_gap(got, truth))
            picks = [sample_layer_pixels(rec["layers"][0], int(self.traffic["check"]["layer_pixels"]), rng)
                     for rec in recs]
            per_layer = [[[] for _ in rec["layers"][0]] for rec in recs]
            for i, e in enumerate(unit.exposures):
                sci = torch.as_tensor(unit.sci[i], device=dev)
                var = torch.as_tensor(unit.var[i], device=dev)
                wx, wy = sample_ccd_pixels(sci.shape, int(self.traffic["check"]["wcs_pixels"]), rng)
                for k, rec in enumerate(recs):
                    gap = self.wcs_gap(e, rec["ebd_wcs"][i], wx, wy, seen_from[i], low)
                    out["ebd_wcs_gap"] = max(out["ebd_wcs_gap"], gap)
                    layer = next(l for l, g in enumerate(rec["layers"][4]) if i in g)
                    ys, xs = picks[k][layer]
                    per_layer[k][layer].append(self.resampled(sci, var, rec["ebd_wcs"][i], ys, xs, low))
                del sci, var
            for k, rec in enumerate(recs):
                gap, flips = self.layer_numbers(rec, picks[k], per_layer[k])
                out["layer_gap"] = max(out["layer_gap"], gap)
                out["mask_flips"] = max(out["mask_flips"], flips)
                out["position_gap"] = max(out["position_gap"], self.position_gap(rec, low))
        return out

    def observer_gap(self, got, want):
        """The largest angle, in arcsec, by which an observer at ``got`` in
        place of ``want`` turns the line of sight to a point at the assumed
        distance: |got - want| / distance."""
        return float(torch.linalg.vector_norm(got - want, dim=-1).max()) / self.distance * ebd.ARCSEC_PER_RAD

    def wcs_gap(self, exposure, fitted, xs, ys, seen_from, low):
        """The largest angle, in arcsec, between the fitted WCS's direction
        and the reference's correction of the original WCS's direction from
        the program's observer ``seen_from`` at the pixels (the control's
        correction in float32 in the fitted WCS's place)."""
        original = ebd.Tan(exposure.crpix, exposure.crval, exposure.cd, device=self.device)
        want = ebd.correct(original.pixel_to_vec(xs, ys), exposure.time, self.distance, observer_au=seen_from)
        if low:
            f32 = torch.float32
            o32 = ebd.Tan(exposure.crpix, exposure.crval, exposure.cd, f32, self.device)
            got = ebd.correct(o32.pixel_to_vec(xs, ys), exposure.time, self.distance, observer_au=seen_from.to(f32))
        else:
            got = ebd.Tan(*fitted, device=self.device).pixel_to_vec(xs, ys)
        return float(ebd.separation_arcsec(got.to(ebd.F64), want).max())

    def resampled(self, sci, var, fitted, ys, xs, low):
        """(reference (sci, var, kept), answer (sci, var, kept) or None) of one
        constituent at the picked layer pixels: the answer is the control's
        (float32 coordinates, bfloat16 planes) with ``low``."""
        common = common_tan(self.traffic, device=self.device)
        src = ebd.Tan(*fitted, device=self.device)
        sy, sx, J = ebd.source_coordinates(common, src, ys, xs)
        ref = ebd.resample(sci.to(ebd.F64), var.to(ebd.F64), sy, sx, J)
        if not low:
            return ref, None
        f32 = torch.float32
        c32 = common_tan(self.traffic, f32, self.device)
        s32 = ebd.Tan(*fitted, f32, self.device)
        sy, sx, J = ebd.source_coordinates(c32, s32, ys, xs)
        got = ebd.resample(sci.to(torch.bfloat16).to(f32), var.to(torch.bfloat16).to(f32), sy, sx, J)
        return ref, got

    def layer_numbers(self, rec, picks, parts):
        """(layer_gap, mask_flips) of one record's layers at the picked
        pixels: the program's layers (or the control's) against the
        reference's mosaic of the constituents."""
        sigma = math.sqrt(float(self.traffic["stack"]["variance"]))
        level = float(self.traffic["stack"]["variance"])
        gap, flips = 0.0, 0
        for layer, (ys, xs) in enumerate(picks):
            ref_s, ref_v, _ = ebd.mosaic([p[0] for p in parts[layer]])
            if parts[layer][0][1] is None:
                got_s = torch.as_tensor(rec["layers"][0][layer][ys, xs], device=self.device).to(ebd.F64)
                got_v = torch.as_tensor(rec["layers"][1][layer][ys, xs], device=self.device).to(ebd.F64)
            else:
                got_s, got_v, _ = ebd.mosaic([p[1] for p in parts[layer]])
                got_s, got_v = got_s.to(ebd.F64), got_v.to(ebd.F64)
            ref_m, got_m = torch.isnan(ref_s) | torch.isnan(ref_v), torch.isnan(got_s) | torch.isnan(got_v)
            flips += int((ref_m != got_m).sum())
            both = ~ref_m & ~got_m
            if both.any():
                gap = max(gap, float(((got_s - ref_s)[both].abs() / sigma).max()),
                          float(((got_v - ref_v)[both].abs() / level).max()))
        return gap, flips

    def position_gap(self, rec, low):
        """The largest angle, in arcsec, between the program's positions of
        its final rows (``global_*`` in the common frame, ``img_*`` as seen
        from the site) and the reference's, from the program's observer at
        each layer's time; the control's in float32 with ``low``. A missing
        ``img_*`` column reads as the ``global_*`` one, a missing
        ``global_*`` column as the largest gap, 180 degrees."""
        rows, pos = rec["final"], rec["positions"]
        if len(rows["x"]) == 0:
            return 0.0
        if not low and "global_ra" not in pos:
            return 648000.0
        times = rec["searched"][2]
        z = torch.as_tensor(times - times[0], dtype=ebd.F64, device=self.device)
        seen_from, _ = self.observers(times)

        def at(dtype):
            common = common_tan(self.traffic, dtype, self.device)
            col = lambda k: torch.as_tensor(np.asarray(rows[k], np.float64), device=self.device).to(dtype)[:, None]
            glob = common.pixel_to_vec(col("x") + col("vx") * z.to(dtype), col("y") + col("vy") * z.to(dtype))
            seen = ebd.invert(glob, times, self.distance, observer_au=seen_from.to(dtype).expand(glob.shape))
            return glob.to(ebd.F64), seen.to(ebd.F64)

        def vec(ra, dec):
            return ebd.unit(np.asarray(pos.get(ra, pos["global_ra"])),
                            np.asarray(pos.get(dec, pos["global_dec"]))).to(self.device)

        want_global, want_seen = at(ebd.F64)
        if low:
            got_global, got_seen = at(torch.float32)
        else:
            got_global, got_seen = vec("global_ra", "global_dec"), vec("img_ra", "img_dec")
        return max(float(ebd.separation_arcsec(got_global, want_global).max()),
                   float(ebd.separation_arcsec(got_seen, want_seen).max()))


Cell = EbdSearchCell


def reference_rows(ref, raw, settings):
    """The final rows (x, y, vx, vy, likelihood) that the results path keeps
    of the search's listed rows ``raw`` (best first), by the reference:
    the best listed row of each near-duplicate bin (start and end positions
    binned by ``near_dup_thresh``), then the reference's sigma-G over its
    own curves, ``num_obs`` and ``lh_level``, then the clustering: DBSCAN
    with min_samples 1 (the connected components of the rows within
    ``cluster_eps`` of each other in the clustering's space, ``all``/
    ``pos_vel`` only), the best row of each. None of the program's answers
    below the listed rows is used."""
    keys = ("x", "y", "vx", "vy")
    if raw is None or len(raw["x"]) == 0:
        return {k: np.zeros(0) for k in keys + ("likelihood",)}
    rows = {k: np.asarray(raw[k]) for k in keys}
    lh = np.asarray(raw["lh"], dtype=np.float64)
    thresh = settings.get("near_dup_thresh", 10)
    if thresh and thresh > 0:
        x, y = rows["x"].astype(np.float64), rows["y"].astype(np.float64)
        bins = judge._bins(x, y, rows["vx"].astype(np.float64), rows["vy"].astype(np.float64), float(thresh),
                           float(ref.zeroed[-1] - ref.zeroed[0]))
        order = np.lexsort((np.arange(len(lh)), -lh, bins[:, 3], bins[:, 2], bins[:, 1], bins[:, 0]))
        first = np.ones(len(order), dtype=bool)
        first[1:] = np.any(bins[order[1:]] != bins[order[:-1]], axis=1)
        pick = np.sort(order[first])
        rows = {k: v[pick] for k, v in rows.items()}
    keep, score = [], []
    for lo in range(0, len(rows["x"]), ROWS_CHUNK):
        part = {k: v[lo:lo + ROWS_CHUNK] for k, v in rows.items()}
        pv, fv, _ = ref.row_curves(part)
        kept = core.host_clip(pv, fv, settings)
        lh_kept, _ = judge.kept_scores(pv, fv, kept)
        ok = kept.sum(1).cpu().numpy() >= int(settings["num_obs"])
        if float(settings["lh_level"]) > 0:
            ok &= lh_kept >= float(settings["lh_level"])
        keep.append(np.flatnonzero(ok) + lo)
        score.append(lh_kept[ok])
    pick = np.concatenate(keep)
    rows = {k: v[pick] for k, v in rows.items()}
    rows["likelihood"] = np.concatenate(score)
    if not settings.get("do_clustering", True) or len(pick) < 2:
        return rows
    if settings.get("cluster_type", "all") not in ("all", "pos_vel"):
        raise ValueError("reference_rows clusters in the position and velocity space only")
    labels = components(judge.cluster_points(rows, settings, ref.zeroed), float(settings.get("cluster_eps", 20.0)),
                        ref.device)
    best = np.lexsort((np.arange(len(labels)), -rows["likelihood"], labels))
    first = np.ones(len(best), dtype=bool)
    first[1:] = labels[best[1:]] != labels[best[:-1]]
    return {k: v[best[first]] for k, v in rows.items()}


def components(points, eps, device):
    """Labels of the connected components of the (N, D) float64 points
    joined where they lie within ``eps`` of each other (Euclidean): each
    point's label is the smallest index in its component."""
    p = torch.as_tensor(points, dtype=ebd.F64, device=device)
    n = len(p)
    chunk = max(256, (1 << 27) // max(n, 1))  # a chunk's distances in 1 GiB
    labels = torch.arange(n, device=device)
    while True:
        low = labels.clone()
        for lo in range(0, n, chunk):
            near = torch.cdist(p[lo:lo + chunk], p, compute_mode="donot_use_mm_for_euclid_dist") <= eps
            low[lo:lo + chunk] = torch.where(near, labels[None, :], n).amin(1)
        low = low.scatter_reduce(0, labels, low.clone(), reduce="amin")  # a label's point takes its members' least
        while True:
            hop = low[low]
            if torch.equal(hop, low):
                break
            low = hop
        if torch.equal(low, labels):
            return labels.cpu().numpy()
        labels = low


def sample_layer_pixels(layers, n, rng):
    """Per layer, (ys, xs) int64 of ``n`` pixels: half drawn uniformly, half
    among the pixels on the edges of the layer's mask (masked, with an
    unmasked neighbour, or the other way round), uniformly where it has no
    edges."""
    out = []
    for sci in layers:
        h, w = sci.shape
        masked = np.isnan(sci)
        edge = np.zeros_like(masked)
        edge[:, 1:] |= masked[:, 1:] != masked[:, :-1]
        edge[:, :-1] |= masked[:, 1:] != masked[:, :-1]
        edge[1:] |= masked[1:] != masked[:-1]
        edge[:-1] |= masked[1:] != masked[:-1]
        flat = rng.integers(h * w, size=n - n // 2)
        where = np.flatnonzero(edge)
        extra = where[rng.integers(len(where), size=n // 2)] if len(where) else rng.integers(h * w, size=n // 2)
        idx = np.unique(np.concatenate([flat, extra]))
        out.append((idx // w, idx % w))
    return out


def sample_ccd_pixels(shape, n, rng):
    """(xs, ys) float64 of ``n`` pixel centres drawn uniformly on a CCD,
    with its four corners."""
    h, w = shape
    xs = np.concatenate([[0.0, w - 1.0, 0.0, w - 1.0], rng.integers(w, size=n).astype(np.float64)])
    ys = np.concatenate([[0.0, 0.0, h - 1.0, h - 1.0], rng.integers(h, size=n).astype(np.float64)])
    return xs, ys


# --- the control ---


def control_readings(run, seconds=0.0):
    """(program numbers, control numbers) of one seed's run."""
    run.setup(warm=False)
    run.window(seconds)
    run.release()
    refs = run.reference_stacks()
    lists = run.search_answers()
    program = run.numbers(refs, lists=lists)
    lows = run.reference_stacks(**stack_search.control_precision(run.settings))
    k = int(run.settings.get("results_per_pixel", 8))
    control = run.numbers(refs, lists=stack_search.control_lists(run, lows, list(lists), k),
                          finals=stack_search.control_finals(run, lows), low=True)
    return program, control
