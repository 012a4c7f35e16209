"""RegionSearch: survey-scale pre-search patch organization.

Copy of the JAX package's region_search.py (host numpy), but that
``match_ic_to_patches`` clips only the chips whose bounding box reaches a
patch (the same matches, so that a whole-sky grid of small patches stays
quick).
Behavior-compatible with the reference's kbmod.region_search
(src/kbmod/region_search.py): divide the survey footprint into an
RA/Dec-aligned (optionally overlapping) grid of patches, match chip
footprints (with reflex correction at guess distances) against patches and
ephemerides, and export per-patch ImageCollections for independent
searches. Polygon overlap uses an internal Sutherland-Hodgman clipper
instead of shapely.
"""

import logging

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["RegionSearch", "Patch", "Ephems", "patch_arcmin_to_pixels"]


def patch_arcmin_to_pixels(patch_size, pixel_scale):
    """Patch side length (arcmin) -> pixels for a pixel scale in
    arcsec/pixel."""
    return int(np.ceil(patch_size * 60.0 / pixel_scale))


# ----------------------------------------------------------------------
# Minimal polygon math (replaces shapely)
# ----------------------------------------------------------------------

def polygon_area(poly):
    """Signed shoelace area of an (N, 2) polygon."""
    poly = np.asarray(poly, dtype=float)
    x = poly[:, 0]
    y = poly[:, 1]
    return 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)


def clip_polygon(subject, clip_rect):
    """Clip a polygon against an axis-aligned rectangle
    (xmin, ymin, xmax, ymax) via Sutherland-Hodgman."""
    xmin, ymin, xmax, ymax = clip_rect

    def clip_edge(pts, inside, intersect):
        out = []
        n = len(pts)
        for i in range(n):
            cur = pts[i]
            prev = pts[i - 1]
            cur_in = inside(cur)
            prev_in = inside(prev)
            if cur_in:
                if not prev_in:
                    out.append(intersect(prev, cur))
                out.append(cur)
            elif prev_in:
                out.append(intersect(prev, cur))
        return out

    def x_intersect(p, q, x_val):
        t = (x_val - p[0]) / (q[0] - p[0])
        return (x_val, p[1] + t * (q[1] - p[1]))

    def y_intersect(p, q, y_val):
        t = (y_val - p[1]) / (q[1] - p[1])
        return (p[0] + t * (q[0] - p[0]), y_val)

    pts = [tuple(p) for p in np.asarray(subject, dtype=float)]
    for inside, intersect in [
        (lambda p: p[0] >= xmin, lambda p, q: x_intersect(p, q, xmin)),
        (lambda p: p[0] <= xmax, lambda p, q: x_intersect(p, q, xmax)),
        (lambda p: p[1] >= ymin, lambda p, q: y_intersect(p, q, ymin)),
        (lambda p: p[1] <= ymax, lambda p, q: y_intersect(p, q, ymax)),
    ]:
        if not pts:
            return []
        pts = clip_edge(pts, inside, intersect)
    return pts


class Patch:
    """An RA/Dec-aligned rectangular patch of sky.

    Attributes: center (ra, dec) in degrees; width/height in degrees;
    pixel dimensions derived from the pixel scale.
    """

    def __init__(self, center_ra, center_dec, width, height, pixel_scale, patch_id=None, dec_dim=None, ra_dim=None):
        self.ra = center_ra
        self.dec = center_dec
        self.width = width
        self.height = height
        self.pixel_scale = pixel_scale
        self.id = patch_id
        self.ra_dim = ra_dim
        self.dec_dim = dec_dim
        self.ra_bounds = (center_ra - width / 2.0, center_ra + width / 2.0)
        self.dec_bounds = (center_dec - height / 2.0, center_dec + height / 2.0)
        self.width_px = int(np.ceil(width * 3600.0 / pixel_scale))
        self.height_px = int(np.ceil(height * 3600.0 / pixel_scale))

    def __str__(self):
        return f"Patch {self.id}: ra={self.ra}, dec={self.dec}, width={self.width}, height={self.height}"

    __repr__ = __str__

    def to_wcs(self):
        """A TAN WCS covering the patch at the patch pixel scale."""
        from kbmod_tpu_torch.wcs_utils import make_fake_wcs

        return make_fake_wcs(self.ra, self.dec, self.height_px, self.width_px, self.pixel_scale / 3600.0)

    def contains(self, ra, dec):
        """Whether (ra, dec) [deg] lies inside the patch."""
        return (
            self.ra_bounds[0] <= ra <= self.ra_bounds[1]
            and self.dec_bounds[0] <= dec <= self.dec_bounds[1]
        )

    def measure_overlap(self, poly):
        """Overlap area (deg^2) of an (N, 2) ra/dec polygon with this
        patch."""
        clipped = clip_polygon(poly, (self.ra_bounds[0], self.dec_bounds[0], self.ra_bounds[1], self.dec_bounds[1]))
        if len(clipped) < 3:
            return 0.0
        return abs(polygon_area(np.asarray(clipped)))

    def overlaps_polygon(self, poly):
        return self.measure_overlap(poly) > 0.0

    def patch_radius(self):
        """The circumscribing radius (deg)."""
        return 0.5 * np.hypot(self.width, self.height)


class Ephems:
    """Reflex-correctable ephemeris storage."""

    def __init__(self, ephems_table, ra_col, dec_col, mjd_col, guess_dists=(), earth_loc=None):
        self.ephems_data = ephems_table
        self.ra_col = ra_col
        self.dec_col = dec_col
        self.mjd_col = mjd_col
        self.guess_dists = list(guess_dists)
        self.earth_loc = earth_loc

        from kbmod_tpu_torch.reprojection_utils import correct_parallax_geometrically_vectorized

        for dist in self.guess_dists:
            corrected, _ = correct_parallax_geometrically_vectorized(
                np.asarray(self.ephems_data[ra_col], dtype=float),
                np.asarray(self.ephems_data[dec_col], dtype=float),
                np.asarray(self.ephems_data[mjd_col], dtype=float),
                dist,
            )
            self.ephems_data[self._reflex_corrected_col(ra_col, dist)] = corrected.ra_deg
            self.ephems_data[self._reflex_corrected_col(dec_col, dist)] = corrected.dec_deg

    def _reflex_corrected_col(self, col_name, guess_dist):
        return f"{col_name}_{guess_dist}"

    def get_mjds(self):
        return np.asarray(self.ephems_data[self.mjd_col], dtype=float)

    def get_ras(self, guess_dist=None):
        if guess_dist is None or guess_dist == 0.0:
            return np.asarray(self.ephems_data[self.ra_col], dtype=float)
        return np.asarray(self.ephems_data[self._reflex_corrected_col(self.ra_col, guess_dist)], dtype=float)

    def get_decs(self, guess_dist=None):
        if guess_dist is None or guess_dist == 0.0:
            return np.asarray(self.ephems_data[self.dec_col], dtype=float)
        return np.asarray(self.ephems_data[self._reflex_corrected_col(self.dec_col, guess_dist)], dtype=float)


class RegionSearch:
    """Organize an ImageCollection into patches and match data to them."""

    def __init__(self, ic, guess_dists=(), earth_loc=None, enforce_unique_visit_detector=True):
        self.ic = ic
        self.guess_dists = list(guess_dists)
        self.earth_loc = earth_loc
        self.patches = None

        # Reflex-correct the collection's pointings at each guess distance.
        for dist in self.guess_dists:
            if f"ra_{dist}" not in self.ic.columns:
                self.ic.reflex_correct(dist, earth_loc)

    # --- collection filtering passthroughs ---

    def filter_by_time_range(self, start_mjd, end_mjd):
        self.ic.filter_by_time_range(start_mjd, end_mjd)

    def filter_by_mjds(self, mjds, time_sep_s=0.001):
        self.ic.filter_by_mjds(mjds, time_sep_s=time_sep_s)

    # --- patch grid ---

    def generate_patches(
        self,
        arcminutes,
        overlap_percentage=0.0,
        image_width=None,
        image_height=None,
        pixel_scale=None,
        dec_range=(-90.0, 90.0),
        ra_range=(0.0, 360.0),
    ):
        """Create the (overlapping) patch grid covering the given ranges."""
        if pixel_scale is None:
            raise ValueError("A pixel_scale must be provided to generate patches.")
        size_deg = arcminutes / 60.0
        step = size_deg * (1.0 - overlap_percentage / 100.0)
        if step <= 0:
            raise ValueError("Overlap percentage must be < 100.")

        ras = np.arange(ra_range[0] + size_deg / 2.0, ra_range[1], step)
        decs = np.arange(dec_range[0] + size_deg / 2.0, dec_range[1], step)
        self.patches = []
        pid = 0
        for dec_i, dec in enumerate(decs):
            for ra_i, ra in enumerate(ras):
                self.patches.append(
                    Patch(ra, dec, size_deg, size_deg, pixel_scale, patch_id=pid, ra_dim=ra_i, dec_dim=dec_i)
                )
                pid += 1
        logger.info(f"Generated {len(self.patches)} patches.")
        return self.patches

    def get_patches(self):
        if self.patches is None:
            raise ValueError("No patches generated. Call generate_patches first.")
        return self.patches

    def get_patch(self, patch_id):
        return self.get_patches()[patch_id]

    # --- matching ---

    def _chip_polygons(self, guess_dist=None):
        """(N, 4, 2) corner polygons for each collection row, using the
        bbox corner columns (reflex-corrected when available)."""
        suffix = f"_{guess_dist}" if guess_dist else ""
        corner_cols = [
            (f"ra_tl{suffix}", f"dec_tl{suffix}"),
            (f"ra_tr{suffix}", f"dec_tr{suffix}"),
            (f"ra_br{suffix}", f"dec_br{suffix}"),
            (f"ra_bl{suffix}", f"dec_bl{suffix}"),
        ]
        have_corners = all(rc in self.ic.columns and dc in self.ic.columns for rc, dc in corner_cols)
        n = len(self.ic)
        polys = np.zeros((n, 4, 2))
        if have_corners:
            for c, (rc, dc) in enumerate(corner_cols):
                polys[:, c, 0] = np.asarray(self.ic[rc], dtype=float)
                polys[:, c, 1] = np.asarray(self.ic[dc], dtype=float)
        else:
            # Approximate the chip as a point footprint at its pointing.
            ra = np.asarray(self.ic[f"ra{suffix}"] if f"ra{suffix}" in self.ic.columns else self.ic["ra"], dtype=float)
            dec = np.asarray(self.ic[f"dec{suffix}"] if f"dec{suffix}" in self.ic.columns else self.ic["dec"], dtype=float)
            eps = 1e-6
            for c, (dx, dy) in enumerate([(-eps, -eps), (eps, -eps), (eps, eps), (-eps, eps)]):
                polys[:, c, 0] = ra + dx
                polys[:, c, 1] = dec + dy
        return polys

    def match_ic_to_patches(self, ic=None, guess_dist=None, earth_loc=None, min_overlap=0.0):
        """For each patch, the row indices of chips overlapping it.

        Returns a dict patch_id -> list of row indices."""
        polys = self._chip_polygons(guess_dist)
        lo, hi = polys.min(axis=1), polys.max(axis=1)
        matches = {}
        for patch in self.get_patches():
            # A chip whose bounding box lies wholly outside the patch clips to
            # nothing, an overlap of 0.0: only the others are clipped, so the
            # matches are those of clipping every chip against every patch.
            near = (hi[:, 0] >= patch.ra_bounds[0]) & (lo[:, 0] <= patch.ra_bounds[1]) \
                & (hi[:, 1] >= patch.dec_bounds[0]) & (lo[:, 1] <= patch.dec_bounds[1])
            rows = np.nonzero(near)[0] if min_overlap >= 0.0 else range(len(polys))
            hits = [int(i) for i in rows if (patch.measure_overlap(polys[i]) if near[i] else 0.0) > min_overlap]
            if hits:
                matches[patch.id] = hits
        return matches

    def search_patches_by_ephems(self, ephems, guess_dist=None):
        """Patch ids containing any (reflex-corrected) ephemeris point."""
        ras = ephems.get_ras(guess_dist)
        decs = ephems.get_decs(guess_dist)
        found = set()
        for patch in self.get_patches():
            for ra, dec in zip(ras, decs):
                if patch.contains(ra, dec):
                    found.add(patch.id)
                    break
        return sorted(found)

    def get_image_collection_from_patch(self, patch, guess_dist=0.0, min_overlap=0.0, max_images=None):
        """The sub-collection of chips overlapping a patch."""
        if isinstance(patch, (int, np.integer)):
            patch = self.get_patch(int(patch))
        polys = self._chip_polygons(guess_dist if guess_dist else None)
        overlaps = np.array([patch.measure_overlap(p) for p in polys])
        hits = np.nonzero(overlaps > min_overlap)[0]
        if max_images is not None:
            hits = hits[:max_images]
        sub = self.ic[np.asarray(hits, dtype=int)]
        # Per-chip overlap area with the patch (deg^2) — the reference's
        # per-patch analysis sums this column (region_searcher.py:183-222).
        sub.data["overlap_deg"] = overlaps[hits]
        sub.reset_lazy_loading_indices()
        return sub

    def export_image_collection(self, ic_to_export=None, guess_dist=None, patch=None, in_place=False):
        """Annotate a (sub-)collection with the patch/guess-distance
        provenance for a per-patch search run."""
        ic = ic_to_export if ic_to_export is not None else self.ic
        if not in_place:
            ic = ic.copy()
        if patch is not None:
            if isinstance(patch, (int, np.integer)):
                patch = self.get_patch(int(patch))
            ic.data.meta["patch_id"] = patch.id
            ic.data.meta["patch_center"] = [patch.ra, patch.dec]
            ic.data.meta["patch_size_deg"] = [patch.width, patch.height]
            ic.data.meta["patch_pixel_scale"] = patch.pixel_scale
        if guess_dist is not None:
            ic.data.meta["guess_dist"] = guess_dist
        return ic
