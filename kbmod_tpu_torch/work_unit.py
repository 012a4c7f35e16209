"""WorkUnit: the standardized container for a single KBMOD run.

A copy of the JAX package's work_unit.py, API-compatible with the
reference's kbmod.work_unit (src/kbmod/work_unit.py): an ImageStackPy +
SearchConfiguration + global/per-image WCS + constituent image metadata +
reprojection state (frame, barycentric distance, per-image mosaicking
indices) + observatory location, with single-file and sharded FITS
persistence (kbmod_tpu_torch.io.fits_io) and lazy loading of sharded data.
The files it writes are byte-equal to the JAX package's, and each package
reads the other's. Host numpy only.
"""

import logging
import os
from pathlib import Path

import numpy as np

from kbmod_tpu_torch.configuration import SearchConfiguration
from kbmod_tpu_torch.core.image_stack_py import ImageStackPy, LayeredImagePy
from kbmod_tpu_torch.io import fits_io
from kbmod_tpu_torch.table import Table
from kbmod_tpu_torch.geom.wcs import WCS as WCS_TYPE
from kbmod_tpu_torch.wcs_utils import (
    calc_ecliptic_angle,
    serialize_wcs,
    deserialize_wcs,
)

logger = logging.getLogger(__name__)

# Rubin Observatory (Cerro Pachon) geocentric coordinates in meters — the
# reference's default observatory (work_unit.py:171-181).
RUBIN_LOCATION_M = (1814303.74553723, -5214365.7436216, -3187340.56598756)


def create_image_metadata(n_images, data=None):
    """Create the constituent-image metadata table with the standard
    columns (data_loc, ebd_wcs, geocentric_distance, per_image_wcs,
    mjd_mid, obs_lon/lat/alt, filter, visit, dataId)."""
    if n_images <= 0:
        raise ValueError("Invalid number of images.")
    defaults = {
        "data_loc": np.full(n_images, None, dtype=object),
        "ebd_wcs": np.full(n_images, None, dtype=object),
        "geocentric_distance": np.full(n_images, None, dtype=object),
        "per_image_wcs": np.full(n_images, None, dtype=object),
    }
    table = Table(defaults)
    if data is not None:
        if isinstance(data, dict):
            data = Table(data)
        if len(data) != n_images:
            raise ValueError(f"Metadata table has {len(data)} rows; expected {n_images}.")
        for col in data.colnames:
            table[col] = data[col]
    return table


class WorkUnit:
    """The work unit: images + configuration + geometry + provenance.

    Parameters mirror the reference (work_unit.py:116-198).
    """

    def __init__(
        self,
        im_stack=None,
        config=None,
        wcs=None,
        per_image_wcs=None,
        reprojected=False,
        reprojection_frame=None,
        per_image_indices=None,
        obstimes=None,
        barycentric_distance=None,
        lazy=False,
        file_paths=None,
        org_image_meta=None,
        observatory=None,
    ):
        self.im_stack = im_stack if im_stack is not None else ImageStackPy()
        self.config = config if config is not None else SearchConfiguration()
        self.lazy = lazy
        self.file_paths = file_paths
        self._obstimes = obstimes

        # Number of constituent (original, pre-mosaic) images.
        if org_image_meta is not None:
            self.n_constituents = len(org_image_meta)
        elif per_image_wcs is not None:
            self.n_constituents = len(per_image_wcs)
        else:
            self.n_constituents = self.im_stack.num_times

        self.org_img_meta = create_image_metadata(max(self.n_constituents, 1), data=org_image_meta)
        if per_image_wcs is not None:
            self.org_img_meta["per_image_wcs"] = np.array(list(per_image_wcs), dtype=object)

        self.wcs = wcs
        self.reprojected = reprojected
        self.reprojection_frame = reprojection_frame
        self.barycentric_distance = barycentric_distance
        self.observatory = observatory if observatory is not None else RUBIN_LOCATION_M

        if per_image_indices is None:
            # One constituent image per stack layer unless mosaicked.
            self._per_image_indices = [[i] for i in range(self.n_constituents)]
        else:
            self._per_image_indices = per_image_indices

    def __len__(self):
        return self.im_stack.num_times

    def get_num_images(self):
        return self.im_stack.num_times

    @property
    def per_image_wcs(self):
        return list(self.org_img_meta["per_image_wcs"])

    def print_stats(self):
        print(f"WorkUnit: {self.im_stack.num_times} images, {self.n_constituents} constituents.")
        print(f"  Reprojected: {self.reprojected} (frame={self.reprojection_frame})")
        self.im_stack.print_stats()

    def get_constituent_meta(self, columns):
        """Dict of requested constituent-metadata columns (those present)."""
        if isinstance(columns, str):
            columns = [columns]
        result = {}
        for col in columns:
            if col in self.org_img_meta.colnames:
                result[col] = list(self.org_img_meta[col])
        return result

    def get_wcs(self, img_num):
        """The WCS for one image: the common WCS if set, else per-image."""
        if self.wcs is not None:
            return self.wcs
        per_img = self.org_img_meta["per_image_wcs"][img_num]
        return per_img

    def compute_ecliptic_angle(self):
        """The ecliptic angle (radians in pixel space) from the WCS."""
        wcs = self.get_wcs(0)
        if wcs is None:
            logger.warning("A valid wcs is required to compute the ecliptic angle. Using 0.0.")
            return 0.0
        center = (self.im_stack.width / 2, self.im_stack.height / 2)
        return calc_ecliptic_angle(wcs, center_pixel=center)

    def get_all_obstimes(self):
        """The constituent observation times."""
        if self._obstimes is not None:
            return self._obstimes
        self._obstimes = np.copy(self.im_stack.times)
        return self._obstimes

    def get_unique_obstimes_and_indices(self):
        from kbmod_tpu_torch.util_functions import unique_obstimes_and_indices

        return unique_obstimes_and_indices(self.get_all_obstimes())

    def disorder_obstimes(self):
        """Randomly re-offset every unique obstime (sampled without
        replacement so uniqueness/sharing structure is preserved), then
        re-sort the stack by the new times (work_unit.py:437-482). Used to
        build unlikely-signal data for tests and ML training."""
        obstimes = self.get_all_obstimes()
        unique_obstimes = np.unique(obstimes)
        if len(unique_obstimes) == 0:
            raise ValueError("No obstimes provided for WorkUnit.")

        max_offset = max(
            int(np.max(unique_obstimes) - np.min(unique_obstimes) + 1),
            self.im_stack.num_times,
        )
        random_offsets = np.random.choice(
            np.arange(0, max_offset), len(unique_obstimes), replace=False
        )
        mapping = {t: t + random_offsets[i] for i, t in enumerate(unique_obstimes)}
        self.im_stack.times = np.asanyarray([mapping[t] for t in obstimes], dtype=float)
        self.im_stack.zeroed_times = self.im_stack.times - self.im_stack.times[0]
        self._obstimes = None

        order = self.im_stack.sort_by_time()
        self._per_image_indices = [self._per_image_indices[i] for i in order]
        if len(self.org_img_meta) == len(order):
            self.org_img_meta = self.org_img_meta[list(order)]

    def get_pixel_coordinates(self, ra, dec, times=None):
        """Pixel (x, y) for sky positions, per matching time. ra/dec in
        degrees; times (MJD) select which image's WCS to use."""
        ra = np.atleast_1d(np.asarray(ra, dtype=float))
        dec = np.atleast_1d(np.asarray(dec, dtype=float))
        if times is None:
            inds = np.arange(len(ra)) % max(self.im_stack.num_times, 1)
        else:
            obstimes = np.asarray(self.get_all_obstimes())
            from kbmod_tpu_torch.util_functions import get_matched_obstimes

            inds = get_matched_obstimes(obstimes, times)
            if np.any(inds < 0):
                raise ValueError("One or more times could not be matched to an image.")
        x = np.zeros(len(ra))
        y = np.zeros(len(ra))
        for i, (r, d, idx) in enumerate(zip(ra, dec, inds)):
            wcs = self.get_wcs(int(idx))
            if wcs is None:
                raise ValueError(f"No WCS for image {idx}.")
            x[i], y[i] = wcs.world_to_pixel_values(r, d)
        return x, y

    def filter_images(self, mask):
        """Keep only images where mask is True, maintaining metadata."""
        mask = np.asarray(mask, dtype=bool)
        self.im_stack.filter_images(mask)
        if self.file_paths is not None:
            self.file_paths = [v for i, v in enumerate(self.file_paths) if mask[i]]
        if self._obstimes is not None:
            self._obstimes = [v for i, v in enumerate(self._obstimes) if mask[i]]
        keep_constituents = sorted({c for i, group in enumerate(self._per_image_indices) if mask[i] for c in group})
        remap = {old: new for new, old in enumerate(keep_constituents)}
        con_mask = np.zeros(self.n_constituents, dtype=bool)
        con_mask[keep_constituents] = True
        self.org_img_meta = self.org_img_meta[con_mask]
        self.n_constituents = len(keep_constituents)
        self._per_image_indices = [
            [remap[c] for c in group] for i, group in enumerate(self._per_image_indices) if mask[i]
        ]

    def apply_color_scale(self, color_scale=None):
        """Scale images by per-filter magnitude corrections
        (work_unit.py:401-435): each image's filter (from the constituent
        metadata) must have an entry in ``color_scale``; the applied
        magnitudes are also recorded in a per-constituent ``color_scale``
        column."""
        if color_scale is None:
            color_scale = self.config["color_scale"]
        if color_scale is None:
            return
        if np.isscalar(color_scale):
            self.im_stack.scale_images(color_scale, is_magnitude=True)
            return
        if "filter" not in self.org_img_meta.colnames:
            raise ValueError("No filter information in WorkUnit to apply color scaling.")
        filters = np.asarray(self.org_img_meta["filter"])

        num_img = len(self.im_stack)
        scales = np.zeros(num_img)
        for i in range(num_img):
            const_filters = filters[np.asarray(self._per_image_indices[i])]
            if len(np.unique(const_filters)) != 1:
                raise ValueError(
                    f"More than one filter found for image {i}: {const_filters}."
                )
            if const_filters[0] not in color_scale:
                raise ValueError(f"Color scale missing entry for filter {const_filters[0]}.")
            scales[i] = color_scale[const_filters[0]]
        self.im_stack.scale_images(scales, is_magnitude=True)
        self.org_img_meta["color_scale"] = np.array([color_scale[f] for f in filters])

    # Alias matching the name used by SearchRunner in the reference.
    def apply_color_scaling(self, color_scale=None):
        self.apply_color_scale(color_scale)

    def image_positions_to_original_icrs(
        self, image_indices, positions, input_format="xy", output_format="xy", filter_in_frame=True
    ):
        """Map positions in the common (possibly EBD) frame back to the
        original per-image frames (work_unit.py:938-996 behavior, using the
        internal parallax inversion)."""
        from kbmod_tpu_torch.reprojection_utils import invert_correct_parallax_vectorized
        from kbmod_tpu_torch.geom.wcs import SkyCoordLite

        if input_format not in ("xy", "radec"):
            raise ValueError(f"Input format {input_format} not supported.")
        if output_format not in ("xy", "radec"):
            raise ValueError(f"Output format {output_format} not supported.")
        obstimes = np.asarray(self.get_all_obstimes())
        results = []
        for idx, pos in zip(np.atleast_1d(image_indices), positions):
            if input_format == "xy":
                ra, dec = self.wcs.pixel_to_world_values(pos[0], pos[1])
            else:
                ra, dec = pos
            if self.reprojected and self.reprojection_frame == "ebd":
                coords = SkyCoordLite(np.atleast_1d(ra), np.atleast_1d(dec))
                coords.distance_au = np.atleast_1d(self.barycentric_distance)
                inv = invert_correct_parallax_vectorized(
                    coords, obstimes=[obstimes[idx]], point_on_earth=self.observatory
                )
                ra, dec = float(inv.ra_deg[0]), float(inv.dec_deg[0])
            if output_format == "radec":
                results.append((ra, dec))
            else:
                wcs = self.org_img_meta["per_image_wcs"][idx] or self.wcs
                x, y = wcs.world_to_pixel_values(ra, dec)
                results.append((float(x), float(y)))
        return results

    # ------------------------------------------------------------------
    # Serialization
    # ------------------------------------------------------------------

    def _meta_header(self):
        hdu = fits_io.ImageHDU(name="METADATA")
        hdu.header["NUMIMG"] = int(self.im_stack.num_times)
        hdu.header["NCON"] = int(self.n_constituents)
        hdu.header["REPROJ"] = bool(self.reprojected)
        hdu.header["REPFRAME"] = self.reprojection_frame if self.reprojection_frame else ""
        hdu.header["BARY"] = float(self.barycentric_distance) if self.barycentric_distance is not None else -1.0
        hdu.header["OBSX"] = float(self.observatory[0])
        hdu.header["OBSY"] = float(self.observatory[1])
        hdu.header["OBSZ"] = float(self.observatory[2])
        hdu.set_long_string("GWCS", serialize_wcs(self.wcs))
        return hdu

    def metadata_to_hdul(self):
        """Build the metadata HDUs: PRIMARY, METADATA header, config,
        constituent metadata table, and per-image index groups."""
        hdus = fits_io.HDUList()
        hdus.append(fits_io.ImageHDU(name="PRIMARY"))
        hdus.append(self._meta_header())

        cfg_hdu = fits_io.ImageHDU(name="KBMOD_CONFIG")
        cfg_hdu.set_long_string("YAMLCFG", self.config.to_yaml())
        hdus.append(cfg_hdu)

        # Constituent metadata with serialized WCS columns.
        meta = self.org_img_meta.copy()
        for col in ("per_image_wcs", "ebd_wcs"):
            if col in meta.colnames:
                meta[col] = np.array([serialize_wcs(w) if w is not None else "" for w in meta[col]], dtype=object)
        hdus.append(fits_io.TableHDU(meta, name="IMG_META"))

        idx_table = Table({"groups": np.array([list(map(int, g)) for g in self._per_image_indices], dtype=object)})
        hdus.append(fits_io.TableHDU(idx_table, name="IMG_IDX"))

        times_table = Table({"obstimes": np.asarray(self.get_all_obstimes(), dtype=float)})
        hdus.append(fits_io.TableHDU(times_table, name="OBSTIMES"))
        return hdus

    def _image_hdus(self, idx):
        stack = self.im_stack
        sci = fits_io.ImageHDU(stack.sci[idx].astype(np.float32), name=f"SCI_{idx}")
        sci.header["MJD"] = float(stack.times[idx])
        var = fits_io.ImageHDU(stack.var[idx].astype(np.float32), name=f"VAR_{idx}")
        psf = fits_io.ImageHDU(np.asarray(stack.psfs[idx], dtype=np.float32), name=f"PSF_{idx}")
        return [sci, var, psf]

    # --- reference (astropy/CFITSIO) single-file layout -----------------

    def _reference_metadata_hdul(self):
        """PRIMARY + KBMOD_CONFIG + IMG_META in the reference's layout
        (work_unit.py:899-936)."""
        from kbmod_tpu_torch.geom.geodesy import geocentric_to_geodetic
        from kbmod_tpu_torch.io.fits_io import BinTableHDU

        hdus = fits_io.HDUList()
        pri = fits_io.ImageHDU(name="PRIMARY")
        pri.header["NUMIMG"] = int(self.im_stack.num_times)
        pri.header["NCON"] = int(self.n_constituents)
        pri.header["REPRJCTD"] = bool(self.reprojected)
        pri.header["REPFRAME"] = self.reprojection_frame if self.reprojection_frame else ""
        pri.header["BARY"] = (
            float(self.barycentric_distance) if self.barycentric_distance is not None else -1.0
        )
        lat, lon, elev = geocentric_to_geodetic(*self.observatory)
        pri.header["OBS_LAT"] = lat
        pri.header["OBS_LON"] = lon
        pri.header["OBS_ELEV"] = elev
        # Exact geocentric coordinates as extra cards (the geodetic
        # inversion is only defined for near-surface points; the upstream
        # reader ignores these).
        pri.header["OBSX"] = float(self.observatory[0])
        pri.header["OBSY"] = float(self.observatory[1])
        pri.header["OBSZ"] = float(self.observatory[2])
        if self.wcs is not None:
            wcs_cards = self.wcs.to_header()
            # A dataless primary header cannot carry NAXIS1/2; the
            # reference smuggles the shape through DIMM1/DIMM2
            # (wcs_utils.py:99-121).
            n1 = wcs_cards.pop("NAXIS1", None)
            n2 = wcs_cards.pop("NAXIS2", None)
            if n1 is not None:
                pri.header["DIMM1"] = n1
                pri.header["DIMM2"] = n2
            pri.header.update(wcs_cards)
        hdus.append(pri)

        hdus.append(self.config.to_reference_hdu())

        # IMG_META: string columns, WCS under _WCSSTR_ (reference
        # work_unit.py:1242-1283).
        cols = {}
        meta = self.org_img_meta
        for name in meta.colnames:
            vals = list(meta[name])
            if all(v is None for v in vals):
                continue
            if any(isinstance(v, WCS_TYPE) for v in vals if v is not None):
                cols[f"_WCSSTR_{name}"] = [serialize_wcs(v) if v is not None else "" for v in vals]
            else:
                cols[name] = [str(v) for v in vals]
        if not cols:
            cols = {"data_loc": [""] * max(self.n_constituents, 1)}
        hdus.append(BinTableHDU(columns=cols, name="IMG_META"))
        return hdus

    def _reference_image_hdus(self, idx, compression_type, quantize_level):
        """SCI/VAR (tile-compressed) + MSK/PSF HDUs for one image
        (reference add_image_data_to_hdul, work_unit.py:1062-1147)."""
        from kbmod_tpu_torch.io.fits_io import make_comp_image_hdu

        stack = self.im_stack
        sci = np.asanyarray(stack.sci[idx], dtype=np.float32)
        var = np.asanyarray(stack.var[idx], dtype=np.float32)
        obstime = float(stack.times[idx])

        wcs_cards = {}
        wcs = self.get_wcs(idx)
        if wcs is not None:
            wcs_cards = {k: v for k, v in wcs.to_header().items() if not k.startswith("NAXIS")}

        extra = dict(MJD=obstime, **wcs_cards)
        sci_hdu = make_comp_image_hdu(
            sci, name=f"SCI_{idx}", compression_type=compression_type,
            quantize_level=quantize_level, header_extra=extra,
        )
        c_indices = self._per_image_indices[idx]
        sci_hdu.header["NIND"] = len(c_indices)
        for j, ci in enumerate(c_indices):
            sci_hdu.header[f"IND_{j}"] = int(ci)
        var_hdu = make_comp_image_hdu(
            var, name=f"VAR_{idx}", compression_type=compression_type,
            quantize_level=quantize_level, header_extra=extra,
        )
        mask_full = (np.asanyarray(stack.get_mask(idx)) > 0) | ~np.isfinite(sci) | ~np.isfinite(var)
        msk_hdu = fits_io.ImageHDU(mask_full.astype(np.uint8), name=f"MSK_{idx}")
        msk_hdu.header["MJD"] = obstime
        msk_hdu.header.update(wcs_cards)
        psf_hdu = fits_io.ImageHDU(
            np.asanyarray(stack.psfs[idx], dtype=np.float32), name=f"PSF_{idx}"
        )
        return [sci_hdu, var_hdu, msk_hdu, psf_hdu]

    def to_fits(self, filename, overwrite=False, format="reference",
                compression_type="GZIP_1", quantize_level=-0.01):
        """Write the whole WorkUnit to a single FITS file.

        ``format="reference"`` (default) produces the reference's layout
        (PRIMARY metadata + KBMOD_CONFIG/IMG_META BINTABLEs + compressed
        SCI_i/VAR_i + MSK_i/PSF_i; work_unit.py:610-682) — readable by
        the upstream astropy-based loader. GZIP_1 keeps the pixel data
        lossless; pass compression_type="RICE_1" for the reference's
        (quantized, lossy) default. Any other ``format`` (the JAX package
        calls it ``"kbmod_tpu"``) writes the self-contained metadata dialect
        that the sharded form uses.
        """
        logger.info(f"Writing WorkUnit to {filename}")
        if format == "reference":
            hdus = self._reference_metadata_hdul()
            for idx in range(self.im_stack.num_times):
                hdus.extend(self._reference_image_hdus(idx, compression_type, quantize_level))
        else:
            hdus = self.metadata_to_hdul()
            for idx in range(self.im_stack.num_times):
                hdus.extend(self._image_hdus(idx))
        hdus.writeto(filename, overwrite=overwrite)

    @classmethod
    def _from_reference_hdul(cls, hdus):
        """Load from the reference's single-file layout
        (work_unit.py:489-608)."""
        from kbmod_tpu_torch.geom.geodesy import geodetic_to_geocentric
        from kbmod_tpu_torch.io.fits_io import BinTableHDU

        pri = hdus[0].header
        num_img = int(pri["NUMIMG"])
        n_con = int(pri.get("NCON", num_img))

        config = (
            SearchConfiguration.from_hdu(hdus["KBMOD_CONFIG"])
            if "KBMOD_CONFIG" in hdus
            else SearchConfiguration()
        )

        img_meta = None
        if "IMG_META" in hdus and isinstance(hdus["IMG_META"], BinTableHDU):
            cols = {}
            for name, vals in hdus["IMG_META"].columns.items():
                if name.startswith("_WCSSTR_"):
                    cols[name[8:]] = np.array(
                        [deserialize_wcs(v) if v else None for v in vals], dtype=object
                    )
                else:
                    vals = list(vals) if not isinstance(vals, np.ndarray) else vals
                    try:
                        cols[name] = np.asarray(vals, dtype=float)
                    except (TypeError, ValueError):
                        cols[name] = np.array(vals, dtype=object)
            img_meta = Table(cols) if cols else None

        wcs = None
        if "CRVAL1" in pri and "CRPIX1" in pri:
            from kbmod_tpu_torch.geom.wcs import WCS as _WCS

            wcs = _WCS.from_header(pri)

        bary = pri.get("BARY", None)
        observatory = None
        if "OBSX" in pri:
            observatory = (float(pri["OBSX"]), float(pri["OBSY"]), float(pri["OBSZ"]))
        elif "OBS_LAT" in pri:
            observatory = geodetic_to_geocentric(
                pri["OBS_LAT"], pri["OBS_LON"], pri.get("OBS_ELEV", 0.0)
            )

        stack = ImageStackPy()
        per_image_indices = []
        for idx in range(num_img):
            sci_hdu = hdus[f"SCI_{idx}"]
            sci = np.asarray(sci_hdu.data, dtype=np.float32)
            var = np.asarray(hdus[f"VAR_{idx}"].data, dtype=np.float32)
            if f"MSK_{idx}" in hdus:
                mask = np.asarray(hdus[f"MSK_{idx}"].data)
                sci[mask > 0] = np.nan
                var[mask > 0] = np.nan
            psf = (
                np.asarray(hdus[f"PSF_{idx}"].data, dtype=np.float32)
                if f"PSF_{idx}" in hdus
                else np.array([[1.0]], dtype=np.float32)
            )
            stack.append_image(
                time=float(sci_hdu.header.get("MJD", idx)), sci=sci, var=var, psf=psf
            )
            n_ind = int(sci_hdu.header.get("NIND", 0) or 0)
            per_image_indices.append(
                [int(sci_hdu.header[f"IND_{j}"]) for j in range(n_ind)] or [idx]
            )

        return cls(
            im_stack=stack,
            config=config,
            wcs=wcs,
            reprojected=bool(pri.get("REPRJCTD", False)),
            reprojection_frame=(pri.get("REPFRAME") or None),
            barycentric_distance=None if bary is None or bary < 0 else float(bary),
            per_image_indices=per_image_indices,
            org_image_meta=img_meta if img_meta is not None and len(img_meta) == n_con else None,
            observatory=observatory,
        )

    @classmethod
    def _from_metadata_hdul(cls, hdus):
        meta_hdu = hdus["METADATA"]
        config = SearchConfiguration.from_yaml(hdus["KBMOD_CONFIG"].get_long_string("YAMLCFG"))

        img_meta = hdus["IMG_META"].to_table()
        for col in ("per_image_wcs", "ebd_wcs"):
            if col in img_meta.colnames:
                img_meta[col] = np.array(
                    [deserialize_wcs(v) if v else None for v in img_meta[col]], dtype=object
                )
        per_image_indices = [list(g) for g in hdus["IMG_IDX"].to_table()["groups"]]
        obstimes = np.asarray(hdus["OBSTIMES"].to_table()["obstimes"], dtype=float)

        wcs = deserialize_wcs(meta_hdu.get_long_string("GWCS"))
        bary = meta_hdu.header.get("BARY", -1.0)
        return {
            "config": config,
            "wcs": wcs,
            "reprojected": bool(meta_hdu.header.get("REPROJ", False)),
            "reprojection_frame": meta_hdu.header.get("REPFRAME") or None,
            "barycentric_distance": None if bary is None or bary < 0 else float(bary),
            "observatory": (
                meta_hdu.header.get("OBSX", RUBIN_LOCATION_M[0]),
                meta_hdu.header.get("OBSY", RUBIN_LOCATION_M[1]),
                meta_hdu.header.get("OBSZ", RUBIN_LOCATION_M[2]),
            ),
            "org_image_meta": img_meta,
            "per_image_indices": per_image_indices,
            "obstimes": obstimes,
            "num_img": int(meta_hdu.header["NUMIMG"]),
        }

    @classmethod
    def from_fits(cls, filename, show_progress=None):
        """Read a WorkUnit from a single FITS file (auto-detects the
        reference layout — NUMIMG in the primary header — vs this
        package's dialect, which keeps NUMIMG on a METADATA HDU)."""
        logger.info(f"Reading WorkUnit from {filename}")
        hdus = fits_io.read_fits(filename)
        if "NUMIMG" in hdus[0].header:
            return cls._from_reference_hdul(hdus)
        meta = cls._from_metadata_hdul(hdus)
        num_img = meta.pop("num_img")

        stack = ImageStackPy()
        for idx in range(num_img):
            sci_hdu = hdus[f"SCI_{idx}"]
            stack.append_image(
                time=float(sci_hdu.header.get("MJD", idx)),
                sci=np.asarray(sci_hdu.data, dtype=np.float32),
                var=np.asarray(hdus[f"VAR_{idx}"].data, dtype=np.float32),
                psf=np.asarray(hdus[f"PSF_{idx}"].data, dtype=np.float32),
            )
        return cls(im_stack=stack, **meta)

    def to_sharded_fits(self, filename, directory, overwrite=False):
        """Write a head file (metadata) plus one FITS shard per image."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        head = self.metadata_to_hdul()
        head.writeto(directory / filename, overwrite=overwrite)
        for idx in range(self.im_stack.num_times):
            shard = fits_io.HDUList([fits_io.ImageHDU(name="PRIMARY")])
            shard.extend(self._image_hdus(idx))
            shard.writeto(directory / f"{idx}_{filename}", overwrite=overwrite)

    @classmethod
    def from_sharded_fits(cls, filename, directory, lazy=False):
        """Read a sharded WorkUnit; with ``lazy`` the images load on
        demand via load_images()."""
        directory = Path(directory)
        hdus = fits_io.read_fits(directory / filename)
        meta = cls._from_metadata_hdul(hdus)
        num_img = meta.pop("num_img")
        file_paths = [str(directory / f"{idx}_{filename}") for idx in range(num_img)]

        if lazy:
            work = cls(im_stack=ImageStackPy(), lazy=True, file_paths=file_paths, **meta)
            return work

        stack = ImageStackPy()
        for idx, path in enumerate(file_paths):
            shard = fits_io.read_fits(path)
            sci_hdu = shard[f"SCI_{idx}"]
            stack.append_image(
                time=float(sci_hdu.header.get("MJD", idx)),
                sci=np.asarray(sci_hdu.data, dtype=np.float32),
                var=np.asarray(shard[f"VAR_{idx}"].data, dtype=np.float32),
                psf=np.asarray(shard[f"PSF_{idx}"].data, dtype=np.float32),
            )
        return cls(im_stack=stack, file_paths=file_paths, **meta)

    def load_images(self):
        """Load the image data for a lazy sharded WorkUnit."""
        if not self.lazy:
            return
        stack = ImageStackPy()
        for idx, path in enumerate(self.file_paths):
            shard = fits_io.read_fits(path)
            sci_hdu = shard[f"SCI_{idx}"]
            stack.append_image(
                time=float(sci_hdu.header.get("MJD", idx)),
                sci=np.asarray(sci_hdu.data, dtype=np.float32),
                var=np.asarray(shard[f"VAR_{idx}"].data, dtype=np.float32),
                psf=np.asarray(shard[f"PSF_{idx}"].data, dtype=np.float32),
            )
        self.im_stack = stack
        self.lazy = False

    def write_config(self, filename, overwrite=False):
        self.config.to_file(filename, overwrite=overwrite)


def load_layered_image_from_shard(file_path):
    """Load one LayeredImagePy from a shard file."""
    idx = int(os.path.basename(file_path).split("_")[0])
    shard = fits_io.read_fits(file_path)
    sci_hdu = shard[f"SCI_{idx}"]
    return LayeredImagePy(
        sci=np.asarray(sci_hdu.data, dtype=np.float32),
        var=np.asarray(shard[f"VAR_{idx}"].data, dtype=np.float32),
        psf=np.asarray(shard[f"PSF_{idx}"].data, dtype=np.float32),
        time=float(sci_hdu.header.get("MJD", idx)),
    )


def add_image_data_to_hdul(
    hdul,
    idx,
    sci,
    var,
    mask,
    obstime,
    psf_kernel=None,
    wcs=None,
    compression_type="RICE_1",
    quantize_level=-0.01,
):
    """Append one time step's SCI/VAR/MSK/PSF layers to an HDU list in the
    reference's on-disk layout (reference work_unit.py:1062-1147): tiled
    compression for sci/var, the observation time under ``MJD``, the WCS
    copied into each image header, and the mask binarized to include
    non-finite science/variance pixels."""
    from kbmod_tpu_torch.io.fits_io import make_comp_image_hdu
    from kbmod_tpu_torch.wcs_utils import append_wcs_to_hdu_header

    sci = np.asanyarray(sci, dtype=np.float32)
    var = np.asanyarray(var, dtype=np.float32)
    obstime = float(obstime)

    wcs_cards = {}
    if wcs is not None:
        hdr = {}
        append_wcs_to_hdu_header(wcs, hdr)
        wcs_cards = {k: v for k, v in hdr.items() if not k.startswith("NAXIS")}

    extra = dict(MJD=obstime, **wcs_cards)
    sci_hdu = make_comp_image_hdu(
        sci, name=f"SCI_{idx}", compression_type=compression_type,
        quantize_level=quantize_level, header_extra=extra,
    )
    var_hdu = make_comp_image_hdu(
        var, name=f"VAR_{idx}", compression_type=compression_type,
        quantize_level=quantize_level, header_extra=extra,
    )
    mask_full = (np.asanyarray(mask) > 0) | ~np.isfinite(sci) | ~np.isfinite(var)
    msk_hdu = fits_io.ImageHDU(mask_full.astype(np.uint8), name=f"MSK_{idx}")
    msk_hdu.header["MJD"] = obstime
    msk_hdu.header.update(wcs_cards)
    if psf_kernel is None:
        psf_kernel = np.array([[1.0]], dtype=np.float32)
    psf_hdu = fits_io.ImageHDU(np.asanyarray(psf_kernel, dtype=np.float32), name=f"PSF_{idx}")
    for hdu in (sci_hdu, var_hdu, msk_hdu, psf_hdu):
        hdul.append(hdu)


def read_image_data_from_hdul(hdul, idx):
    """Read one time step's layers back (reference work_unit.py:1149-1200):
    the mask is auto-applied to the science and variance layers; the PSF
    defaults to an identity kernel and the WCS may be None."""
    from kbmod_tpu_torch.wcs_utils import extract_wcs_from_hdu_header

    def _image(hdu):
        # Freshly built (in-memory) compressed layers hold tiles in a
        # BinTable; reading a file decompresses at load time instead.
        cols = getattr(hdu, "columns", None)
        if cols is not None and "COMPRESSED_DATA" in cols:
            from kbmod_tpu_torch.io.comp_image import decompress_image

            img, _ = decompress_image(hdu.header, cols)
            return img
        return hdu.data

    sci_hdu = hdul[f"SCI_{idx}"]
    sci = np.asarray(_image(sci_hdu), dtype=np.float32)
    obstime = float(sci_hdu.header["MJD"])
    wcs = extract_wcs_from_hdu_header(sci_hdu.header)

    var = np.asarray(_image(hdul[f"VAR_{idx}"]), dtype=np.float32)

    if f"MSK_{idx}" in hdul:
        mask = np.asarray(hdul[f"MSK_{idx}"].data, dtype=np.float32)
        sci = sci.copy()
        var = var.copy()
        sci[mask > 0] = np.nan
        var[mask > 0] = np.nan
    else:
        mask = np.zeros_like(sci, dtype=np.float32)

    if f"PSF_{idx}" in hdul:
        psf_kernel = np.asarray(hdul[f"PSF_{idx}"].data, dtype=np.float32)
    else:
        psf_kernel = np.array([[1.0]], dtype=np.float32)

    return sci, var, mask, obstime, psf_kernel, wcs


def image_metadata_table_to_hdu(data, layer_name=None):
    """Encode a metadata table as a BinTable HDU (reference
    work_unit.py:1242-1283): WCS-valued columns serialize to
    ``_WCSSTR_{col}`` string columns, all-None object columns are
    dropped, and remaining object columns stringify."""
    from kbmod_tpu_torch.geom.wcs import WCS
    from kbmod_tpu_torch.io.fits_io import BinTableHDU
    from kbmod_tpu_torch.wcs_utils import serialize_wcs

    cols = {}
    if len(data) > 0:
        for colname in data.colnames:
            vals = list(data[colname])
            if all(v is None for v in vals):
                continue
            if isinstance(vals[0], WCS):
                cols[f"_WCSSTR_{colname}"] = [serialize_wcs(v) if v is not None else "" for v in vals]
            else:
                try:
                    arr = np.asarray(vals)
                    if arr.dtype == object:
                        raise ValueError
                    cols[colname] = arr
                except Exception:
                    cols[colname] = [str(v) for v in vals]
    return BinTableHDU(columns=cols, name=layer_name)


def hdu_to_image_metadata_table(hdu):
    """Decode a metadata BinTable HDU back into a Table (reference
    work_unit.py:1285-1309): ``_WCSSTR_{col}`` columns deserialize to
    WCS objects under the original column name."""
    from kbmod_tpu_torch.table import Table
    from kbmod_tpu_torch.wcs_utils import deserialize_wcs

    data = Table()
    for colname, vals in hdu.columns.items():
        if colname.startswith("_WCSSTR_"):
            data[colname[len("_WCSSTR_"):]] = [
                deserialize_wcs(v) if v else None for v in vals
            ]
        else:
            data[colname] = vals
    return data
