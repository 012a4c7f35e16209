"""ImageCollection: a metadata catalog of unstandardized images.

Copy of the JAX package's image_collection.py (host code); its files are
the JAX package's, so either package reads the other's collections.
Behavior-compatible with the reference's kbmod.image_collection
(src/kbmod/image_collection.py): build from targets/directories/
standardizers, query and filter by time/band, apply reflex correction
columns, lazily materialize standardizers, and produce a WorkUnit.
"""

import glob
import logging
import os

import numpy as np

from kbmod_tpu_torch.configuration import SearchConfiguration
from kbmod_tpu_torch.core.image_stack_py import ImageStackPy
from kbmod_tpu_torch.standardizers import Standardizer
from kbmod_tpu_torch.table import Table, vstack
from kbmod_tpu_torch.work_unit import WorkUnit

logger = logging.getLogger(__name__)

__all__ = ["ImageCollection"]


class ImageCollection:
    """A table of standardized metadata rows, one per science exposure,
    with lazy access to the backing standardizers.

    Attributes
    ----------
    data : `Table`
        The metadata table. Includes bookkeeping columns ``std_idx`` (which
        standardizer provides the row) and ``ext_idx`` (which processable
        unit within it).
    """

    required_metadata = ["location", "mjd_mid", "ra", "dec"]

    def __init__(self, metadata, standardizers=None, enable_std_caching=True):
        self.data = metadata if isinstance(metadata, Table) else Table(metadata)
        for col in self.required_metadata:
            if col not in self.data.colnames:
                raise ValueError(f"Missing required metadata column {col}.")

        n_stds = int(self.data.meta.get("n_stds", 0))
        if standardizers is not None:
            self._standardizers = list(standardizers)
            self.data.meta["n_stds"] = len(self._standardizers)
        elif enable_std_caching:
            if not n_stds and "std_idx" in self.data.colnames and len(self.data):
                n_stds = int(np.max(self.data["std_idx"])) + 1
                self.data.meta["n_stds"] = n_stds
            self._standardizers = [None] * n_stds
        else:
            self._standardizers = None

        self._userColumns = [
            c for c in self.data.colnames if c not in ("std_idx", "ext_idx", "std_name", "config")
        ]

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------

    @classmethod
    def fromStandardizers(cls, standardizers, meta=None):
        """Build from instantiated standardizers, unravelling per-exposure
        metadata rows."""
        unravelled = []
        for std_idx, std in enumerate(standardizers):
            meta_dict = std.standardizeMetadata()
            wcs_list = meta_dict.pop("wcs", [None] * len(std.processable))
            bbox_list = meta_dict.pop("bbox", [None] * len(std.processable))
            n_ext = len(std.processable)

            for ext_idx in range(n_ext):
                row = {}
                for key, value in meta_dict.items():
                    if isinstance(value, (list, tuple, np.ndarray)) and len(value) == n_ext:
                        row[key] = value[ext_idx]
                    else:
                        row[key] = value
                bbox = bbox_list[ext_idx]
                if isinstance(bbox, dict):
                    row.update(bbox)
                wcs = wcs_list[ext_idx]
                if wcs is not None:
                    from kbmod_tpu_torch.wcs_utils import serialize_wcs

                    row["wcs"] = serialize_wcs(wcs)
                row["std_idx"] = std_idx
                row["ext_idx"] = ext_idx
                row["std_name"] = std.name
                unravelled.append(row)

        all_cols = sorted({k for row in unravelled for k in row})
        data = {col: [row.get(col) for row in unravelled] for col in all_cols}
        table = Table(data)
        table.meta["n_stds"] = len(standardizers)
        if meta:
            table.meta.update(meta)
        return cls(table, standardizers=standardizers)

    @classmethod
    def fromTargets(cls, tgts, force=None, config=None, **kwargs):
        """Build by resolving a standardizer for each target."""
        standardizers = [Standardizer.get(tgt, force=force, config=config, **kwargs) for tgt in tgts]
        return cls.fromStandardizers(standardizers)

    @classmethod
    def fromDir(cls, dirpath, recursive=False, force=None, config=None, **kwargs):
        """Build from all FITS files in a directory."""
        fits_files = []
        for pattern in ("*.fits", "*.fit", "*.fits.fz"):
            fits_files.extend(glob.glob(os.path.join(dirpath, "**" if recursive else "", pattern), recursive=recursive))
        fits_files = sorted(set(fits_files))
        if not fits_files:
            raise ValueError(f"No FITS files found in {dirpath}.")
        return cls.fromTargets(fits_files, force=force, config=config, **kwargs)

    @classmethod
    def fromBinTableHDU(cls, hdu):
        return cls(hdu.to_table())

    # ------------------------------------------------------------------
    # Table interface
    # ------------------------------------------------------------------

    def __len__(self):
        return len(self.data)

    def __getitem__(self, key):
        if isinstance(key, str) or (isinstance(key, tuple) and all(isinstance(k, str) for k in key)):
            return self.data[key]
        if isinstance(key, (int, np.integer)):
            return self.data[int(key)]
        sub = ImageCollection(self.data[key], standardizers=self._standardizers)
        return sub

    def __setitem__(self, key, value):
        self.data[key] = value

    def __contains__(self, key):
        return key in self.data

    def __eq__(self, other):
        if not isinstance(other, ImageCollection):
            return NotImplemented
        if set(self.data.colnames) != set(other.data.colnames) or len(self) != len(other):
            return False
        for col in self.data.colnames:
            a, b = self.data[col], other.data[col]
            if a.dtype == object or b.dtype == object:
                if any(str(x) != str(y) for x, y in zip(a, b)):
                    return False
            elif not np.array_equal(a, b):
                return False
        return True

    @property
    def meta(self):
        return self.data.meta

    @property
    def columns(self):
        return self.data.colnames

    @property
    def wcs(self):
        from kbmod_tpu_torch.wcs_utils import deserialize_wcs

        if "wcs" not in self.data.colnames:
            return [None] * len(self)
        return [deserialize_wcs(w) if w else None for w in self.data["wcs"]]

    def copy(self):
        return ImageCollection(self.data.copy(), standardizers=self._standardizers)

    def reset_lazy_loading_indices(self):
        """Re-number std_idx to a dense range (used after filtering)."""
        if "std_idx" not in self.data.colnames or self._standardizers is None:
            return
        old_inds = np.asarray(self.data["std_idx"], dtype=int)
        unique_inds = sorted(set(old_inds.tolist()))
        remap = {old: new for new, old in enumerate(unique_inds)}
        self.data["std_idx"] = np.array([remap[i] for i in old_inds])
        self._standardizers = [self._standardizers[i] for i in unique_inds]
        self.data.meta["n_stds"] = len(self._standardizers)

    # ------------------------------------------------------------------
    # Standardizer access
    # ------------------------------------------------------------------

    def get_standardizer(self, index, **kwargs):
        """The standardizer (and ext index) backing a row, materializing it
        on first access."""
        row = self.data[int(index)]
        std_idx = int(row["std_idx"])
        if self._standardizers[std_idx] is None:
            std_cls = Standardizer.registry[str(row["std_name"])]
            self._standardizers[std_idx] = std_cls(str(row["location"]), **kwargs)
        return {"std": self._standardizers[std_idx], "ext": int(row["ext_idx"])}

    def get_standardizers(self, **kwargs):
        """All standardizers backing this collection."""
        std_idxs = sorted(set(int(i) for i in self.data["std_idx"]))
        out = []
        for std_idx in std_idxs:
            row_idx = int(np.nonzero(np.asarray(self.data["std_idx"], dtype=int) == std_idx)[0][0])
            out.append(self.get_standardizer(row_idx, **kwargs))
        return out

    # ------------------------------------------------------------------
    # Filtering / bookkeeping
    # ------------------------------------------------------------------

    def filter_by_mjds(self, mjds, time_sep_s=0.001):
        """Keep rows whose mjd_mid matches any of the given times within
        ``time_sep_s`` seconds."""
        if time_sep_s < 0:
            raise ValueError(f"time_sep_s must be >= 0. Got {time_sep_s}")
        data_t = np.asarray(self.data["mjd_mid"], dtype=float)
        keep = np.zeros(len(self), dtype=bool)
        for t in np.atleast_1d(mjds):
            keep |= np.abs(data_t - t) <= time_sep_s / 86400.0
        self.data = self.data[keep]
        self.reset_lazy_loading_indices()

    def filter_by_time_range(self, start_mjd=None, end_mjd=None):
        data_t = np.asarray(self.data["mjd_mid"], dtype=float)
        keep = np.ones(len(self), dtype=bool)
        if start_mjd is not None:
            keep &= data_t >= start_mjd
        if end_mjd is not None:
            keep &= data_t <= end_mjd
        self.data = self.data[keep]
        self.reset_lazy_loading_indices()

    def filter_by_bands(self, bands):
        if "filter" not in self.data.colnames:
            raise KeyError("No filter column to filter bands on.")
        keep = np.array([str(f) in set(bands) for f in self.data["filter"]])
        self.data = self.data[keep]
        self.reset_lazy_loading_indices()

    # ------------------------------------------------------------------
    # Reflex correction
    # ------------------------------------------------------------------

    def reflex_correct(self, guess_distance, earth_loc=None):
        """Add reflex-corrected ``{col}_{dist}`` coordinate columns for the
        given barycentric guess distance (AU)."""
        from kbmod_tpu_torch.reprojection_utils import correct_parallax_geometrically_vectorized

        ra = np.asarray(self.data["ra"], dtype=float)
        dec = np.asarray(self.data["dec"], dtype=float)
        mjds = np.asarray(self.data["mjd_mid"], dtype=float)
        corrected, _ = correct_parallax_geometrically_vectorized(ra, dec, mjds, guess_distance)
        self.data[f"ra_{guess_distance}"] = corrected.ra_deg
        self.data[f"dec_{guess_distance}"] = corrected.dec_deg
        self.data.meta.setdefault("reflex_corrected", []).append(guess_distance)
        return self

    # ------------------------------------------------------------------
    # Output
    # ------------------------------------------------------------------

    _supporting_metadata = ("std_name", "std_idx", "ext_idx", "config")

    def remove_column(self, name):
        """Remove a user column; required/bookkeeping columns are protected
        (reference image_collection.remove_column behavior)."""
        import warnings

        if name in self.required_metadata or name in self._supporting_metadata:
            warnings.warn(
                f"Column {name} is required metadata for image collection and will not be removed."
            )
            return
        self.data.remove_column(name)
        if name in self._userColumns:
            self._userColumns.remove(name)

    def remove_columns(self, names):
        for name in list(names):
            self.remove_column(name)

    def reflex_corrected_col(self, col_name, guess_dist):
        """Name of the reflex-corrected variant of ``col_name`` at
        ``guess_dist`` (0.0 -> the original column)."""
        if col_name not in self.data.colnames:
            raise ValueError(f"Column {col_name} not in ImageCollection")
        if not isinstance(guess_dist, float):
            raise ValueError("Reflex-corrected guess distance must be a float")
        if guess_dist == 0.0:
            return col_name
        return f"{col_name}_{guess_dist}"

    def drop_bands(self, bands_to_drop):
        """Drop rows taken in the given bands (in place)."""
        if len(self.data) < 1:
            return
        col = "band" if "band" in self.data.colnames else "filter"
        keep = ~np.isin(np.asarray(self.data[col]).astype(str), list(bands_to_drop))
        self.data = self.data[keep]
        self.reset_lazy_loading_indices()

    def filter_by_wcs_error(self, max_wcs_error, in_arcsec=True):
        """Keep rows whose ``wcs_err`` (degrees) is within the given bound."""
        if "wcs_err" not in self.data.colnames:
            raise ValueError("Cannot filter ImageCollection by missing wcs_err column.")
        if max_wcs_error < 0:
            raise ValueError("max_wcs_error must be positive")
        if len(self.data) < 1:
            return
        bound = max_wcs_error / 3600.0 if in_arcsec else max_wcs_error
        self.data = self.data[np.asarray(self.data["wcs_err"], dtype=float) <= bound]
        self.reset_lazy_loading_indices()

    def validate(self):
        """Check the required metadata columns exist and carry values."""
        for col in self.required_metadata:
            if col not in self.data.colnames:
                raise ValueError(f"Metadata is missing required column {col}.")
        return True

    def get_wcs(self, idxs):
        """WCS object(s) for the selected row(s), resolved through the
        row's standardizer."""
        if isinstance(idxs, (int, np.integer)):
            return self.get_standardizer(int(idxs))["std"].standardizeWCS()[
                int(self.data["ext_idx"][int(idxs)])
            ]
        idx_list = range(*idxs.indices(len(self))) if isinstance(idxs, slice) else idxs
        return [self.get_wcs(int(i)) for i in idx_list]

    def get_bbox(self, idxs):
        """Footprint corners {(ra, dec), tl, tr, br, bl} for the selected
        row(s), from corner columns when present, else the row's WCS."""
        if not isinstance(idxs, (int, np.integer)):
            idx_list = range(*idxs.indices(len(self))) if isinstance(idxs, slice) else idxs
            return [self.get_bbox(int(i)) for i in idx_list]
        i = int(idxs)
        corner_cols = ["ra_tl", "dec_tl", "ra_tr", "dec_tr", "ra_br", "dec_br", "ra_bl", "dec_bl"]
        out = {"ra": float(self.data["ra"][i]), "dec": float(self.data["dec"][i])}
        if all(c in self.data.colnames for c in corner_cols):
            for c in corner_cols:
                out[c] = float(self.data[c][i])
            return out
        wcs = self.get_wcs(i)
        h = int(2 * wcs.crpix[1])
        w = int(2 * wcs.crpix[0])
        for (x, y), tag in zip(
            [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)], ("tl", "tr", "br", "bl")
        ):
            ra, dec = wcs.pixel_to_world_values(float(x), float(y))
            out[f"ra_{tag}"] = float(ra)
            out[f"dec_{tag}"] = float(dec)
        return out

    def bbox(self):
        """Iterate over per-row footprint corner dicts."""
        for i in range(len(self)):
            yield self.get_bbox(i)

    def get_observatory(self):
        """(lat_deg, lon_deg, elev_m) from the first row's obs_* columns,
        or None when unavailable."""
        if len(self.data) == 0:
            return None
        cols = ("obs_lat", "obs_lon", "obs_elev")
        if not all(c in self.data.colnames for c in cols):
            return None
        return tuple(float(self.data[c][0]) for c in cols)

    @property
    def is_packed(self):
        return bool(self.data.meta.get("is_packed", False))

    def pack(self):
        """Move columns whose value repeats on every row into table
        metadata (smaller serialized files); `unpack` restores them."""
        if len(self.data) == 0:
            return
        shared = []
        for col in list(self.data.colnames):
            vals = self.data[col]
            try:
                first = vals[0]
                if all(v == first for v in vals):
                    shared.append(col)
            except Exception:
                continue
        shared = [c for c in shared if c not in self._supporting_metadata]
        for col in shared:
            self.data.meta[f"shared_{col}"] = self.data[col][0]
            self.data.remove_column(col)
        self.data.meta["shared_cols"] = shared
        self.data.meta["is_packed"] = True
        self._userColumns = [c for c in self.data.colnames if c not in self._supporting_metadata]

    def unpack(self):
        if not self.is_packed:
            return
        n = len(self.data)
        for col in self.data.meta.get("shared_cols", []):
            self.data[col] = [self.data.meta.pop(f"shared_{col}")] * n
        self.data.meta.pop("shared_cols", None)
        self.data.meta["is_packed"] = False
        self._userColumns = [c for c in self.data.colnames if c not in self._supporting_metadata]

    def toBinTableHDU(self):
        """The (unpacked) metadata table as a FITS table HDU (inverse of
        fromBinTableHDU)."""
        from kbmod_tpu_torch.io.fits_io import TableHDU

        if self.is_packed:
            self.unpack()
            self.data.meta.pop("is_packed", None)
        return TableHDU(self.data, name="IMGCOLL")

    def obs_nights_spanned(self):
        """Number of calendar nights spanned by the observations (inclusive
        of both endpoints; reference image_collection behavior)."""
        mjds = np.asarray(self.data["mjd_mid"], dtype=float)
        if len(mjds) == 0:
            return 0
        return int(np.floor(mjds.max()) - np.floor(mjds.min())) + 1

    def get_zero_shifted_times(self):
        times = np.asarray(self.data["mjd_mid"], dtype=float)
        return times - times.min()

    def toImageStack(self):
        """Standardize all images into an ImageStackPy."""
        stack = ImageStackPy()
        order = np.argsort(np.asarray(self.data["mjd_mid"], dtype=float), kind="stable")
        for row_idx in order:
            entry = self.get_standardizer(int(row_idx))
            std, ext = entry["std"], entry["ext"]
            layered = std.toLayeredImage()[ext]
            stack.append_layered_image(layered)
        return stack

    def toWorkUnit(self, search_config=None, **kwargs):
        """Standardize everything into a WorkUnit (images time-sorted)."""
        logger.info("Building WorkUnit from ImageCollection")
        if search_config is None:
            search_config = SearchConfiguration()
        elif isinstance(search_config, dict):
            search_config = SearchConfiguration.from_dict(search_config)

        order = np.argsort(np.asarray(self.data["mjd_mid"], dtype=float), kind="stable")
        stack = ImageStackPy()
        per_image_wcs = []
        wcs_list = self.wcs
        for row_idx in order:
            entry = self.get_standardizer(int(row_idx))
            std, ext = entry["std"], entry["ext"]
            layered = std.toLayeredImage()[ext]
            stack.append_layered_image(layered)
            per_image_wcs.append(wcs_list[int(row_idx)])

        meta_cols = {}
        for col in ("visit", "filter", "location", "dataId"):
            if col in self.data.colnames:
                meta_cols["data_loc" if col == "location" else col] = np.asarray(self.data[col], dtype=object)[order]
        org_meta = Table(meta_cols) if meta_cols else None

        return WorkUnit(
            im_stack=stack,
            config=search_config,
            per_image_wcs=per_image_wcs,
            org_image_meta=org_meta,
            obstimes=np.asarray(self.data["mjd_mid"], dtype=float)[order],
            **kwargs,
        )

    def get_global_wcs(self):
        """A simple shared WCS guess: the per-image WCS of the first row."""
        wcs_list = self.wcs
        return wcs_list[0] if wcs_list else None

    # --- ecsv IO ---

    def write(self, filename, overwrite=True, **kwargs):
        from kbmod_tpu_torch.io import table_io

        out = self.data.copy()
        table_io.write_table(out, filename)

    @classmethod
    def read(cls, filename, **kwargs):
        from kbmod_tpu_torch.io import table_io

        return cls(table_io.read_table(filename))

    def vstack(self, others):
        """Concatenate other collections into this one."""
        tables = [self.data] + [o.data for o in others]
        stds = list(self._standardizers or [])
        offset = len(stds)
        for o in others:
            shifted = np.asarray(o.data["std_idx"], dtype=int) + offset
            o.data["std_idx"] = shifted
            stds.extend(o._standardizers or [])
            offset = len(stds)
        self.data = vstack(tables)
        self._standardizers = stds
        self.data.meta["n_stds"] = len(stds)
        return self


def pack_table(data):
    """Move columns whose value repeats on every row into the table's
    metadata (reference image_collection.py:38-67): shared column names
    are recorded under ``shared_cols``, each value under its own meta
    key, and ``is_packed`` is set. Returns the (mutated) table."""
    shared_values = {}
    for col in list(data.colnames):
        vals = data[col]
        if len(vals) == 0:
            continue
        try:
            uniq = np.unique(np.asarray(vals))
        except Exception:
            continue
        if len(uniq) == 1:
            v = uniq[0]
            shared_values[col] = str(v) if isinstance(v, np.str_) else v
    data.meta["shared_cols"] = list(shared_values.keys())
    data.meta.update(shared_values)
    data.meta["is_packed"] = True
    data.remove_columns(data.meta["shared_cols"])
    return data


def unpack_table(data):
    """Restore columns packed into metadata by :func:`pack_table`
    (reference image_collection.py:70-99). A table without an
    ``is_packed`` metadata entry is returned unchanged."""
    if not data.meta.get("is_packed", False):
        return data
    n_rows = 1 if len(data) == 0 else len(data)
    for col in data.meta["shared_cols"]:
        data[col] = np.full((n_rows,), data.meta[col])
    for col in data.meta["shared_cols"]:
        data.meta.pop(col)
    data.meta.pop("shared_cols")
    data.meta["is_packed"] = False
    return data
