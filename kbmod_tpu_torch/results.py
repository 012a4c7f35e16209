"""Results: the column-based results container with filter bookkeeping.

Port of the JAX package's results.py, which is behavior-compatible with the reference's kbmod.results (src/kbmod/
results.py): required trajectory columns (x, y, vx, vy, likelihood, flux,
obs_count) + auto uuid, psi/phi curve columns with likelihood recomputation,
named-filter statistics with optional full tracking and revert, image-like
column detection with side-car file IO, and ecsv/parquet/hdf5 round trips.

Built on kbmod_tpu_torch.table.Table (no astropy dependency); the
serialization formats are self-describing (JSON metadata header / parquet
key-value metadata / hdf5 attrs) and the same as the JAX package's,
a global WCS included (``kbmod_tpu_torch.wcs_utils.serialize_wcs``).
"""

import copy
import logging
import re
import uuid as uuid_mod
from pathlib import Path

import numpy as np

from kbmod_tpu_torch.search.trajectory import Trajectory, trajectories_to_arrays
from kbmod_tpu_torch.search.trajectory_list import TrajectoryList
from kbmod_tpu_torch.table import Table, vstack

logger = logging.getLogger(__name__)

class Results:
    """A collection of candidate results with per-filter bookkeeping.

    Attributes
    ----------
    table : `kbmod_tpu_torch.table.Table`
        The stored results data.
    wcs : `kbmod_tpu_torch.geom.wcs.WCS` or None
        A global WCS, serialized with the table.
    mjd_mid : `np.ndarray` or None
        Optional per-observation midpoint times (UTC MJD).
    track_filtered : `bool`
        Whether removed rows are retained per filter label.
    filtered : `dict`
        label -> Table of removed rows (only when track_filtered).
    filtered_stats : `dict`
        label -> count of removed rows (always maintained).
    """

    required_cols = [
        ("x", int, 0),
        ("y", int, 0),
        ("vx", float, 0.0),
        ("vy", float, 0.0),
        ("likelihood", float, 0.0),
        ("flux", float, 0.0),
        ("obs_count", int, 0),
    ]
    _required_col_names = {c[0] for c in required_cols}
    _supported_formats = [".ecsv", ".parq", ".parquet", ".hdf5"]

    def __init__(self, data=None, track_filtered=False, wcs=None):
        self.wcs = wcs
        self.mjd_mid = None
        self.track_filtered = track_filtered
        self.filtered = {}
        self.filtered_stats = {}

        if data is None:
            self.table = Table({name: np.array([], dtype=dtype) for name, dtype, _ in self.required_cols})
        elif isinstance(data, dict):
            self.table = Table(data)
        elif isinstance(data, Table):
            self.table = data
        else:
            raise TypeError(f"Incompatible data type {type(data)}")

        if "uuid" not in self.table.colnames:
            self.table["uuid"] = np.array([uuid_mod.uuid4().hex for _ in range(len(self.table))], dtype=object)

        for name, _, _ in self.required_cols:
            if name not in self.table.colnames:
                raise KeyError(f"Column {name} missing from input data.")

    def __len__(self):
        return len(self.table)

    def __str__(self):
        return str(self.table)

    def __repr__(self):
        return repr(self.table).replace("Table", "Results")

    def __getitem__(self, key):
        return self.table[key]

    def __setitem__(self, key, value):
        self.table[key] = value

    def __contains__(self, key):
        return key in self.table

    @property
    def mjd_utc_mid(self):
        return self.mjd_mid

    @property
    def mjd_tai_mid(self):
        # TAI = UTC + (leap seconds + 10); ~37s for the 2017+ era covered by
        # modern surveys. Exact leap-second tables are out of scope here.
        return None if self.mjd_mid is None else np.asarray(self.mjd_mid) + 37.0 / 86400.0

    def set_mjd_utc_mid(self, times):
        self.mjd_mid = None if times is None else np.asarray(times, dtype=float)

    @property
    def colnames(self):
        return self.table.colnames

    def get_num_times(self):
        """Number of observation times, from mjd_mid or the curve columns."""
        if self.mjd_mid is not None:
            return len(self.mjd_mid)
        for col in ("psi_curve", "phi_curve", "obs_valid"):
            if col in self.table.colnames:
                return self.table[col].shape[1]
        return 0

    def copy(self):
        return copy.deepcopy(self)

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @classmethod
    def from_trajectories(cls, trajectories, track_filtered=False):
        """Build from a list of Trajectory objects or a TrajectoryList."""
        if isinstance(trajectories, TrajectoryList):
            arrays = trajectories.get_arrays()
        else:
            arrays = trajectories_to_arrays(list(trajectories))
        data = {
            "x": arrays["x"].astype(int),
            "y": arrays["y"].astype(int),
            "vx": arrays["vx"].astype(float),
            "vy": arrays["vy"].astype(float),
            "likelihood": arrays["lh"].astype(float),
            "flux": arrays["flux"].astype(float),
            "obs_count": arrays["obs_count"].astype(int),
        }
        return cls(Table(data), track_filtered=track_filtered)

    def make_trajectory_list(self):
        """Create the list of ``Trajectory`` objects for this table."""
        t = self.table
        return [
            Trajectory(
                x=int(t["x"][i]),
                y=int(t["y"][i]),
                vx=float(t["vx"][i]),
                vy=float(t["vy"][i]),
                flux=float(t["flux"][i]),
                lh=float(t["likelihood"][i]),
                obs_count=int(t["obs_count"][i]),
            )
            for i in range(len(t))
        ]

    # ------------------------------------------------------------------
    # Column / likelihood management
    # ------------------------------------------------------------------

    def remove_column(self, colname):
        if colname not in self.table.colnames:
            raise KeyError(f"Column {colname} not found.")
        if colname in self._required_col_names:
            raise KeyError(f"Unable to drop required column {colname}.")
        self.table.remove_column(colname)

    def extend(self, results2):
        """Append the rows of another Results. Non-empty tables must share
        columns; an empty side adopts the other's schema."""
        if len(self) > 0 and len(results2) > 0 and set(self.colnames) != set(results2.colnames):
            raise ValueError("Column mismatch in extend().")
        self.table = vstack([self.table, results2.table])
        for label, count in results2.filtered_stats.items():
            self.filtered_stats[label] = self.filtered_stats.get(label, 0) + count
        if self.track_filtered:
            for label, tbl in results2.filtered.items():
                if label in self.filtered:
                    self.filtered[label] = vstack([self.filtered[label], tbl])
                else:
                    self.filtered[label] = tbl
        return self

    def extend_batches(self, batches):
        """Append many Results in ONE table copy.

        ``extend`` re-vstacks the accumulated table per call, which is
        quadratic over a long batch loop — at survey scale
        (load_and_filter_results walks ~85 batches of 100k rows whose
        psi/phi curves make rows ~1 KB) that is hundreds of GB of memcpy.
        Here every batch lands in a single vstack.
        """
        batches = list(batches)
        non_empty = [b for b in batches if len(b) > 0]
        for b in non_empty:
            if len(self) > 0 and set(self.colnames) != set(b.colnames):
                raise ValueError("Column mismatch in extend_batches().")
        if non_empty:
            self.table = vstack([self.table] + [b.table for b in non_empty])
        # Filter bookkeeping merges from EVERY batch — a batch whose rows
        # were all filtered away still carries its stats.
        for b in batches:
            for label, count in b.filtered_stats.items():
                self.filtered_stats[label] = self.filtered_stats.get(label, 0) + count
            if self.track_filtered:
                for label, tbl in b.filtered.items():
                    if label in self.filtered:
                        self.filtered[label] = vstack([self.filtered[label], tbl])
                    else:
                        self.filtered[label] = tbl
        return self

    def sort(self, colname, descending=True):
        if colname not in self.table.colnames:
            raise KeyError(f"Column {colname} not found.")
        self.table.sort(colname, reverse=descending)
        return self

    def compute_likelihood_curves(self, filter_obs=True, mask_value=0.0):
        """Per-row likelihood curves psi/sqrt(phi) with invalid samples set
        to ``mask_value``."""
        if "psi_curve" not in self.table.colnames:
            raise IndexError("Missing column 'psi_curve'. Use add_psi_phi_data()")
        if "phi_curve" not in self.table.colnames:
            raise IndexError("Missing column 'phi_curve'. Use add_psi_phi_data()")
        psi = np.asarray(self.table["psi_curve"])
        phi = np.asarray(self.table["phi_curve"])
        valid = (phi != 0) & np.isfinite(psi) & np.isfinite(phi)
        if filter_obs and "obs_valid" in self.table.colnames:
            valid &= np.asarray(self.table["obs_valid"], dtype=bool)
        lh = np.full(psi.shape, mask_value, dtype=np.float32)
        lh[valid] = psi[valid] / np.sqrt(phi[valid])
        return lh

    def _update_likelihood(self):
        """Recompute likelihood/flux/obs_count from curve columns (and
        obs_valid when present)."""
        n = len(self.table)
        if n == 0:
            return
        if "psi_curve" not in self.table.colnames or "phi_curve" not in self.table.colnames:
            raise IndexError("Missing psi/phi curve columns. Use add_psi_phi_data()")
        psi = np.asarray(self.table["psi_curve"])
        phi = np.asarray(self.table["phi_curve"])
        if "obs_valid" in self.table.colnames:
            ov = np.asarray(self.table["obs_valid"], dtype=bool)
            psi_sum = (psi * ov).sum(axis=1)
            phi_sum = (phi * ov).sum(axis=1)
            num_obs = ov.sum(axis=1)
        else:
            psi_sum = psi.sum(axis=1)
            phi_sum = phi.sum(axis=1)
            num_obs = np.full(n, psi.shape[1])
        nz = phi_sum != 0
        lh = np.zeros(n)
        lh[nz] = psi_sum[nz] / np.sqrt(phi_sum[nz])
        flux = np.zeros(n)
        flux[nz] = psi_sum[nz] / phi_sum[nz]
        self.table["likelihood"] = lh
        self.table["flux"] = flux
        self.table["obs_count"] = num_obs

    def add_psi_phi_data(self, psi_array, phi_array, obs_valid=None):
        """Set curve columns and recompute the trajectory statistics."""
        if len(psi_array) != len(self.table):
            raise ValueError(
                f"Wrong number of psi curves provided. Expected {len(self.table)} rows."
                f" Found {len(psi_array)} rows."
            )
        if len(phi_array) != len(self.table):
            raise ValueError(
                f"Wrong number of phi curves provided. Expected {len(self.table)} rows."
                f" Found {len(phi_array)} rows."
            )
        self.table["psi_curve"] = np.asanyarray(psi_array, dtype=np.float32)
        self.table["phi_curve"] = np.asanyarray(phi_array, dtype=np.float32)
        if obs_valid is not None:
            if len(obs_valid) != len(self.table):
                raise ValueError(
                    f"Wrong number of obs_valid provided. Expected {len(self.table)} rows."
                    f" Found {len(obs_valid)} rows."
                )
            self.table["obs_valid"] = np.asanyarray(obs_valid, dtype=bool)
        self._update_likelihood()
        return self

    def update_obs_valid(self, obs_valid, drop_empty_rows=True):
        """Set the obs_valid column; drop rows with zero valid observations
        and refresh the statistics."""
        if len(obs_valid) != len(self.table):
            raise ValueError(
                f"Wrong number of obs_valid lists provided. Expected {len(self.table)} rows"
                f" Found {len(obs_valid)} rows"
            )
        self.table["obs_valid"] = np.asanyarray(obs_valid, dtype=bool)
        self.table["obs_count"] = np.asarray(self.table["obs_valid"]).sum(axis=1)
        row_has_obs = np.asarray(self.table["obs_count"]) > 0
        if drop_empty_rows and not np.all(row_has_obs):
            self.filter_rows(row_has_obs, "no valid observations")
        if "psi_curve" in self.colnames and "phi_curve" in self.colnames:
            self._update_likelihood()
        return self

    # ------------------------------------------------------------------
    # Filtering bookkeeping
    # ------------------------------------------------------------------

    def is_empty_value(self, colname):
        """Boolean vector marking rows whose entry is None or length 0."""
        if colname not in self.table.colnames:
            raise KeyError(f"Querying unknown column {colname}")
        col = self.table[colname]
        result = np.full(len(self.table), False)
        if np.issubdtype(col.dtype, np.number):
            return result
        for idx, val in enumerate(col):
            if val is None or (hasattr(val, "__len__") and len(val) == 0):
                result[idx] = True
        return result

    def is_image_like(self, colname, max_rows=10):
        """True when the column holds 2D+ arrays (stamps etc.)."""
        if colname not in self.table.colnames:
            raise KeyError(f"Querying unknown column {colname}")
        shapes = self.table.meta.get("image_column_shapes", {})
        if colname in shapes:
            return True
        col = self.table[colname]
        if isinstance(col, np.ndarray) and col.dtype != object:
            return col.ndim >= 3
        max_rows = len(self.table) if max_rows is None else min(max_rows, len(self.table))
        for idx in range(max_rows):
            entry = col[idx]
            if isinstance(entry, np.ndarray) and entry.ndim >= 2:
                return True
        return False

    def filter_rows(self, rows, label=""):
        """Keep only the given rows (mask or index list), recording the
        removal count under ``label``."""
        logger.info(f"Applying filter={label} to results of size {len(self.table)}.")
        if len(self.table) == 0 or len(rows) == 0:
            self.filtered_stats[label] = self.filtered_stats.get(label, 0)
            return self
        rows = np.asarray(rows)
        if rows.dtype == bool:
            if len(rows) != len(self.table):
                raise ValueError(
                    f"Mask length mismatch. Expected {len(self.table)} rows, but found {len(rows)}."
                )
            mask = rows
        else:
            mask = np.full(len(self.table), False)
            mask[rows] = True

        removed = self.table[~mask]
        self.filtered_stats[label] = self.filtered_stats.get(label, 0) + len(removed)
        logger.debug(f"Filter={label} removed {len(removed)} entries.")
        if self.track_filtered:
            if label in self.filtered:
                self.filtered[label] = vstack([self.filtered[label], removed])
            else:
                self.filtered[label] = removed
        self.table = self.table[mask]
        return self

    def get_filtered(self, label=None):
        """The rows removed at one (or all) filter stages."""
        if not self.track_filtered:
            raise ValueError("ResultTable filter tracking not enabled.")
        if label is not None:
            return self.filtered.get(label, None)
        if not self.filtered:
            return None
        return vstack(list(self.filtered.values()))

    def revert_filter(self, label=None, add_column=None):
        """Re-append filtered rows (all labels, or one)."""
        if not self.track_filtered:
            raise ValueError("ResultTable filter tracking not enabled.")
        if label is not None:
            if label not in self.filtered:
                raise KeyError(f"Unknown filtered label {label}")
            to_revert = [label]
        else:
            to_revert = list(self.filtered.keys())

        if add_column is not None and add_column not in self.table.colnames:
            self.table[add_column] = np.full(len(self.table), "", dtype=object)

        tables = [self.table]
        for key in to_revert:
            logger.info(f"Reverting filter={key} with {self.filtered_stats[key]} entries.")
            removed = self.filtered[key]
            if add_column is not None and len(removed) > 0:
                removed[add_column] = np.full(len(removed), key, dtype=object)
            tables.append(removed)
            del self.filtered[key]
            del self.filtered_stats[key]
        self.table = vstack(tables)
        return self

    # ------------------------------------------------------------------
    # Serialization
    # ------------------------------------------------------------------

    def _detect_image_columns(self):
        """colname -> per-row shape for every image-like column."""
        shapes = {}
        for colname in self.table.colnames:
            col = self.table[colname]
            if isinstance(col, np.ndarray) and col.dtype != object and col.ndim >= 3:
                shapes[colname] = tuple(col.shape[1:])
            elif col.dtype == object and len(col) > 0:
                entry = col[0]
                if isinstance(entry, np.ndarray) and entry.ndim >= 2:
                    shapes[colname] = tuple(entry.shape)
        return shapes

    def _build_meta(self):
        meta = {}
        if self.wcs is not None:
            from kbmod_tpu_torch.wcs_utils import serialize_wcs

            meta["wcs"] = serialize_wcs(self.wcs)
        if self.mjd_mid is not None:
            meta["mjd_mid"] = list(np.asarray(self.mjd_mid, dtype=float))
        shapes = self._detect_image_columns()
        if shapes:
            meta["image_column_shapes"] = {k: list(v) for k, v in shapes.items()}
        return meta

    @staticmethod
    def _parse_table_metadata(meta):
        wcs = None
        if meta.get("wcs"):
            from kbmod_tpu_torch.wcs_utils import deserialize_wcs

            wcs = deserialize_wcs(meta["wcs"])
        mjd_mid = np.asarray(meta["mjd_mid"], dtype=float) if meta.get("mjd_mid") else None
        image_column_shapes = meta.get("image_column_shapes")
        return wcs, mjd_mid, image_column_shapes

    def _reshape_image_columns(self, image_column_shapes):
        """Restore (N, ...) shapes for image columns flattened by storage."""
        if not image_column_shapes or len(self) == 0:
            return
        for colname, shape in image_column_shapes.items():
            if colname not in self.table.colnames:
                continue
            col = self.table[colname]
            shape = tuple(int(s) for s in shape)
            if col.dtype == object:
                stacked = np.stack([np.asarray(entry).reshape(shape) for entry in col])
                self.table[colname] = stacked
            elif col.ndim == 2 and col.shape[1] == int(np.prod(shape)):
                self.table[colname] = col.reshape((len(col),) + shape)

    def write_table(self, filename, overwrite=True, cols_to_drop=(), extra_meta=None):
        """Write to .ecsv / .parquet / .parq / .hdf5, preserving metadata
        (WCS, times, image column shapes)."""
        from kbmod_tpu_torch.io import table_io

        logger.info(f"Saving results to {filename}")
        filepath = Path(filename)
        if filepath.suffix not in self._supported_formats:
            raise ValueError(f"Unsupported file type '{filepath.suffix}' use one of {self._supported_formats}.")
        if filepath.exists() and not overwrite:
            raise FileExistsError(f"File {filename} already exists.")

        out = self.table.copy()
        for col in cols_to_drop:
            if col in out.colnames and col not in self._required_col_names:
                out.remove_column(col)
        meta = self._build_meta()
        if extra_meta:
            meta.update(extra_meta)
        out.meta.update(meta)
        table_io.write_table(out, filepath)

    @classmethod
    def read_table(cls, filename, track_filtered=False, load_aux_files=False):
        """Read a Results file written by write_table."""
        from kbmod_tpu_torch.io import table_io

        logger.info(f"Reading results from {filename}")
        filepath = Path(filename)
        if not filepath.is_file():
            raise FileNotFoundError(f"File {filename} not found.")
        if filepath.suffix not in cls._supported_formats:
            raise ValueError(f"Unsupported file type '{filepath.suffix}' use one of {cls._supported_formats}.")
        data = table_io.read_table(filepath)
        wcs, mjd_mid, image_column_shapes = cls._parse_table_metadata(data.meta)
        results = cls(data, track_filtered=track_filtered, wcs=wcs)
        if mjd_mid is not None:
            results.set_mjd_utc_mid(mjd_mid)
        if load_aux_files:
            for aux_file in sorted(filepath.parent.glob(f"{filepath.stem}_*")):
                if aux_file.suffix not in cls._supported_formats and aux_file.suffix != ".npy":
                    continue
                colname = aux_file.stem.replace(f"{filepath.stem}_", "")
                logger.info(f"Loading column {colname} results from {aux_file}")
                results.load_column(aux_file, colname=colname)
        results._reshape_image_columns(data.meta.get("image_column_shapes"))
        return results

    @classmethod
    def read_table_chunks(cls, filename, chunk_size=10000):
        """Yield Results objects for chunks of a parquet results file."""
        import pyarrow.parquet as pq

        filepath = Path(filename)
        if not filepath.is_file():
            raise FileNotFoundError(f"File {filename} not found.")
        if filepath.suffix not in (".parquet", ".parq"):
            raise ValueError("Chunked reading currently only supported for parquet files.")

        from kbmod_tpu_torch.io import table_io

        pf = pq.ParquetFile(filename)
        meta = table_io.parquet_metadata(pf)
        wcs, mjd_mid, image_column_shapes = cls._parse_table_metadata(meta)
        for batch in pf.iter_batches(batch_size=chunk_size):
            tbl = table_io.arrow_batch_to_table(batch, meta)
            results = cls(tbl, track_filtered=False, wcs=wcs)
            if mjd_mid is not None:
                results.set_mjd_utc_mid(mjd_mid)
            results._reshape_image_columns(image_column_shapes)
            yield results

    def write_column(self, colname, filename, overwrite=True):
        """Write a single column (e.g. all_stamps) to its own file; .npy for
        numeric arrays, else a one-column table file."""
        if colname not in self.table.colnames:
            raise KeyError(f"Unknown column {colname}")
        filepath = Path(filename)
        if filepath.exists() and not overwrite:
            raise FileExistsError(f"File {filename} already exists.")
        col = self.table[colname]
        if filepath.suffix == ".npy":
            np.save(filepath, np.asarray(col))
        else:
            from kbmod_tpu_torch.io import table_io

            tbl = Table({colname: col, "uuid": self.table["uuid"]})
            shapes = {}
            if isinstance(col, np.ndarray) and col.dtype != object and col.ndim >= 3:
                shapes[colname] = list(col.shape[1:])
            tbl.meta["image_column_shapes"] = shapes
            table_io.write_table(tbl, filepath)

    def load_column(self, filename, colname=None):
        """Load a side-car column file written by write_column."""
        filepath = Path(filename)
        if not filepath.is_file():
            raise FileNotFoundError(f"File {filename} not found.")
        if colname is None:
            colname = filepath.stem
        if filepath.suffix == ".npy":
            data = np.load(filepath, allow_pickle=False)
            if len(data) != len(self.table):
                raise ValueError(
                    f"Column size mismatch. Expected {len(self.table)} rows. Found {len(data)}."
                )
            self.table[colname] = data
        else:
            from kbmod_tpu_torch.io import table_io

            tbl = table_io.read_table(filepath)
            if len(tbl) != len(self.table):
                raise ValueError(
                    f"Column size mismatch. Expected {len(self.table)} rows. Found {len(tbl)}."
                )
            self.table[colname] = tbl[colname]
            shapes = tbl.meta.get("image_column_shapes")
            if shapes:
                self._reshape_image_columns({colname: shapes[colname]} if colname in shapes else None)

    def write_filtered_stats(self, filename):
        """Write the filter label/count statistics as CSV."""
        with open(filename, "w") as f:
            f.write("unfiltered,%i\n" % len(self.table))
            for label, count in self.filtered_stats.items():
                f.write(f"{label},{count}\n")

    @classmethod
    def from_trajectory_file(cls, filename, track_filtered=False):
        """Load results from a legacy whitespace trajectory file
        ('lh: X flux: X x: X y: X vx: X vy: X obs_count: X' per line)."""
        filepath = Path(filename)
        if not filepath.is_file():
            raise FileNotFoundError(f"File {filename} not found.")
        trajectories = []
        pattern = re.compile(
            r"lh:\s*(\S+)\s+flux:\s*(\S+)\s+x:\s*(\S+)\s+y:\s*(\S+)\s+vx:\s*(\S+)\s+vy:\s*(\S+)\s+obs_count:\s*(\S+)"
        )
        with open(filepath) as f:
            for line in f:
                m = pattern.search(line)
                if m:
                    lh, flux, x, y, vx, vy, obs = m.groups()
                    trajectories.append(
                        Trajectory(
                            x=int(x), y=int(y), vx=float(vx), vy=float(vy),
                            flux=float(flux), lh=float(lh), obs_count=int(obs),
                        )
                    )
        return cls.from_trajectories(trajectories, track_filtered=track_filtered)


def write_results_to_files_destructive(
    filename, results, separate_col_files=None, drop_columns=None, extra_meta=None, overwrite=True
):
    """Write results, splitting regex-matched columns into side files
    ({stem}_{col}{suffix}) and dropping requested columns. Destructive: the
    split/dropped columns are removed from ``results`` to save memory.

    Mirrors reference results.py:1271-1367.
    """
    separate_col_files = separate_col_files or []
    drop_columns = drop_columns or []
    filepath = Path(filename)

    image_col_shapes = results._detect_image_columns()

    # Resolve regex lists to actual columns.
    to_split = set()
    for pattern in separate_col_files:
        regex = re.compile(pattern)
        to_split.update(c for c in results.colnames if regex.fullmatch(c))
    to_drop = set()
    for pattern in drop_columns:
        regex = re.compile(pattern)
        to_drop.update(c for c in results.colnames if regex.fullmatch(c))
    to_drop -= Results._required_col_names
    to_split -= Results._required_col_names

    for colname in sorted(to_split):
        side_file = filepath.parent / f"{filepath.stem}_{colname}{filepath.suffix}"
        results.write_column(colname, side_file, overwrite=overwrite)
        results.table.remove_column(colname)

    for colname in sorted(to_drop):
        if colname in results.colnames:
            results.table.remove_column(colname)

    meta = dict(extra_meta or {})
    if image_col_shapes:
        meta["image_column_shapes"] = {c: list(s) for c, s in image_col_shapes.items()}
    results.write_table(filepath, overwrite=overwrite, extra_meta=meta)
