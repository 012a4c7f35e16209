"""Known-object matching and filtering.

Behavior-compatible with the reference's kbmod.filters.known_object_filters
(src/kbmod/filters/known_object_filters.py): match result trajectories'
per-time (RA, Dec) predictions against a catalog of known-object
ephemerides within a separation/time threshold, mark matched observations
invalid, and account recovered/missed objects.

The sky match uses a cKDTree over 3D unit vectors (chord-distance
threshold) instead of astropy's search_around_sky. Copy of the JAX
package's filters/known_object_filters.py (host numpy and scipy).
"""

import logging
from collections import Counter

import numpy as np
from scipy.spatial import cKDTree

from kbmod_tpu_torch.geom.ecliptic import radec_unit_vector
from kbmod_tpu_torch.trajectory_utils import trajectory_predict_skypos

logger = logging.getLogger(__name__)


class KnownObjsMatcher:
    """Match KBMOD results against a known-object observation catalog.

    Parameters
    ----------
    table : Table
        Catalog of known-object observations (mjd/ra/dec/name columns).
    obstimes : array
        The MJD times of the result observations.
    matcher_name : str
        Label for the match column and log messages.
    sep_thresh : float
        Maximum separation (arcsec) to count a match.
    time_thresh_s : float
        Maximum time separation (seconds) to count a match.
    """

    def __init__(
        self,
        table,
        obstimes,
        matcher_name,
        sep_thresh=1.0,
        time_thresh_s=600.0,
        mjd_col="mjd_mid",
        ra_col="RA",
        dec_col="DEC",
        name_col="Name",
    ):
        self.data = table
        self.mjd_col = mjd_col
        self.ra_col = ra_col
        self.dec_col = dec_col
        self.name_col = name_col

        missing = {mjd_col, ra_col, dec_col, name_col} - set(self.data.colnames)
        if missing:
            raise ValueError(f"{missing} not found in KnownObjs data.")

        self.obstimes = np.asarray(obstimes)
        if len(self.obstimes) == 0:
            raise ValueError("No obstimes provided")

        self.matcher_name = matcher_name
        self.sep_thresh_arcsec = sep_thresh
        self.time_thresh_s = time_thresh_s

        # Restrict the catalog to the temporally relevant window.
        time_thresh_days = time_thresh_s / 86400.0
        start_mjd = max(0, self.obstimes.min() - time_thresh_days - 1e-6)
        end_mjd = self.obstimes.max() + time_thresh_days + 1e-6
        mjds = np.asarray(self.data[self.mjd_col], dtype=float)
        self.data = self.data[(mjds >= start_mjd) & (mjds <= end_mjd)]

        self._tree = None

    def __len__(self):
        return len(self.data)

    def get_mjd(self, ko_idx):
        return float(self.data[self.mjd_col][ko_idx])

    def get_ra(self, ko_idx):
        return float(self.data[self.ra_col][ko_idx])

    def get_dec(self, ko_idx):
        return float(self.data[self.dec_col][ko_idx])

    def to_skycoords(self):
        """The catalog positions as a SkyCoordLite (known_object_filters.py:146)."""
        from kbmod_tpu_torch.geom.wcs import SkyCoordLite

        return SkyCoordLite(
            np.asarray(self.data[self.ra_col], dtype=float),
            np.asarray(self.data[self.dec_col], dtype=float),
        )

    def get_name(self, ko_idx):
        return self.data[self.name_col][ko_idx]

    def match_min_obs_col(self, min_obs):
        """Column name for min-obs recovery accounting."""
        return f"recovered_{self.matcher_name}_min_obs_{min_obs}"

    def match_obs_ratio_col(self, obs_ratio):
        """Column name for obs-ratio recovery accounting."""
        return f"recovered_{self.matcher_name}_obs_ratio_{obs_ratio}"

    def _catalog_tree(self):
        if self._tree is None and len(self.data) > 0:
            vecs = radec_unit_vector(
                np.asarray(self.data[self.ra_col], dtype=float),
                np.asarray(self.data[self.dec_col], dtype=float),
            )
            self._tree = cKDTree(vecs)
        return self._tree

    def match(self, result_data, wcs):
        """Add the ``matcher_name`` column: per result, a dict mapping known
        object names to boolean arrays of which observations matched."""
        logger.info(f"Matching known objects to {len(result_data)} results using {self.matcher_name} filter")
        all_matches = []
        tree = self._catalog_tree()
        # Chord distance equivalent of the angular threshold.
        chord = 2.0 * np.sin(np.radians(self.sep_thresh_arcsec / 3600.0) / 2.0)
        cat_mjds = np.asarray(self.data[self.mjd_col], dtype=float) if len(self.data) else np.array([])

        trj_list = result_data.make_trajectory_list()
        obs_valid_col = (
            np.asarray(result_data["obs_valid"], dtype=bool)
            if "obs_valid" in result_data.colnames
            else np.ones((len(result_data), len(self.obstimes)), dtype=bool)
        )

        for result_idx in range(len(result_data)):
            matched_known_objs = {}
            if tree is not None:
                valid_mask = obs_valid_col[result_idx]
                valid_obstimes = self.obstimes[valid_mask]
                trj_idx_to_obs_idx = np.nonzero(valid_mask)[0]
                if len(valid_obstimes) > 0:
                    coords = trajectory_predict_skypos(trj_list[result_idx], wcs, valid_obstimes)
                    vecs = radec_unit_vector(coords.ra_deg, coords.dec_deg)
                    neighbor_lists = tree.query_ball_point(np.atleast_2d(vecs), chord)
                    for t_idx, neighbors in enumerate(neighbor_lists):
                        for ko_idx in neighbors:
                            if abs(cat_mjds[ko_idx] - valid_obstimes[t_idx]) * 86400.0 <= self.time_thresh_s:
                                obj_name = self.get_name(ko_idx)
                                if obj_name not in matched_known_objs:
                                    matched_known_objs[obj_name] = [False] * len(self.obstimes)
                                matched_known_objs[obj_name][trj_idx_to_obs_idx[t_idx]] = True
            all_matches.append(matched_known_objs)

        result_data.table[self.matcher_name] = np.array(all_matches, dtype=object)
        return result_data

    def mark_matched_obs_invalid(self, result_data, drop_empty_rows=True):
        """Invalidate observations that matched any known object."""
        if len(result_data) == 0 or len(self.obstimes) == 0 or len(self.data) == 0:
            return result_data
        if self.matcher_name not in result_data.table.colnames:
            raise ValueError(f"Column {self.matcher_name} not found in results table. Please run match() first.")

        matched_known_objs = result_data.table[self.matcher_name]
        new_obs_valid = np.asarray(result_data["obs_valid"], dtype=bool).copy()
        for result_idx in range(len(result_data)):
            matches = matched_known_objs[result_idx]
            if matches:
                any_matched = np.any(np.array(list(matches.values()), dtype=bool), axis=0)
                new_obs_valid[result_idx] &= ~any_matched
        return result_data.update_obs_valid(new_obs_valid, drop_empty_rows=drop_empty_rows)

    def match_on_min_obs(self, result_data, min_obs):
        """Add a recovery column: names matched by >= min_obs observations."""
        if self.matcher_name not in result_data.table.colnames:
            raise ValueError(f"Column {self.matcher_name} not found in results table. Please run match() first.")
        matched_objs = []
        for idx in range(len(result_data)):
            names = set()
            for name, mask in result_data[self.matcher_name][idx].items():
                if np.count_nonzero(mask) >= min_obs:
                    names.add(name)
            matched_objs.append(list(names))
        result_data.table[self.match_min_obs_col(min_obs)] = np.array(matched_objs, dtype=object)
        return result_data

    def match_on_obs_ratio(self, result_data, obs_ratio):
        """Add a recovery column: names whose matched fraction of catalog
        observations is <= obs_ratio."""
        if obs_ratio < 0 or obs_ratio > 1:
            raise ValueError("obs_ratio must be within the range [0, 1].")
        if self.matcher_name not in result_data.table.colnames:
            raise ValueError(f"Column {self.matcher_name} not found in results table. Please run match() first.")

        known_obj_cnts = dict(Counter(self.data[self.name_col]))
        matched_objs = []
        for idx in range(len(result_data)):
            names = set()
            for name, mask in result_data[self.matcher_name][idx].items():
                if name not in known_obj_cnts:
                    raise ValueError(f"Unknown known object {name}")
                if np.count_nonzero(mask) / known_obj_cnts[name] <= obs_ratio:
                    names.add(name)
            matched_objs.append(list(names))
        result_data.table[self.match_obs_ratio_col(obs_ratio)] = np.array(matched_objs, dtype=object)
        return result_data

    def get_recovered_objects(self, result_data, match_col):
        """(recovered, missed) object-name sets under a match column."""
        if match_col not in result_data.table.colnames:
            raise ValueError(f"Column {match_col} not found in results table.")
        if len(result_data) == 0 or len(self.data) == 0:
            return set(), set()
        expected = set(self.data[self.name_col])
        matched = set()
        for idx in range(len(result_data)):
            matched.update(result_data[match_col][idx])
        recovered = matched & expected
        return recovered, expected - recovered

    def filter_matches(self, result_data, match_col):
        """Keep only results that matched no known object."""
        if match_col not in result_data.table.colnames:
            raise ValueError(f"Column {match_col} not found in results table.")
        if len(result_data) == 0:
            return result_data
        keep = np.array([len(x) == 0 for x in result_data[match_col]])
        result_data.filter_rows(keep, match_col)
        return result_data


def apply_known_obj_filters(result_data, known_objs, wcs, filter_params):
    """Convenience wrapper: match, mark invalid, and refilter."""
    known_objs.match(result_data, wcs)
    known_objs.mark_matched_obs_invalid(result_data)
    return result_data
