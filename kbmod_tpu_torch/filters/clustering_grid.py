"""Online spatial-hash clustering of trajectories.

Port of the JAX package's filters/clustering_grid.py, behavior-compatible
with the reference's kbmod.filters.clustering_grid
(src/kbmod/filters/clustering_grid.py): trajectories hash into a
(start_bin_x, start_bin_y, end_bin_x, end_bin_y) 4-tuple, keeping the
highest-likelihood trajectory per bin. The bulk path
(``grid_keep_indices``) replaces the per-trajectory Python loop with the
native C++ hash map (kbmod_tpu_torch.native) or, where that library is
unavailable or the bins leave its packed-key range, a numpy lexsort: the
form the pipeline uses for millions of raw results. Both give the same rows.
"""

import numpy as np


def _bin_indices(x0, y0, vx, vy, bin_width, max_time):
    """Vectorized 4-tuple bins: int(v / width) truncation, matching the
    reference's int() casts (clustering_grid.py:73-76)."""
    xs_bin = (np.asarray(x0, dtype=np.float64) / bin_width).astype(np.int64)
    ys_bin = (np.asarray(y0, dtype=np.float64) / bin_width).astype(np.int64)
    xe_bin = ((np.asarray(x0) + max_time * np.asarray(vx, dtype=np.float64)) / bin_width).astype(np.int64)
    ye_bin = ((np.asarray(y0) + max_time * np.asarray(vy, dtype=np.float64)) / bin_width).astype(np.int64)
    return xs_bin, ys_bin, xe_bin, ye_bin


def grid_keep_indices(x0, y0, vx, vy, lh, bin_width, max_time):
    """Vectorized best-per-bin selection.

    Returns the indices (ascending) of the best-likelihood trajectory per
    occupied bin; ties keep the earliest index (the reference's '>' update
    rule keeps the first-seen on ties, clustering_grid.py:87).

    Uses the native C++ hash-map path (kbmod_tpu_torch.native.grid_dedup) when
    the bin coordinates fit its packed-key range; falls back to a numpy
    lexsort over (bin, -lh, index).
    """
    n = len(x0)
    if n == 0:
        return np.array([], dtype=int)

    from kbmod_tpu_torch import native

    bins_preview = _bin_indices(x0, y0, vx, vy, bin_width, max_time)
    if native.available() and all(np.abs(b).max(initial=0) < 32000 for b in bins_preview):
        kept = native.grid_dedup(x0, y0, vx, vy, lh, bin_width, max_time)
        if kept is not None:
            return kept

    bins = np.stack(_bin_indices(x0, y0, vx, vy, bin_width, max_time), axis=1)
    # Sort by bin then by descending lh then ascending index (stable).
    order = np.lexsort((np.arange(n), -np.asarray(lh, dtype=np.float64), bins[:, 3], bins[:, 2], bins[:, 1], bins[:, 0]))
    sorted_bins = bins[order]
    first = np.ones(n, dtype=bool)
    if n > 1:
        first[1:] = np.any(sorted_bins[1:] != sorted_bins[:-1], axis=1)
    return np.sort(order[first])


class TrajectoryClusterGrid:
    """A spatial hash keeping the best trajectory per (start, end) bin."""

    def __init__(self, bin_width=10, max_time=1.0):
        if bin_width < 1 or not np.isfinite(bin_width):
            raise ValueError(f"Bin width must be at least 1. Got {bin_width}.")
        if max_time < 0 or not np.isfinite(max_time):
            raise ValueError(f"Max time must be >= 0. Got {max_time}.")
        self.bin_width = bin_width
        self.max_time = max_time
        self.table = {}
        self.count = {}
        self.idx_table = {}
        self.total_count = 0

    def __len__(self):
        return len(self.table)

    def _key(self, trj):
        return (
            int(trj.x / self.bin_width),
            int(trj.y / self.bin_width),
            int((trj.x + self.max_time * trj.vx) / self.bin_width),
            int((trj.y + self.max_time * trj.vy) / self.bin_width),
        )

    def add_trajectory(self, trj, idx=None):
        """Insert one trajectory, keeping the best lh per bin."""
        if idx is None:
            idx = self.total_count
        key = self._key(trj)
        old = self.table.get(key)
        if old is None:
            self.table[key] = trj
            self.count[key] = 1
            self.idx_table[key] = idx
        else:
            if trj.lh > old.lh:
                self.table[key] = trj
                self.idx_table[key] = idx
            self.count[key] += 1
        self.total_count += 1

    def add_trajectory_list(self, trj_list):
        for trj in trj_list:
            self.add_trajectory(trj)
        # add_trajectory already advances total_count per insert.

    def get_trajectories(self):
        return list(self.table.values())

    def get_indices(self):
        return list(self.idx_table.values())


def apply_trajectory_grid_filter(trajectories, bin_width, max_dt):
    """Remove near-duplicates via the cluster grid.

    Accepts a list of Trajectory or a struct-of-arrays dict; uses the
    vectorized path for arrays. Returns (kept_trajectories, kept_indices).
    """
    if isinstance(trajectories, dict):
        idx = grid_keep_indices(
            trajectories["x"], trajectories["y"], trajectories["vx"], trajectories["vy"],
            trajectories["lh"], bin_width, max_dt,
        )
        kept = {k: np.asarray(v)[idx] for k, v in trajectories.items()}
        return kept, list(idx)

    grid_filter = TrajectoryClusterGrid(bin_width=bin_width, max_time=max_dt)
    for idx, trj in enumerate(trajectories):
        grid_filter.add_trajectory(trj, idx=idx)
    return grid_filter.get_trajectories(), grid_filter.get_indices()
