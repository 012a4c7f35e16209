"""Analysis of inserted fake objects: per-fake bookkeeping + recovery
rates (reference: src/kbmod/analysis/analyze_fakes.py).

``FakeInfo`` carries one fake's observations (times/RA/Dec/mag), joins
them against a WorkUnit (pixel positions, in-bounds mask, fitted linear
trajectory, stamps at raw and predicted positions) and plots summaries;
``load_fake_info_from_ecsv`` reads the survey fakes file. The
recovery-rate helpers quantify how many fakes a search found. The JAX
package's module with its imports re-pointed: host numpy throughout, the
stamps cut by the port's host ``core/stamp_utils``.
"""

import csv
import logging

import numpy as np

from kbmod_tpu_torch.trajectory_utils import (
    evaluate_trajectory_mse,
    fit_trajectory_from_pixels,
    match_trajectory_sets,
)
from kbmod_tpu_torch.util_functions import get_matched_obstimes

logger = logging.getLogger(__name__)

__all__ = [
    "FakeInfo",
    "load_fake_info_from_ecsv",
    "compute_recovery_rates",
    "recovery_report",
]


class FakeInfo:
    """One fake object's observations plus derived search-frame data.

    Parameters
    ----------
    times, ra, dec : arrays
        MJD times and sky positions (degrees) of the fake.
    mag : array, optional
        Magnitudes (zeros when absent).
    name : str, optional
        Object identifier.

    After :meth:`join_with_workunit`: ``image_inds`` (stack index per
    observation), ``x_pos_fakes``/``y_pos_fakes`` (pixel positions),
    ``in_image_bnds`` (on-chip mask), ``trj`` (fitted linear
    trajectory), ``xy_stamps``/``trj_stamps`` (stamp stacks at the raw
    and predicted positions). Mirrors the reference FakeInfo
    (analyze_fakes.py:13-247).
    """

    def __init__(self, times, ra, dec, mag=None, name=None):
        self.name = name
        self.times = np.asarray(times, dtype=float)
        self.ra = np.asarray(ra, dtype=float)
        self.dec = np.asarray(dec, dtype=float)
        self.mag = np.asarray(mag, dtype=float) if mag is not None else np.zeros(len(self.times))
        self._validate_times()

        self.image_inds = None
        self.x_pos_fakes = None
        self.y_pos_fakes = None
        self.in_image_bnds = None
        self.trj = None
        self.xy_stamps = None
        self.trj_stamps = None

    def _validate_times(self):
        """Sort by time and drop duplicate epochs."""
        order = np.argsort(self.times)
        self.times = self.times[order]
        self.ra = self.ra[order]
        self.dec = self.dec[order]
        self.mag = self.mag[order]
        if np.any(np.diff(self.times) == 0.0):
            dup = np.where(np.diff(self.times) == 0.0)
            self.times = np.delete(self.times, dup)
            self.ra = np.delete(self.ra, dup)
            self.dec = np.delete(self.dec, dup)
            self.mag = np.delete(self.mag, dup)

    def __len__(self):
        return len(self.times)

    @property
    def num_times_seen(self):
        if self.in_image_bnds is None:
            raise ValueError("Must call join_with_workunit first.")
        return int(np.count_nonzero(self.in_image_bnds))

    def join_with_workunit(self, wu, radius=10):
        """Derive search-frame data from a WorkUnit: image indices, pixel
        positions, in-bounds mask, fitted trajectory and (for radius > 0)
        stamp stacks at the raw and fitted positions."""
        obstimes = np.asarray(wu.get_all_obstimes())
        t0 = obstimes[0]

        self.image_inds = np.asarray(
            get_matched_obstimes(obstimes, self.times, threshold=0.002)
        )
        if np.any(self.image_inds == -1):
            raise ValueError(
                f"Unable to match one or more of the times:\n{obstimes}\n{self.times}"
            )

        x_pos, y_pos = wu.get_pixel_coordinates(self.ra, self.dec, self.times)
        self.x_pos_fakes = np.asarray(x_pos, dtype=float)
        self.y_pos_fakes = np.asarray(y_pos, dtype=float)

        in_x = (self.x_pos_fakes >= 0) & (self.x_pos_fakes < wu.im_stack.width)
        in_y = (self.y_pos_fakes >= 0) & (self.y_pos_fakes < wu.im_stack.height)
        self.in_image_bnds = in_x & in_y

        zeroed = self.times - t0
        self.trj = fit_trajectory_from_pixels(self.x_pos_fakes, self.y_pos_fakes, zeroed)

        if radius > 0:
            from kbmod_tpu_torch.core.stamp_utils import create_stamps_from_image_stack_xy

            xy_list = create_stamps_from_image_stack_xy(
                wu.im_stack, radius,
                self.x_pos_fakes.astype(int), self.y_pos_fakes.astype(int),
                list(self.image_inds),
            )
            trj_list = create_stamps_from_image_stack_xy(
                wu.im_stack, radius,
                (self.trj.x + self.trj.vx * zeroed + 0.5).astype(int),
                (self.trj.y + self.trj.vy * zeroed + 0.5).astype(int),
                list(self.image_inds),
            )
            self.xy_stamps = np.asarray(xy_list, dtype=np.float32)
            self.trj_stamps = np.asarray(trj_list, dtype=np.float32)

    def compute_fit_mse(self):
        """Mean squared pixel error of the fitted trajectory."""
        if self.trj is None:
            raise ValueError("compute_fit_mse can only be called after join_with_workunit.")
        return evaluate_trajectory_mse(
            self.trj, self.x_pos_fakes, self.y_pos_fakes, self.times - self.times[0]
        )

    def compare_stamps(self, inds=None):
        """Plot raw-position vs predicted-position stamp pairs."""
        if self.xy_stamps is None or self.trj_stamps is None:
            raise ValueError("compare_stamps can only be called after join_with_workunit.")
        import matplotlib.pyplot as plt

        from kbmod_tpu_torch.analysis.plotting import plot_image

        if inds is None:
            inds = list(range(len(self.xy_stamps)))
        fig, axes = plt.subplots(len(inds), 2, figsize=(6.0, 3.0 * len(inds)), squeeze=False)
        fig.tight_layout()
        for i, index in enumerate(inds):
            plot_image(
                self.xy_stamps[index], ax=axes[i, 0], figure=fig, norm=True,
                title=f"Fake Given Pos\n({self.times[index]})", show_counts=False,
            )
            plot_image(
                self.trj_stamps[index], ax=axes[i, 1], figure=fig, norm=True,
                title=f"Trj Predicted Pos\n({self.times[index]})", show_counts=False,
            )
        plt.show()
        return fig

    def plot_summary(self, figure=None, title=None):
        """RA/Dec/mag vs time summary panels."""
        import matplotlib.pyplot as plt

        if figure is None:
            figure = plt.figure(figsize=(9.0, 3.0), layout="constrained")
        if title is None:
            title = f"{self.name} ({len(self.times)} obs)"
        ax = figure.subplots(1, 3)
        for a, vals, label in (
            (ax[0], self.ra, "RA (deg)"),
            (ax[1], self.dec, "DEC (deg)"),
            (ax[2], self.mag, "Mag"),
        ):
            a.plot(self.times, vals, marker="o", color="black")
            a.set_xlabel("Time (days)")
            a.set_ylabel(label)
        ax[0].set_title("RA vs Time")
        ax[1].set_title("DEC vs Time")
        ax[2].set_title("Mag vs Time")
        figure.suptitle(title)
        plt.show()
        return figure


def load_fake_info_from_ecsv(filename, time_adjust=0.00112558):
    """Load FakeInfo objects from the survey fakes file (space-separated
    with ORBITID/RA/DEC/mjd_mid/MAG columns and '#' comments;
    reference analyze_fakes.py:249-282)."""
    logger.info(f"Loading fakes from {filename}")
    rows = []
    with open(filename, newline="") as f:
        header = None
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if header is None:
                header = parts
                continue
            rows.append(dict(zip(header, parts)))
    logger.info(f"Loaded the fakes file with {len(rows)} rows.")

    by_obj = {}
    for row in rows:
        by_obj.setdefault(row["ORBITID"], []).append(row)
    logger.info(f"Found {len(by_obj)} unique objects.")

    fakes = []
    for obj, obj_rows in by_obj.items():
        fakes.append(
            FakeInfo(
                times=[float(r["mjd_mid"]) + time_adjust for r in obj_rows],
                ra=[float(r["RA"]) for r in obj_rows],
                dec=[float(r["DEC"]) for r in obj_rows],
                mag=[float(r.get("MAG", 0.0)) for r in obj_rows],
                name=obj,
            )
        )
    return fakes


def compute_recovery_rates(fake_trjs, results, times, threshold=5.0, by=None):
    """Fraction of fake trajectories recovered in a Results set.

    Parameters
    ----------
    fake_trjs : list of Trajectory
        The inserted fakes.
    results : Results
        The search output.
    times : array
        Zero-shifted sample times for path matching.
    threshold : float
        Mean path distance (pixels) to count as recovered.
    by : array, optional
        A per-fake grouping value (e.g. magnitude bins); when given,
        returns a dict group -> recovery fraction.

    Returns
    -------
    float or dict
    """
    if len(fake_trjs) == 0:
        return {} if by is not None else 0.0
    base = results.make_trajectory_list()
    if len(base) == 0:
        recovered = np.zeros(len(fake_trjs), dtype=bool)
    else:
        sample_times = [0.0, float(np.max(times)) / 2.0, float(np.max(times))]
        matches = match_trajectory_sets(fake_trjs, base, threshold, times=sample_times)
        recovered = matches >= 0

    if by is None:
        return float(np.mean(recovered))
    by = np.asarray(by)
    return {val: float(np.mean(recovered[by == val])) for val in np.unique(by)}


def recovery_report(fake_trjs, results, times, threshold=5.0):
    """Print a recovery summary and return the per-fake recovery mask."""
    base = results.make_trajectory_list()
    sample_times = [0.0, float(np.max(times)) / 2.0, float(np.max(times))]
    if len(base) == 0:
        matches = np.full(len(fake_trjs), -1)
    else:
        matches = match_trajectory_sets(fake_trjs, base, threshold, times=sample_times)
    recovered = matches >= 0
    print(f"Recovered {np.count_nonzero(recovered)} / {len(fake_trjs)} fakes.")
    for i, trj in enumerate(fake_trjs):
        status = f"-> result {matches[i]}" if recovered[i] else "MISSED"
        print(f"  fake {i}: x={trj.x} y={trj.y} vx={trj.vx:.2f} vy={trj.vy:.2f} flux={trj.flux:.1f} {status}")
    return recovered
