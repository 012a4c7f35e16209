"""Visualizer: batch stamp/lightcurve visualization for a Results set.

Reference: src/kbmod/analysis/visualizer.py. The JAX package's module, but
for ``device``: the stamps are cut on the card unless ``device="cpu"``, as
the port's ``TrajectoryExplorer`` does.
"""

import numpy as np

from kbmod_tpu_torch.analysis.plotting import plot_multiple_images, plot_result_row
from kbmod_tpu_torch.device import resolve_device
from kbmod_tpu_torch.filters.stamp_filters import append_all_stamps

__all__ = ["Visualizer"]


class Visualizer:
    """Visualize the stamps and curves of a Results set against its image
    stack."""

    def __init__(self, im_stack, results, device=None):
        self.im_stack = im_stack
        self.results = results
        self.device = resolve_device(device)

    def generate_all_stamps(self, radius=10):
        """Ensure the all_stamps column exists."""
        if "all_stamps" not in self.results.colnames:
            append_all_stamps(self.results, self.im_stack, radius, device=self.device)

    def count_num_days(self):
        """The number of distinct observation days."""
        from kbmod_tpu_torch.geom.time_utils import mjd_to_day_string

        return len({mjd_to_day_string(t) for t in self.im_stack.times})

    def plot_stamps(self, result_idx, columns=5, figure=None):
        """Grid of per-time stamps for one result."""
        self.generate_all_stamps()
        stamps = np.asanyarray(self.results["all_stamps"][result_idx])
        labels = [f"t={t:.2f}" for t in self.im_stack.zeroed_times]
        return plot_multiple_images(list(stamps), labels=labels, columns=columns, figure=figure)

    def plot_result_summary(self, result_idx, figure=None):
        """Stamp + curve summary for one result."""
        return plot_result_row(self.results.table[result_idx], times=self.im_stack.zeroed_times, figure=figure)
