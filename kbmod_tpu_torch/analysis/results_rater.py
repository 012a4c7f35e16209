"""Interactive matplotlib rater for classifying search results.

The JAX package's ``analysis/results_rater.py`` with its imports re-pointed;
that module is the counterpart of the reference's ``analysis/results_rater.py``
(results_rater.py:10-497): steps through a ``Results`` table one row at a
time showing coadd stamps, psi/phi light curves and scalar statistics, and
lets the user assign a classification label (written to a ``user_class``
column) plus free-form ``notes``, saving back to disk. Navigation: arrow
keys / prev-next buttons, digit keys for labels, escape to quit.

Headless-safe: the figure is only created on construction and ``show()``
is a no-op under a non-interactive backend, so the class is fully testable
without a display.
"""

import numpy as np

from kbmod_tpu_torch.analysis.plotting import plot_image, plot_time_series
from kbmod_tpu_torch.results import Results

__all__ = ["ResultsRater", "extract_results_row_scalars"]


def extract_results_row_scalars(results, idx):
    """Return a dict of the scalar-valued columns of row ``idx``
    (results_rater.py:474-497)."""
    if idx < 0 or idx >= len(results):
        raise IndexError(f"Index {idx} out of bounds for {len(results)} entries.")
    values = {}
    for col_key in results.colnames:
        entry = results[col_key][idx]
        if np.isscalar(entry):
            values[col_key] = entry
    return values


class ResultsRater:
    """Visualize and hand-classify rows of a `Results` object
    (results_rater.py:10-76).

    Parameters
    ----------
    results : `Results` or `str`
        The results table, or a filename to load it from.
    outfile : `str`, optional
        Where "save" writes the updated table (default
        ``updated_results.ecsv``).
    stamp_size : `float`
        Stamp panel size in inches.
    """

    _labels = ["Not Classified (0)", "Valid (1)", "Noise (2)", "Unknown (3)"]

    def __init__(self, results, outfile=None, stamp_size=2.0):
        if isinstance(results, str):
            results = Results.read_table(results)
        elif not isinstance(results, Results):
            raise TypeError("results must be a Results object or a filename string.")
        if stamp_size <= 0:
            raise ValueError("stamp_size must be positive.")
        self.results = results
        self.outfile = outfile if outfile is not None else "updated_results.ecsv"
        self.stamp_size = stamp_size
        self.idx = 0
        self.is_running = True

        if results.mjd_mid is not None:
            self.times = np.asarray(results.mjd_mid)
        else:
            self.times = np.arange(results.get_num_times())

        self.coadds = [c for c in results.colnames if c.startswith("coadd_")]

        # User-input columns created on demand so re-rating a saved file
        # keeps earlier classifications.
        if "notes" not in results.colnames:
            results.table["notes"] = np.full(len(results), "", dtype=object)
        if "user_class" not in results.colnames:
            results.table["user_class"] = np.full(len(results), self._labels[0], dtype=object)

        self._figure = None
        self._ax_map = {}
        self._controls = {}
        self._setup_figure()

    @classmethod
    def from_file(cls, filename, stamp_size=2.0):
        """Load results from ``filename`` and write ratings back to it."""
        return cls(Results.read_table(filename), outfile=filename, stamp_size=stamp_size)

    # --- persistence ---

    def save_to_file(self, filename):
        if len(filename) < 1:
            raise ValueError("Filename must be a non-empty string.")
        self.results.write_table(filename, overwrite=True)

    # --- navigation / classification ---

    def set_class(self, label_idx):
        """Assign label ``label_idx`` (index into ``_labels``) to the
        current row."""
        self.results["user_class"][self.idx] = self._labels[int(label_idx)]
        self._update_controls()

    def set_notes(self, text):
        self.results["notes"][self.idx] = str(text)

    def next_result(self, event=None):
        if self.idx < len(self.results) - 1:
            self.idx += 1
            self.update_all()

    def previous_result(self, event=None):
        if self.idx > 0:
            self.idx -= 1
            self.update_all()

    def goto_index(self, idx):
        idx = int(idx)
        if 0 <= idx < len(self.results):
            self.idx = idx
            self.update_all()

    def stop(self, event=None):
        import matplotlib.pyplot as plt

        self.is_running = False
        if self._figure is not None:
            plt.close(self._figure)

    def _on_key_press(self, event):
        if event.key == "right":
            self.next_result()
        elif event.key == "left":
            self.previous_result()
        elif event.key == "escape":
            self.stop()
        elif event.key is not None and event.key.isdigit() and int(event.key) < len(self._labels):
            self.set_class(int(event.key))

    # --- widget callbacks ---

    def _update_label(self, event=None):
        chosen = self._controls["radio"].value_selected
        self.results["user_class"][self.idx] = chosen

    def _update_notes(self, event=None):
        self.set_notes(self._controls["notes"].text)

    def _update_outfile(self, event=None):
        self.outfile = self._controls["outfile"].text

    def _save_button(self, event=None):
        self._update_notes()
        self._update_outfile()
        self.save_to_file(self.outfile)

    def _goto_button(self, event=None):
        try:
            self.goto_index(int(self._controls["goto"].text))
        except ValueError:
            pass

    # --- figure assembly ---

    def _setup_figure(self):
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Button, RadioButtons, TextBox

        n_stamps = max(len(self.coadds), 1)
        width = max(4, n_stamps) * self.stamp_size + 3.0
        height = 3 * self.stamp_size + 2.5
        self._figure = plt.figure(figsize=(width, height))
        self._figure.canvas.mpl_connect("key_press_event", self._on_key_press)

        # Row 1: one axis per coadd stamp. Row 2: light curves + scalar text.
        for i, name in enumerate(self.coadds):
            ax = self._figure.add_axes(
                [0.03 + 0.95 * i / n_stamps, 0.62, 0.9 / n_stamps, 0.3]
            )
            self._ax_map[name] = ax
        self._ax_map["curves"] = self._figure.add_axes([0.08, 0.3, 0.55, 0.24])
        self._ax_map["stats"] = self._figure.add_axes([0.68, 0.3, 0.3, 0.24])
        self._ax_map["stats"].axis("off")

        # Bottom strip: controls.
        self._controls["radio"] = RadioButtons(
            self._figure.add_axes([0.02, 0.02, 0.2, 0.2]), self._labels
        )
        self._controls["radio"].on_clicked(self._update_label)
        self._controls["notes"] = TextBox(
            self._figure.add_axes([0.3, 0.14, 0.3, 0.06]), "notes "
        )
        self._controls["notes"].on_submit(self._update_notes)
        self._controls["outfile"] = TextBox(
            self._figure.add_axes([0.3, 0.04, 0.3, 0.06]), "file ", initial=self.outfile
        )
        self._controls["outfile"].on_submit(self._update_outfile)
        self._controls["goto"] = TextBox(
            self._figure.add_axes([0.68, 0.14, 0.08, 0.06]), "goto "
        )
        self._controls["goto"].on_submit(self._goto_button)
        self._controls["prev"] = Button(self._figure.add_axes([0.78, 0.14, 0.08, 0.06]), "prev")
        self._controls["prev"].on_clicked(self.previous_result)
        self._controls["next"] = Button(self._figure.add_axes([0.87, 0.14, 0.08, 0.06]), "next")
        self._controls["next"].on_clicked(self.next_result)
        self._controls["save"] = Button(self._figure.add_axes([0.78, 0.04, 0.17, 0.06]), "save")
        self._controls["save"].on_clicked(self._save_button)

        self.update_all()

    def show(self):
        import matplotlib.pyplot as plt

        plt.show()

    # --- per-row rendering ---

    def update_all(self):
        self.plot_coadds()
        self.plot_curves()
        self.plot_stats()
        self._update_controls()
        if self._figure is not None:
            self._figure.canvas.draw_idle()

    def plot_coadds(self):
        for name in self.coadds:
            ax = self._ax_map[name]
            ax.clear()
            plot_image(np.asarray(self.results[name][self.idx]), ax=ax, title=name)

    def plot_curves(self):
        ax = self._ax_map["curves"]
        ax.clear()
        row = self.results.table
        if "psi_curve" in self.results.colnames and "phi_curve" in self.results.colnames:
            psi = np.asarray(row["psi_curve"][self.idx], dtype=float)
            phi = np.asarray(row["phi_curve"][self.idx], dtype=float)
            with np.errstate(divide="ignore", invalid="ignore"):
                lc = np.where(phi != 0, psi / phi, np.nan)
            indices = None
            if "obs_valid" in self.results.colnames:
                indices = np.asarray(row["obs_valid"][self.idx], dtype=bool)
            plot_time_series(lc, times=self.times[: len(lc)], indices=indices, ax=ax,
                             title=f"result {self.idx} flux curve")
        else:
            ax.text(0.5, 0.5, "no psi/phi curves", ha="center", va="center")

    def plot_stats(self):
        ax = self._ax_map["stats"]
        ax.clear()
        ax.axis("off")
        lines = [
            f"{key} = {val:.4g}" if isinstance(val, float) else f"{key} = {val}"
            for key, val in extract_results_row_scalars(self.results, self.idx).items()
            if key not in ("user_class", "notes")
        ]
        ax.text(0.0, 1.0, "\n".join(lines[:18]), va="top", family="monospace", fontsize=8)

    def _update_controls(self):
        current = self.results["user_class"][self.idx]
        if current in self._labels and "radio" in self._controls:
            self._controls["radio"].set_active(self._labels.index(current))
        if "notes" in self._controls:
            self._controls["notes"].set_val(str(self.results["notes"][self.idx]))
