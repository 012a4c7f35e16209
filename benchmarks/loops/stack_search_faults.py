"""The faults of the whole-stack search loop, planted in the program
underneath a run for the check that ``correct`` comes out false
(``benchmarks/faults.py`` plants them; ``stack_search`` names them as its
``FAULTS`` and ``CELL_SIZE_FAULTS``). Each takes an object with
``setattr(target, name, value)``, as pytest's monkeypatch fixture is.
"""

import numpy as np


def _half_the_candidates(monkeypatch):
    """The search scores every other candidate only."""
    from kbmod_tpu_torch.search import StackSearch, TrajectoryList

    search_all = StackSearch.search_all

    def faulty(self, search_list, on_gpu=True):
        arrays = {k: v[::2] for k, v in search_list.get_arrays().items()}
        return search_all(self, TrajectoryList(arrays), on_gpu)

    monkeypatch.setattr(StackSearch, "search_all", faulty)


def _half_the_exposures(monkeypatch):
    """The build leaves the science of the second half of each batch of
    exposures out (psi 0 there)."""
    from kbmod_tpu_torch.ops import psi_phi

    build = psi_phi._psi_phi_from_sci_var

    def faulty(sci, var, psf):
        psi, phi = build(sci, var, psf)
        psi[sci.shape[0] // 2:] = 0.0
        return psi, phi

    monkeypatch.setattr(psi_phi, "_psi_phi_from_sci_var", faulty)


def _search_answer_altered(monkeypatch):
    """Each listed row's likelihood is altered by 5% where the search
    produces it."""
    from kbmod_tpu_torch.ops import search

    core = search.core_search

    def faulty(*args, **kwargs):
        out = core(*args, **kwargs)
        out["lh"] = np.where(out["lh"] > -1e30, out["lh"] * np.float32(1.05), out["lh"])
        return out

    monkeypatch.setattr(search, "core_search", faulty)


def _final_answer_altered(monkeypatch):
    """Each final row's flux is altered by 5% where the results path
    produces it."""
    from kbmod_tpu_torch.run_search import SearchRunner

    load = SearchRunner.load_and_filter_results

    def faulty(self, *args, **kwargs):
        keep = load(self, *args, **kwargs)
        if len(keep):
            keep.table["flux"] = np.asarray(keep.table["flux"]) * 1.05
        return keep

    monkeypatch.setattr(SearchRunner, "load_and_filter_results", faulty)


def _coadds_left_unchanged(monkeypatch):
    """The coadd step returns the table with its stamps never filled."""
    from kbmod_tpu_torch import run_search

    def faulty(keep, stack, coadd_types, radius, **kwargs):
        for kind in coadd_types:
            keep.table[f"coadd_{kind}"] = np.zeros((len(keep), 2 * radius + 1, 2 * radius + 1), np.float32)

    monkeypatch.setattr(run_search, "append_coadds", faulty)


def _clustering_left_out(monkeypatch):
    """The clustering step returns the rows unchanged."""
    from kbmod_tpu_torch import run_search

    monkeypatch.setattr(run_search, "apply_clustering", lambda keep, params: None)


def _half_the_final_rows_left_out(monkeypatch):
    """Every other row the clustering kept is dropped."""
    from kbmod_tpu_torch import run_search

    cluster = run_search.apply_clustering

    def faulty(keep, params):
        cluster(keep, params)
        keep.filter_rows(np.arange(0, len(keep), 2), "fault")

    monkeypatch.setattr(run_search, "apply_clustering", faulty)


def _sigma_g_left_out(monkeypatch):
    """The results path's sigma-G clipping returns the rows unclipped."""
    from kbmod_tpu_torch import run_search

    monkeypatch.setattr(run_search, "apply_clipped_sigma_g", lambda clipper, results: None)


FAULTS = {
    "clustering left out": _clustering_left_out,
    "half the final rows left out": _half_the_final_rows_left_out,
    "half the candidates": _half_the_candidates,
    "half the exposures": _half_the_exposures,
    "a listed likelihood altered": _search_answer_altered,
    "a final flux altered": _final_answer_altered,
    "coadds left unchanged": _coadds_left_unchanged,
}
# Seen only where the results path's sigma-G removes samples, as it does at
# the cells' own size (not at the tests' few exposures).
CELL_SIZE_FAULTS = {"sigma-G left out": _sigma_g_left_out}
