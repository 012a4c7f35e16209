"""Port parity for the whole pipeline: the JAX package's
``SearchRunner.run_search`` against kbmod_tpu_torch's
``SearchRunner().run_search(..., device="cpu")`` on one fake 10 x 40 x 48
stack with masked pixels and an injected object.

The port's searches take the JAX package's own psi/phi planes (float) or
code planes (uint8), handed over with ``psi_phi_array_from_numpy`` where
the runner builds its ``StackSearch``, so the convolution's rounding does
not enter; the builds are compared on their own elsewhere. The JAX side
runs its TPU dispatcher for the quantized search (``KB_SEARCH_KERNEL=
pallas``, kernels in interpret mode), whose dedup, grouping and tie order
the port follows; the port ignores that route switch.

Every case compares the final table: x, y, vx, vy, obs_count and the row
order exactly, likelihood and flux within 1e-5 * max(1, |value|) (ROADMAP
Queue 3), obs_valid exactly, the psi/phi curves within 1e-6 (exact on float
planes; a decoded uint8 code may sit 2 float32 ulps apart), and the coadd
stamps (coadd_sum, stamp and the case's other coadds) exactly. The ECSV file each
side writes reads back through the port's ``Results.read_table`` equal to
the port's table.
"""

import json
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kbmod_tpu.configuration import SearchConfiguration
from kbmod_tpu.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu.run_search import SearchRunner
from kbmod_tpu.search import StackSearch, Trajectory

import kbmod_tpu_torch.run_search as port_run_search
from kbmod_tpu_torch.configuration import SearchConfiguration as TSearchConfiguration
from kbmod_tpu_torch.core.image_stack_py import ImageStackPy as TImageStackPy
from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
from kbmod_tpu_torch.results import Results as TResults
from kbmod_tpu_torch.search import StackSearch as TStackSearch
from kbmod_tpu_torch.search import TrajectoryList as TTrajectoryList
from kbmod_tpu_torch.search import psi_phi_array_from_numpy

TOL = 1e-5
CURVE_TOL = 1e-6
KEY = ("x", "y", "vx", "vy", "obs_count")
OBJ = dict(x=17, y=21, vx=4.0, vy=-1.5, flux=300.0)
# 49 candidates around the object's velocity (vx 4, vy -1.5 is on the grid).
GENERATOR = {"name": "KBMODV1SearchConfig", "v_arr": [2.0, 6.0, 7], "ang_arr": [0.6, 0.2, 7], "average_angle": 0.0}
BASE = dict(generator_config=GENERATOR, num_obs=5, lh_level=2.0, near_dup_thresh=3, cluster_eps=1.5, save_config=False)

CASES = {
    "float_host_sigmag": dict(coadds=["mean", "median", "weighted"]),
    "u8_gpu_filter": dict(encode_num_bytes=1, gpu_filter=True, coadds=["mean"]),
    "max_results": dict(max_results=3, do_clustering=False),
    "num_obs_auto": dict(num_obs=-1, lh_level=3.0),
    "overmasked_dropped": dict(max_masked_pixels=0.5),
    "no_clustering": dict(do_clustering=False, nightly_coadds=True),
    "no_psi_phi_no_sigmag": dict(generate_psi_phi=False, sigmaG_filter=False),
}


def _jax_stack(overmask):
    times = create_fake_times(10, t0=57130.2, obs_per_day=2, intra_night_gap=0.05)
    ds = FakeDataSet(48, 40, times, psf_val=1.0, mask_fraction=0.03, use_seed=7)
    ds.insert_object(Trajectory(**OBJ))
    st = ds.stack_py
    if overmask:
        for t in (2, 7):
            st.sci[t][:, 5:] = np.nan
            st.var[t][:, 5:] = np.nan
    return st


def _port_stack(st):
    return TImageStackPy(
        times=list(st.times), sci=[np.array(s) for s in st.sci], var=[np.array(v) for v in st.var],
        psfs=[np.asarray(p) for p in st.psfs],
    )


class _HandedOver(TStackSearch):
    """The port's StackSearch searching the JAX package's planes.

    Its ``search_all`` also runs the JAX package's search with the same
    settings and holds the port's raw rows to it: equal in KEY and order,
    lh within TOL, except rows that name another candidate of the same
    pixel where the two candidates' (clipped) lh tie. That tie at the top-K
    boundary is documented (ROADMAP Queue 3: the reference's bubble
    insertion keeps the later of two equal candidates, the port the
    earlier); where rows differ the port continues with the JAX package's
    raw rows, so that the rest of the pipeline compares exactly.
    ``substituted`` counts the rows that named another, tying candidate and
    ``reordered`` the rows that stood elsewhere inside their tie run."""

    substituted = 0
    reordered = 0

    def __init__(self, sci, var, psfs, zeroed_times, num_bytes=-1, device=None):
        super().__init__(sci, var, psfs, zeroed_times, num_bytes, device=device)
        self._ref = StackSearch(sci, var, psfs, zeroed_times, num_bytes)
        arr = self._ref.psi_phi_array
        valid = None if num_bytes in (1, 2) else np.asarray(arr.valid)
        self.psi_phi_array = psi_phi_array_from_numpy(
            np.asarray(arr.psi), np.asarray(arr.phi), valid, arr.times, arr.meta, device=self.device
        )

    def search_all(self, search_list, on_gpu=True):
        super().search_all(search_list, on_gpu)
        for name, value in vars(self.params).items():
            setattr(self._ref.params, name, value)
        self._ref.search_all(search_list, on_gpu)
        a, b = self._ref.results.get_arrays(), self.results.get_arrays()
        assert len(a["x"]) == len(b["x"])
        assert _close(a["lh"], b["lh"])
        # Runs of consecutive rows whose lh agree to TOL: inside a run rows
        # may come in another order, or name another candidate of the same
        # pixel that ties.
        cuts = np.nonzero(np.abs(np.diff(a["lh"])) > TOL * np.maximum(np.abs(a["lh"][1:]), 1.0))[0] + 1
        moved = substituted = 0
        for rows in np.split(np.arange(len(a["x"])), cuts):
            ka = Counter(zip(*(a[k][rows].tolist() for k in ("x", "y", "vx", "vy"))))
            kb = Counter(zip(*(b[k][rows].tolist() for k in ("x", "y", "vx", "vy"))))
            only_a, only_b = sorted((ka - kb).elements()), sorted((kb - ka).elements())
            assert len(only_a) == len(only_b), f"rows {rows[0]}..{rows[-1]} differ"
            for ra, rb in zip(only_a, only_b):
                assert ra[:2] == rb[:2], f"rows {rows[0]}..{rows[-1]}: {ra} and {rb} start apart"
                la = self.search_linear_trajectory(*ra, use_kernel=True).lh
                lb = self.search_linear_trajectory(*rb, use_kernel=True).lh
                assert _close(la, lb), f"rows {rows[0]}..{rows[-1]}: {ra} and {rb} do not tie"
            substituted += len(only_a)
            moved += sum(any(a[k][i] != b[k][i] for k in ("x", "y", "vx", "vy")) for i in rows)
        _HandedOver.substituted += substituted
        _HandedOver.reordered += moved - substituted
        if moved:
            self.results = TTrajectoryList({k: np.array(v) for k, v in a.items()})


def _close(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return bool(np.all(np.abs(a - b) <= TOL * np.maximum(1.0, np.abs(a))))


def _assert_tables_match(ref, got):
    assert len(ref) == len(got) > 0
    assert set(ref.colnames) == set(got.colnames)
    for k in KEY:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("likelihood", "flux"):
        assert _close(ref[k], got[k]), k
    for k in ref.colnames:
        if k in ("psi_curve", "phi_curve"):
            # Exact on float planes; a uint8 code decodes up to 2 float32
            # ulps apart (the JAX package's XLA fuses the decode's
            # multiply-add; tests/test_torch_search_encoded.py).
            np.testing.assert_allclose(got[k], ref[k], rtol=CURVE_TOL, atol=CURVE_TOL, err_msg=k)
        elif k == "obs_valid" or k == "stamp" or k.startswith("coadd_"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _run_both(tmp_path, monkeypatch, case):
    _HandedOver.substituted = _HandedOver.reordered = 0
    over = dict(BASE, **CASES[case])
    st = _jax_stack(case == "overmasked_dropped")
    pst = _port_stack(st)
    monkeypatch.setenv("KB_SEARCH_KERNEL", "pallas")
    monkeypatch.setattr(port_run_search, "StackSearch", _HandedOver)
    ref_file, got_file = tmp_path / "jax.ecsv", tmp_path / "port.ecsv"
    ref = SearchRunner().run_search(SearchConfiguration(dict(over, result_filename=str(ref_file))), st)
    search_topk_encoded.last_route = None
    runner = port_run_search.SearchRunner()
    got = runner.run_search(TSearchConfiguration(dict(over, result_filename=str(got_file))), pst, device="cpu")
    return ref, got, ref_file, got_file, st, pst


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_search_matches(tmp_path, monkeypatch, case):
    ref, got, ref_file, got_file, st, pst = _run_both(tmp_path, monkeypatch, case)
    _assert_tables_match(ref, got)
    # Raw rows naming another, tying candidate: one in the uint8 case (a
    # sigma-G clipped tie at the top-K boundary), none on float planes. The
    # uint8 lh repeat across pixels (integer code sums), so there ~800 raw
    # rows also change places inside their tie runs.
    assert _HandedOver.substituted <= (1 if case == "u8_gpu_filter" else 0)
    if case != "u8_gpu_filter":
        assert _HandedOver.reordered == 0
    assert pst.num_times == st.num_times
    if case == "overmasked_dropped":
        assert pst.num_times == 8
    if case == "u8_gpu_filter":
        assert search_topk_encoded.last_route is not None
    if case == "max_results":
        assert len(got) == 3
    if case == "no_psi_phi_no_sigmag":
        assert "psi_curve" not in got.colnames and "obs_valid" not in got.colnames
    best = int(np.argmax(got["likelihood"]))
    assert abs(got["x"][best] - OBJ["x"]) <= 1 and abs(got["y"][best] - OBJ["y"]) <= 1

    # Both files read back through the port's reader equal to the port's
    # table (the file holds the rows as run_search left them).
    for path in (ref_file, got_file):
        back = TResults.read_table(path)
        assert len(back) == len(got)
        for k in KEY:
            np.testing.assert_array_equal(back[k], got[k], err_msg=f"{path.name} {k}")
        assert _close(got["likelihood"], back["likelihood"])
        np.testing.assert_array_equal(back["coadd_sum"], got["coadd_sum"])
        np.testing.assert_allclose(back.mjd_utc_mid, st.times)


def test_runner_phases_and_device():
    """The port's runner, on its own psi/phi build, records the reference's
    phases, runs on the device it was given and finds the object (the best
    row within a pixel of it)."""
    runner = port_run_search.SearchRunner(device="cpu")
    pst = _port_stack(_jax_stack(False))
    got = runner.run_search(TSearchConfiguration(dict(BASE, do_clustering=False)), pst)
    assert runner.device.type == "cpu"
    best = int(np.argmax(got["likelihood"]))
    assert abs(got["x"][best] - OBJ["x"]) <= 1 and abs(got["y"][best] - OBJ["y"]) <= 1
    for phase in ("KBMOD", "do_core_search", "grid search", "load_and_filter_results", "stamp generation",
                  "write results"):
        assert runner.phase_times[phase][1] >= runner.phase_times[phase][0]


def test_default_device_is_cuda_and_deferred_paths_raise():
    """Without a card the runner raises unless the CPU is asked for; the
    three WorkUnit paths (no longer deferred) run on the CPU: the QA cut
    on the WorkUnit, sky positions from its WCS, the constituent metadata
    in the saved file."""
    from kbmod_tpu_torch.wcs_utils import make_fake_wcs
    from kbmod_tpu_torch.work_unit import WorkUnit

    pst = _port_stack(_jax_stack(True))
    config = TSearchConfiguration(dict(BASE))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_run_search.SearchRunner().run_search(config, pst)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_run_search.SearchRunner(device="cuda")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_run_search.SearchRunner().run_search_from_work_unit(WorkUnit(im_stack=pst, config=config))
    from kbmod_tpu_torch.table import Table as TTable

    work = WorkUnit(im_stack=pst, config=TSearchConfiguration(dict(BASE, max_masked_pixels=0.5)),
                    wcs=make_fake_wcs(200.0, -7.0, 40, 48, 1.0 / 3600.0),
                    org_image_meta=TTable({"visit": list(range(10))}))
    got = port_run_search.SearchRunner(device="cpu").run_search(work.config, pst, workunit=work)
    assert work.im_stack.num_times == 8 and list(work.org_img_meta["visit"]) == [0, 1, 3, 4, 5, 6, 8, 9]
    assert got.wcs is work.wcs and got["global_ra"].shape == (len(got), 8)
    got2 = port_run_search.SearchRunner(device="cpu").run_search_from_work_unit(work)
    for k in KEY:
        np.testing.assert_array_equal(got2[k], got[k])
    got.table["global_ra"] = np.zeros_like(got["global_ra"])
    port_run_search.append_positions_to_results(work, got)
    np.testing.assert_array_equal(got["global_ra"], got2["global_ra"])
    ra, dec = work.wcs.pixel_to_world_values(got["pred_x"], got["pred_y"])
    np.testing.assert_array_equal(got["img_ra"], ra)


def test_memory_budget_counts_what_the_port_allocates(monkeypatch):
    """The budget's terms follow the port's allocations: the kept planes
    (9 bytes a float pixel-time, 2 or 4 for code pairs padded to 8
    columns), the maps at K' = 4 K under the in-kernel sigma-G pool, K2's
    padded copy for widths off its 16-pixel chunk; check_gpu_memory holds
    the total against the card's free memory."""
    st = _port_stack(_jax_stack(False))
    T, H, W = st.num_times, st.height, st.width  # 10 x 40 x 48
    dev = torch.device("cpu")

    def budget(**over):
        return port_run_search.search_memory_budget(TSearchConfiguration(dict(BASE, **over)), st, 49, dev)

    flt, u8, u16 = budget(), budget(encode_num_bytes=1), budget(encode_num_bytes=2)
    assert flt["planes"] == 9 * T * H * W and flt["padding"] == 0 and flt["expand"] == 0
    assert u8["planes"] == 2 * T * H * 48 and u16["planes"] == 4 * T * H * 48 and u8["expand"] > 0
    assert budget(gpu_filter=True)["maps"] == 4 * flt["maps"] == 4 * 25 * 8 * H * W
    assert budget(cpu_only=True, results_per_pixel=100)["maps"] == 25 * 49 * H * W
    assert budget(x_pixel_bounds=[0, 40])["maps"] == 25 * 8 * H * 40
    for term in flt:
        assert flt[term] >= 0
    assert flt["total"] == sum(v for k, v in flt.items() if k != "total")
    narrow = TImageStackPy(times=list(st.times), sci=[s[:, :45] for s in st.sci], var=[v[:, :45] for v in st.var],
                           psfs=st.psfs)
    pad = port_run_search.search_memory_budget(TSearchConfiguration(dict(BASE)), narrow, 49, dev)["padding"]
    assert pad == 9 * T * H * 48

    gen = port_run_search.create_trajectory_generator(TSearchConfiguration(dict(BASE)))
    monkeypatch.setattr(port_run_search, "resolve_device", lambda device=None: dev)
    monkeypatch.setattr(port_run_search, "device_free_bytes", lambda device: flt["total"] + 1)
    assert port_run_search.check_gpu_memory(TSearchConfiguration(dict(BASE)), st, gen, dev)
    monkeypatch.setattr(port_run_search, "device_free_bytes", lambda device: flt["total"] - 1)
    assert not port_run_search.check_gpu_memory(TSearchConfiguration(dict(BASE)), st, gen, dev)


# The benchmark cells' (T, C), with the height, width, search settings and
# environment of their configuration files, and the budget's terms there
# in bytes on the CPU device (the terms not listed are 0).
CELL_BUDGETS = {
    "regression_float": ((20, 1352), dict(
        planes=94_371_840, build=251_658_240, maps=111_081_600, layouts=1_860_352, gathers=1_006_632_960,
        curves=320_000_000, exact=3_203_235_840, total=4_988_840_832)),
    "survey_u8": ((100, 33_153), dict(
        planes=209_715_200, build=5_033_164_800, expand=1_207_959_552, maps=209_715_200, layouts=225_970_848,
        gathers=5_033_164_800, curves=1_600_000_000, total=13_519_690_400)),
}
BUDGET_TERMS = ("planes", "build", "padding", "expand", "maps", "layouts", "gathers", "curves", "exact", "checkpoint",
                "shards", "total")


@pytest.mark.parametrize("name", sorted(CELL_BUDGETS))
def test_memory_budget_of_the_benchmark_cells(monkeypatch, name):
    """Every term of the budget, in its order, at a benchmark cell's
    configuration and shapes."""
    cfg = json.loads((Path(__file__).resolve().parents[1] / "benchmarks" / "configs" / f"{name}.json").read_text())
    for var in ("KB_SIGMAG_MODE", "KB_SIGMAG_TOPK_FACTOR", "KB_SIGMAG_AUTO", "KB_SEARCH_CKPT_DIR", "KB_SHARDED"):
        monkeypatch.delenv(var, raising=False)
    for var, value in cfg.get("environment", {}).items():
        monkeypatch.setenv(var, value)
    (T, C), want = CELL_BUDGETS[name]
    stack = SimpleNamespace(num_times=T, height=cfg["height"], width=cfg["width"])
    got = port_run_search.search_memory_budget(TSearchConfiguration(cfg["search"]), stack, C, torch.device("cpu"))
    assert list(got.items()) == [(term, want.get(term, 0)) for term in BUDGET_TERMS]
