"""The port's other worked examples against the JAX package's, on the CPU.

The rules and helpers of tests/test_torch_examples_search.py, for the eight
examples that run no search: 02 (fake data and the WorkUnit files), 04
(reprojection), 06 (region search), 07 (plots, stamps cut on the device), 08
(fake analysis), 09 (clustering), 10 (known objects) and 11 (the results
rater). The FITS files of 02 are compared byte for byte, every file of its
directory; reprojected layers within ``REPROJECT_ATOL``, the bound of
tests/test_torch_reprojection.py for a resampled layer.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from test_torch_examples_search import (
    PORT_EXAMPLES,
    assert_files_equal,
    assert_tables_match,
    assert_trajectories_match,
    assert_values_match,
    cleanup,
    run_example,
    run_pair,
)

REPROJECT_ATOL = 1e-4


def _stacks_match(ref, got, key, atol=0.0):
    for plane in ("sci", "var", "psfs"):
        np.testing.assert_allclose(np.asarray(getattr(got, plane)), np.asarray(getattr(ref, plane)), rtol=0,
                                   atol=atol, err_msg=f"{key}.{plane}")
    np.testing.assert_array_equal(np.asarray(got.times), np.asarray(ref.times), err_msg=f"{key}.times")


def check_02(ref, got):
    _stacks_match(ref["ds"].stack_py, got["ds"].stack_py, "stack")
    assert_trajectories_match(ref["ds"].trajectories, got["ds"].trajectories, "trajectories")
    names = sorted(os.listdir(ref["workdir"]))
    assert sorted(os.listdir(got["workdir"])) == names and "fake.fits" in names and len(names) > 2
    for name in names:
        assert_files_equal(os.path.join(ref["workdir"], name), os.path.join(got["workdir"], name))
    _stacks_match(ref["lazy"].im_stack, got["lazy"].im_stack, "lazy")
    cleanup(ref["workdir"], got["workdir"])


def check_04(ref, got):
    for name in ("aligned", "ebd"):
        _stacks_match(ref[name].im_stack, got[name].im_stack, name, atol=REPROJECT_ATOL)
        assert got[name].reprojection_frame == ref[name].reprojection_frame
    assert_values_match(np.asarray(ref["ebd"].org_img_meta["geocentric_distance"], np.float64),
                        np.asarray(got["ebd"].org_img_meta["geocentric_distance"], np.float64), "geocentric_distance")


def check_06(ref, got):
    assert len(got["rs"].get_patches()) == len(ref["rs"].get_patches())
    assert got["sizes"] == ref["sizes"] and got["busiest"] == ref["busiest"]
    assert {p: sorted(v) for p, v in got["matches"].items()} == {p: sorted(v) for p, v in ref["matches"].items()}
    assert_tables_match(ref["out"].data, got["out"].data, "exported collection")


def check_07(ref, got):
    assert_tables_match(ref["results"], got["results"], "results")
    assert_values_match(ref["curve"], got["curve"], "curve")
    assert sorted(os.listdir(got["outdir"])) == sorted(os.listdir(ref["outdir"]))
    cleanup(ref["outdir"], got["outdir"])


def check_08(ref, got):
    r, g = ref["fake"], got["fake"]
    assert g.num_times_seen == r.num_times_seen
    for attr in ("xy_stamps", "trj_stamps"):
        assert_values_match(getattr(r, attr), getattr(g, attr), attr)
    assert_trajectories_match([r.trj], [g.trj], "fitted trajectory")
    assert_values_match(np.float64(r.compute_fit_mse()), np.float64(g.compute_fit_mse()), "fit mse")


def check_09(ref, got):
    # The loop keeps its last variant (grid_start_end); the printed lines
    # hold every variant's rows kept and objects recovered.
    assert_tables_match(ref["results"], got["results"], "results")
    assert_values_match(ref["matches"], got["matches"], "matches")


def check_10(ref, got):
    assert_tables_match(ref["results"], got["results"], "results")
    assert got["col"] == ref["col"]


def check_11(ref, got):
    assert_tables_match(ref["reloaded"].results, got["reloaded"].results, "reloaded")
    assert got["rater"].idx == ref["rater"].idx
    for env in (ref, got):
        os.remove(env["outfile"])


# Per example: the check of its outputs; each prints no temporary path, so
# what each prints must be the same.
OUTPUTS = {
    "02_create_fake_data.py": check_02,
    "04_reprojection_demo.py": check_04,
    "06_region_search.py": check_06,
    "07_visualization.py": check_07,
    "08_fake_analysis.py": check_08,
    "09_clustering_evaluation.py": check_09,
    "10_known_objects.py": check_10,
    "11_results_rater.py": check_11,
}


@pytest.mark.parametrize("name", sorted(OUTPUTS))
def test_tool_example_matches_jax(name):
    (ref, ref_out), (got, got_out) = run_pair(name)
    OUTPUTS[name](ref, got)
    assert got_out.splitlines() == ref_out.splitlines()


# The examples that hand ``DEVICE`` to an entry point.
DEVICE_EXAMPLES = ["01_kbmod_demo.py", "03_trajectory_explorer.py", "04_reprojection_demo.py",
                   "05_results_and_filtering.py", "07_visualization.py", "12_multichip_sharding.py",
                   "13_checkpoint_resume.py"]


@pytest.mark.parametrize("name", DEVICE_EXAMPLES)
def test_device_example_raises_without_a_card(name, monkeypatch, tmp_path):
    """With no ``DEVICE`` an example runs on the CUDA card, and without one
    it raises: it never falls back to the host on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the default device is valid here")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_example(PORT_EXAMPLES / name)
