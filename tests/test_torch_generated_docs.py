"""The port's generated trees stay fresh: its notebooks
(``kbmod_tpu_torch/examples/notebooks/``, from the percent-format examples)
and its API reference (``kbmod_tpu_torch/docs/api/``), as
tests/test_notebooks.py and tests/test_api_docs.py hold the JAX package's.

Each generator runs in a clean subprocess into a temporary directory, and
its output must equal the committed tree file for file, with no file
missing or left over. The notebooks are nbformat 4 with both cell kinds and
no outputs, and cover the reference's eight notebook topics; the API
reference covers the port's public modules (the JAX generator's list with
the Pallas module replaced by the four kernel wrappers), every
SearchConfiguration parameter and the key public classes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
NB_DIR = REPO / "kbmod_tpu_torch" / "examples" / "notebooks"
API_DIR = REPO / "kbmod_tpu_torch" / "docs" / "api"
EXAMPLES = REPO / "kbmod_tpu_torch" / "examples"

# The JAX package's Pallas module and the port's modules that replace it.
KERNEL_WRAPPERS = {
    "kbmod_tpu.ops.search_pallas": ["kbmod_tpu_torch.ops.conv_kernel", "kbmod_tpu_torch.ops.search_kernel",
                                    "kbmod_tpu_torch.ops.search_encoded_kernel",
                                    "kbmod_tpu_torch.ops.exactrow_kernel"],
}


def _generate(module, out_dir):
    proc = subprocess.run([sys.executable, "-m", module, str(out_dir)], cwd=REPO, capture_output=True, text=True)
    if proc.returncode != 0:
        pytest.fail(f"{module} failed (rc={proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    return sorted(os.listdir(out_dir))


@pytest.mark.parametrize("module,committed", [
    ("kbmod_tpu_torch.scripts.gen_notebooks", NB_DIR),
    ("kbmod_tpu_torch.scripts.gen_api_docs", API_DIR),
], ids=["notebooks", "api"])
def test_tree_is_fresh(module, committed, tmp_path):
    names = _generate(module, tmp_path)
    assert names, "the generator produced nothing"
    stale = [n for n in names
             if not (committed / n).exists() or (committed / n).read_text() != (tmp_path / n).read_text()]
    extra = sorted(set(os.listdir(committed)) - set(names))
    assert not stale and not extra, (
        f"{committed.relative_to(REPO)} is stale (changed: {stale}, orphaned: {extra}): "
        f"run `python -m {module}` and commit."
    )


def test_one_notebook_per_example():
    assert sorted(p.stem for p in NB_DIR.glob("*.ipynb")) == sorted(p.stem for p in EXAMPLES.glob("*.py"))
    assert len(list(NB_DIR.glob("*.ipynb"))) == 13


def test_notebooks_are_valid_nbformat4():
    for p in sorted(NB_DIR.glob("*.ipynb")):
        nb = json.loads(p.read_text())
        assert nb["nbformat"] == 4, p
        assert len(nb["cells"]) >= 3, f"{p} is too thin to be a walkthrough"
        assert {c["cell_type"] for c in nb["cells"]} == {"markdown", "code"}, p
        for c in nb["cells"]:
            if c["cell_type"] == "code":
                assert c["outputs"] == [] and c["execution_count"] is None


def test_notebooks_cover_reference_topics():
    names = " ".join(p.name for p in NB_DIR.glob("*.ipynb"))
    for topic in ("demo", "trajectory_explorer", "fake_data", "clustering", "results_and_filtering",
                  "fake_analysis", "visualization", "results_rater"):
        assert topic in names, f"no notebook for reference topic {topic}"


def _port_modules():
    from kbmod_tpu_torch.scripts.gen_api_docs import MODULES

    return [m for m, _ in MODULES]


def _jax_modules():
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_gen_api_docs", REPO / "scripts" / "gen_api_docs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [m for m, _ in mod.MODULES]


def test_api_index_covers_the_ported_modules():
    """Every module the JAX reference lists has its counterpart in the
    port's, and the index links a page for each."""
    port = _port_modules()
    want = []
    for m in _jax_modules():
        want += KERNEL_WRAPPERS.get(m, [m.replace("kbmod_tpu.", "kbmod_tpu_torch.", 1)])
    assert not sorted(set(want) - set(port))
    index = (API_DIR / "index.md").read_text()
    for m in port:
        page = m.replace(".", "_") + ".md"
        assert (API_DIR / page).exists() and f"]({page})" in index, m


def test_api_covers_all_config_params():
    from kbmod_tpu_torch.configuration import _SUPPORTED_PARAMS

    text = (API_DIR / "configuration_params.md").read_text()
    missing = [p.name for p in _SUPPORTED_PARAMS if f"`{p.name}`" not in text]
    assert not missing, f"config params missing from the API reference: {missing}"


def test_api_covers_key_public_classes():
    joined = "\n".join(p.read_text() for p in API_DIR.glob("*.md"))
    for cls in ("StackSearch", "Trajectory", "TrajectoryList", "SearchRunner", "Results", "SearchConfiguration",
                "ImageStackPy", "LayeredImagePy", "PSF", "WorkUnit", "ImageCollection", "Standardizer", "KBMODV1",
                "RegionSearch", "TrajectoryExplorer", "FakeDataSet", "SigmaGClipping", "KnownObjsMatcher",
                "DebugTimer", "WCS", "Mesh", "StampClassifier"):
        assert f"class `{cls}`" in joined, f"{cls} not documented in the port's API reference"
    for fn in ("psi_phi_conv", "search_topk", "search_topk_encoded", "resolve_device"):
        assert f"- `{fn}(" in joined, f"{fn} not documented in the port's API reference"
