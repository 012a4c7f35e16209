"""Generate the port's markdown API reference.

    python -m kbmod_tpu_torch.scripts.gen_api_docs [out_dir]

The port of the JAX package's scripts/gen_api_docs.py (no pdoc or sphinx
needed): introspects the port's public modules (classes, their public
methods, and module-level functions with signatures and docstring
summaries) and writes one page each, an index, and a table of every
SearchConfiguration parameter from the port's ``_SUPPORTED_PARAMS``, into
``kbmod_tpu_torch/docs/api/`` by default. Where the JAX package lists its
Pallas module, the port lists the kernel wrappers that replace it.
tests/test_torch_generated_docs.py regenerates into a temporary directory
and fails if the committed tree is stale.
"""

import argparse
import importlib
import inspect
import os
import re

API_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs", "api")

# Public modules, grouped as the JAX package's list. Each entry is
# (module path, one-line role).
MODULES = [
    ("kbmod_tpu_torch.configuration", "Search configuration (45 typed parameters)"),
    ("kbmod_tpu_torch.device", "Where an entry point runs: CUDA by default, the host on request"),
    ("kbmod_tpu_torch.search", "StackSearch + the kbmod.search compat surface"),
    ("kbmod_tpu_torch.search.stack_search", "StackSearch implementation"),
    ("kbmod_tpu_torch.search.trajectory", "Trajectory struct"),
    ("kbmod_tpu_torch.search.trajectory_list", "TrajectoryList (struct-of-arrays)"),
    ("kbmod_tpu_torch.run_search", "SearchRunner pipeline"),
    ("kbmod_tpu_torch.results", "Results table, IO, filtered tracking"),
    ("kbmod_tpu_torch.trajectory_generator", "Candidate-grid generators"),
    ("kbmod_tpu_torch.trajectory_utils", "Trajectory prediction/fitting/matching"),
    ("kbmod_tpu_torch.trajectory_explorer", "Interactive single-trajectory evaluation"),
    ("kbmod_tpu_torch.core.image_stack_py", "ImageStackPy / LayeredImagePy"),
    ("kbmod_tpu_torch.core.psf", "PSF kernels and masked convolution"),
    ("kbmod_tpu_torch.core.stamp_utils", "Stamp cutouts and coadds"),
    ("kbmod_tpu_torch.core.shift_and_stack", "psi/phi generation (compat shim)"),
    ("kbmod_tpu_torch.ops.psi_phi", "On-device psi/phi build + quantization"),
    ("kbmod_tpu_torch.ops.search", "Core search: offsets, the top-K kernels, re-scoring and sigma-G assembly"),
    ("kbmod_tpu_torch.ops.search_encoded", "Encoded search dispatcher: offset-class dedup, then K5, K4 or K3"),
    ("kbmod_tpu_torch.ops.conv_kernel", "K1: the psi/phi build as a CUDA kernel and its plain PyTorch twin"),
    ("kbmod_tpu_torch.ops.search_kernel", "K2: the float top-K search as a CUDA kernel and its plain PyTorch twin"),
    ("kbmod_tpu_torch.ops.search_encoded_kernel",
     "K3, K4, K5: the quantized top-K searches as CUDA kernels and their plain PyTorch twin"),
    ("kbmod_tpu_torch.ops.exactrow_kernel", "K6: K5's packed inner loop micro-benchmark as a CUDA kernel and its twin"),
    ("kbmod_tpu_torch.ops.sigmag_exact_kernel", "K7: the exact in-search sigma-G top-K as a CUDA kernel"),
    ("kbmod_tpu_torch.ops.stamps", "On-device stamp coadds"),
    ("kbmod_tpu_torch.ops.reproject", "On-device adaptive reprojection"),
    ("kbmod_tpu_torch.ops.convolve", "Masked PSF convolution"),
    ("kbmod_tpu_torch.filters.sigma_g_filter", "Sigma-G clipping"),
    ("kbmod_tpu_torch.filters.clustering_filters", "DBSCAN / NN-sweep clustering (no scikit-learn)"),
    ("kbmod_tpu_torch.filters.clustering_grid", "Grid clustering + near-dup prefilter"),
    ("kbmod_tpu_torch.filters.stamp_filters", "Coadds, all-stamps, CNN vetting"),
    ("kbmod_tpu_torch.filters.brightness_filters", "Brightness-consistency scoring"),
    ("kbmod_tpu_torch.filters.known_object_filters", "Known-object ephemeris matching"),
    ("kbmod_tpu_torch.filters.sns_filters", "Peak-offset + predictive line cluster"),
    ("kbmod_tpu_torch.models.cnn", "PyTorch ResNet vetting models (torchvision layout) + flax weight conversion"),
    ("kbmod_tpu_torch.standardizers.standardizer", "Standardizer ABC + plugin registry"),
    ("kbmod_tpu_torch.standardizers.fits_standardizer", "FITS standardizer bases"),
    ("kbmod_tpu_torch.standardizers.kbmodv1", "Rubin imdiff (KBMOD V1) standardizer"),
    ("kbmod_tpu_torch.standardizers.kbmodv05", "Legacy DECam (KBMOD V0.5) standardizer"),
    ("kbmod_tpu_torch.standardizers.butler_standardizer", "LSST Butler standardizer"),
    ("kbmod_tpu_torch.image_collection", "ImageCollection metadata catalog"),
    ("kbmod_tpu_torch.work_unit", "WorkUnit container + FITS layouts"),
    ("kbmod_tpu_torch.reprojection", "WorkUnit reprojection drivers"),
    ("kbmod_tpu_torch.reprojection_utils", "Parallax / barycentric corrections"),
    ("kbmod_tpu_torch.wcs_utils", "WCS helpers"),
    ("kbmod_tpu_torch.geom.wcs", "Self-contained SIP-capable WCS"),
    ("kbmod_tpu_torch.region_search", "Survey-scale patch pre-search"),
    ("kbmod_tpu_torch.injection", "Synthetic source injection + recovery"),
    ("kbmod_tpu_torch.fake_data.fake_data_creator", "Fake image stacks"),
    ("kbmod_tpu_torch.fake_data.fake_result_creator", "Fake results"),
    ("kbmod_tpu_torch.parallel.sharded", "Sharded search over a mesh of torch devices"),
    ("kbmod_tpu_torch.parallel.distributed", "torch.distributed process groups + patch assignment"),
    ("kbmod_tpu_torch.search.checkpoint", "Per-tile search checkpoint/resume"),
    ("kbmod_tpu_torch.analysis.plotting", "Matplotlib result plotting"),
    ("kbmod_tpu_torch.analysis.visualizer", "Interactive visualizer"),
    ("kbmod_tpu_torch.analysis.results_rater", "Manual result rating"),
    ("kbmod_tpu_torch.analysis.analyze_fakes", "Fake-recovery analysis"),
    ("kbmod_tpu_torch.util_functions", "Shared utilities"),
    ("kbmod_tpu_torch.utils.debug_timer", "DebugTimer"),
    ("kbmod_tpu_torch.tracing", "Spans and counters on the profiler's clock"),
]


def _summary(obj):
    doc = inspect.getdoc(obj) or ""
    first = doc.split("\n\n", 1)[0].replace("\n", " ").strip()
    return first


def _signature(obj):
    try:
        sig = str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"
    # Default-value reprs of live objects embed memory addresses, which
    # would make the generated pages non-deterministic.
    return re.sub(r" at 0x[0-9a-f]+", "", sig)


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    classes, functions = [], []
    for name, obj in sorted(vars(mod).items()):
        if name.startswith("_"):
            continue
        if names is not None and name not in names:
            continue
        if getattr(obj, "__module__", None) != mod.__name__:
            continue
        if inspect.isclass(obj):
            classes.append((name, obj))
        elif inspect.isfunction(obj):
            functions.append((name, obj))
    return classes, functions


def render_module(modpath, role):
    try:
        mod = importlib.import_module(modpath)
    except ImportError as exc:
        # Optional-dependency modules (e.g. the Butler standardizer needs
        # the LSST middleware) still get a stub page.
        return (
            f"# `{modpath}`\n\n{role}.\n\n"
            f"*Not importable in this environment ({exc}); requires the "
            "optional dependency named above.*\n"
        )
    classes, functions = _public_members(mod)
    lines = [f"# `{modpath}`", "", role + ".", ""]
    mod_doc = _summary(mod)
    if mod_doc:
        lines += [mod_doc, ""]
    for name, cls in classes:
        lines += [f"## class `{name}`", ""]
        s = _summary(cls)
        if s:
            lines += [s, ""]
        try:
            init_sig = _signature(cls.__init__)
            lines += [f"- `__init__{init_sig}`"]
        except Exception:
            pass
        for mname, meth in sorted(vars(cls).items()):
            if mname.startswith("_"):
                continue
            target = meth
            if isinstance(meth, (staticmethod, classmethod)):
                target = meth.__func__
            elif isinstance(meth, property):
                doc = _summary(meth.fget) if meth.fget else ""
                lines += [f"- `{mname}` (property){' — ' + doc if doc else ''}"]
                continue
            if not inspect.isfunction(target):
                continue
            doc = _summary(target)
            lines += [f"- `{mname}{_signature(target)}`{' — ' + doc if doc else ''}"]
        lines += [""]
    if functions:
        lines += ["## Functions", ""]
        for name, fn in functions:
            doc = _summary(fn)
            lines += [f"- `{name}{_signature(fn)}`{' — ' + doc if doc else ''}"]
        lines += [""]
    return "\n".join(lines) + "\n"


def render_configuration_params():
    from kbmod_tpu_torch.configuration import _SUPPORTED_PARAMS

    by_section = {}
    for p in _SUPPORTED_PARAMS:
        by_section.setdefault(p.section, []).append(p)
    lines = [
        "# SearchConfiguration parameters",
        "",
        f"All {len(_SUPPORTED_PARAMS)} supported parameters of `kbmod_tpu_torch.configuration` (the JAX "
        "package's names, defaults and sections, which are the reference's configuration.py:73-400).",
        "",
    ]
    for section in sorted(by_section):
        lines += [f"## {section}", "", "| Parameter | Default | Description |", "|---|---|---|"]
        for p in sorted(by_section[section], key=lambda p: p.name):
            default = repr(p.default_value)
            desc = p.description.replace("|", "\\|")
            req = " **(required)**" if p.required else ""
            lines.append(f"| `{p.name}` | `{default}` | {desc}{req} |")
        lines.append("")
    return "\n".join(lines) + "\n"


def render_index():
    lines = [
        "# kbmod_tpu_torch API reference",
        "",
        "Generated by `python -m kbmod_tpu_torch.scripts.gen_api_docs`; regenerate after changing any "
        "public signature or docstring (tests/test_torch_generated_docs.py enforces freshness).",
        "",
        "- [SearchConfiguration parameters](configuration_params.md)",
        "",
        "| Module | Role |",
        "|---|---|",
    ]
    for modpath, role in MODULES:
        lines.append(f"| [`{modpath}`]({modpath.replace('.', '_')}.md) | {role} |")
    lines += [
        "",
        "Worked examples: [kbmod_tpu_torch/examples](../../examples/) (percent-format scripts that run on the "
        "CUDA card, or on the host with `DEVICE = \"cpu\"`), rendered as notebooks in "
        "[examples/notebooks](../../examples/notebooks/).",
        "",
    ]
    return "\n".join(lines) + "\n"


def generate(out_dir):
    os.makedirs(out_dir, exist_ok=True)
    pages = {"index.md": render_index(), "configuration_params.md": render_configuration_params()}
    for modpath, role in MODULES:
        pages[modpath.replace(".", "_") + ".md"] = render_module(modpath, role)
    for name, text in pages.items():
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(text)
    return sorted(pages)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?", default=API_DIR, help="where the pages go")
    args = ap.parse_args(argv)
    names = generate(args.out_dir)
    print(f"wrote {len(names)} pages to {args.out_dir}")


if __name__ == "__main__":
    main()
