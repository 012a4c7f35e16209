"""Build every CUDA source of the port ahead of use, then run the README's
quick-start shapes once as a smoke check.

    python -m kbmod_tpu_torch.scripts.prewarm [--device cuda|cpu]

The counterpart of the JAX package's scripts/prewarm.py, which runs its
production shapes to fill JAX's persistent compile cache, keyed by shape.
The port has no shape-keyed cache to warm: its kernels are CUDA sources
built by nvcc (``ops/_build.py``) into ``kbmod_tpu_torch/_build/``, keyed
by a hash of the source, and a build serves every shape. So this builds all
of them in parallel (on the card; the host has no nvcc and runs the twins)
and the native host library, then searches the quick-start stack (10 x 512
x 512 float, 441 candidates; K1, K2) to show that the built kernels run.

Each stage prints its wall; a second run finds every library built.
"""

import argparse
import time


def _stage(name, fn):
    t0 = time.perf_counter()
    fn()
    print(f"prewarm {name}: {time.perf_counter() - t0:.1f}s", flush=True)


def build_all():
    """nvcc for every csrc/*.cu (all started together) and g++ for the
    native library. Returns {source: compiler output}."""
    from kbmod_tpu_torch import native
    from kbmod_tpu_torch.ops import _build

    logs = _build.build(sorted(p.stem for p in _build.SRC_DIR.glob("*.cu")))
    if not native.available():
        raise RuntimeError("the native library did not build")
    return logs


def quick_start(dev):
    """The README quick-start block's shapes, on ``dev``."""
    from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
    from kbmod_tpu_torch.search import StackSearch, Trajectory
    from kbmod_tpu_torch.trajectory_generator import KBMODV1Search

    def run():
        ds = FakeDataSet(512, 512, create_fake_times(10, t0=57130.2))
        ds.insert_object(Trajectory(x=300, y=200, vx=10.0, vy=-5.0, flux=500.0))
        stack = ds.stack_py
        search = StackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, -1, device=dev)
        search.set_min_obs(7)
        search.search_all(list(KBMODV1Search(21, 5.0, 15.0, 21, -0.7, -0.2)), True)
        search.get_results(0, 10)

    _stage("readme quick-start (10x512^2 f32, 441 candidates)", run)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    from kbmod_tpu_torch.device import resolve_device
    from kbmod_tpu_torch.ops import _build

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        _stage(f"nvcc build of every source into {_build.BUILD_DIR}", build_all)
    quick_start(dev)
    print(f"prewarm total: {time.perf_counter() - t0:.1f}s (libraries in {_build.BUILD_DIR})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
