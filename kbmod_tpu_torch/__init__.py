"""kbmod_tpu_torch: the PyTorch and CUDA port of kbmod_tpu's shift-and-stack
search, for NVIDIA Hopper cards.

It mirrors the JAX package's module names (``search``, ``ops``, ``core``,
``fake_data``, ``trajectory_generator``, the pipeline's ``run_search``,
``configuration``, ``results``, ``filters``, and ``analysis`` and the
``cmdline`` tools) and imports nothing from it. Entry points run on CUDA
unless the caller passes ``device="cpu"``; asking for CUDA (the default) on
a host without a card raises. The search kernels are CUDA C++ under
``csrc/``, built with nvcc at first use.

Environment flags (as the reference's src/kbmod/__init__.py:16-31):
  KB_INTERACTIVE_MODE : force progress bars on/off.
  KB_LOG_LEVEL        : the default logging level of the ``kbmod`` logger.

The JAX package's persistent compilation cache has no counterpart: nvcc's
builds are cached by source hash (``ops/_build.py``).
"""

import logging as _py_logging
import os
import sys

__version__ = "0.1.0"


def is_interactive():
    """Check whether we are running in an interactive session (used to gate
    progress bars). Mirrors reference src/kbmod/__init__.py:16-31."""
    if "KB_INTERACTIVE_MODE" in os.environ:
        return os.environ["KB_INTERACTIVE_MODE"].lower() in ("1", "true", "yes")
    # Heuristic: attached tty or an IPython kernel.
    try:
        if hasattr(sys, "ps1"):
            return True
        return sys.stdout.isatty()
    except Exception:
        return False


def _configure_logging():
    """Set the kbmod logger's level from KB_LOG_LEVEL."""
    level_name = os.environ.get("KB_LOG_LEVEL", "WARNING").upper()
    level = getattr(_py_logging, level_name, _py_logging.WARNING)
    _py_logging.getLogger("kbmod").setLevel(level)


_configure_logging()

from kbmod_tpu_torch.device import resolve_device  # noqa: E402
from kbmod_tpu_torch.search import StackSearch, Trajectory  # noqa: E402
from kbmod_tpu_torch.configuration import SearchConfiguration  # noqa: E402

__all__ = [
    "StackSearch",
    "Trajectory",
    "SearchConfiguration",
    "Standardizer",
    "ImageCollection",
    "WorkUnit",
    "is_interactive",
    "resolve_device",
]


def __getattr__(name):
    """Lazy top-level re-exports (the reference's src/kbmod/__init__.py:96-98)
    that keep the ingestion stack out of ``import kbmod_tpu_torch``."""
    if name == "Standardizer":
        from kbmod_tpu_torch.standardizers import Standardizer

        return Standardizer
    if name == "ImageCollection":
        from kbmod_tpu_torch.image_collection import ImageCollection

        return ImageCollection
    if name == "WorkUnit":
        from kbmod_tpu_torch.work_unit import WorkUnit

        return WorkUnit
    raise AttributeError(f"module 'kbmod_tpu_torch' has no attribute {name}")
