"""kbmod_tpu_torch: the PyTorch and CUDA port of kbmod_tpu's shift-and-stack
search, for NVIDIA Hopper cards.

It mirrors the JAX package's module names (``search``, ``ops``, ``core``,
``fake_data``, ``trajectory_generator``, and the pipeline's
``run_search``, ``configuration``, ``results``, ``filters``) and imports
nothing from it. Entry points run on CUDA unless the caller passes
``device="cpu"``; asking for CUDA (the default) on a host without a card
raises. The search kernels are CUDA C++ under ``csrc/``, built with nvcc at
first use.
"""

from kbmod_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
