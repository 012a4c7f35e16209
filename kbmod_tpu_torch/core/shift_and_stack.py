"""Core shift-and-stack psi/phi generation (pure functions).

API-compatible with the reference's kbmod.core.shift_and_stack
(src/kbmod/core/shift_and_stack.py:8-93) and the JAX package's module of
the same name. The convolution is kernel K1 on the card (its plain twin on
the CPU), through kbmod_tpu_torch.ops.psi_phi. Unlike the JAX package's
functions, which return lists of numpy arrays, these return float32 tensors
on the device.
"""

from kbmod_tpu_torch.ops.psi_phi import (
    generate_psi_phi_images,
    generate_all_psi_phi_images,
    generate_psi_phi_from_image_stack,
)

__all__ = [
    "generate_psi_phi_images",
    "generate_all_psi_phi_images",
    "generate_psi_phi_from_image_stack",
]
