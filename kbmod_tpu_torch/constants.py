"""Framework-wide constants (a copy of the JAX package's constants.py).

Mirrors the reference's src/kbmod/search/common.h:24-35, minus its
thread-geometry constants.
"""

import math

# The NO_DATA flag indicates masked values in the image (common.h:35).
KB_NO_DATA = float("nan")

# Maximum stamp sizes kept for API parity (common.h:25).
MAX_STAMP_EDGE = 64

# The reference caps GPU stacks at 200 images (common.h:31). The port's
# search kernels stage time steps in blocks, so there is NO hard cap here;
# this constant exists only so compat code can reference it.
REFERENCE_MAX_NUM_IMAGES = 200


def pixel_value_valid(value):
    """Check that a pixel value is valid (finite, not NO_DATA).

    Mirrors common.h:41."""
    return math.isfinite(value)
