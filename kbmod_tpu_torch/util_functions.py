"""Small shared utility functions: the part of the JAX package's
util_functions.py that the pipeline needs (``mjd_to_day``, for the nightly
coadds). The rest of that module is not ported yet."""

__all__ = ["mjd_to_day"]


def mjd_to_day(mjd):
    """Convert an MJD timestamp to a YYYY-MM-DD day string (UTC)."""
    from kbmod_tpu_torch.geom.time_utils import mjd_to_datetime

    return mjd_to_datetime(mjd).strftime("%Y-%m-%d")
