"""Sigma-G clipping of light curves.

Robust standard deviation from a percentile spread (Smotherman et al. 2021):
sigma_G = coeff * (percentile_hi - percentile_lo), with coeff derived from
the inverse Gaussian CDF. Port of the JAX package's filters/sigma_g_filter.py
(API-compatible with the reference's kbmod.filters.sigma_g_filter): the
batched matrix path runs ``torch.nanquantile`` on the clipper's device where
the JAX package runs ``jnp.nanquantile``.
"""

import logging

import numpy as np
import torch
from scipy.special import erfinv

from kbmod_tpu_torch.device import resolve_device
from kbmod_tpu_torch.utils.debug_timer import DebugTimer

logger = logging.getLogger(__name__)

# Curve elements one nanquantile call takes (it sorts them all).
_QUANTILE_CHUNK = 1 << 24


def _clip_matrix(lh, q_lo, q_hi, n_sigma_coeff, clip_negative):
    """The per-row validity mask of sigma-G clipping, on lh's device.

    lh: (N, T) float32 light curves (NaN allowed). The percentiles
    interpolate linearly between the sorted finite values, as
    ``jnp.nanquantile`` does; the spread has a floor of 1e-5 and the bounds
    are strict.
    """
    masked = torch.where(lh > 0.0, lh, torch.nan) if clip_negative else lh
    q = torch.tensor([q_lo, 0.5, q_hi], dtype=torch.float32, device=lh.device)
    lower_per, median, upper_per = torch.nanquantile(masked, q, dim=1, interpolation="linear")
    delta = torch.clamp(upper_per - lower_per, min=1e-5)
    n_sigma_g = torch.tensor(n_sigma_coeff, dtype=torch.float32, device=lh.device) * delta
    lower_bnd = (median - n_sigma_g)[:, None]
    upper_bnd = (median + n_sigma_g)[:, None]
    return torch.isfinite(lh) & (lh < upper_bnd) & (lh > lower_bnd)


class SigmaGClipping:
    """Sigma-G clipping configuration.

    Attributes
    ----------
    low_bnd, high_bnd : float
        Percentiles (0-100) bounding the spread estimate.
    n_sigma : float
        Number of sigma-G for the clip bounds.
    clip_negative : bool
        Drop non-positive values before computing percentiles.
    coeff : float
        1 / (z(high) - z(low)) from the inverse Gaussian CDF.
    device : torch.device
        Where the batched clipping runs: CUDA unless ``device="cpu"``.
    """

    def __init__(self, low_bnd=25, high_bnd=75, n_sigma=2, clip_negative=False, device=None):
        if low_bnd > high_bnd or low_bnd <= 0.0 or high_bnd >= 100.0:
            raise ValueError(f"Invalid bounds [{low_bnd}, {high_bnd}]")
        if n_sigma <= 0.0:
            raise ValueError(f"Invalid n_sigma {n_sigma}")
        self.low_bnd = low_bnd
        self.high_bnd = high_bnd
        self.n_sigma = n_sigma
        self.coeff = SigmaGClipping.find_sigma_g_coeff(low_bnd, high_bnd)
        self.clip_negative = clip_negative
        self.device = resolve_device(device)

    @staticmethod
    def find_sigma_g_coeff(low_bnd, high_bnd):
        """coeff = 1 / (z(high) - z(low)) where z is the inverse Gaussian
        CDF (reference sigma_g_filter.py:50-83)."""
        if high_bnd <= low_bnd or low_bnd < 0 or high_bnd > 100:
            raise ValueError(f"Invalid percentiles for sigma G coefficient [{low_bnd}, {high_bnd}]")
        x1 = SigmaGClipping.invert_gauss_cdf(low_bnd / 100.0)
        x2 = SigmaGClipping.invert_gauss_cdf(high_bnd / 100.0)
        return 1.0 / (x2 - x1)

    @staticmethod
    def invert_gauss_cdf(z):
        sign = -1 if z < 0.5 else 1
        return float(sign * np.sqrt(2) * erfinv(sign * (2 * z - 1)))

    def compute_clipped_sigma_g(self, lh):
        """Indices of a single curve that survive the clipping."""
        lh = np.asarray(lh)
        if self.clip_negative:
            if np.count_nonzero(lh > 0) == 0:
                return np.array([])
            lower_per, median, upper_per = np.percentile(lh[lh > 0], [self.low_bnd, 50, self.high_bnd])
        else:
            lower_per, median, upper_per = np.percentile(lh, [self.low_bnd, 50, self.high_bnd])
        delta = max(upper_per - lower_per, 1e-8)
        n_sigma_g = self.n_sigma * self.coeff * delta
        return np.where((lh > median - n_sigma_g) & (lh < median + n_sigma_g))[0]

    def compute_clipped_sigma_g_matrix(self, lh):
        """(N, T) curves -> (N, T) bool validity after clipping, computed on
        the clipper's device in chunks of rows."""
        lh = np.asanyarray(lh, dtype=np.float32)
        out = np.zeros(lh.shape, dtype=bool)
        rows = max(1, _QUANTILE_CHUNK // max(lh.shape[1], 1))
        q_lo, q_hi = np.float32(self.low_bnd / 100.0), np.float32(self.high_bnd / 100.0)
        coeff = float(np.float32(self.n_sigma * self.coeff))
        for lo in range(0, lh.shape[0], rows):
            chunk = torch.as_tensor(lh[lo : lo + rows], device=self.device)
            mask = _clip_matrix(chunk, float(q_lo), float(q_hi), coeff, self.clip_negative)
            out[lo : lo + rows] = mask.cpu().numpy()
        return out


def apply_clipped_sigma_g(clipper, result_data):
    """Apply sigma-G clipping to a Results object's likelihood curves,
    writing the obs_valid column (reference sigma_g_filter.py:171-190)."""
    if len(result_data) == 0:
        logger.info("SigmaG Clipping : skipping, nothing to filter.")
        return

    filter_timer = DebugTimer("sigma-g filtering", logger)
    lh = result_data.compute_likelihood_curves(filter_obs=True, mask_value=np.nan)
    obs_valid = clipper.compute_clipped_sigma_g_matrix(lh)
    result_data.update_obs_valid(obs_valid)
    filter_timer.stop()
