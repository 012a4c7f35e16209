"""Host-side image-stack containers.

Port of the JAX package's core/image_stack_py.py. ``ImageStackPy`` holds T science/variance images plus per-time PSF kernels
and timestamps. Masked pixels are represented as NaN in both science and
variance layers. API-compatible with the reference's
``kbmod.core.image_stack_py`` (src/kbmod/core/image_stack_py.py).

These containers are deliberately host/numpy objects: they are the mutable
ingestion-side representation. The device-side search uses the
``PsiPhiArray`` built from them (kbmod_tpu_torch.ops.psi_phi), and the coadd
stamps gather their windows from the per-time images on the host
(kbmod_tpu_torch.ops.stamps). ``get_matched_obstimes`` waits for the rest of
util_functions.
"""

import logging
import numpy as np

from kbmod_tpu_torch.core.psf import PSF

logger = logging.getLogger(__name__)


class LayeredImagePy:
    """All image components for a single time step.

    Attributes
    ----------
    sci : np.ndarray
        The H x W science layer.
    var : np.ndarray
        The H x W variance layer.
    time : float
        The time stamp (UTC MJD).
    mask : np.ndarray
        The H x W boolean/int mask (>0 means masked).
    psf : np.ndarray
        The PSF kernel.
    """

    def __init__(self, sci, var, mask=None, time=0.0, psf=None):
        self.time = time
        self.sci = np.asanyarray(sci, dtype=np.float32)
        self.var = np.asanyarray(var, dtype=np.float32)
        self.psf = np.ones((1, 1), dtype=np.float32) if psf is None else np.asanyarray(psf, dtype=np.float32)
        self.mask = (np.isnan(self.sci) | np.isnan(self.var)) if mask is None else mask

    @property
    def width(self):
        return self.sci.shape[1]

    @property
    def height(self):
        return self.sci.shape[0]


class ImageStackPy:
    """Science and variance image data over T times with metadata.

    Images need not be time-sorted; ``zeroed_times`` are relative to the
    first image's time. Masked pixels are NaN in both sci and var.
    """

    def __init__(self, times=None, sci=None, var=None, mask=None, psfs=None):
        if times is None or len(times) == 0:
            if sci is not None or var is not None:
                raise ValueError("Cannot create an ImageStackPy without times")
            self.num_times = 0
            self.times = np.array([])
            self.sci = []
            self.var = []
            self.psfs = []
            self.height = -1
            self.width = -1
            self.zeroed_times = np.array([])
            return

        self.num_times = len(times)
        self.times = np.asarray(times, dtype=float)
        self.zeroed_times = self.times - self.times[0]

        if sci is None:
            raise ValueError("Missing science data.")
        if len(sci) != self.num_times:
            raise ValueError(f"Expected {self.num_times} science images. Received {len(sci)}.")
        if var is None:
            raise ValueError("Missing variance data.")
        if len(var) != self.num_times:
            raise ValueError(f"Expected {self.num_times} variance images. Received {len(var)}.")
        if mask is not None and len(mask) != self.num_times:
            raise ValueError(f"Expected {self.num_times} mask images. Received {len(mask)}.")

        self.height = len(sci[0])
        self.width = len(sci[0][0])

        self.sci = [self._standardize_image(img) for img in sci]
        self.var = [self._standardize_image(img) for img in var]

        if mask is not None:
            for idx in range(self.num_times):
                m = np.asanyarray(mask[idx])
                if m.shape != self.sci[idx].shape:
                    raise ValueError("Science and Mask data must have the same shape.")
                bad = m > 0
                self.sci[idx][bad] = np.nan
                self.var[idx][bad] = np.nan

        if psfs is None:
            self.psfs = [np.ones((1, 1)) for _ in range(self.num_times)]
        elif len(psfs) != self.num_times:
            raise ValueError(f"PSF data must have {self.num_times} entries.")
        else:
            self.psfs = [p.kernel if isinstance(p, PSF) else np.asanyarray(p) for p in psfs]

    def _standardize_image(self, img):
        """Coerce an image to float32 numpy, updating stack dimensions."""
        img = np.asanyarray(img)
        if img.dtype != np.single:
            img = img.astype(np.single)
        if self.num_times == 0:
            self.height, self.width = img.shape
        # Track the largest dimensions seen (ragged stacks are allowed).
        self.height = max(self.height, img.shape[0])
        self.width = max(self.width, img.shape[1])
        return img

    def __len__(self):
        return self.num_times

    def __eq__(self, other):
        if self.num_times != other.num_times:
            return False
        if self.height != other.height or self.width != other.width:
            return False
        if not np.allclose(self.times, other.times):
            return False
        if not np.allclose(self.zeroed_times, other.zeroed_times):
            return False
        for i in range(self.num_times):
            if not np.allclose(self.sci[i], other.sci[i], equal_nan=True):
                return False
            if not np.allclose(self.var[i], other.var[i], equal_nan=True):
                return False
            if not np.allclose(self.psfs[i], other.psfs[i]):
                return False
        return True

    @property
    def npixels(self):
        return self.height * self.width

    @property
    def total_pixels(self):
        return self.height * self.width * self.num_times

    def get_total_pixels(self):
        return self.total_pixels

    def get_obstime(self, index):
        if index < 0 or index >= self.num_times:
            raise IndexError(f"Index {index} out of range for ImageStackPy.")
        return self.times[index]

    def copy(self):
        return ImageStackPy(
            times=list(self.times),
            sci=[np.copy(img) for img in self.sci],
            var=[np.copy(img) for img in self.var],
            psfs=[np.copy(p) for p in self.psfs],
        )

    def num_masked_pixels(self):
        """The count of masked pixels at each time step."""
        return np.array(
            [np.count_nonzero(np.isnan(s) | np.isnan(v)) for s, v in zip(self.sci, self.var)],
            dtype=float,
        )

    def get_masked_fractions(self):
        """The fraction of masked pixels for each image."""
        return self.num_masked_pixels() / float(self.width * self.height)

    def get_mask(self, index):
        if index < 0 or index >= self.num_times:
            raise IndexError(f"Index {index} out of range for image stack.")
        return np.isnan(self.sci[index]) | np.isnan(self.var[index])

    def scale_images(self, scale_factor, is_magnitude=True):
        """Scale sci by 1/f and var by 1/f^2 where f is the flux scale factor
        (f = 10**(scale/2.5) when ``is_magnitude``)."""
        if np.isscalar(scale_factor):
            scale_factor = np.full(self.num_times, scale_factor)
        else:
            scale_factor = np.asanyarray(scale_factor)
            if scale_factor.shape != (self.num_times,):
                raise ValueError(
                    f"Scale factor array must have shape ({self.num_times},). "
                    f"Received shape {scale_factor.shape}."
                )
        flux_scale = 10 ** (scale_factor / 2.5) if is_magnitude else scale_factor
        for idx in range(self.num_times):
            good = ~(np.isnan(self.sci[idx]) | np.isnan(self.var[idx]))
            self.sci[idx][good] /= flux_scale[idx]
            self.var[idx][good] /= flux_scale[idx] * flux_scale[idx]

    def append_image(self, time, sci, var, mask=None, psf=None):
        """Append an image onto the back of the stack."""
        if mask is not None:
            mask = np.asanyarray(mask)
            if mask.shape != sci.shape:
                raise ValueError("Science and Mask data must have the same shape.")

        idx = self.num_times
        self.sci.append(self._standardize_image(sci))
        self.var.append(self._standardize_image(var))
        if psf is None:
            psf = np.array([[1.0]])
        elif isinstance(psf, PSF):
            psf = psf.kernel
        self.psfs.append(psf)

        if mask is not None:
            bad = mask > 0
            self.sci[idx][bad] = np.nan
            self.var[idx][bad] = np.nan

        self.num_times += 1
        self.times = np.append(self.times, time)
        self.zeroed_times = self.times - self.times[0]

    def append_layered_image(self, layered_image):
        self.append_image(
            layered_image.time,
            layered_image.sci,
            layered_image.var,
            mask=layered_image.mask,
            psf=layered_image.psf,
        )

    def filter_images(self, mask):
        """Keep only the images where ``mask`` is True."""
        mask = np.asanyarray(mask)
        keep = [i for i in range(self.num_times) if mask[i]]
        self.sci = [self.sci[i] for i in keep]
        self.var = [self.var[i] for i in keep]
        self.psfs = [self.psfs[i] for i in keep]
        self.num_times = len(keep)
        self.times = self.times[mask]
        self.zeroed_times = (self.times - self.times[0]) if self.num_times > 0 else []

    def mask_by_science_bounds(self, min_val=-1e20, max_val=1e20):
        """Mask pixels whose science value lies outside the given bounds."""
        for idx in range(self.num_times):
            bad = (self.sci[idx] < min_val) | (self.sci[idx] > max_val)
            self.sci[idx][bad] = np.nan
            self.var[idx][bad] = np.nan

    def mask_by_variance_bounds(self, min_val=1e-20, max_val=1e20):
        """Mask pixels whose variance lies outside the given bounds."""
        for idx in range(self.num_times):
            bad = (self.var[idx] < min_val) | (self.var[idx] > max_val)
            self.sci[idx][bad] = np.nan
            self.var[idx][bad] = np.nan

    def get_single_image(self, index):
        if index < 0 or index >= self.num_times:
            raise IndexError(f"Index {index} out of range for ImageStackPy.")
        return LayeredImagePy(self.sci[index], self.var[index], time=self.times[index], psf=self.psfs[index])

    def set_single_image(self, index, img):
        if index < 0 or index >= self.num_times:
            raise IndexError(f"Index {index} out of range for ImageStackPy.")
        if img.width != self.width or img.height != self.height:
            raise ValueError(
                f"Image shape does not match the ImageStackPy size. Expected ({self.width},{self.height}). "
                f"Received ({img.width}, {img.height})."
            )
        new_sci = self._standardize_image(img.sci)
        new_var = self._standardize_image(img.var)
        bad = img.mask > 0
        if np.any(bad):
            new_sci[bad] = np.nan
            new_var[bad] = np.nan
        self.sci[index] = new_sci
        self.var[index] = new_var
        self.psfs[index] = img.psf
        self.times[index] = img.time
        self.zeroed_times[index] = img.time - self.times[0]

    def sort_by_time(self):
        """Sort images by time; returns the sort indices."""
        order = np.argsort(self.times)
        self.sci = [self.sci[i] for i in order]
        self.var = [self.var[i] for i in order]
        self.psfs = [self.psfs[i] for i in order]
        self.times = self.times[order]
        self.zeroed_times = self.times - self.times[0]
        return order

    def validate(self, masked_fraction=0.5, min_flux=-1e8, max_flux=1e8, min_var=1e-20, max_var=1e8):
        """Run basic sanity checks, logging a warning and returning False on
        any failure."""
        if self.total_pixels == 0 or self.num_times == 0:
            logger.warning("Image stack is empty.")
            return False

        is_valid = True
        for idx in range(self.num_times):
            sci, var = self.sci[idx], self.var[idx]
            masked = np.isnan(sci) | np.isnan(var)
            frac = np.count_nonzero(masked) / (self.height * self.width)
            if frac > masked_fraction:
                logger.warning(f"Image {idx} has {frac * 100.0} percent masked pixels.")
                is_valid = False
            if frac < 1.0:
                checks = [
                    (np.nanmin(sci) < min_flux, f"science {np.nanmin(sci)} < {min_flux}"),
                    (np.nanmax(sci) > max_flux, f"science {np.nanmax(sci)} > {max_flux}"),
                    (np.nanmin(var) < min_var, f"variance {np.nanmin(var)} < {min_var}"),
                    (np.nanmax(var) > max_var, f"variance {np.nanmax(var)} > {max_var}"),
                ]
                for failed, msg in checks:
                    if failed:
                        logger.warning(f"Image {idx} has invalid values: {msg}")
                        is_valid = False
        return is_valid

    def print_stats(self):
        """Print basic statistics of the stack as a table."""
        print("Image Stack Statistics:")
        print(f"  Image Count: {self.num_times}")
        print(f"  Image Size: {self.height} x {self.width} = {self.npixels}")
        for idx in range(self.num_times):
            masked = np.isnan(self.sci[idx]) | np.isnan(self.var[idx]) | (self.var[idx] <= 0.0)
            pct = 100.0 * np.count_nonzero(masked) / self.npixels
            print(
                f"  [{idx:4d}] t={self.times[idx]:10.3f} "
                f"flux=[{np.nanmin(self.sci[idx]):.2f}, {np.nanmax(self.sci[idx]):.2f}] "
                f"mean={np.nanmean(self.sci[idx]):.2f} "
                f"var=[{np.nanmin(self.var[idx]):.2f}, {np.nanmax(self.var[idx]):.2f}] "
                f"masked={pct:.2f}%"
            )

    # --- stacked layers ---

    def stacked_sci(self):
        """Return the science layers as one (T, H, W) float32 array."""
        return np.stack(self.sci, axis=0) if self.num_times else np.zeros((0, 0, 0), np.float32)

    def stacked_var(self):
        """Return the variance layers as one (T, H, W) float32 array."""
        return np.stack(self.var, axis=0) if self.num_times else np.zeros((0, 0, 0), np.float32)


