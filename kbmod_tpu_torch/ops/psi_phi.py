"""PsiPhiArray: the device-resident, search-ready psi/phi planes.

psi = conv(sci / var, PSF) and phi = conv(1 / var, PSF^2) are the per-pixel
likelihood components; the search sums them along candidate paths
(the reference's src/kbmod/core/shift_and_stack.py:8-45 and
psi_phi_array.cpp). Port of the JAX package's ops/psi_phi.py. The float
path keeps psi and phi as separate (T, H, W) float32 tensors, zero at masked
pixels, beside a uint8 validity plane. The quantized path (num_bytes 1 or 2)
keeps uint8/uint16 code planes where code 0 means masked and a valid value
v is stored as floor((clamp(v) - min) / scale + 1), the reference's encoding
(psi_phi_array_ds.h:40-47). Everything is built on the device by kernel K1
(ops/conv_kernel.py) and plain PyTorch ops, and stays there.

A build is traced in the stages ``build.stage`` (the host's stack and
float32 cast), ``build.upload`` (the copy to the device, counted in
``bytes.h2d``), ``build.conv`` (K1), ``build.scale`` (the quantized build's
min/max pass) and ``build.encode`` (the codes and their pair writes, or the
float planes' zero fill and validity plane).
"""

import numpy as np
import torch

from kbmod_tpu_torch import tracing
from kbmod_tpu_torch.device import resolve_device
from kbmod_tpu_torch.ops.conv_kernel import psi_phi_conv

_CODE_DTYPES = {1: torch.uint8, 2: torch.uint16}


# ----------------------------------------------------------------------
# psi / phi generation
# ----------------------------------------------------------------------

def _psi_phi_from_sci_var(sci, var, psf):
    """Fused psi/phi generation for a batch of images sharing one PSF.

    sci, var: (N, H, W) float32 tensors (NaN = masked); psf: (kh, kw)
    float32 tensor on the host, where K1 builds its tap table. Returns psi,
    phi: (N, H, W) float32 with NaN at masked pixels. Runs kernel K1 on a
    card, its plain twin on the CPU.
    """
    return psi_phi_conv(sci, var, psf)


def _upload(sci, var, chunk, device):
    """The images ``chunk`` of sci and var as (N, H, W) float32 tensors on
    ``device``: stacked and cast on the host, then copied."""
    with tracing.span("build.stage"):
        sci_h = np.stack([np.asarray(sci[i], dtype=np.float32) for i in chunk])
        var_h = np.stack([np.asarray(var[i], dtype=np.float32) for i in chunk])
    with tracing.span("build.upload"):
        tracing.count("bytes.h2d", sci_h.nbytes + var_h.nbytes)
        return torch.as_tensor(sci_h).to(device), torch.as_tensor(var_h).to(device)


def _conv_batch_budget(device):
    """Bytes one psi/phi build dispatch may hold: an eighth of the card's
    memory, or 2 GiB on the host."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 8
    return 2 * 2**30


def _conv_batch(device, h, w):
    """Images of one build dispatch: four float planes an image within :func:`_conv_batch_budget`."""
    return max(1, int(_conv_batch_budget(device) // (4 * h * w * 4)))


def _psf_conv_groups(sci, psfs, device):
    """Group image indices by identical PSF kernel, with a batch size of
    :func:`_conv_batch`. Returns (groups: {key: [indices]}, kernels, batch)."""
    kernels = [np.asanyarray(getattr(p, "kernel", p), dtype=np.float32) for p in psfs]
    groups = {}
    for i, k in enumerate(kernels):
        groups.setdefault((k.shape, k.tobytes()), []).append(i)
    return groups, kernels, _conv_batch(device, *np.asanyarray(sci[0]).shape)


def planes_bytes(num_bytes, T, H, W):
    """Device bytes of a PsiPhiArray's planes: float psi, phi and validity (9 bytes a
    pixel and time), or uint8/uint16 code pairs (2 or 4 a pixel of the padded width)."""
    if num_bytes in (1, 2):
        return 2 * num_bytes * T * H * padded_width(W)
    return 9 * T * H * W


def build_bytes(num_bytes, T, H, W, device):
    """Device bytes a build holds beside the kept planes: K1's inputs and
    outputs for a batch of images (16 bytes a pixel, 48 with the encode's
    temporaries), twice where there are several batches (the next arrives
    while the last is held), and the float path's unpacked planes and masks
    (:func:`fill_psi_phi_array`)."""
    hw = H * W
    batch = min(T, _conv_batch(device, H, W))
    live = batch * (2 if batch < T else 1)
    if num_bytes in (1, 2):
        return 48 * live * hw
    return max(8 * T * hw + 16 * live * hw, 11 * T * hw)


def generate_all_psi_phi_images(sci, var, psfs, device=None):
    """psi/phi planes for lists of sci/var images and PSFs.

    Images sharing a PSF are convolved in batches on the device. Returns
    (psi, phi) as (T, H, W) float32 tensors on the device, NaN at masked
    pixels.
    """
    dev = resolve_device(device)
    num = len(sci)
    h, w = np.asanyarray(sci[0]).shape
    psi = torch.empty((num, h, w), dtype=torch.float32, device=dev)
    phi = torch.empty((num, h, w), dtype=torch.float32, device=dev)
    groups, kernels, batch = _psf_conv_groups(sci, psfs, dev)
    for idxs in groups.values():
        k = torch.as_tensor(kernels[idxs[0]])
        for lo in range(0, len(idxs), batch):
            chunk = idxs[lo : lo + batch]
            sci_b, var_b = _upload(sci, var, chunk, dev)
            with tracing.span("build.conv"):
                psi_b, phi_b = _psi_phi_from_sci_var(sci_b, var_b, k)
                where = torch.as_tensor(chunk, device=dev)
                psi.index_copy_(0, where, psi_b)
                phi.index_copy_(0, where, phi_b)
    return psi, phi


def generate_psi_phi_images(sci, var, psf, device=None):
    """psi/phi planes of one time step: kernel K1 on ``sci`` and ``var``
    (H, W) with ``psf`` (an array or a PSF). Returns (psi, phi) as (H, W)
    float32 tensors on the device, NaN at masked pixels, where the JAX
    package's function returns numpy arrays."""
    dev = resolve_device(device)
    kernel = torch.as_tensor(np.asarray(getattr(psf, "kernel", psf), dtype=np.float32))
    sci_b = torch.as_tensor(np.asarray(sci, dtype=np.float32)[None]).to(dev)
    var_b = torch.as_tensor(np.asarray(var, dtype=np.float32)[None]).to(dev)
    psi, phi = _psi_phi_from_sci_var(sci_b, var_b, kernel)
    return psi[0], phi[0]


def generate_psi_phi_from_image_stack(stack, device=None):
    """psi/phi planes of an ImageStackPy, as :func:`generate_all_psi_phi_images`
    returns them: (T, H, W) float32 tensors on the device, where the JAX
    package's function returns lists of numpy arrays."""
    return generate_all_psi_phi_images(stack.sci, stack.var, stack.psfs, device=device)


# ----------------------------------------------------------------------
# Quantization helpers (parity with psi_phi_array_ds.h:40-47)
# ----------------------------------------------------------------------

def compute_scale_params_from_image_vect(imgs, num_bytes):
    """Global (min, max, scale) over the finite values of a list of images
    (arrays or tensors), as Python floats. Mirrors psi_phi_array.cpp:219-245."""
    min_val = np.inf
    max_val = -np.inf
    for img in imgs:
        a = torch.as_tensor(img)
        finite = a[torch.isfinite(a)]
        if finite.numel():
            min_val = min(min_val, float(finite.min()))
            max_val = max(max_val, float(finite.max()))
    scale = 1.0
    if num_bytes == 1 or num_bytes == 2:
        width = max_val - min_val
        if width < 1e-6:
            width = 1e-6
        num_values = (1 << (8 * num_bytes)) - 1
        scale = width / float(num_values)
    return [min_val, max_val, scale]


def encode_uint_scalar(value, min_val, max_val, scale):
    """Encode one float as the reference does (psi_phi_array_ds.h:40-42):
    invalid -> 0; valid -> (clamp(value) - min) / scale + 1."""
    if not np.isfinite(value):
        return 0.0
    return (min(max(value, min_val), max_val) - min_val) / scale + 1.0


def decode_uint_scalar(value, min_val, scale):
    """Decode one encoded value (psi_phi_array_ds.h:44-46)."""
    if value == 0.0:
        return float("nan")
    return (value - 1.0) * scale + min_val


def _f32(value, device):
    """A 0-dim float32 tensor on ``device``. Arithmetic with it rounds as
    float32 on both sides, and a CUDA division by it is a true division (a
    division by a Python number there multiplies by its reciprocal)."""
    return torch.tensor(np.float32(value), device=device)


def _storage(codes):
    """The tensor to run ops on for a code tensor: a uint16 tensor is viewed
    as int16 (PyTorch's uint16 supports few ops), a uint8 one is itself."""
    return codes.view(torch.int16) if codes.dtype == torch.uint16 else codes


def _zero_codes(shape, dtype, device):
    if dtype == torch.uint16:
        return torch.zeros(shape, dtype=torch.int16, device=device).view(torch.uint16)
    return torch.zeros(shape, dtype=dtype, device=device)


def _encode(a, mn, safe_max, scale, dtype):
    """Codes of a float32 tensor: 0 where non-finite, else
    floor((clamp(a, mn, safe_max) - mn) / scale + 1), every step in
    float32. The bounds and scale are 0-dim float32 tensors on a's device."""
    ok = torch.isfinite(a)
    clamped = torch.minimum(torch.maximum(torch.where(ok, a, mn), mn), safe_max)
    codes = torch.floor((clamped - mn) / scale + 1.0)
    zero = torch.zeros((), dtype=torch.float32, device=a.device)
    codes = torch.where(ok, codes, zero).to(torch.int32)
    if dtype == torch.uint16:
        # Codes up to 65535 wrap to int16 and come back as uint16.
        return codes.to(torch.int16).view(torch.uint16)
    return codes.to(dtype)


def _encode_array(imgs, min_val, max_val, scale, dtype):
    """Encode a (T, H, W) float32 tensor with Python-float parameters, as
    the JAX package's numpy ``_encode_array`` (ops/psi_phi.py:317) does
    under NumPy 2 scalar rules: the parameters round to float32, except
    ``safe_max = max - scale / 100``, which is taken in float64 first."""
    dev = imgs.device
    return _encode(
        imgs, _f32(min_val, dev), _f32(max_val - scale / 100.0, dev), _f32(scale, dev), dtype
    )


def _encode_chunk(a, params, dtype):
    """Device encode with float32 parameters (min, max, scale), mirroring
    the JAX package's ``_encode_chunk`` (ops/psi_phi.py:153): ``safe_max``
    is taken in float32 too."""
    mn, mx, scale = (np.float32(v) for v in params)
    safe_max = mx - scale / np.float32(100.0)
    dev = a.device
    return _encode(a, _f32(mn, dev), _f32(safe_max, dev), _f32(scale, dev), dtype)


def _codes_as_int(codes):
    """uint8/uint16 codes as int32."""
    if codes.dtype == torch.uint16:
        return codes.view(torch.int16).to(torch.int32) & 0xFFFF
    return codes.to(torch.int32)


def decode_codes(codes, min_val, scale):
    """Decoded float32 values of a code tensor, 0.0 where the code is 0:
    (code - 1) * scale + min in float32, the multiply and the add rounded
    separately."""
    dev = codes.device
    c = _codes_as_int(codes)
    val = (c.to(torch.float32) - 1.0) * _f32(scale, dev) + _f32(min_val, dev)
    return torch.where(c != 0, val, torch.zeros((), dtype=torch.float32, device=dev))


def _set_meta(meta, num_bytes, num_times, height, width):
    meta.num_bytes = num_bytes if num_bytes in (1, 2) else 4
    meta.block_size = meta.num_bytes
    meta.num_times = num_times
    meta.height = height
    meta.width = width
    meta.pixels_per_image = height * width
    meta.num_entries = 2 * meta.pixels_per_image * num_times
    meta.total_array_size = meta.block_size * meta.num_entries


# ----------------------------------------------------------------------
# Streaming device-side quantized build
# ----------------------------------------------------------------------

def _finite_minmax(a):
    """(min, max) over the finite values of a tensor, as 0-dim tensors on
    its device (inf, -inf when there are none)."""
    ok = torch.isfinite(a)
    inf = torch.full((), float("inf"), dtype=a.dtype, device=a.device)
    return torch.where(ok, a, inf).amin(), torch.where(ok, a, -inf).amax()


def fill_psi_phi_array_streaming(result, num_bytes, sci, var, psfs, zeroed_times, device=None):
    """Quantized build in two passes over the stack, both on the device:

      pass 1  K1 on each sci/var chunk, then the finite min/max of psi and
              phi (four numbers per chunk, read once at the end);
      pass 2  K1 again, encode with the global parameters and write the
              codes into the array's one (T, H, Wp, 2) code-pair tensor.

    Float psi/phi never exist for more than one chunk. Port of the JAX
    package's ``fill_psi_phi_array_streaming`` (ops/psi_phi.py:179); the
    codes equal :func:`fill_psi_phi_array`'s up to the float32 rounding of
    ``safe_max`` (a code moves only if a value lies within an ulp of it).
    """
    num_times = len(sci)
    if num_times == 0:
        raise RuntimeError("No images to fill PsiPhiArray.")
    dev = resolve_device(device)
    height, width = np.asanyarray(sci[0]).shape
    nbits = 8 * num_bytes
    groups, kernels, batch = _psf_conv_groups(sci, psfs, dev)

    def chunks():
        for idxs in groups.values():
            k = torch.as_tensor(kernels[idxs[0]])
            for lo in range(0, len(idxs), batch):
                chunk = idxs[lo : lo + batch]
                yield (k, chunk, *_upload(sci, var, chunk, dev))

    # Pass 1: global finite min/max (psi_phi_array.cpp:219-245 semantics),
    # four numbers per chunk, read once.
    mms = []
    for k, _, sci_b, var_b in chunks():
        with tracing.span("build.conv"):
            psi_b, phi_b = _psi_phi_from_sci_var(sci_b, var_b, k)
        with tracing.span("build.scale"):
            mms.append(torch.stack([*_finite_minmax(psi_b), *_finite_minmax(phi_b)]))
    with tracing.span("build.scale"):
        mms = torch.stack(mms).tolist()
    psi_min = min(m[0] for m in mms)
    psi_max = max(m[1] for m in mms)
    phi_min = min(m[2] for m in mms)
    phi_max = max(m[3] for m in mms)

    def scale_of(mn, mx):
        return max(mx - mn, 1e-6) / float((1 << nbits) - 1)

    psi_params = (psi_min, psi_max, scale_of(psi_min, psi_max))
    phi_params = (phi_min, phi_max, scale_of(phi_min, phi_max))

    # Pass 2: encode each chunk and write its planes into the code pairs.
    dtype = _CODE_DTYPES[num_bytes]
    pairs = _zero_codes((num_times, height, padded_width(width), 2), dtype, dev)
    for k, chunk, sci_b, var_b in chunks():
        with tracing.span("build.conv"):
            psi_b, phi_b = _psi_phi_from_sci_var(sci_b, var_b, k)
        with tracing.span("build.encode"):
            psi_e = _storage(_encode_chunk(psi_b, psi_params, dtype))
            phi_e = _storage(_encode_chunk(phi_b, phi_params, dtype))
            for j, i in enumerate(chunk):
                _storage(pairs)[i, :, :width, 0] = psi_e[j]
                _storage(pairs)[i, :, :width, 1] = phi_e[j]

    meta = result.meta
    _set_meta(meta, num_bytes, num_times, height, width)
    meta.psi_min_val, meta.psi_max_val, meta.psi_scale = psi_params
    meta.phi_min_val, meta.phi_max_val, meta.phi_scale = phi_params
    result._set_pairs(pairs, width)
    result.times = np.asarray(zeroed_times, dtype=float)
    result._on_device = False
    return result


# ----------------------------------------------------------------------
# PsiPhiArray
# ----------------------------------------------------------------------

class PsiPhi:
    """Named (psi, phi) value pair (psi_phi_array_ds.h:33-38)."""

    __slots__ = ("psi", "phi")

    def __init__(self, psi=0.0, phi=0.0):
        self.psi = psi
        self.phi = phi

    def __iter__(self):
        return iter((self.psi, self.phi))

    def __repr__(self):
        return f"PsiPhi(psi={self.psi}, phi={self.phi})"


class PsiPhiArrayMeta:
    """Metadata mirror of the reference's PsiPhiArrayMeta
    (psi_phi_array_ds.h:49-67)."""

    def __init__(self):
        self.num_times = 0
        self.width = 0
        self.height = 0
        self.pixels_per_image = 0
        self.num_entries = 0
        self.block_size = 0
        self.total_array_size = 0
        self.num_bytes = 4
        self.psi_min_val = np.inf
        self.psi_max_val = -np.inf
        self.psi_scale = 1.0
        self.phi_min_val = np.inf
        self.phi_max_val = -np.inf
        self.phi_scale = 1.0


class PsiPhiArray:
    """The psi/phi planes for the search.

    Attributes
    ----------
    psi, phi : torch.Tensor (T, H, W)
        float32, zero at masked pixels; or uint8/uint16 codes, 0 = masked,
        which are views into the one code-pair tensor (:meth:`code_pairs`).
    valid : torch.Tensor (T, H, W) uint8, or None
        Validity plane of the float path (quantized arrays have none: code
        0 is the validity signal there).
    times : np.ndarray (T,)
        Zero-shifted times.
    """

    def __init__(self):
        self.meta = PsiPhiArrayMeta()
        self.psi = None
        self.phi = None
        self.valid = None
        self.times = np.array([])
        self._on_device = False
        self._pairs = None

    def _set_codes(self, psi_codes, phi_codes):
        self._set_pairs(interleave_code_pairs(psi_codes, phi_codes), psi_codes.shape[2])

    def _set_pairs(self, pairs, width):
        self._pairs = pairs
        self.psi, self.phi = code_pair_views(pairs, width)
        self.valid = None

    def encode_meta(self):
        """The (4,) float32 decode vector [psi_min, psi_scale, phi_min,
        phi_scale] of a quantized array, as the search kernels take it."""
        m = self.meta
        return np.array([m.psi_min_val, m.psi_scale, m.phi_min_val, m.phi_scale], dtype=np.float32)

    def code_pairs(self):
        """The one tensor that holds a quantized array's codes, in the layout
        the encoded search kernels read: (T, H, Wp, 2) (psi, phi) codes, Wp
        the width rounded up to 8 with zero (masked) columns, so that a
        uint8 pair is one aligned 16-bit word and a uint16 pair one 32-bit
        word, and a row starts on a 16-byte boundary. ``psi`` and ``phi``
        are views into it. Quantized arrays only."""
        if self.meta.num_bytes not in (1, 2):
            raise RuntimeError("code_pairs requires a uint8/uint16 quantized array.")
        return self._pairs

    # --- reference-compatible metadata accessors ---
    @property
    def on_gpu(self):
        return self._on_device

    def get_meta_data(self):
        return self.meta

    def get_num_times(self):
        return self.meta.num_times

    def get_width(self):
        return self.meta.width

    def get_height(self):
        return self.meta.height

    def get_num_bytes(self):
        return self.meta.num_bytes

    def get_psi_min_val(self):
        return self.meta.psi_min_val

    def get_psi_max_val(self):
        return self.meta.psi_max_val

    def get_psi_scale(self):
        return self.meta.psi_scale

    def get_phi_min_val(self):
        return self.meta.phi_min_val

    def get_phi_max_val(self):
        return self.meta.phi_max_val

    def get_phi_scale(self):
        return self.meta.phi_scale

    def read_time(self, index):
        if index < 0 or index >= self.meta.num_times:
            raise RuntimeError(f"Out of bounds read for time step. [{index}]")
        return float(self.times[index])

    def set_time_array(self, times):
        self.times = np.asarray(times, dtype=float)

    def clear(self):
        self.psi = None
        self.phi = None
        self.valid = None
        self.meta = PsiPhiArrayMeta()
        self.times = np.array([])
        self._on_device = False
        self._pairs = None

    def move_to_gpu(self):
        """Mark the planes as preloaded (they are built on the device)."""
        if self.psi is not None:
            self._on_device = True

    def clear_from_gpu(self):
        self._on_device = False

    def decoded_psi_phi(self):
        """(psi, phi, valid) device tensors: float32 planes zero at masked
        pixels and a uint8 validity plane. A quantized array decodes its
        codes here (validity from the psi code alone, as the JAX package's
        ops/psi_phi.py:510-526); the search itself never calls this for
        one."""
        if self.meta.num_bytes == 4:
            return self.psi, self.phi, self.valid
        m = self.meta
        valid = (_codes_as_int(self.psi) != 0).to(torch.uint8)
        return decode_codes(self.psi, m.psi_min_val, m.psi_scale), decode_codes(self.phi, m.phi_min_val, m.phi_scale), valid

    def read_psi_phi(self, time, row, col):
        """Read a single (psi, phi) value pair; out-of-bounds or masked reads
        return NaN. Mirrors psi_phi_array.cpp:172-205."""
        if (
            self.psi is None
            or row < 0
            or col < 0
            or row >= self.meta.height
            or col >= self.meta.width
            or time >= self.meta.num_times
        ):
            return PsiPhi(float("nan"), float("nan"))
        if self.meta.num_bytes in (1, 2):
            psi_code = float(_codes_as_int(self.psi[time, row, col]))
            phi_code = float(_codes_as_int(self.phi[time, row, col]))
            return PsiPhi(
                decode_uint_scalar(psi_code, self.meta.psi_min_val, self.meta.psi_scale),
                decode_uint_scalar(phi_code, self.meta.phi_min_val, self.meta.phi_scale),
            )
        if not bool(self.valid[time, row, col]):
            return PsiPhi(float("nan"), float("nan"))
        return PsiPhi(float(self.psi[time, row, col]), float(self.phi[time, row, col]))


def padded_width(width):
    return -(-width // 8) * 8


def interleave_code_pairs(psi_codes, phi_codes):
    """(T, H, W) uint8/uint16 psi and phi codes -> a (T, H, Wp, 2) tensor of
    the same type holding (psi, phi) side by side, Wp = W rounded up to 8,
    the extra columns zero. Built one time plane at a time."""
    T, H, W = psi_codes.shape
    pairs = _zero_codes((T, H, padded_width(W), 2), psi_codes.dtype, psi_codes.device)
    for t in range(T):
        _storage(pairs)[t, :, :W, 0] = _storage(psi_codes)[t]
        _storage(pairs)[t, :, :W, 1] = _storage(phi_codes)[t]
    return pairs


def code_pair_views(pairs, width):
    """The (T, H, W) psi and phi code planes of a (T, H, Wp, 2) code-pair
    tensor, as strided views (no copy)."""
    return pairs[:, :, :width, 0], pairs[:, :, :width, 1]


def _as_stack(imgs, device):
    if isinstance(imgs, torch.Tensor):
        return imgs.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.stack([np.asarray(p, dtype=np.float32) for p in imgs])).to(device)


def fill_psi_phi_array(result, num_bytes, psi_imgs, phi_imgs, zeroed_times, device=None):
    """Pack psi/phi images (a list of (H, W) arrays, or one (T, H, W)
    tensor each) into a PsiPhiArray on the device, quantizing for
    num_bytes 1 and 2. Mirrors psi_phi_array.cpp:321-372: the float
    encodings keep zero-filled planes plus the uint8 validity plane; the
    quantized ones encode each plane with its global finite min/max."""
    num_times = len(psi_imgs)
    if num_times == 0:
        raise RuntimeError("No images to fill PsiPhiArray.")
    dev = resolve_device(device)
    psi = _as_stack(psi_imgs, dev)
    phi = _as_stack(phi_imgs, dev)
    meta = result.meta
    _set_meta(meta, num_bytes, num_times, psi.shape[1], psi.shape[2])
    if meta.num_bytes in (1, 2):
        with tracing.span("build.scale"):
            psi_params = compute_scale_params_from_image_vect(psi, meta.num_bytes)
            phi_params = compute_scale_params_from_image_vect(phi, meta.num_bytes)
        meta.psi_min_val, meta.psi_max_val, meta.psi_scale = psi_params
        meta.phi_min_val, meta.phi_max_val, meta.phi_scale = phi_params
        dtype = _CODE_DTYPES[meta.num_bytes]
        with tracing.span("build.encode"):
            result._set_codes(_encode_array(psi, *psi_params, dtype), _encode_array(phi, *phi_params, dtype))
    else:
        with tracing.span("build.encode"):
            valid = torch.isfinite(psi) & torch.isfinite(phi)
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            result.psi = torch.where(valid, psi, zero)
            result.phi = torch.where(valid, phi, zero)
            result.valid = valid.to(torch.uint8)
            result._pairs = None
    result.times = np.asarray(zeroed_times, dtype=float)
    # As in the reference, building the array does not mark it "on GPU";
    # an explicit move_to_gpu does.
    result._on_device = False
    return result


def fill_psi_phi_array_from_image_arrays(result, num_bytes, sci, var, psfs, zeroed_times, device=None):
    """Generate psi/phi from sci/var/psf on the device and pack them.
    Mirrors psi_phi_array.cpp:374-410. Quantized builds stream
    (:func:`fill_psi_phi_array_streaming`)."""
    dev = resolve_device(device)
    if num_bytes in (1, 2):
        return fill_psi_phi_array_streaming(result, num_bytes, sci, var, psfs, zeroed_times, device=dev)
    psi, phi = generate_all_psi_phi_images(sci, var, psfs, device=dev)
    return fill_psi_phi_array(result, num_bytes, psi, phi, zeroed_times, device=dev)


def psi_phi_array_from_numpy(psi, phi, valid, times, meta, device=None):
    """A PsiPhiArray holding given planes, for example the arrays of a JAX
    package PsiPhiArray: (T, H, W) psi, phi (float32, zero-filled) and valid
    (uint8) as numpy for the float encodings; for num_bytes 1 and 2, psi and
    phi are the uint8/uint16 code planes and ``valid`` is ignored. ``meta``
    is any object with that PsiPhiArrayMeta's attributes (min/max/scale
    included); it is copied."""
    dev = resolve_device(device)
    result = PsiPhiArray()
    for name in vars(result.meta):
        setattr(result.meta, name, getattr(meta, name))
    if result.meta.num_bytes in (1, 2):
        wide = result.meta.num_bytes == 2

        def codes(a):
            # uint16 planes cross as their int16 bit pattern.
            a = np.array(a, dtype=np.uint16 if wide else np.uint8, order="C")
            c = torch.as_tensor(a.view(np.int16) if wide else a, device=dev)
            return c.view(torch.uint16) if wide else c

        result._set_codes(codes(psi), codes(phi))
    else:
        result.psi = torch.as_tensor(np.asarray(psi, dtype=np.float32), device=dev)
        result.phi = torch.as_tensor(np.asarray(phi, dtype=np.float32), device=dev)
        result.valid = torch.as_tensor(np.asarray(valid, dtype=np.uint8), device=dev)
    result.times = np.asarray(times, dtype=float)
    return result
