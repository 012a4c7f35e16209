"""K1's arithmetic on the CPU: the tap table, and the rewrites of the mask
terms that the kernel (csrc/psi_phi_conv.cu) relies on to equal its twin bit
for bit.

The twin sums every tap as a float32 product and a float32 add, i outer and
j inner. For the mask terms am1 = sum k * m and am2 = sum k^2 * m, with m 0
or 1, the product is exact (k, or +-0), so the sum is unchanged bit for bit
when the product is replaced by k with its bits ANDed by an all-ones or zero
mask, or when product and add are one fused multiply-add (the kernel's
FFMA). Both are checked here over random masks, taps of both signs, and
whole neighbourhoods masked. A fused multiply-add is emulated in float64:
k * m is exact there, and a float32 sum rounded through float64 is the
correctly rounded float32 sum. All comparisons are of bits.
"""

import numpy as np
import pytest
import torch

from kbmod_tpu_torch.core.psf import PSF
from kbmod_tpu_torch.ops import conv_kernel


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _fma(a, b, c):
    """float32 a * b + c rounded once (exact for b in {0, 1})."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("shape", [(9, 9), (3, 5), (1, 1), (15, 15)])
def test_mask_terms_equal_and_masked_and_fused_sums(shape):
    rng = np.random.default_rng(sum(shape))
    k = rng.normal(0.0, 1.0, shape).astype(np.float32)  # taps of both signs
    k.flat[0] = -abs(k.flat[0])
    k2 = k * k
    n = 400
    m = (rng.uniform(size=(n,) + shape) < rng.uniform(0.0, 1.0, (n, 1, 1))).astype(np.float32)
    m[0] = 0.0  # a neighbourhood masked whole
    m[1] = 1.0
    m[2, :, : shape[1] // 2 + 1] = 0.0
    zero = np.zeros(n, np.float32)
    for taps in (k, k2):
        plain, anded, fused = zero.copy(), zero.copy(), zero.copy()
        for i in range(shape[0]):
            for j in range(shape[1]):
                mij = m[:, i, j]
                plain = plain + np.float32(taps[i, j]) * mij
                word = np.where(mij > 0, np.uint32(0xFFFFFFFF), np.uint32(0))
                anded = anded + (_bits(taps[i, j]) & word).view(np.float32)
                fused = _fma(np.full(n, taps[i, j], np.float32), mij, fused)
        assert plain.dtype == np.float32
        np.testing.assert_array_equal(_bits(anded), _bits(plain))
        np.testing.assert_array_equal(_bits(fused), _bits(plain))
        assert _bits(plain[0]) == 0  # all masked: +0.0, never -0.0


def _sequential_sum(values):
    """A float32 sum, one add at a time, first value first."""
    acc = np.float32(0.0)
    for v in np.asarray(values, np.float32).ravel():
        acc = np.float32(acc + v)
    return acc


def test_tap_table_is_the_twins():
    psf = PSF.make_gaussian_kernel(1.4)
    psf[0, 0] = -0.01  # a negative tap
    t = conv_kernel.psf_taps(torch.as_tensor(psf))
    n = psf.size
    assert t.dtype == np.float32 and t.shape == (2 * n + 2,)
    np.testing.assert_array_equal(_bits(t[:n]), _bits(psf.ravel()))
    np.testing.assert_array_equal(_bits(t[n : 2 * n]), _bits(psf.ravel() * psf.ravel()))
    assert _bits(t[2 * n]) == _bits(_sequential_sum(psf))
    assert _bits(t[2 * n + 1]) == _bits(_sequential_sum(psf * psf))


# 42 Gaussian PSFs, sigma 0.8 to 3.0 on sizes 5 x 5 to 15 x 15: torch.sum
# adds in another order than a sequential sum for most of them, so a table
# summed on each device rounded differently on each.
GAUSSIANS = [(s, w) for s in np.round(np.linspace(0.8, 3.0, 7), 3) for w in (5, 7, 9, 11, 13, 15)]


@pytest.mark.parametrize("sigma,width", GAUSSIANS)
def test_tap_table_one_order_for_every_form(sigma, width):
    """The same float32 table whether the PSF comes as numpy, as a CPU
    tensor or as a float64 array; its sums are the sequential float32 sums
    in row-major order, whatever torch.sum would give."""
    r = np.arange(width) - width // 2
    g = np.exp(-(r[:, None] ** 2 + r[None, :] ** 2) / (2.0 * sigma**2))
    psf = (g / g.sum()).astype(np.float32)
    n = psf.size
    tables = [conv_kernel.psf_taps(psf), conv_kernel.psf_taps(torch.as_tensor(psf)),
              conv_kernel.psf_taps(psf.astype(np.float64))]
    for t in tables[1:]:
        np.testing.assert_array_equal(_bits(t), _bits(tables[0]))
    t = tables[0]
    assert _bits(t[2 * n]) == _bits(_sequential_sum(psf))
    assert _bits(t[2 * n + 1]) == _bits(_sequential_sum(psf.ravel() * psf.ravel()))


def _replay(sci, var, table, kh, kw):
    """K1 in numpy from its tap table, as the kernel computes it: the mask
    terms fused, the rest one rounded product and one rounded add a tap."""
    n = kh * kw
    k, k2 = table[:n].reshape(kh, kw), table[n : 2 * n].reshape(kh, kw)
    valid = np.isfinite(sci) & np.isfinite(var) & (var > 0)
    with np.errstate(invalid="ignore", divide="ignore"):
        p = np.where(valid, sci / var, np.float32(0)).astype(np.float32)
        f = np.where(valid, np.float32(1) / var, np.float32(0)).astype(np.float32)
    m = valid.astype(np.float32)
    ph, pw = kh // 2, kw // 2
    pad = ((0, 0), (ph, kh - 1 - ph), (pw, kw - 1 - pw))
    pp, fp, mp = (np.pad(a, pad) for a in (p, f, m))
    N, H, W = sci.shape
    apsi, aphi, am1, am2 = (np.zeros((N, H, W), np.float32) for _ in range(4))
    for i in range(kh):
        for j in range(kw):
            win = (slice(None), slice(i, i + H), slice(j, j + W))
            apsi = apsi + k[i, j] * pp[win]
            aphi = aphi + k2[i, j] * fp[win]
            am1 = _fma(np.full_like(am1, k[i, j]), mp[win], am1)
            am2 = _fma(np.full_like(am2, k2[i, j]), mp[win], am2)
    tiny = np.float32(1e-24)
    psi = np.where(valid, apsi * (table[2 * n] / np.maximum(am1, tiny)), np.float32(np.nan))
    phi = np.where(valid, aphi * (table[2 * n + 1] / np.maximum(am2, tiny)), np.float32(np.nan))
    return psi.astype(np.float32), phi.astype(np.float32)


@pytest.mark.parametrize("psf", ["s1.4", "3x5", "1x1"])
def test_kernel_arithmetic_replayed_equals_twin(psf):
    """The kernel's order of operations, replayed in numpy from the tap
    table, equals the twin bit for bit (NaN masks equal, every finite value
    equal), with masked pixels, var <= 0 and a fully masked corner."""
    rng = np.random.default_rng(5)
    N, H, W = 2, 19, 23
    sci = rng.normal(10, 2, (N, H, W)).astype(np.float32)
    var = rng.uniform(1, 4, (N, H, W)).astype(np.float32)
    sci[rng.uniform(size=sci.shape) < 0.08] = np.nan
    var[rng.uniform(size=sci.shape) < 0.03] = -1.0
    sci[0, :6, :6] = np.nan
    if psf == "s1.4":
        k = PSF.make_gaussian_kernel(1.4)
    elif psf == "1x1":
        k = np.ones((1, 1), np.float32)
    else:
        k = rng.uniform(-0.2, 1, (3, 5)).astype(np.float32)
    kt = torch.as_tensor(k)
    table = conv_kernel.psf_taps(kt)
    got = _replay(sci, var, table, *k.shape)
    ref = conv_kernel.psi_phi_conv_plain(torch.as_tensor(sci), torch.as_tensor(var), kt)
    for g, r in zip(got, ref):
        r = r.numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        fin = ~np.isnan(r)
        np.testing.assert_array_equal(_bits(g[fin]), _bits(r[fin]))
