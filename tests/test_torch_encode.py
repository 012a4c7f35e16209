"""Port parity for the quantized psi/phi build: the JAX package's encoders
against kbmod_tpu_torch's on identical float inputs (NaN and inf pixels
included), with ``device="cpu"``.

Codes and metadata must be exactly equal. The streaming builds convolve
inside, where XLA's conv and the port's K1 twin may round a value one ulp
apart and move it across a code boundary, so the streaming comparison
hands both builds the JAX package's psi/phi (the port's convolution is
replaced by the JAX one for that test); the port's own streaming build is
then compared with its own non-streaming build.
"""

import numpy as np
import pytest
import torch

import kbmod_tpu.ops.psi_phi as jax_psi_phi
from kbmod_tpu.fake_data.fake_data_creator import FakeDataSet, create_fake_times

import kbmod_tpu_torch.ops.psi_phi as psi_phi
from kbmod_tpu_torch.ops.psi_phi import PsiPhiArray, _codes_as_int

META_FIELDS = ("num_bytes", "block_size", "num_times", "width", "height", "pixels_per_image",
               "num_entries", "total_array_size", "psi_min_val", "psi_max_val", "psi_scale",
               "phi_min_val", "phi_max_val", "phi_scale")


def _planes(seed=4, T=5, H=19, W=27):
    rng = np.random.default_rng(seed)
    psi = rng.normal(0.5, 3.0, (T, H, W)).astype(np.float32)
    phi = rng.uniform(0.05, 2.5, (T, H, W)).astype(np.float32)
    psi[rng.uniform(size=psi.shape) < 0.06] = np.nan
    phi[rng.uniform(size=phi.shape) < 0.04] = np.nan
    psi[1, 2, 3] = np.inf
    phi[2, 4, 5] = -np.inf
    return psi, phi


def _assert_same_array(ref, got):
    np.testing.assert_array_equal(_codes_as_int(got.psi).numpy(), np.asarray(ref.psi).astype(np.int32))
    np.testing.assert_array_equal(_codes_as_int(got.phi).numpy(), np.asarray(ref.phi).astype(np.int32))
    assert got.psi.dtype == {1: torch.uint8, 2: torch.uint16}[ref.meta.num_bytes]
    assert got.valid is None and ref.valid is None
    for name in META_FIELDS:
        assert getattr(got.meta, name) == getattr(ref.meta, name), name


@pytest.mark.parametrize("num_bytes", [1, 2])
def test_fill_psi_phi_array_codes_equal(num_bytes):
    psi, phi = _planes()
    times = np.arange(len(psi)) * 0.5
    ref = jax_psi_phi.fill_psi_phi_array(jax_psi_phi.PsiPhiArray(), num_bytes, list(psi), list(phi), times)
    got = psi_phi.fill_psi_phi_array(PsiPhiArray(), num_bytes, list(psi), list(phi), times, device="cpu")
    _assert_same_array(ref, got)
    # Decoded planes and single reads follow the same codes.
    for a, b in zip(ref.decoded_psi_phi(), got.decoded_psi_phi()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for t, r, c in ((0, 0, 0), (1, 2, 3), (2, 4, 5), (4, 18, 26), (3, -1, 2), (0, 5, 27)):
        a, b = ref.read_psi_phi(t, r, c), got.read_psi_phi(t, r, c)
        np.testing.assert_array_equal([b.psi, b.phi], [a.psi, a.phi])


def test_scalar_helpers_match():
    rng = np.random.default_rng(7)
    imgs = [rng.normal(0, 2, (6, 7)).astype(np.float32) for _ in range(3)]
    imgs[1][2, 2] = np.nan
    for nb in (1, 2, 4):
        assert psi_phi.compute_scale_params_from_image_vect(imgs, nb) == \
            jax_psi_phi.compute_scale_params_from_image_vect(imgs, nb)
    mn, mx, sc = jax_psi_phi.compute_scale_params_from_image_vect(imgs, 1)
    for v in (float("nan"), -9.0, 0.3, 1.7, 40.0):
        assert psi_phi.encode_uint_scalar(v, mn, mx, sc) == jax_psi_phi.encode_uint_scalar(v, mn, mx, sc)
    for code in (0.0, 1.0, 17.0, 255.0):
        np.testing.assert_array_equal(psi_phi.decode_uint_scalar(code, mn, sc),
                                      jax_psi_phi.decode_uint_scalar(code, mn, sc))


@pytest.mark.parametrize("num_bytes", [1, 2])
def test_encode_chunk_matches(num_bytes):
    """The streaming encoder with float32 parameters, value by value,
    including values at and beyond both ends of the range."""
    psi, _ = _planes(seed=9)
    params = np.array([-4.0, 6.5, 10.5 / ((1 << (8 * num_bytes)) - 1)], np.float32)
    psi[0, 0, :4] = [-4.0, 6.5, -100.0, 100.0]
    dtype = np.uint8 if num_bytes == 1 else np.uint16
    ref = np.asarray(jax_psi_phi._encode_chunk(psi, params, dtype))
    got = psi_phi._encode_chunk(torch.as_tensor(psi), params, psi_phi._CODE_DTYPES[num_bytes])
    np.testing.assert_array_equal(_codes_as_int(got).numpy(), ref.astype(np.int32))


@pytest.fixture(scope="module")
def stack():
    times = create_fake_times(7, t0=57130.2, obs_per_day=3, intra_night_gap=0.03)
    ds = FakeDataSet(31, 26, times, psf_val=1.1, mask_fraction=0.05, use_seed=12)
    return ds.stack_py


@pytest.mark.parametrize("num_bytes", [1, 2])
def test_streaming_build_codes_equal(stack, monkeypatch, num_bytes):
    """The two streaming builds on the same psi/phi: the port's convolution
    is swapped for the JAX package's for this comparison."""

    def jax_conv(sci_b, var_b, kernel):
        psi, phi = jax_psi_phi._psi_phi_from_sci_var(sci_b.numpy(), var_b.numpy(), kernel.numpy())
        return torch.as_tensor(np.asarray(psi)), torch.as_tensor(np.asarray(phi))

    monkeypatch.setattr(psi_phi, "_psi_phi_from_sci_var", jax_conv)
    # Small chunks: several chunks, and a short last one.
    monkeypatch.setattr(psi_phi, "_conv_batch_budget", lambda dev: 3 * 16 * 26 * 31)
    times = stack.zeroed_times
    ref = jax_psi_phi.fill_psi_phi_array_streaming(
        jax_psi_phi.PsiPhiArray(), num_bytes, stack.sci, stack.var, stack.psfs, times
    )
    got = psi_phi.fill_psi_phi_array_from_image_arrays(
        PsiPhiArray(), num_bytes, stack.sci, stack.var, stack.psfs, times, device="cpu"
    )
    _assert_same_array(ref, got)


@pytest.mark.parametrize("num_bytes", [1, 2])
def test_port_streaming_equals_port_fill(stack, num_bytes):
    """On the port's own convolution the streaming build and the build from
    float planes give the same parameters, and codes that differ only
    where the two float32/float64 roundings of safe_max part (none here)."""
    times = stack.zeroed_times
    streamed = psi_phi.fill_psi_phi_array_from_image_arrays(
        PsiPhiArray(), num_bytes, stack.sci, stack.var, stack.psfs, times, device="cpu"
    )
    psi_f, phi_f = psi_phi.generate_all_psi_phi_images(stack.sci, stack.var, stack.psfs, device="cpu")
    filled = psi_phi.fill_psi_phi_array(PsiPhiArray(), num_bytes, psi_f, phi_f, times, device="cpu")
    for name in META_FIELDS:
        assert getattr(streamed.meta, name) == getattr(filled.meta, name), name
    assert torch.equal(_codes_as_int(streamed.psi), _codes_as_int(filled.psi))
    assert torch.equal(_codes_as_int(streamed.phi), _codes_as_int(filled.phi))
    # Masked pixels are code 0 in both planes.
    assert torch.equal(_codes_as_int(streamed.psi) == 0, ~torch.isfinite(psi_f))


def test_code_pairs_layout():
    psi, phi = _planes(seed=2, W=13)
    for nb, width in ((1, 8), (2, 16)):
        arr = psi_phi.fill_psi_phi_array(PsiPhiArray(), nb, list(psi), list(phi), np.arange(5.0), device="cpu")
        pairs = arr.code_pairs()
        assert pairs is arr.code_pairs()
        # The code planes are views into the pairs: the codes are held once.
        for plane in (arr.psi, arr.phi):
            assert plane.untyped_storage().data_ptr() == pairs.untyped_storage().data_ptr()
        assert tuple(pairs.shape) == (5, 19, 16, 2) and pairs.dtype == arr.psi.dtype
        got = _codes_as_int(pairs)
        assert torch.equal(got[..., :13, 0], _codes_as_int(arr.psi))
        assert torch.equal(got[..., :13, 1], _codes_as_int(arr.phi))
        assert int(got[..., 13:, :].abs().sum()) == 0
        # One pair is one little-endian word: psi in the low bits.
        word = pairs.view(torch.int16 if nb == 1 else torch.int32).reshape(5, 19, 16).to(torch.int64)
        word = word & ((1 << (2 * width)) - 1)
        assert torch.equal(word & ((1 << width) - 1), got[..., 0].to(torch.int64))
        assert torch.equal(word >> width, got[..., 1].to(torch.int64))


def test_psi_phi_array_from_numpy_carries_codes():
    psi, phi = _planes(seed=3)
    for nb in (1, 2):
        ref = jax_psi_phi.fill_psi_phi_array(jax_psi_phi.PsiPhiArray(), nb, list(psi), list(phi), np.arange(5.0))
        got = psi_phi.psi_phi_array_from_numpy(
            np.asarray(ref.psi), np.asarray(ref.phi), None, ref.times, ref.meta, device="cpu"
        )
        _assert_same_array(ref, got)
        np.testing.assert_array_equal(
            got.encode_meta(),
            np.array([ref.meta.psi_min_val, ref.meta.psi_scale, ref.meta.phi_min_val, ref.meta.phi_scale],
                     np.float32),
        )
