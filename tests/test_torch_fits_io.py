"""The port's FITS IO (io/rice, io/comp_image, io/fits_bintable, io/fits_io
and native/) against the JAX package's, on the CPU.

The cases of tests/test_fits_io.py and tests/test_fits_compressed.py run
again against the port, and each is also held to the JAX package:

- files: byte-equal for the same inputs, and each package reads the other's
  file to equal headers and arrays;
- RICE_1 streams: byte-equal across the port's pure-Python path, the
  port's native library and the JAX package's path; decodes exact;
- tiled compression: the same header cards and column values; lossless
  codecs exact, RICE_1 float tiles within half a quantum (0.005 at
  quantize_level -0.01; 0.0051 allows the float32 rounding of the input).
"""

import logging
import subprocess
import unittest.mock as mock

import numpy as np
import pytest

from kbmod_tpu.io import comp_image as j_comp
from kbmod_tpu.io import fits_io as j_fits
from kbmod_tpu.io import rice as j_rice
from kbmod_tpu.table import Table as JTable

from kbmod_tpu_torch import native
from kbmod_tpu_torch.io import comp_image as t_comp
from kbmod_tpu_torch.io import fits_io as t_fits
from kbmod_tpu_torch.io import rice as t_rice
from kbmod_tpu_torch.table import Table as TTable
from test_torch_filters import private_jax_native  # noqa: F401 (a fixture)

QUANT_ATOL = 0.0051


def _write_both(tmp_path, build):
    """Write ``build(fits_io_module, Table)``'s HDUs with each package;
    return (jax bytes, port bytes, jax path, port path)."""
    paths = []
    for tag, mod, table in (("jax", j_fits, JTable), ("port", t_fits, TTable)):
        path = str(tmp_path / f"{tag}.fits")
        mod.write_fits(path, build(mod, table))
        paths.append(path)
    return open(paths[0], "rb").read(), open(paths[1], "rb").read(), paths[0], paths[1]


def _image_hdus(mod, table):
    rng = np.random.default_rng(3)
    primary = mod.ImageHDU(name="PRIMARY")
    primary.header["OBSID"] = "test_123"
    primary.header["MJD"] = 57130.25
    primary.header["FLAG"] = True
    return [
        primary,
        mod.ImageHDU(rng.normal(0, 1, (16, 20)).astype(np.float32), name="SCI_0"),
        mod.ImageHDU(np.arange(320, dtype=np.int32).reshape(16, 20), name="MASK_0"),
        mod.ImageHDU(np.arange(256, dtype=np.uint8).reshape(16, 16), name="U8"),
        mod.ImageHDU(rng.normal(size=(4, 4)), name="DBL"),
    ]


class TestFitsRoundtrip:
    def test_image_hdus(self, tmp_path):
        ref, got, jpath, tpath = _write_both(tmp_path, _image_hdus)
        assert got == ref
        want = _image_hdus(t_fits, TTable)
        for path in (tpath, jpath):
            hdus = t_fits.read_fits(path)
            assert len(hdus) == 5
            assert hdus[0].header["OBSID"] == "test_123"
            assert hdus[0].header["MJD"] == 57130.25
            assert hdus[0].header["FLAG"] is True
            for hdu in want[1:]:
                np.testing.assert_array_equal(hdus[hdu.name].data, hdu.data)
        back = j_fits.read_fits(tpath)
        for hdu in want[1:]:
            np.testing.assert_array_equal(back[hdu.name].data, hdu.data)

    def test_file_is_standard_blocks(self, tmp_path):
        """The file is a multiple of 2880 bytes and starts with SIMPLE."""
        ref, raw, _, _ = _write_both(
            tmp_path, lambda mod, table: [mod.ImageHDU(np.ones((3, 5), dtype=np.float32), name="X")]
        )
        assert raw == ref
        assert len(raw) % 2880 == 0
        assert raw[:6] == b"SIMPLE"

    def test_long_string(self, tmp_path):
        text = "line1\nline2: [1, 2, 3]\n" * 40 + "tail with 'quotes' & symbols #/="

        def build(mod, table):
            hdu = mod.ImageHDU(name="CFG")
            hdu.set_long_string("YAMLCFG", text)
            return [mod.ImageHDU(name="PRIMARY"), hdu]

        ref, got, jpath, tpath = _write_both(tmp_path, build)
        assert got == ref
        assert t_fits.read_fits(jpath)["CFG"].get_long_string("YAMLCFG") == text
        assert j_fits.read_fits(tpath)["CFG"].get_long_string("YAMLCFG") == text

    def test_table_hdu(self, tmp_path):
        def build(mod, table_cls):
            table = table_cls({"a": np.arange(5), "b": np.array(["x", "y", "z", "w", "v"], dtype=object)})
            table.meta["note"] = "hello"
            return [mod.ImageHDU(name="PRIMARY"), mod.TableHDU(table, name="META")]

        ref, got, jpath, tpath = _write_both(tmp_path, build)
        assert got == ref
        for path in (tpath, jpath):
            out = t_fits.read_fits(path)["META"].to_table()
            np.testing.assert_array_equal(out["a"], np.arange(5))
            assert list(out["b"]) == ["x", "y", "z", "w", "v"]
            assert out.meta["note"] == "hello"

    def test_header_string_escaping(self, tmp_path):
        def build(mod, table):
            hdu = mod.ImageHDU(name="PRIMARY")
            hdu.header["NAME"] = "it's quoted"
            return [hdu]

        ref, got, jpath, tpath = _write_both(tmp_path, build)
        assert got == ref
        assert t_fits.read_fits(tpath)[0].header["NAME"] == "it's quoted"
        assert j_fits.read_fits(tpath)[0].header["NAME"] == "it's quoted"

    def test_missing_hdu_lookup(self):
        hdus = t_fits.HDUList([t_fits.ImageHDU(name="PRIMARY")])
        with pytest.raises(KeyError):
            hdus["NOPE"]
        assert "PRIMARY" in hdus
        assert "NOPE" not in hdus


def _card(key, value=None, string=False):
    if value is None:
        return f"{key:<80}"[:80].encode()
    if string:
        v = f"'{value}'"
        return f"{key:<8}= {v:<20}"[:80].ljust(80).encode()
    if isinstance(value, bool):
        value = "T" if value else "F"
    return f"{key:<8}= {value:>20}"[:80].ljust(80).encode()


def _pad_block(b):
    return b + b" " * ((-len(b)) % 2880)


def _pad_data(b):
    return b + b"\0" * ((-len(b)) % 2880)


class TestForeignFitsFiles:
    """Files the reference's tools write (astropy conventions): unsigned
    16-bit images (BZERO=32768) and heap-bearing binary tables keep the
    HDU stream in sync; both packages read them alike."""

    def test_unsigned_int16_bzero(self, tmp_path):
        vals = np.array([[0, 1, 32767], [32768, 40000, 65535]], dtype=np.uint16)
        stored = (vals.astype(np.int64) - 32768).astype(">i2")
        hdr = (
            _card("SIMPLE", True) + _card("BITPIX", 16) + _card("NAXIS", 2)
            + _card("NAXIS1", 3) + _card("NAXIS2", 2)
            + _card("BZERO", 32768) + _card("BSCALE", 1) + _card("END")
        )
        path = tmp_path / "u16.fits"
        path.write_bytes(_pad_block(hdr) + _pad_data(stored.tobytes()))
        out = np.asarray(t_fits.read_fits(str(path))[0].data)
        assert out.dtype == np.uint16
        np.testing.assert_array_equal(out, vals)
        np.testing.assert_array_equal(out, np.asarray(j_fits.read_fits(str(path))[0].data))

    def test_heap_bintable_keeps_stream_in_sync(self, tmp_path):
        primary = _pad_block(
            _card("SIMPLE", True) + _card("BITPIX", 8) + _card("NAXIS", 0)
            + _card("EXTEND", True) + _card("END")
        )
        row_bytes, nrows, heap_len = 8, 3, 100
        heap = b"\x55" * heap_len
        bintable = _pad_block(
            _card("XTENSION", "BINTABLE", string=True) + _card("BITPIX", 8)
            + _card("NAXIS", 2) + _card("NAXIS1", row_bytes) + _card("NAXIS2", nrows)
            + _card("PCOUNT", heap_len) + _card("GCOUNT", 1) + _card("TFIELDS", 1)
            + _card("TFORM1", "8B", string=True) + _card("TTYPE1", "blob", string=True)
            + _card("END")
        ) + _pad_data(bytes(range(row_bytes)) * nrows + heap)
        img = np.arange(6, dtype=">f4").reshape(2, 3)
        image = _pad_block(
            _card("XTENSION", "IMAGE", string=True) + _card("BITPIX", -32)
            + _card("NAXIS", 2) + _card("NAXIS1", 3) + _card("NAXIS2", 2)
            + _card("PCOUNT", 0) + _card("GCOUNT", 1)
            + _card("EXTNAME", "SCI_0", string=True) + _card("END")
        ) + _pad_data(img.tobytes())
        path = tmp_path / "mixed.fits"
        path.write_bytes(primary + bintable + image)
        hdus = t_fits.read_fits(str(path))
        assert len(hdus) == 3
        assert hdus[2].name == "SCI_0"
        np.testing.assert_array_equal(np.asarray(hdus[2].data), img.astype("=f4"))
        assert hdus[1].heap == heap == j_fits.read_fits(str(path))[1].heap


def _rice_cases(bytepix):
    rng = np.random.default_rng(17)
    lim = 2 ** (8 * bytepix - 1)
    cases = [
        rng.integers(-lim, lim, 1000).astype(np.int32),
        np.full(77, 13, np.int32),
        (np.arange(500) * 7 % (2 * lim) - lim).astype(np.int32),
        rng.integers(-3, 3, 333).astype(np.int32).cumsum().astype(np.int32),
        rng.integers(-lim, lim, 257, dtype=np.int64).astype(np.int32),
        np.zeros(0, np.int32),
    ]
    if bytepix < 4:
        cases = [((v.astype(np.int64) + lim) % (2 * lim) - lim).astype(np.int32) for v in cases]
    return cases


class TestRice:
    @pytest.mark.parametrize("bytepix", [1, 2, 4])
    def test_three_paths_byte_equal(self, bytepix):
        """The port's Python path, its native library and the JAX package's
        path write the same stream; each decodes every stream exactly."""
        if not native.available():
            pytest.skip("no C++ compiler for the native library")
        for vals in _rice_cases(bytepix):
            enc_native = t_rice.rice_encode(vals, bytepix)
            with mock.patch.object(native, "available", return_value=False):
                enc_py = t_rice.rice_encode(vals, bytepix)
                dec_py = t_rice.rice_decode(enc_native, len(vals), bytepix)
            enc_jax = j_rice.rice_encode(vals, bytepix)
            assert enc_native == enc_py == enc_jax
            np.testing.assert_array_equal(dec_py, vals)
            np.testing.assert_array_equal(t_rice.rice_decode(enc_jax, len(vals), bytepix), vals)
            np.testing.assert_array_equal(j_rice.rice_decode(enc_native, len(vals), bytepix), vals)

    def test_roundtrip_ramp_constant_and_direct_blocks(self):
        rng = np.random.default_rng(5)
        ramp = (np.arange(1000) * 3 + rng.integers(-5, 5, 1000)).astype(np.int32)
        direct = rng.integers(-(2**30), 2**30, 64, dtype=np.int64).astype(np.int32)
        const = np.full(100, 42, dtype=np.int32)
        for vals in (ramp, direct, const):
            np.testing.assert_array_equal(t_rice.rice_decode(t_rice.rice_encode(vals, 4), len(vals), 4), vals)
        # Constant blocks collapse to fs=0 markers: a tiny stream.
        assert len(t_rice.rice_encode(const, 4)) < 8

    def test_known_vector(self):
        # First value 5 (raw int32 BE), then one all-zero-diff block (fs
        # code 0 in 5 bits).
        data = (5).to_bytes(4, "big", signed=True) + bytes([0b00000000])
        for path_native in (True, False):
            with mock.patch.object(native, "available", return_value=path_native):
                np.testing.assert_array_equal(t_rice.rice_decode(data, 32, 4), np.full(32, 5, np.int32))


class TestNative:
    def test_builds_into_the_ignored_build_directory(self, private_jax_native):  # noqa: F811
        """The library is keyed by its source and flags under _build/, never
        beside the source. The JAX package's helper it is compared with is
        built into a private directory (``private_jax_native``)."""
        if not native.available():
            pytest.skip("no C++ compiler for the native library")
        path = native.library_path()
        assert path.parent.name == "_build" and path.exists()
        assert not any(p.suffix == ".so" for p in native._SRC.parent.iterdir())
        rng = np.random.default_rng(2)
        imgs = rng.normal(size=(3, 12, 10)).astype(np.float32)
        xs = np.array([[0, 5, 9], [11, 3, -4]], dtype=np.int32)
        ys = np.array([[0, 6, 11], [2, 13, 1]], dtype=np.int32)
        assert private_jax_native.available(), "the JAX package's native helper did not build"
        np.testing.assert_array_equal(native.extract_stamps(imgs, xs, ys, 2),
                                      private_jax_native.extract_stamps(imgs, xs, ys, 2))

    def test_without_a_compiler_warns_once_and_falls_back(self, monkeypatch, tmp_path, caplog):
        def no_compiler(*args, **kwargs):
            raise FileNotFoundError("g++")

        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
        monkeypatch.setattr(subprocess, "run", no_compiler)
        with caplog.at_level(logging.WARNING, logger=native.__name__):
            assert not native.available()
            assert not native.available()
            vals = np.arange(70, dtype=np.int32) * 3
            enc = t_rice.rice_encode(vals, 4)
        warnings = [r for r in caplog.records if "Native library unavailable" in r.getMessage()]
        assert len(warnings) == 1
        assert enc == j_rice.rice_encode(vals, 4)
        assert native.grid_dedup([1], [1], [0.0], [0.0], [1.0], 10, 1.0) is None


def _comp_cases():
    rng = np.random.default_rng(11)
    ints = rng.integers(-100, 4000, (17, 23)).astype(np.int32)
    floats = rng.normal(0, 100, (9, 33)).astype(np.float32)
    floats[3, 4] = np.nan
    quant = rng.normal(50, 10, (20, 31)).astype(np.float32)
    quant[0, 0] = quant[7, 7] = np.nan
    mask = (np.arange(64).reshape(8, 8) % 3 == 0).astype(np.uint8)
    cases = {f"int_{c}": (ints, dict(compression_type=c, tile_rows=4))
             for c in ("RICE_1", "GZIP_1", "GZIP_2", "NOCOMPRESS")}
    cases.update({f"float_{c}": (floats, dict(compression_type=c, tile_rows=3)) for c in ("GZIP_1", "GZIP_2")})
    cases["float_RICE_1"] = (quant, dict(compression_type="RICE_1", quantize_level=-0.01))
    cases["mask_u8"] = (mask, dict(compression_type="RICE_1"))
    return cases


COMP_CASES = _comp_cases()


class TestCompImage:
    @pytest.mark.parametrize("case", sorted(COMP_CASES))
    def test_compress_matches_and_decompresses(self, case):
        img, kw = COMP_CASES[case]
        cards, cols = t_comp.compress_image(img, **kw)
        jcards, jcols = j_comp.compress_image(img, **kw)
        assert cards == jcards
        assert set(cols) == set(jcols)
        for a, b in zip(cols["COMPRESSED_DATA"], jcols["COMPRESSED_DATA"]):
            np.testing.assert_array_equal(a, b)
        for k in ("ZSCALE", "ZZERO"):
            if k in cols:
                np.testing.assert_array_equal(cols[k], jcols[k])
        out, hdr = t_comp.decompress_image(cards, cols)
        jout, jhdr = j_comp.decompress_image(cards, cols)
        assert hdr == jhdr
        np.testing.assert_array_equal(out, jout)
        if case == "float_RICE_1":
            finite = np.isfinite(img)
            assert np.isnan(out[~finite]).all()
            np.testing.assert_allclose(out[finite], img[finite], atol=QUANT_ATOL)
        else:
            np.testing.assert_array_equal(out, img)
        if case.startswith("int"):
            assert hdr["BITPIX"] == 32

    def test_dithered_quantization_self_consistent(self):
        """SUBTRACTIVE_DITHER_1 decode inverts the spec-matched encode, with
        the port's dither sequence equal to the JAX package's."""
        rng = np.random.default_rng(14)
        img = rng.normal(0, 5, (4, 64)).astype(np.float64)
        scale, zero, zdither0 = 0.01, -20.0, 77
        cards, _ = t_comp.compress_image(img.astype(np.float32), compression_type="RICE_1",
                                         quantize_level=-scale, tile_rows=1)
        tiles = []
        for itile in range(4):
            rnd = t_comp._tile_rand(itile, zdither0, img[itile].size)
            np.testing.assert_array_equal(rnd, j_comp._tile_rand(itile, zdither0, img[itile].size))
            ints = np.round((img[itile] - zero) / scale + rnd - 0.5).astype(np.int64)
            tiles.append(np.frombuffer(t_rice.rice_encode(ints, 4), np.uint8))
        cards = dict(cards, ZQUANTIZ="SUBTRACTIVE_DITHER_1", ZDITHER0=zdither0)
        cols = {"COMPRESSED_DATA": tiles, "ZSCALE": np.full(4, scale), "ZZERO": np.full(4, zero)}
        out, _ = t_comp.decompress_image(cards, cols)
        np.testing.assert_allclose(out, img, atol=scale / 2 + 1e-9)
        np.testing.assert_array_equal(out, j_comp.decompress_image(cards, cols)[0])


class TestBinTableFile:
    def test_bintable_roundtrip_through_file(self, tmp_path):
        rng = np.random.default_rng(21)
        cols = {
            "name": ["alpha", "b", "gamma-ray"],
            "flux": rng.normal(0, 1, 3).astype(np.float64),
            "count": np.array([1, 2, 3], dtype=np.int32),
            "good": np.array([True, False, True]),
            "blob": [np.arange(5, dtype=np.int32), np.arange(2, dtype=np.int32), np.zeros(0, dtype=np.int32)],
        }
        ref, got, jpath, tpath = _write_both(
            tmp_path, lambda mod, table: mod.HDUList([mod.ImageHDU(), mod.BinTableHDU(columns=cols, name="META")])
        )
        assert got == ref
        for path in (tpath, jpath):
            bt = t_fits.read_fits(path)["META"]
            assert bt.columns["name"] == cols["name"]
            np.testing.assert_array_equal(bt.columns["flux"], cols["flux"])
            np.testing.assert_array_equal(bt.columns["count"], cols["count"])
            np.testing.assert_array_equal(bt.columns["good"], cols["good"])
            for a, b in zip(bt.columns["blob"], cols["blob"]):
                np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("ctype", ["RICE_1", "GZIP_1", "GZIP_2"])
    def test_comp_image_roundtrip_through_file(self, tmp_path, ctype):
        rng = np.random.default_rng(22)
        img = rng.normal(10, 3, (16, 40)).astype(np.float32)
        img[5, 5] = np.nan
        ref, got, jpath, tpath = _write_both(tmp_path, lambda mod, table: mod.HDUList([
            mod.ImageHDU(),
            mod.make_comp_image_hdu(img, name="SCI_0", compression_type=ctype, header_extra={"MJD": 57130.5}),
        ]))
        assert got == ref
        for path in (tpath, jpath):
            sci = t_fits.read_fits(path)["SCI_0"]
            assert sci.header["MJD"] == 57130.5
            data = np.asarray(sci.data)
            finite = np.isfinite(img)
            assert np.isnan(data[~finite]).all()
            if ctype == "RICE_1":
                np.testing.assert_allclose(data[finite], img[finite], atol=QUANT_ATOL)
            else:
                np.testing.assert_array_equal(data, img)
            np.testing.assert_array_equal(data, np.asarray(j_fits.read_fits(path)["SCI_0"].data))

