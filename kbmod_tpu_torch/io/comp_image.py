"""FITS tiled-image compression (CompImageHDU) codec: a copy of the JAX
package's io/comp_image.py, writing the same bytes.

Reads and writes the BINTABLE-with-ZIMAGE layout astropy/CFITSIO produce
(the reference stores WorkUnit SCI/VAR layers this way with RICE_1 and
quantize_level=-0.01; work_unit.py:1062-1147). Supported compression:
RICE_1, GZIP_1, GZIP_2, NOCOMPRESS. Quantized float tiles honor
ZSCALE/ZZERO per tile, ZBLANK NaN codes and the NO_DITHER /
SUBTRACTIVE_DITHER_1 / SUBTRACTIVE_DITHER_2 conventions (CFITSIO's
fixed 10,000-value LCG random sequence).
"""

import zlib

import numpy as np

from kbmod_tpu_torch.io.rice import rice_decode, rice_encode

NULL_VALUE = -2147483647  # quantized NaN (CFITSIO convention)
ZERO_VALUE = -2147483646  # exact 0.0 under SUBTRACTIVE_DITHER_2
N_RANDOM = 10000

_BITPIX_DTYPE = {
    8: np.uint8, 16: np.int16, 32: np.int32, 64: np.int64,
    -32: np.float32, -64: np.float64,
}


def _fits_rand_values():
    """CFITSIO's fits_init_randoms: fixed Park-Miller sequence."""
    a, m = 16807.0, 2147483647.0
    seed = 1.0
    out = np.empty(N_RANDOM, dtype=np.float64)
    for i in range(N_RANDOM):
        temp = a * seed
        seed = temp - m * float(int(temp / m))
        out[i] = seed / m
    return out


_RAND = None


def fits_rand_values():
    global _RAND
    if _RAND is None:
        _RAND = _fits_rand_values()
    return _RAND


def _tile_rand(itile, zdither0, n):
    """Per-pixel dither offsets for 0-based tile index ``itile``."""
    rv = fits_rand_values()
    iseed = int((itile + zdither0 - 1) % N_RANDOM)
    irand = int(rv[iseed] * 500.0)
    out = np.empty(n, dtype=np.float64)
    for i in range(n):
        out[i] = rv[irand]
        irand += 1
        if irand == N_RANDOM:
            iseed = (iseed + 1) % N_RANDOM
            irand = int(rv[iseed] * 500.0)
    return out


def _gzip2_shuffle(raw, itemsize):
    arr = np.frombuffer(raw, dtype=np.uint8).reshape(-1, itemsize)
    return arr.T.tobytes()


def _gzip2_unshuffle(raw, itemsize):
    arr = np.frombuffer(raw, dtype=np.uint8).reshape(itemsize, -1)
    return arr.T.tobytes()


def _tile_shapes(znaxis_dims, ztile_dims):
    """Yield (slices, shape) for each tile in CFITSIO order (first axis
    fastest)."""
    ndim = len(znaxis_dims)
    counts = [
        (znaxis_dims[i] + ztile_dims[i] - 1) // ztile_dims[i] for i in range(ndim)
    ]
    total = int(np.prod(counts))
    for flat in range(total):
        idx = []
        rem = flat
        for i in range(ndim):  # axis 1 varies fastest
            idx.append(rem % counts[i])
            rem //= counts[i]
        slices = []
        shape = []
        for i in range(ndim - 1, -1, -1):  # numpy order: last axis = NAXIS1
            start = idx[i] * ztile_dims[i]
            stop = min(start + ztile_dims[i], znaxis_dims[i])
            slices.append(slice(start, stop))
            shape.append(stop - start)
        yield tuple(slices), tuple(shape)


def is_compressed_image(header):
    return bool(header.get("ZIMAGE", False))


def decompress_image(header, columns):
    """Decompress a tiled-image BINTABLE into (data, image_header).

    ``columns`` is the parsed BINTABLE column dict (COMPRESSED_DATA as a
    list of uint8 arrays, optional GZIP_COMPRESSED_DATA fallback tiles,
    optional per-tile ZSCALE/ZZERO/ZBLANK).
    """
    zbitpix = int(header["ZBITPIX"])
    znaxis = int(header["ZNAXIS"])
    dims = [int(header[f"ZNAXIS{i}"]) for i in range(1, znaxis + 1)]
    tdims = [int(header.get(f"ZTILE{i}", dims[i - 1] if i == 1 else 1)) for i in range(1, znaxis + 1)]
    cmptype = str(header.get("ZCMPTYPE", "RICE_1")).strip()
    quantiz = str(header.get("ZQUANTIZ", "NO_DITHER")).strip()
    zdither0 = int(header.get("ZDITHER0", 0) or 0)

    # ZNAMEi/ZVALi parameters.
    zvals = {}
    for i in range(1, 10):
        if f"ZNAME{i}" in header:
            zvals[str(header[f"ZNAME{i}"]).strip().upper()] = header[f"ZVAL{i}"]
    bytepix = int(zvals.get("BYTEPIX", abs(zbitpix) // 8))

    out_dtype = _BITPIX_DTYPE[zbitpix]
    quantized = zbitpix < 0
    out = np.zeros(dims[::-1], dtype=np.float64 if quantized else np.int64)

    comp = columns.get("COMPRESSED_DATA")
    gzfall = columns.get("GZIP_COMPRESSED_DATA")
    zscale = columns.get("ZSCALE")
    zzero = columns.get("ZZERO")
    zblank_col = columns.get("ZBLANK")
    zblank_hdr = header.get("ZBLANK", NULL_VALUE if quantized else None)

    for itile, (slices, shape) in enumerate(_tile_shapes(dims, tdims)):
        npix = int(np.prod(shape))
        raw = bytes(np.asarray(comp[itile], dtype=np.uint8).tobytes()) if comp is not None else b""
        if len(raw) == 0 and gzfall is not None and len(gzfall[itile]):
            # Lossless-gzip fallback tile: original pixel bytes, gzipped.
            raw_bytes = zlib.decompress(
                bytes(np.asarray(gzfall[itile], np.uint8).tobytes()), 15 + 32
            )
            vals = np.frombuffer(raw_bytes, dtype=np.dtype(out_dtype).newbyteorder(">"))
            out[slices] = vals.astype(out.dtype).reshape(shape)
            continue
        if cmptype == "RICE_1":
            ints = rice_decode(raw, npix, bytepix)
        elif cmptype in ("GZIP_1", "GZIP_2"):
            dec = zlib.decompress(raw, 15 + 32)
            if cmptype == "GZIP_2":
                dec = _gzip2_unshuffle(dec, bytepix)
            int_dt = {1: ">i1", 2: ">i2", 4: ">i4", 8: ">i8"}[bytepix]
            if not quantized and zbitpix == 8:
                int_dt = ">u1"
            if quantized and bytepix == abs(zbitpix) // 8 and not _has_quant(zscale, itile):
                # Losslessly gzipped float tile.
                vals = np.frombuffer(dec, dtype=np.dtype(out_dtype).newbyteorder(">"))
                out[slices] = vals.astype(out.dtype).reshape(shape)
                continue
            ints = np.frombuffer(dec, dtype=int_dt).astype(np.int64)
        elif cmptype == "NOCOMPRESS":
            dt = np.dtype(out_dtype).newbyteorder(">")
            out[slices] = np.frombuffer(raw, dtype=dt).astype(out.dtype).reshape(shape)
            continue
        else:
            raise ValueError(f"Unsupported ZCMPTYPE {cmptype!r}")

        if not quantized:
            out[slices] = ints.reshape(shape)
            continue

        scale = float(zscale[itile]) if _has_quant(zscale, itile) else 1.0
        zero = float(zzero[itile]) if _has_quant(zzero, itile) else 0.0
        ints = ints.astype(np.int64)
        if quantiz in ("SUBTRACTIVE_DITHER_1", "SUBTRACTIVE_DITHER_2"):
            rnd = _tile_rand(itile, zdither0, npix)
            vals = (ints.astype(np.float64) - rnd + 0.5) * scale + zero
        else:
            vals = ints.astype(np.float64) * scale + zero
        if quantiz == "SUBTRACTIVE_DITHER_2":
            vals = np.where(ints == ZERO_VALUE, 0.0, vals)
        blank = zblank_col[itile] if zblank_col is not None else zblank_hdr
        if blank is not None:
            vals = np.where(ints == int(blank), np.nan, vals)
        out[slices] = vals.reshape(shape)

    # Reconstruct the logical image header.
    img_header = {"XTENSION": "IMAGE", "BITPIX": zbitpix, "NAXIS": znaxis}
    for i in range(1, znaxis + 1):
        img_header[f"NAXIS{i}"] = dims[i - 1]
    skip_prefixes = ("Z", "TTYPE", "TFORM", "TUNIT", "TDIM", "TSCAL", "TZERO", "TNULL")
    skip_exact = {
        "XTENSION", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2", "PCOUNT", "GCOUNT",
        "TFIELDS", "THEAP", "END",
    }
    for key, val in header.items():
        if key in skip_exact or any(key.startswith(p) and key not in ("ZTENSION",) for p in skip_prefixes):
            continue
        img_header.setdefault(key, val)
    return out.astype(out_dtype), img_header


def _has_quant(col, itile):
    return col is not None and len(col) > itile


def compress_image(
    data,
    extname=None,
    compression_type="RICE_1",
    quantize_level=-0.01,
    tile_rows=1,
    header_extra=None,
):
    """Compress an image into (bintable_header_cards, columns) in the
    CompImageHDU layout. Float data with RICE_1 is quantized per tile
    with NO_DITHER (ZSCALE = |quantize_level| when quantize_level < 0,
    the reference's setting); GZIP_1/GZIP_2 float tiles are stored
    losslessly.
    """
    data = np.asarray(data)
    if data.ndim != 2:
        raise ValueError("compress_image expects a 2D image")
    H, W = data.shape
    if data.dtype.kind == "f":
        zbitpix = -32 if data.dtype == np.float32 else -64
    else:
        zbitpix = {1: 8, 2: 16, 4: 32, 8: 64}[data.dtype.itemsize]
    quantized = zbitpix < 0 and compression_type == "RICE_1"

    tiles = []
    zscales, zzeros = [], []
    bytepix = 4 if quantized else max(1, abs(zbitpix) // 8)
    for y0 in range(0, H, int(tile_rows)):
        tile = data[y0 : y0 + int(tile_rows)].reshape(-1)
        if quantized:
            scale = abs(float(quantize_level)) if quantize_level < 0 else None
            finite = np.isfinite(tile)
            if scale is None:
                std = float(np.std(tile[finite])) if finite.any() else 1.0
                scale = max(std / max(float(quantize_level), 1.0), 1e-12)
            zero = float(np.min(tile[finite])) if finite.any() else 0.0
            safe = np.where(finite, tile.astype(np.float64), zero)
            ints = np.round((safe - zero) / scale).astype(np.int64)
            ints = np.where(finite, ints, NULL_VALUE)
            zscales.append(scale)
            zzeros.append(zero)
            payload = ints
        elif zbitpix < 0:
            payload = tile  # lossless float bytes for gzip paths
        else:
            payload = tile.astype(np.int64)

        if compression_type == "RICE_1":
            tiles.append(np.frombuffer(rice_encode(payload, bytepix), np.uint8))
        elif compression_type in ("GZIP_1", "GZIP_2"):
            if zbitpix < 0:
                raw = tile.astype(np.dtype(data.dtype).newbyteorder(">")).tobytes()
                itemsize = data.dtype.itemsize
            else:
                int_dt = {1: ">i1", 2: ">i2", 4: ">i4", 8: ">i8"}[bytepix]
                if zbitpix == 8:
                    int_dt = ">u1"
                raw = payload.astype(int_dt).tobytes()
                itemsize = bytepix
            if compression_type == "GZIP_2":
                raw = _gzip2_shuffle(raw, itemsize)
            tiles.append(np.frombuffer(zlib.compress(raw), np.uint8))
        elif compression_type == "NOCOMPRESS":
            dt = np.dtype(_BITPIX_DTYPE[zbitpix]).newbyteorder(">")
            tiles.append(np.frombuffer(tile.astype(dt).tobytes(), np.uint8))
        else:
            raise ValueError(f"Unsupported compression type {compression_type!r}")

    columns = {"COMPRESSED_DATA": tiles}
    if quantized:
        columns["ZSCALE"] = np.asarray(zscales, dtype=np.float64)
        columns["ZZERO"] = np.asarray(zzeros, dtype=np.float64)

    cards = {
        "ZIMAGE": True,
        "ZTENSION": "IMAGE",
        "ZBITPIX": zbitpix,
        "ZNAXIS": 2,
        "ZNAXIS1": W,
        "ZNAXIS2": H,
        "ZTILE1": W,
        "ZTILE2": int(tile_rows),
        "ZCMPTYPE": compression_type,
        "ZNAME1": "BLOCKSIZE",
        "ZVAL1": 32,
        "ZNAME2": "BYTEPIX",
        "ZVAL2": bytepix,
        "ZPCOUNT": 0,
        "ZGCOUNT": 1,
        "ZSIMPLE": True,
    }
    if quantized:
        cards["ZQUANTIZ"] = "NO_DITHER"
        cards["ZBLANK"] = NULL_VALUE
    if extname is not None:
        cards["EXTNAME"] = str(extname)
    if header_extra:
        for k, v in header_extra.items():
            cards.setdefault(k, v)
    return cards, columns
