"""A self-contained FITS reader/writer (no astropy): a copy of the JAX
package's io/fits_io.py, writing byte-equal files.

Supports the subset of FITS that kbmod_tpu_torch's WorkUnit / standardizer layers
need: primary + IMAGE extension HDUs with int8/16/32/64 and float32/64
data (big-endian, BZERO/BSCALE honored on read), standard 80-byte header
cards with the long-string CONTINUE convention, and EXTNAME-addressable
HDU lists. Table-like metadata is stored as JSON payloads in 1D uint8
image HDUs (marked with KBTABLE=T) — a valid-FITS encoding that
round-trips through this module.

The reference relies on astropy.io.fits for the same role
(src/kbmod/work_unit.py:489-682).
"""

import json
from pathlib import Path

import numpy as np

BLOCK = 2880
CARD = 80

_BITPIX_TO_DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}
_DTYPE_TO_BITPIX = {
    "uint8": 8,
    "int16": 16,
    "int32": 32,
    "int64": 64,
    "float32": -32,
    "float64": -64,
}


def _format_value(value):
    if isinstance(value, bool):
        return "T" if value else "F"
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        return repr(float(value))
    if value is None:
        return ""
    text = str(value).replace("'", "''")
    return f"'{text}'"


def _format_card(key, value, comment=None):
    key = key.upper()[:8]
    if key in ("COMMENT", "HISTORY", ""):
        return f"{key:<8}{str(value):<72}"[:CARD]
    val_str = _format_value(value)
    card = f"{key:<8}= {val_str:>20}" if not val_str.startswith("'") else f"{key:<8}= {val_str:<20}"
    if comment:
        card += f" / {comment}"
    return f"{card:<{CARD}}"[:CARD]


def _parse_value(raw):
    raw = raw.strip()
    if raw.startswith("'"):
        # String value: find the closing quote (doubled quotes escape).
        body = raw[1:]
        out = []
        i = 0
        while i < len(body):
            if body[i] == "'":
                if i + 1 < len(body) and body[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(body[i])
            i += 1
        return "".join(out).rstrip()
    # Strip a trailing comment.
    if "/" in raw:
        raw = raw.split("/", 1)[0].strip()
    if raw == "T":
        return True
    if raw == "F":
        return False
    if raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


class ImageHDU:
    """One FITS HDU: a header dict plus an optional numpy data array."""

    def __init__(self, data=None, header=None, name=None):
        self.data = None if data is None else np.asarray(data)
        self.header = dict(header) if header else {}
        if name is not None:
            self.header["EXTNAME"] = str(name)

    @property
    def name(self):
        return self.header.get("EXTNAME", "")

    # --- long-string storage (CONTINUE-style chunking) ---

    def set_long_string(self, key, text):
        """Store an arbitrarily long string under KEY as KEY0..KEYn chunked
        values plus a KEYCNT count. Base64-encoded: header cards cannot
        carry newlines or arbitrary punctuation."""
        import base64

        encoded = base64.urlsafe_b64encode(text.encode()).decode("ascii")
        chunks = [encoded[i : i + 60] for i in range(0, max(len(encoded), 1), 60)]
        self.header[f"{key[:5]}CNT"] = len(chunks)
        for i, chunk in enumerate(chunks):
            self.header[f"{key[:5]}{i}"] = chunk

    def get_long_string(self, key):
        import base64

        count = self.header.get(f"{key[:5]}CNT", 0)
        encoded = "".join(str(self.header.get(f"{key[:5]}{i}", "")) for i in range(count))
        if not encoded:
            return ""
        return base64.urlsafe_b64decode(encoded.encode("ascii")).decode()


def PrimaryHDU(data=None, header=None):
    """Convenience constructor mirroring astropy's PrimaryHDU: an ImageHDU
    named PRIMARY (the writer emits it as the primary header unit)."""
    return ImageHDU(data, header=header, name="PRIMARY")


class TableHDU(ImageHDU):
    """Table metadata stored as JSON in a uint8 image HDU (KBTABLE=T)."""

    def __init__(self, table=None, name=None, header=None):
        payload = None
        if table is not None:
            payload = _table_to_bytes(table)
        super().__init__(data=payload, header=header, name=name)
        self.header["KBTABLE"] = True

    def to_table(self):
        from kbmod_tpu_torch.table import Table

        if self.data is None or len(self.data) == 0:
            return Table()
        obj = json.loads(bytes(np.asarray(self.data, dtype=np.uint8)).decode())
        data = {}
        for name, col in obj["columns"].items():
            if isinstance(col, dict) and "__ndarray__" in col:
                data[name] = np.asarray(col["__ndarray__"], dtype=col["dtype"]).reshape(col["shape"])
            else:
                data[name] = np.array(col, dtype=object)
        table = Table(data)
        table.meta.update(obj.get("meta", {}))
        return table


def _table_to_bytes(table):
    cols = {}
    for name in table.colnames:
        col = table[name]
        if col.dtype == object:
            cols[name] = [None if v is None else (v.tolist() if isinstance(v, np.ndarray) else v) for v in col]
        else:
            cols[name] = {"__ndarray__": col.tolist(), "dtype": str(col.dtype), "shape": list(col.shape)}
    payload = json.dumps({"columns": cols, "meta": table.meta}).encode()
    return np.frombuffer(payload, dtype=np.uint8).copy()


def _hdu_is_table(hdu):
    return bool(hdu.header.get("KBTABLE", False))


class BinTableHDU:
    """A standard FITS BINTABLE HDU (astropy-interoperable layout).

    ``columns`` maps column name -> numpy array / list of strings / list
    of variable-length numpy arrays (see io.fits_bintable). This is the
    layout the reference uses for IMG_META, kbmod_config and compressed
    image layers (work_unit.py:1242-1283, configuration.py:584-598).
    """

    def __init__(self, columns=None, header=None, name=None, nrows=None):
        self.columns = dict(columns) if columns else {}
        self.header = dict(header) if header else {}
        if name is not None:
            self.header["EXTNAME"] = str(name)
        if nrows is None and self.columns:
            first = next(iter(self.columns.values()))
            nrows = len(first)
        self.nrows = int(nrows or 0)
        self.data = None  # raw row bytes (set on read)
        self.heap = b""

    @property
    def name(self):
        return self.header.get("EXTNAME", "")

    def as_table(self):
        from kbmod_tpu_torch.table import Table

        data = {}
        for name, col in self.columns.items():
            if isinstance(col, np.ndarray):
                data[name] = col
            else:
                data[name] = np.array(col, dtype=object)
        return Table(data)


def make_comp_image_hdu(data, name=None, compression_type="RICE_1",
                        quantize_level=-0.01, tile_rows=1, header_extra=None):
    """Build a CompImageHDU-layout BinTableHDU from a 2D image."""
    from kbmod_tpu_torch.io.comp_image import compress_image

    cards, columns = compress_image(
        data, extname=name, compression_type=compression_type,
        quantize_level=quantize_level, tile_rows=tile_rows,
        header_extra=header_extra,
    )
    return BinTableHDU(columns=columns, header=cards, nrows=len(columns["COMPRESSED_DATA"]))


class HDUList(list):
    """An ordered list of HDUs with name lookup, mirroring astropy's."""

    def __getitem__(self, key):
        if isinstance(key, str):
            for hdu in self:
                if hdu.name.upper() == key.upper():
                    return hdu
            raise KeyError(f"No HDU named {key}")
        return super().__getitem__(key)

    def __contains__(self, key):
        if isinstance(key, str):
            return any(hdu.name.upper() == key.upper() for hdu in self)
        return super().__contains__(key)

    def writeto(self, filename, overwrite=False):
        write_fits(filename, self, overwrite=overwrite)


# ----------------------------------------------------------------------
# Writing
# ----------------------------------------------------------------------

def _header_bytes(hdu, primary):
    cards = []
    data = hdu.data
    if primary:
        cards.append(_format_card("SIMPLE", True, "conforms to FITS standard"))
    else:
        cards.append(f"{'XTENSION':<8}= 'IMAGE   '           / Image extension"[:CARD].ljust(CARD))

    if data is None:
        cards.append(_format_card("BITPIX", 8))
        cards.append(_format_card("NAXIS", 0))
    else:
        key = str(data.dtype.newbyteorder("=").name)
        if key not in _DTYPE_TO_BITPIX:
            raise ValueError(f"Unsupported FITS dtype {data.dtype}")
        cards.append(_format_card("BITPIX", _DTYPE_TO_BITPIX[key]))
        cards.append(_format_card("NAXIS", data.ndim))
        # FITS NAXIS1 is the fastest-varying (last numpy) axis.
        for i, size in enumerate(reversed(data.shape)):
            cards.append(_format_card(f"NAXIS{i + 1}", int(size)))
    if not primary:
        cards.append(_format_card("PCOUNT", 0))
        cards.append(_format_card("GCOUNT", 1))

    skip = {"SIMPLE", "XTENSION", "BITPIX", "NAXIS", "PCOUNT", "GCOUNT", "END"}
    skip.update(f"NAXIS{i}" for i in range(1, 10))
    for key, value in hdu.header.items():
        if key.upper() in skip:
            continue
        cards.append(_format_card(key, value))
    cards.append(f"{'END':<{CARD}}")

    text = "".join(cards)
    pad = (-len(text)) % BLOCK
    return (text + " " * pad).encode("ascii")


def _data_bytes(data):
    if data is None:
        return b""
    dtype = _BITPIX_TO_DTYPE[_DTYPE_TO_BITPIX[str(data.dtype.newbyteorder("=").name)]]
    raw = np.ascontiguousarray(data, dtype=dtype).tobytes()
    pad = (-len(raw)) % BLOCK
    return raw + b"\x00" * pad


def _bintable_bytes(hdu):
    """Header + data blocks for a BinTableHDU (standard layout)."""
    from kbmod_tpu_torch.io.fits_bintable import serialize_bintable

    cards_req, data, heap = serialize_bintable(hdu.columns, hdu.nrows)
    cards = [
        _format_card("XTENSION", "BINTABLE"),
        _format_card("BITPIX", 8),
        _format_card("NAXIS", 2),
        _format_card("NAXIS1", cards_req["NAXIS1"]),
        _format_card("NAXIS2", cards_req["NAXIS2"]),
        _format_card("PCOUNT", cards_req["PCOUNT"]),
        _format_card("GCOUNT", 1),
        _format_card("TFIELDS", cards_req["TFIELDS"]),
    ]
    for i in range(1, cards_req["TFIELDS"] + 1):
        cards.append(_format_card(f"TTYPE{i}", cards_req[f"TTYPE{i}"]))
        cards.append(_format_card(f"TFORM{i}", cards_req[f"TFORM{i}"]))
    skip = {
        "XTENSION", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2", "PCOUNT", "GCOUNT",
        "TFIELDS", "THEAP", "END",
    }
    skip.update(f"TTYPE{i}" for i in range(1, 1000))
    skip.update(f"TFORM{i}" for i in range(1, 1000))
    for key, value in hdu.header.items():
        if key.upper() in skip:
            continue
        cards.append(_format_card(key, value))
    cards.append(f"{'END':<{CARD}}")
    text = "".join(cards)
    header = (text + " " * ((-len(text)) % BLOCK)).encode("ascii")
    payload = data + heap
    return header + payload + b"\x00" * ((-len(payload)) % BLOCK)


def write_fits(filename, hdus, overwrite=True):
    """Write a list of HDUs (the first becomes the primary)."""
    path = Path(filename)
    if path.exists() and not overwrite:
        raise FileExistsError(f"File {filename} already exists.")
    with open(path, "wb") as f:
        for i, hdu in enumerate(hdus):
            if isinstance(hdu, BinTableHDU):
                if i == 0:
                    raise ValueError("A BINTABLE cannot be the primary HDU.")
                f.write(_bintable_bytes(hdu))
                continue
            f.write(_header_bytes(hdu, primary=(i == 0)))
            f.write(_data_bytes(hdu.data))


# ----------------------------------------------------------------------
# Reading
# ----------------------------------------------------------------------

def _read_header(f):
    header = {}
    raw_all = b""
    while True:
        block = f.read(BLOCK)
        if len(block) < BLOCK:
            if raw_all == b"" and len(block) == 0:
                return None  # clean EOF
            raise ValueError("Truncated FITS header.")
        raw_all += block
        text = block.decode("ascii", errors="replace")
        done = False
        for i in range(0, BLOCK, CARD):
            card = text[i : i + CARD]
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if not key or key in ("COMMENT", "HISTORY"):
                continue
            if card[8:10] == "= ":
                header[key] = _parse_value(card[10:])
        if done:
            return header


def _read_hdu(f, primary):
    header = _read_header(f)
    if header is None:
        return None
    naxis = int(header.get("NAXIS", 0))
    data = None
    heap = b""
    # Heap area for random-groups / binary tables (fpack CompImageHDUs and
    # variable-length table columns): GCOUNT * (PCOUNT + product(NAXISn))
    # bytes per the FITS standard — must be consumed to keep the HDU
    # stream in sync.
    pcount = int(header.get("PCOUNT", 0) or 0)
    gcount = int(header.get("GCOUNT", 1) or 1)
    if naxis > 0:
        shape = tuple(int(header[f"NAXIS{i}"]) for i in range(naxis, 0, -1))
        bitpix = int(header["BITPIX"])
        dtype = _BITPIX_TO_DTYPE[bitpix]
        count = int(np.prod(shape))
        nbytes = count * dtype.itemsize
        total = gcount * (pcount * abs(bitpix) // 8 + nbytes) if pcount else nbytes
        raw = f.read(nbytes)
        if len(raw) < nbytes:
            raise ValueError("Truncated FITS data.")
        heap = f.read(total - nbytes) if total > nbytes else b""
        f.read((-total) % BLOCK)  # skip padding
        data = np.frombuffer(raw, dtype=dtype).reshape(shape)
        data = data.astype(dtype.newbyteorder("="))
        bzero = header.get("BZERO", 0)
        bscale = header.get("BSCALE", 1)
        if bscale != 1 or bzero != 0:
            # Upcast before scaling: BITPIX=16 + BZERO=32768 (standard
            # unsigned-16 images) overflows int16 under NumPy 2 casting.
            if data.dtype.kind in "iu":
                if (
                    float(bscale) == int(bscale)
                    and float(bzero) == int(bzero)
                    and data.dtype.itemsize <= 4
                ):
                    data = data.astype(np.int64) * int(bscale) + int(bzero)
                    # Unsigned-int convention: report the natural dtype.
                    if int(bscale) == 1 and int(bzero) == 1 << (8 * dtype.itemsize - 1):
                        data = data.astype(f"uint{8 * dtype.itemsize}")
                else:
                    data = data.astype(np.float64) * bscale + bzero
            else:
                data = data * bscale + bzero
    if str(header.get("XTENSION", "")).strip().upper() == "BINTABLE":
        from kbmod_tpu_torch.io.fits_bintable import parse_bintable

        raw_rows = b"" if data is None else np.ascontiguousarray(data, dtype=np.uint8).tobytes()
        try:
            columns = parse_bintable(header, raw_rows, heap)
        except ValueError:
            columns = {}  # exotic TFORMs: keep raw bytes accessible
        bt = BinTableHDU(columns=columns, header=header,
                         nrows=int(header.get("NAXIS2", 0) or 0))
        bt.data = data
        bt.heap = heap
        if header.get("ZIMAGE", False) and columns:
            # Tiled-image compression (astropy CompImageHDU): decompress
            # into a plain image HDU transparently.
            from kbmod_tpu_torch.io.comp_image import decompress_image

            img, img_header = decompress_image(header, columns)
            hdu = ImageHDU(data=img, header=img_header)
            hdu.heap = b""
            return hdu
        return bt

    hdu = ImageHDU(data=data, header=header)
    hdu.heap = heap  # BINTABLE variable-length-array heap (b"" otherwise)
    if _hdu_is_table(hdu):
        table_hdu = TableHDU(name=hdu.name)
        table_hdu.header = hdu.header
        table_hdu.data = hdu.data
        table_hdu.heap = heap
        return table_hdu
    return hdu


def read_fits(filename):
    """Read all HDUs from a FITS file."""
    hdus = HDUList()
    with open(filename, "rb") as f:
        primary = True
        while True:
            hdu = _read_hdu(f, primary)
            if hdu is None:
                break
            hdus.append(hdu)
            primary = False
    return hdus


def open_fits(filename):
    return read_fits(filename)
