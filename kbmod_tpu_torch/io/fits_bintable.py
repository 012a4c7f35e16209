"""FITS BINTABLE parsing/serialization (astropy-interoperable): a copy of
the JAX package's io/fits_bintable.py.

Handles the subset the reference's files use (work_unit.py:489-682,
configuration.py:584-598): fixed-width columns of logical (L), bytes
(B), integers (I/J/K), floats (E/D) and strings (A), plus 32-bit 'P'
and 64-bit 'Q' variable-length array descriptors backed by the heap
(the layout fpack/CompImageHDU uses for per-tile compressed byte
streams).
"""

import re

import numpy as np

_TFORM_RE = re.compile(r"^(\d*)([LBIJKED])$|^(\d*)A$|^([01]?)([PQ])([BIJKED])(?:\((\d+)\))?$")

_CODE_DTYPE = {
    "L": np.dtype(">u1"),
    "B": np.dtype(">u1"),
    "I": np.dtype(">i2"),
    "J": np.dtype(">i4"),
    "K": np.dtype(">i8"),
    "E": np.dtype(">f4"),
    "D": np.dtype(">f8"),
}
_NP_TO_CODE = {
    "uint8": "B",
    "bool": "L",
    "int16": "I",
    "int32": "J",
    "int64": "K",
    "float32": "E",
    "float64": "D",
}


class ColumnSpec:
    def __init__(self, name, tform):
        self.name = name
        self.tform = tform
        m = _TFORM_RE.match(tform.strip())
        if not m:
            raise ValueError(f"Unsupported TFORM {tform!r}")
        if m.group(2):  # numeric / logical
            self.kind = "num"
            self.repeat = int(m.group(1) or 1)
            self.code = m.group(2)
            self.nbytes = self.repeat * _CODE_DTYPE[self.code].itemsize
        elif m.group(3) is not None or tform.strip().endswith("A"):
            self.kind = "str"
            self.repeat = int(m.group(3) or 1)
            self.code = "A"
            self.nbytes = self.repeat
        else:
            self.kind = "varlen"
            self.code = m.group(6)
            self.desc64 = m.group(5) == "Q"
            self.nbytes = 16 if self.desc64 else 8


def _parse_tforms(header):
    nfields = int(header.get("TFIELDS", 0))
    cols = []
    for i in range(1, nfields + 1):
        name = str(header.get(f"TTYPE{i}", f"col{i}")).strip()
        cols.append(ColumnSpec(name, str(header[f"TFORM{i}"])))
    return cols


def parse_bintable(header, raw, heap):
    """Parse BINTABLE row bytes + heap into {column name: values}.

    Numeric columns come back as native-endian numpy arrays (repeat > 1
    gives a 2D array); string columns as lists of stripped str; logical
    as bool arrays; variable-length columns as lists of numpy arrays
    (uint8 for 'B', etc.).
    """
    cols = _parse_tforms(header)
    row_bytes = int(header["NAXIS1"])
    nrows = int(header["NAXIS2"])
    theap = int(header.get("THEAP", row_bytes * nrows) or row_bytes * nrows)
    if theap > row_bytes * nrows:
        # Heap starts at THEAP bytes from the start of the data block; our
        # heap buffer starts right after the table rows.
        heap = heap[theap - row_bytes * nrows :]
    table = np.frombuffer(raw, dtype=np.uint8).reshape(nrows, row_bytes) if nrows else np.zeros((0, row_bytes), np.uint8)

    out = {}
    offset = 0
    for col in cols:
        chunk = table[:, offset : offset + col.nbytes]
        offset += col.nbytes
        if col.kind == "num":
            dt = _CODE_DTYPE[col.code]
            vals = chunk.reshape(-1).view(dt).reshape(nrows, col.repeat)
            vals = vals.astype(dt.newbyteorder("="))
            if col.code == "L":
                vals = np.isin(vals, (ord("T"),))
            if col.repeat == 1:
                vals = vals[:, 0]
            out[col.name] = vals
        elif col.kind == "str":
            out[col.name] = [
                bytes(row).rstrip(b"\x00 ").decode("ascii", "replace") for row in chunk
            ]
        else:
            desc_dt = np.dtype(">i8") if col.desc64 else np.dtype(">i4")
            desc = chunk.reshape(-1).view(desc_dt).reshape(nrows, 2)
            elem = _CODE_DTYPE[col.code]
            vals = []
            for n_elem, off in desc:
                nbytes = int(n_elem) * elem.itemsize
                seg = heap[int(off) : int(off) + nbytes]
                vals.append(np.frombuffer(seg, dtype=elem).astype(elem.newbyteorder("=")))
            out[col.name] = vals
    return out


def serialize_bintable(columns, nrows):
    """Serialize {name: values} into (header_cards, row_bytes, heap_bytes).

    Values may be numpy numeric arrays (1D or 2D), lists of strings, or
    lists of numpy arrays (variable-length; stored via 'P' descriptors).
    Returns (cards: dict, data: bytes, heap: bytes).
    """
    specs = []
    encoded = []
    heap = bytearray()
    for name, vals in columns.items():
        if isinstance(vals, np.ndarray) and vals.dtype.kind in "iufb":
            arr = vals
            if arr.dtype == bool:
                code = "L"
                enc = np.where(arr, ord("T"), ord("F")).astype(">u1")
            else:
                code = _NP_TO_CODE[arr.dtype.name]
                enc = arr.astype(_CODE_DTYPE[code])
            repeat = 1 if enc.ndim == 1 else enc.shape[1]
            tform = f"{repeat}{code}" if repeat != 1 else code
            specs.append((name, tform))
            encoded.append(enc.reshape(nrows, -1).view(np.uint8).reshape(nrows, -1))
        elif isinstance(vals, (list, tuple)) and (len(vals) == 0 or isinstance(vals[0], str)):
            strs = [str(v) for v in vals]
            width = max([len(s) for s in strs] + [1])
            tform = f"{width}A"
            specs.append((name, tform))
            enc = np.zeros((nrows, width), dtype=np.uint8)
            for i, s in enumerate(strs):
                b = s.encode("ascii", "replace")[:width]
                enc[i, : len(b)] = np.frombuffer(b, np.uint8)
            encoded.append(enc)
        else:
            # Variable-length byte/numeric arrays -> 'P' descriptors.
            sample = np.asarray(vals[0]) if len(vals) else np.zeros(0, np.uint8)
            code = _NP_TO_CODE[sample.dtype.name] if sample.dtype.kind in "iuf" else "B"
            elem = _CODE_DTYPE[code]
            desc = np.zeros((nrows, 2), dtype=">i4")
            for i, v in enumerate(vals):
                arr = np.asarray(v).astype(elem)
                desc[i] = (len(arr), len(heap))
                heap.extend(arr.tobytes())
            specs.append((name, f"1P{code}({max((len(np.asarray(v)) for v in vals), default=0)})"))
            encoded.append(desc.view(np.uint8).reshape(nrows, -1))
        if encoded[-1].shape[0] != nrows:
            raise ValueError(f"Column {name} has {encoded[-1].shape[0]} rows, expected {nrows}")

    row_bytes = sum(e.shape[1] for e in encoded)
    data = np.concatenate(encoded, axis=1).tobytes() if nrows else b""

    cards = {
        "XTENSION": "BINTABLE",
        "BITPIX": 8,
        "NAXIS": 2,
        "NAXIS1": row_bytes,
        "NAXIS2": nrows,
        "PCOUNT": len(heap),
        "GCOUNT": 1,
        "TFIELDS": len(specs),
    }
    # THEAP defaults to NAXIS1*NAXIS2 (heap follows the table directly).
    for i, (name, tform) in enumerate(specs, start=1):
        cards[f"TTYPE{i}"] = name
        cards[f"TFORM{i}"] = tform
    return cards, data, bytes(heap)
