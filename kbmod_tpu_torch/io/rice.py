"""RICE_1 codec for FITS tiled-image compression (a copy of the JAX
package's io/rice.py; the streams are byte-equal).

Implements the Rice algorithm exactly as specified by the FITS tiled
image compression convention (and implemented by CFITSIO's ricecomp.c,
which the reference relies on through astropy: CompImageHDU with
compression_type="RICE_1", work_unit.py:1062-1147): difference mapping
to non-negative integers, 32-pixel blocks, per-block Golomb-Rice split
parameter FS stored in fsbits bits, top-entropy blocks stored verbatim,
zero-entropy blocks run-length collapsed.

Pure-Python reference implementation; a C fast path (native/) can be
swapped in transparently — the bitstreams are identical.
"""

import numpy as np

_PARAMS = {
    1: dict(fsbits=3, fsmax=6, bbits=8),
    2: dict(fsbits=4, fsmax=14, bbits=16),
    4: dict(fsbits=5, fsmax=25, bbits=32),
}
NBLOCK = 32


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value, bits):
        if bits <= 0:
            return
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.out.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def flush(self):
        if self.nbits:
            self.out.append((self.acc << (8 - self.nbits)) & 0xFF)
            self.acc = 0
            self.nbits = 0
        return bytes(self.out)


class _BitReader:
    def __init__(self, data):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def read(self, bits):
        while self.nbits < bits:
            byte = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.acc = (self.acc << 8) | byte
            self.nbits += 8
        self.nbits -= bits
        value = self.acc >> self.nbits
        self.acc &= (1 << self.nbits) - 1
        return value

    def read_unary(self):
        """Count zero bits until (and consuming) the first 1 bit."""
        count = 0
        while True:
            if self.nbits == 0:
                byte = self.data[self.pos] if self.pos < len(self.data) else 1
                self.pos += 1
                self.acc = byte
                self.nbits = 8
            if self.acc == 0:
                count += self.nbits
                self.nbits = 0
                continue
            top = self.acc.bit_length()
            count += self.nbits - top
            self.nbits = top - 1
            self.acc &= (1 << self.nbits) - 1
            return count


def rice_decode(data, npix, bytepix=4):
    """Decode a RICE_1 stream into ``npix`` signed integers.

    Returns an int32 numpy array (int8/int16 semantics wrap naturally via
    the two's-complement difference arithmetic). Uses the native (C)
    codec when available — the pure-Python path below is the semantic
    reference and the compiler-less fallback.
    """
    from kbmod_tpu_torch import native

    if native.available():
        out = native.rice_decode(data, npix, bytepix)
        if out is not None:
            return out
    p = _PARAMS[int(bytepix)]
    fsbits, fsmax, bbits = p["fsbits"], p["fsmax"], p["bbits"]
    out = np.zeros(npix, dtype=np.int64)
    if npix == 0:
        return out.astype(np.int32)

    first = int.from_bytes(data[:bytepix], "big", signed=True)
    rd = _BitReader(data[bytepix:])
    lastpix = first
    mask = (1 << (8 * bytepix)) - 1
    sign = 1 << (8 * bytepix - 1)

    i = 0
    while i < npix:
        imax = min(i + NBLOCK, npix)
        fs = rd.read(fsbits) - 1
        if fs < 0:
            out[i:imax] = lastpix
            i = imax
            continue
        if fs == fsmax:
            for j in range(i, imax):
                diff = rd.read(bbits)
                if diff & 1:
                    diff = ~(diff >> 1)
                else:
                    diff >>= 1
                lastpix = (lastpix + diff) & mask
                if lastpix & sign:
                    lastpix -= 1 << (8 * bytepix)
                out[j] = lastpix
            i = imax
            continue
        for j in range(i, imax):
            top = rd.read_unary()
            low = rd.read(fs) if fs else 0
            diff = (top << fs) | low
            if diff & 1:
                diff = ~(diff >> 1)
            else:
                diff >>= 1
            lastpix = (lastpix + diff) & mask
            if lastpix & sign:
                lastpix -= 1 << (8 * bytepix)
            out[j] = lastpix
        i = imax
    return out.astype(np.int32)


def rice_encode(values, bytepix=4):
    """Encode signed integers as a RICE_1 stream (bit-identical decoding
    contract with CFITSIO's fits_rcomp). Native (C) fast path when
    available; pure-Python reference below."""
    from kbmod_tpu_torch import native

    if native.available():
        out = native.rice_encode(values, bytepix)
        if out is not None:
            return out
    p = _PARAMS[int(bytepix)]
    fsbits, fsmax, bbits = p["fsbits"], p["fsmax"], p["bbits"]
    vals = np.asarray(values, dtype=np.int64)
    npix = len(vals)
    wr = _BitWriter()
    if npix == 0:
        return wr.flush()

    mask = (1 << (8 * bytepix)) - 1
    first = int(vals[0]) & mask
    out_head = first.to_bytes(bytepix, "big")

    # Map successive differences to non-negative integers. Decoder
    # arithmetic is modulo 2^(8*bytepix), so wrap each diff to the signed
    # width range first — the minimal representative fits in bbits bits.
    half = 1 << (8 * bytepix - 1)
    d = (vals[1:] - vals[:-1]).astype(np.int64)
    d = ((d + half) & mask) - half
    mapped = np.where(d < 0, (-d << 1) - 1, d << 1)
    diffs = np.concatenate([[0], mapped])

    # Blocks cover pixels [0, npix); the first pixel is stored verbatim in
    # the header, so its in-block diff is 0.
    i = 0
    while i < npix:
        imax = min(i + NBLOCK, npix)
        block = diffs[i:imax]
        total = int(np.sum(block))
        if total == 0:
            wr.write(0, fsbits)  # fs = -1: all-same block
            i = imax
            continue
        # Choose fs so the unary parts stay short (cfitsio heuristic).
        pixelsum = (total - (len(block) // 2) - 1) / len(block)
        if pixelsum < 0:
            pixelsum = 0.0
        fs = 0
        psum = int(pixelsum)
        while psum > 0:
            psum >>= 1
            fs += 1
        if fs > fsmax:
            fs = fsmax
        wr.write(fs + 1, fsbits)
        if fs == fsmax:
            for v in block:
                wr.write(int(v), bbits)
        else:
            for v in block:
                v = int(v)
                top = v >> fs
                wr.write(1, top + 1)  # top zeros then a 1 -> write value 1 in top+1 bits
                if fs:
                    wr.write(v & ((1 << fs) - 1), fs)
        i = imax
    return out_head + wr.flush()
