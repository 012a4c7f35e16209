// Native host-side kernels for kbmod_tpu.
//
// The TPU handles all image-domain compute; these routines cover the
// host-side hot paths that the reference implements in C++/numba:
//   * grid_dedup — best-likelihood-per-spatial-bin selection over raw
//     result sets (the reference's TrajectoryClusterGrid,
//     src/kbmod/filters/clustering_grid.py / trajectory_list.cpp), used as
//     the near-duplicate prefilter over up to hundreds of millions of raw
//     trajectories before they ever reach Python objects.
//   * extract_stamps — NaN-padded stamp cutouts (the reference's numba
//     kernels, src/kbmod/core/stamp_utils.py:403-474).
//
// Exposed with a plain C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Select the best (highest lh; first-seen wins ties) trajectory per
// 4-tuple spatial bin. Bins: (x/bw, y/bw, (x+dt*vx)/bw, (y+dt*vy)/bw) with
// C-truncation, matching the Python reference.
//
// Returns the number of kept indices written to out_idx (caller allocates
// n entries). Kept indices are in ascending order.
int64_t grid_dedup(const int32_t* x, const int32_t* y, const float* vx, const float* vy,
                   const float* lh, int64_t n, double bin_width, double max_time,
                   int64_t* out_idx) {
    std::unordered_map<uint64_t, int64_t> best;  // bin key -> index of best
    best.reserve(static_cast<size_t>(n) * 2);

    auto bin_of = [&](double v) -> int64_t { return static_cast<int64_t>(v / bin_width); };

    for (int64_t i = 0; i < n; ++i) {
        const int64_t bx = bin_of(static_cast<double>(x[i]));
        const int64_t by = bin_of(static_cast<double>(y[i]));
        const int64_t ex = bin_of(static_cast<double>(x[i]) + max_time * static_cast<double>(vx[i]));
        const int64_t ey = bin_of(static_cast<double>(y[i]) + max_time * static_cast<double>(vy[i]));

        // Pack the four (small) bin coordinates into one 64-bit key.
        const uint64_t key = ((static_cast<uint64_t>(bx) & 0xFFFF) << 48) |
                             ((static_cast<uint64_t>(by) & 0xFFFF) << 32) |
                             ((static_cast<uint64_t>(ex) & 0xFFFF) << 16) |
                             (static_cast<uint64_t>(ey) & 0xFFFF);

        auto it = best.find(key);
        if (it == best.end()) {
            best.emplace(key, i);
        } else if (lh[i] > lh[it->second]) {
            it->second = i;
        }
    }

    int64_t count = 0;
    for (const auto& kv : best) {
        out_idx[count++] = kv.second;
    }
    // Ascending order for deterministic output.
    std::vector<int64_t> tmp(out_idx, out_idx + count);
    std::sort(tmp.begin(), tmp.end());
    std::memcpy(out_idx, tmp.data(), sizeof(int64_t) * count);
    return count;
}

// Extract NaN-padded stamps: for each of n trajectories and T times, cut a
// (2r+1)^2 window centered at (xs[i*T + t], ys[i*T + t]) from imgs
// (T, H, W) into out (n, T, S, S).
void extract_stamps(const float* imgs, int64_t T, int64_t H, int64_t W,
                    const int32_t* xs, const int32_t* ys, int64_t n, int32_t radius,
                    float* out) {
    const int64_t S = 2 * static_cast<int64_t>(radius) + 1;
    const float nanv = std::nanf("");

    for (int64_t i = 0; i < n; ++i) {
        for (int64_t t = 0; t < T; ++t) {
            const int64_t cx = xs[i * T + t];
            const int64_t cy = ys[i * T + t];
            float* dst = out + ((i * T + t) * S * S);
            const float* src_img = imgs + t * H * W;
            for (int64_t r = 0; r < S; ++r) {
                const int64_t sy = cy - radius + r;
                float* row_dst = dst + r * S;
                if (sy < 0 || sy >= H) {
                    for (int64_t c = 0; c < S; ++c) row_dst[c] = nanv;
                    continue;
                }
                for (int64_t c = 0; c < S; ++c) {
                    const int64_t sx = cx - radius + c;
                    row_dst[c] = (sx >= 0 && sx < W) ? src_img[sy * W + sx] : nanv;
                }
            }
        }
    }
}

// ----------------------------------------------------------------------
// RICE_1 codec (FITS tiled-image compression; CFITSIO bitstream contract).
// The hot path for reading/writing reference-format WorkUnit files
// (SCI/VAR CompImageHDUs): the pure-Python codec in io/rice.py is the
// semantic reference, this is the speed path (identical bitstreams).
// ----------------------------------------------------------------------

struct BitReader {
    const uint8_t* data;
    int64_t nbytes;
    int64_t pos = 0;
    uint64_t acc = 0;
    int nbits = 0;

    inline uint32_t read(int bits) {
        while (nbits < bits) {
            uint8_t b = pos < nbytes ? data[pos] : 0;
            pos++;
            acc = (acc << 8) | b;
            nbits += 8;
        }
        nbits -= bits;
        uint32_t value = (uint32_t)(acc >> nbits);
        acc &= (nbits >= 64) ? ~0ULL : ((1ULL << nbits) - 1);
        return value;
    }

    inline uint32_t read_unary() {
        uint32_t count = 0;
        for (;;) {
            if (nbits == 0) {
                uint8_t b = pos < nbytes ? data[pos] : 1;  // terminate on EOF
                pos++;
                acc = b;
                nbits = 8;
            }
            if (acc == 0) {
                count += nbits;
                nbits = 0;
                continue;
            }
            int top = 64 - __builtin_clzll(acc);
            count += nbits - top;
            nbits = top - 1;
            acc &= (nbits >= 64) ? ~0ULL : ((1ULL << nbits) - 1);
            return count;
        }
    }
};

static inline void rice_params(int bytepix, int* fsbits, int* fsmax, int* bbits) {
    if (bytepix == 1) { *fsbits = 3; *fsmax = 6; *bbits = 8; }
    else if (bytepix == 2) { *fsbits = 4; *fsmax = 14; *bbits = 16; }
    else { *fsbits = 5; *fsmax = 25; *bbits = 32; }
}

// Decode a RICE_1 stream into npix int32 values. Returns 0 on success.
int rice_decode(const uint8_t* data, int64_t nbytes, int64_t npix,
                int32_t bytepix, int32_t* out) {
    if (npix <= 0) return 0;
    if (nbytes < bytepix) return 1;
    int fsbits, fsmax, bbits;
    rice_params(bytepix, &fsbits, &fsmax, &bbits);
    const int nblock = 32;
    const int width = 8 * bytepix;
    const uint64_t mask = (width >= 64) ? ~0ULL : ((1ULL << width) - 1);
    const int64_t sign = 1LL << (width - 1);

    int64_t first = 0;
    for (int i = 0; i < bytepix; i++) first = (first << 8) | data[i];
    if (first & sign) first -= (1LL << width);
    int64_t lastpix = first;

    BitReader rd{data + bytepix, nbytes - bytepix};
    int64_t i = 0;
    while (i < npix) {
        int64_t imax = i + nblock < npix ? i + nblock : npix;
        int fs = (int)rd.read(fsbits) - 1;
        if (fs < 0) {
            for (; i < imax; i++) out[i] = (int32_t)lastpix;
            continue;
        }
        for (; i < imax; i++) {
            uint64_t diff;
            if (fs == fsmax) {
                diff = rd.read(bbits);
            } else {
                uint64_t top = rd.read_unary();
                uint64_t low = fs ? rd.read(fs) : 0;
                diff = (top << fs) | low;
            }
            int64_t d = (diff & 1) ? ~(int64_t)(diff >> 1) : (int64_t)(diff >> 1);
            lastpix = (lastpix + d) & mask;
            if (lastpix & sign) lastpix -= (1LL << width);
            out[i] = (int32_t)lastpix;
        }
    }
    return 0;
}

struct BitWriter {
    uint8_t* out;
    int64_t cap;
    int64_t pos = 0;
    uint64_t acc = 0;
    int nbits = 0;
    bool overflow = false;

    inline void put_byte(uint8_t b) {
        if (pos < cap) out[pos] = b; else overflow = true;
        pos++;
    }

    inline void write(uint64_t value, int bits) {
        while (bits > 56) {  // keep acc within 64 bits
            write((value >> (bits - 56)), 56);
            bits -= 56;
            value &= (1ULL << bits) - 1;
        }
        if (bits <= 0) return;
        acc = (acc << bits) | (value & ((bits >= 64) ? ~0ULL : ((1ULL << bits) - 1)));
        nbits += bits;
        while (nbits >= 8) {
            nbits -= 8;
            put_byte((uint8_t)(acc >> nbits));
        }
        acc &= (nbits >= 64) ? ~0ULL : ((1ULL << nbits) - 1);
    }

    inline void write_unary_one(uint64_t zeros) {
        // `zeros` zero bits followed by a 1.
        while (zeros >= 32) { write(0, 32); zeros -= 32; }
        write(1, (int)zeros + 1);
    }

    inline void flush() {
        if (nbits) {
            put_byte((uint8_t)(acc << (8 - nbits)));
            acc = 0;
            nbits = 0;
        }
    }
};

// Encode npix int32 values; writes up to cap bytes into out and returns
// the stream length in bytes, or -1 if cap was too small.
int64_t rice_encode(const int32_t* vals, int64_t npix, int32_t bytepix,
                    uint8_t* out, int64_t cap) {
    if (npix <= 0) return 0;
    int fsbits, fsmax, bbits;
    rice_params(bytepix, &fsbits, &fsmax, &bbits);
    const int nblock = 32;
    const int width = 8 * bytepix;
    const uint64_t mask = (width >= 64) ? ~0ULL : ((1ULL << width) - 1);
    const int64_t half = 1LL << (width - 1);

    BitWriter wr{out, cap};
    uint64_t first = (uint64_t)vals[0] & mask;
    for (int i = bytepix - 1; i >= 0; i--) wr.put_byte((uint8_t)(first >> (8 * i)));

    std::vector<uint64_t> diffs(nblock);
    int64_t i = 0;
    int64_t prev = vals[0];
    while (i < npix) {
        int64_t imax = i + nblock < npix ? i + nblock : npix;
        uint64_t total = 0;
        int nb = (int)(imax - i);
        for (int j = 0; j < nb; j++) {
            int64_t d = (i + j == 0) ? 0 : (int64_t)vals[i + j] - prev;
            prev = vals[i + j];
            d = ((d + half) & mask) - half;  // wrap to the signed width range
            uint64_t m = d < 0 ? (uint64_t)((-d << 1) - 1) : (uint64_t)(d << 1);
            diffs[j] = m;
            total += m;
        }
        if (total == 0) {
            wr.write(0, fsbits);  // fs = -1: constant block
            i = imax;
            continue;
        }
        double pixelsum = ((double)total - (nb / 2) - 1) / nb;
        if (pixelsum < 0) pixelsum = 0.0;
        uint64_t psum = (uint64_t)pixelsum;
        int fs = 0;
        while (psum > 0) { psum >>= 1; fs++; }
        if (fs > fsmax) fs = fsmax;
        wr.write(fs + 1, fsbits);
        if (fs == fsmax) {
            for (int j = 0; j < nb; j++) wr.write(diffs[j], bbits);
        } else {
            for (int j = 0; j < nb; j++) {
                wr.write_unary_one(diffs[j] >> fs);
                if (fs) wr.write(diffs[j] & ((1ULL << fs) - 1), fs);
            }
        }
        i = imax;
    }
    wr.flush();
    return wr.overflow ? -1 : wr.pos;
}

}  // extern "C"
