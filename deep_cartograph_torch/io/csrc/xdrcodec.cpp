// Native trajectory codec: GROMACS XTC (xdr3dfcoord) coordinate compression.
//
// Host-side C++ replacing the trajectory decoding the reference delegated to
// PLUMED's molfile plugins (SURVEY §2.4: "Trajectory decoding (DCD/XTC)
// needs a host-side reader feeding device buffers").
//
// Decoder: full xdr3dfcoord bitstream per the format specification
// (absolute bit-packed triplets + adaptive small-delta runs with the
// water-swap reordering), so externally produced GROMACS/MDAnalysis XTC
// files read correctly.
//
// Encoder: writes spec-conformant frames using absolute bit-packed triplets
// only (run length 0 throughout) — a valid, simpler subset that every XTC
// reader accepts (~3x smaller than raw floats for typical precisions).
//
// Exposed as a flat C ABI consumed via ctypes (no pybind11 dependency).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Allowed range sizes from the XTC format specification.
const int MAGICINTS[] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64, 80,
    101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024, 1290, 1625,
    2048, 2580, 3250, 4096, 5060, 6501, 8192, 10321, 13003, 16384, 20642,
    26007, 32768, 41285, 52015, 65536, 82570, 104031, 131072, 165140,
    208063, 262144, 330280, 416127, 524287, 660561, 832255, 1048576,
    1321122, 1664510, 2097152, 2642245, 3329021, 4194304, 5284491, 6658042,
    8388607, 10568983, 13316085, 16777216};
const int FIRSTIDX = 9;
const int LASTIDX = int(sizeof(MAGICINTS) / sizeof(int)) - 1;

struct BitWriter {
    std::vector<uint8_t> data;
    uint32_t acc = 0;
    int nbits = 0;

    void put(int num_bits, uint32_t value) {
        value &= (num_bits >= 32) ? 0xffffffffu : ((1u << num_bits) - 1);
        acc = (acc << num_bits) | value;
        nbits += num_bits;
        while (nbits >= 8) {
            nbits -= 8;
            data.push_back(uint8_t((acc >> nbits) & 0xff));
        }
        acc &= (nbits > 0) ? ((1u << nbits) - 1) : 0;
    }

    void flush() {
        if (nbits > 0) {
            data.push_back(uint8_t((acc << (8 - nbits)) & 0xff));
            acc = 0;
            nbits = 0;
        }
    }
};

struct BitReader {
    const uint8_t* data;
    size_t size;
    size_t pos = 0;   // bytes consumed
    int used = 0;     // bits consumed of data[pos]

    uint32_t get(int num_bits) {
        uint32_t value = 0;
        while (num_bits > 0) {
            if (pos >= size) return value << num_bits;  // truncated
            int avail = 8 - used;
            int take = std::min(avail, num_bits);
            uint8_t chunk =
                (data[pos] >> (avail - take)) & uint8_t((1u << take) - 1);
            value = (value << take) | chunk;
            used += take;
            num_bits -= take;
            if (used == 8) {
                used = 0;
                ++pos;
            }
        }
        return value;
    }
};

int sizeofint(unsigned int size) {
    unsigned int num = 1;
    int nbits = 0;
    while (size >= num && nbits < 32) {
        ++nbits;
        num <<= 1;
    }
    return nbits;
}

// Total bits needed to store num_of_ints values with the given ranges as one
// mixed-radix big integer (per the format spec).
int sizeofints(int num_of_ints, const unsigned int sizes[]) {
    unsigned int bytes[32];
    unsigned int num_of_bytes = 1;
    bytes[0] = 1;
    int num_of_bits = 0;
    for (int i = 0; i < num_of_ints; ++i) {
        unsigned int tmp = 0;
        unsigned int bytecnt;
        for (bytecnt = 0; bytecnt < num_of_bytes; ++bytecnt) {
            tmp = bytes[bytecnt] * sizes[i] + tmp;
            bytes[bytecnt] = tmp & 0xff;
            tmp >>= 8;
        }
        while (tmp != 0) {
            bytes[bytecnt++] = tmp & 0xff;
            tmp >>= 8;
        }
        num_of_bytes = bytecnt;
    }
    unsigned int num = 1;
    --num_of_bytes;
    while (bytes[num_of_bytes] >= num) {
        ++num_of_bits;
        num *= 2;
    }
    return num_of_bits + int(num_of_bytes) * 8;
}

void encodeints(BitWriter& w, int num_of_ints, int num_of_bits,
                const unsigned int sizes[], const unsigned int nums[]) {
    unsigned int bytes[32];
    unsigned int num_of_bytes = 0;
    unsigned int tmp = nums[0];
    do {
        bytes[num_of_bytes++] = tmp & 0xff;
        tmp >>= 8;
    } while (tmp != 0);
    for (int i = 1; i < num_of_ints; ++i) {
        unsigned int carry = nums[i];
        unsigned int bytecnt;
        for (bytecnt = 0; bytecnt < num_of_bytes; ++bytecnt) {
            unsigned int t = bytes[bytecnt] * sizes[i] + carry;
            bytes[bytecnt] = t & 0xff;
            carry = t >> 8;
        }
        while (carry != 0) {
            bytes[num_of_bytes++] = carry & 0xff;
            carry >>= 8;
        }
    }
    if (num_of_bits >= int(num_of_bytes) * 8) {
        for (unsigned int b = 0; b < num_of_bytes; ++b) w.put(8, bytes[b]);
        w.put(num_of_bits - int(num_of_bytes) * 8, 0);
    } else {
        unsigned int b;
        for (b = 0; int(b) < num_of_bits / 8; ++b) w.put(8, bytes[b]);
        w.put(num_of_bits % 8, bytes[b]);
    }
}

void decodeints(BitReader& r, int num_of_ints, int num_of_bits,
                const unsigned int sizes[], int nums[]) {
    int bytes[32] = {0, 0, 0, 0};
    int num_of_bytes = 0;
    while (num_of_bits > 8) {
        bytes[num_of_bytes++] = int(r.get(8));
        num_of_bits -= 8;
    }
    if (num_of_bits > 0) bytes[num_of_bytes++] = int(r.get(num_of_bits));
    for (int i = num_of_ints - 1; i > 0; --i) {
        int num = 0;
        for (int j = num_of_bytes - 1; j >= 0; --j) {
            num = (num << 8) | bytes[j];
            int p = num / int(sizes[i]);
            bytes[j] = p;
            num -= p * int(sizes[i]);
        }
        nums[i] = num;
    }
    nums[0] = bytes[0] | (bytes[1] << 8) | (bytes[2] << 16) | (bytes[3] << 24);
}

void put_be(std::vector<uint8_t>& out, int v) {
    out.push_back(uint8_t((v >> 24) & 0xff));
    out.push_back(uint8_t((v >> 16) & 0xff));
    out.push_back(uint8_t((v >> 8) & 0xff));
    out.push_back(uint8_t(v & 0xff));
}

int get_be(const uint8_t*& p) {
    int v = (p[0] << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
    p += 4;
    return v;
}

}  // namespace

extern "C" {

// Compress natoms coordinates (nm floats) into the xdr3dfcoord section
// (precision .. padded payload). Returns byte count, -1 on overflow/range,
// -2 for natoms <= 9 (format stores those uncompressed — caller handles).
int xtc_compress_coords(const float* coords, int natoms, float precision,
                        uint8_t* out, int out_capacity) {
    if (natoms <= 9) return -2;
    if (precision <= 0) precision = 1000.0f;

    std::vector<int> ints(size_t(natoms) * 3);
    int minint[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
    int maxint[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
    for (int i = 0; i < natoms * 3; ++i) {
        float lf = coords[i] * precision;
        lf += (lf >= 0) ? 0.5f : -0.5f;
        if (lf > 2097152.0f || lf < -2097152.0f) return -1;
        int v = int(lf);
        ints[i] = v;
        minint[i % 3] = std::min(minint[i % 3], v);
        maxint[i % 3] = std::max(maxint[i % 3], v);
    }

    unsigned int sizeint[3], bitsizeint[3] = {0, 0, 0};
    for (int d = 0; d < 3; ++d)
        sizeint[d] = (unsigned)(maxint[d] - minint[d]) + 1;
    int bitsize;
    if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
        bitsizeint[0] = sizeofint(sizeint[0]);
        bitsizeint[1] = sizeofint(sizeint[1]);
        bitsizeint[2] = sizeofint(sizeint[2]);
        bitsize = 0;
    } else {
        bitsize = sizeofints(3, sizeint);
    }

    int smallidx = FIRSTIDX;  // fixed: we never emit delta runs

    BitWriter w;
    int prevrun = -1;
    for (int i = 0; i < natoms; ++i) {
        unsigned int absc[3] = {
            (unsigned)(ints[i * 3] - minint[0]),
            (unsigned)(ints[i * 3 + 1] - minint[1]),
            (unsigned)(ints[i * 3 + 2] - minint[2])};
        if (bitsize == 0) {
            w.put(int(bitsizeint[0]), absc[0]);
            w.put(int(bitsizeint[1]), absc[1]);
            w.put(int(bitsizeint[2]), absc[2]);
        } else {
            encodeints(w, 3, bitsize, sizeint, absc);
        }
        // run header: first atom announces run=0 (encoded value 1:
        // decoder does is_smaller = 1%3 = 1; run -= 1 -> 0; is_smaller-- -> 0)
        if (prevrun != 0) {
            w.put(1, 1);
            w.put(5, 1);
            prevrun = 0;
        } else {
            w.put(1, 0);
        }
    }
    w.flush();

    std::vector<uint8_t> head;
    uint32_t prec_bits;
    std::memcpy(&prec_bits, &precision, 4);
    put_be(head, int(prec_bits));
    for (int d = 0; d < 3; ++d) put_be(head, minint[d]);
    for (int d = 0; d < 3; ++d) put_be(head, maxint[d]);
    put_be(head, smallidx);
    put_be(head, int(w.data.size()));

    size_t padded = (w.data.size() + 3) / 4 * 4;
    if (head.size() + padded > size_t(out_capacity)) return -1;
    std::memcpy(out, head.data(), head.size());
    std::memcpy(out + head.size(), w.data.data(), w.data.size());
    std::memset(out + head.size() + w.data.size(), 0, padded - w.data.size());
    return int(head.size() + padded);
}

// Decompress the xdr3dfcoord section (starting at the precision field) into
// natoms*3 nm floats. Returns bytes consumed, or -1 on error.
int xtc_decompress_coords(const uint8_t* in, int in_size, int natoms,
                          float* coords) {
    if (natoms <= 9) return -2;
    const uint8_t* p = in;
    if (in_size < 9 * 4) return -1;
    int prec_bits = get_be(p);
    float precision;
    std::memcpy(&precision, &prec_bits, 4);
    int minint[3], maxint[3];
    for (int d = 0; d < 3; ++d) minint[d] = get_be(p);
    for (int d = 0; d < 3; ++d) maxint[d] = get_be(p);
    int smallidx = get_be(p);
    if (smallidx < FIRSTIDX || smallidx > LASTIDX) return -1;
    int nbytes = get_be(p);
    if (p - in + nbytes > in_size) return -1;

    unsigned int sizeint[3], bitsizeint[3] = {0, 0, 0};
    for (int d = 0; d < 3; ++d)
        sizeint[d] = (unsigned)(maxint[d] - minint[d]) + 1;
    int bitsize;
    if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
        bitsizeint[0] = sizeofint(sizeint[0]);
        bitsizeint[1] = sizeofint(sizeint[1]);
        bitsizeint[2] = sizeofint(sizeint[2]);
        bitsize = 0;
    } else {
        bitsize = sizeofints(3, sizeint);
    }

    int smaller = MAGICINTS[std::max(FIRSTIDX, smallidx - 1)] / 2;
    int smallnum = MAGICINTS[smallidx] / 2;
    unsigned int sizesmall[3] = {(unsigned)MAGICINTS[smallidx],
                                 (unsigned)MAGICINTS[smallidx],
                                 (unsigned)MAGICINTS[smallidx]};

    BitReader r{p, size_t(nbytes)};
    float inv_precision = 1.0f / precision;
    int run = 0;
    int i = 0;
    float* lfp = coords;
    int prevcoord[3] = {0, 0, 0};

    while (i < natoms) {
        int thiscoord[3];
        if (bitsize == 0) {
            thiscoord[0] = int(r.get(int(bitsizeint[0])));
            thiscoord[1] = int(r.get(int(bitsizeint[1])));
            thiscoord[2] = int(r.get(int(bitsizeint[2])));
        } else {
            decodeints(r, 3, bitsize, sizeint, thiscoord);
        }
        ++i;
        thiscoord[0] += minint[0];
        thiscoord[1] += minint[1];
        thiscoord[2] += minint[2];
        prevcoord[0] = thiscoord[0];
        prevcoord[1] = thiscoord[1];
        prevcoord[2] = thiscoord[2];

        unsigned int flag = r.get(1);
        int is_smaller = 0;
        if (flag == 1) {
            run = int(r.get(5));
            is_smaller = run % 3;
            run -= is_smaller;
            --is_smaller;
        }
        if (run > 0) {
            for (int k = 0; k < run; k += 3) {
                // Corrupt (or desynced) run headers must not write past
                // the caller's natoms*3 buffer.
                if (i >= natoms) return -1;
                int delta[3];
                // GROMACS xdr3dfcoord decodes delta triples with exactly
                // `smallidx` bits (decodeints(buf,3,smallidx,sizesmall,..)).
                // sizeofints(3,sizesmall) equals smallidx+1 whenever
                // magicints[smallidx]^3 is an exact power of two
                // (smallidx 9,12,15,...), which would desync the stream
                // on externally produced files.
                decodeints(r, 3, smallidx, sizesmall, delta);
                ++i;
                thiscoord[0] = delta[0] + prevcoord[0] - smallnum;
                thiscoord[1] = delta[1] + prevcoord[1] - smallnum;
                thiscoord[2] = delta[2] + prevcoord[2] - smallnum;
                if (k == 0) {
                    // Water-swap: the delta atom is written before the
                    // absolute atom (format-mandated reordering).
                    std::swap(thiscoord[0], prevcoord[0]);
                    std::swap(thiscoord[1], prevcoord[1]);
                    std::swap(thiscoord[2], prevcoord[2]);
                    *lfp++ = float(prevcoord[0]) * inv_precision;
                    *lfp++ = float(prevcoord[1]) * inv_precision;
                    *lfp++ = float(prevcoord[2]) * inv_precision;
                } else {
                    prevcoord[0] = thiscoord[0];
                    prevcoord[1] = thiscoord[1];
                    prevcoord[2] = thiscoord[2];
                }
                *lfp++ = float(thiscoord[0]) * inv_precision;
                *lfp++ = float(thiscoord[1]) * inv_precision;
                *lfp++ = float(thiscoord[2]) * inv_precision;
            }
        } else {
            *lfp++ = float(thiscoord[0]) * inv_precision;
            *lfp++ = float(thiscoord[1]) * inv_precision;
            *lfp++ = float(thiscoord[2]) * inv_precision;
        }
        smallidx += is_smaller;
        if (is_smaller < 0) {
            smallnum = smaller;
            smaller = (smallidx > FIRSTIDX) ? MAGICINTS[smallidx - 1] / 2 : 0;
        } else if (is_smaller > 0) {
            smaller = smallnum;
            smallnum = MAGICINTS[smallidx] / 2;
        }
        sizesmall[0] = sizesmall[1] = sizesmall[2] =
            (unsigned)MAGICINTS[smallidx];
        if (sizesmall[0] == 0) return -1;
    }
    return int(p - in) + ((nbytes + 3) / 4) * 4;
}

// Parallel batch decode: frame f's xdr3dfcoord section starts at
// data + offsets[f] (caller walks the frame table — header sizes are
// readable without decompression). All frames share natoms; out is
// (n_frames, natoms, 3) nm floats. Frames are independent bit streams,
// so they decode concurrently (OpenMP). Returns 0, or the error code of
// a failing frame.
int xtc_decompress_frames_batch(const uint8_t* data, long data_size,
                                const long* offsets, int n_frames,
                                int natoms, float* out) {
    int err = 0;
#pragma omp parallel for schedule(dynamic, 4)
    for (int f = 0; f < n_frames; ++f) {
        long avail = data_size - offsets[f];
        if (avail > INT32_MAX) avail = INT32_MAX;
        int rc = xtc_decompress_coords(
            data + offsets[f], int(avail), natoms,
            out + size_t(f) * size_t(natoms) * 3);
        if (rc < 0) {
#pragma omp atomic write
            err = rc;
        }
    }
    return err;
}

}  // extern "C"
