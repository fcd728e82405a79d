// kzg_tpu_torch native runtime: byte-level codecs and bulk conversions on
// the host.
//
// Host C++ only, with no device code: the port's field and group math runs
// in PyTorch and its CUDA kernels (kzg_tpu_torch/csrc/*.cu); this library
// owns the byte shuffling around it, the role NTL/MIRACL byte converters and
// the reference's serialization helpers play on the C++ side (reference
// src/util.cpp:31-170, src/blob.cpp:20-48, src/trusted_setup.cpp:256-287):
// hex codecs, blob chunk packing, big-endian point records <-> little-endian
// limb matrices, polynomial stream codecs, and trusted-setup file scanning
// and writing. Exposed through a plain C ABI, built at first use and loaded
// with ctypes by kzg_tpu_torch/native.py.
//
// Conventions:
//   * "limbs" are base-2^16 little-endian uint32 lanes, limb-major:
//     out[l * n + i] = limb l of element i  (the (L, n) layout of
//     kzg_tpu_torch.fields.mont, whose tensors take them as int64);
//   * all sizes are element counts unless suffixed _bytes.

#include <cstdint>
#include <cstring>
#include <cstdio>

extern "C" {

// ---------------------------------------------------------------------------
// hex
// ---------------------------------------------------------------------------

int kzg_hex_decode(const char* hex, int64_t hex_len, uint8_t* out) {
    auto nib = [](char c) -> int {
        if (c >= '0' && c <= '9') return c - '0';
        if (c >= 'a' && c <= 'f') return c - 'a' + 10;
        if (c >= 'A' && c <= 'F') return c - 'A' + 10;
        return -1;
    };
    int64_t n = hex_len / 2;
    for (int64_t i = 0; i < n; i++) {
        int h = nib(hex[2 * i]), l = nib(hex[2 * i + 1]);
        if (h < 0 || l < 0) return -1;
        out[i] = static_cast<uint8_t>((h << 4) | l);
    }
    return 0;
}

void kzg_hex_encode(const uint8_t* data, int64_t n, char* out) {
    static const char* d = "0123456789abcdef";
    for (int64_t i = 0; i < n; i++) {
        out[2 * i] = d[data[i] >> 4];
        out[2 * i + 1] = d[data[i] & 0xF];
    }
}

// ---------------------------------------------------------------------------
// blob packing: bytes -> limb-major (L, n) matrix of chunk scalars
// (chunk bytes little-endian, zero-padded to modbytes; reference
// blob.cpp:32-44 semantics with the read-from-start quirk)
// ---------------------------------------------------------------------------

void kzg_pack_chunks_limbs(const uint8_t* data, int64_t chunk_length,
                           int32_t chunk_size, int32_t n_limbs,
                           uint32_t* out) {
    for (int64_t i = 0; i < chunk_length; i++) {
        const uint8_t* c = data + i * chunk_size;
        for (int32_t l = 0; l < n_limbs; l++) {
            int32_t b0 = 2 * l, b1 = 2 * l + 1;
            uint32_t v = 0;
            if (b0 < chunk_size) v |= static_cast<uint32_t>(c[b0]);
            if (b1 < chunk_size) v |= static_cast<uint32_t>(c[b1]) << 8;
            out[static_cast<int64_t>(l) * chunk_length + i] = v;
        }
    }
}

// ---------------------------------------------------------------------------
// big-endian byte records <-> limb-major matrices
// ---------------------------------------------------------------------------

// in:  n records of `width` big-endian bytes (concatenated)
// out: (n_limbs, n) limb-major matrix
void kzg_be_to_limbs(const uint8_t* recs, int64_t n, int32_t width,
                     int32_t n_limbs, uint32_t* out) {
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* r = recs + i * width;
        for (int32_t l = 0; l < n_limbs; l++) {
            // limb l covers bytes [2l, 2l+2) little-endian from the value,
            // i.e. big-endian positions width-1-2l and width-2-2l
            uint32_t v = 0;
            int32_t p0 = width - 1 - 2 * l;
            int32_t p1 = width - 2 - 2 * l;
            if (p0 >= 0) v |= static_cast<uint32_t>(r[p0]);
            if (p1 >= 0) v |= static_cast<uint32_t>(r[p1]) << 8;
            out[static_cast<int64_t>(l) * n + i] = v;
        }
    }
}

void kzg_limbs_to_be(const uint32_t* limbs, int64_t n, int32_t n_limbs,
                     int32_t width, uint8_t* out) {
    memset(out, 0, static_cast<size_t>(n) * width);
    for (int64_t i = 0; i < n; i++) {
        uint8_t* r = out + i * width;
        for (int32_t l = 0; l < n_limbs; l++) {
            uint32_t v = limbs[static_cast<int64_t>(l) * n + i];
            int32_t p0 = width - 1 - 2 * l;
            int32_t p1 = width - 2 - 2 * l;
            if (p0 >= 0) r[p0] = static_cast<uint8_t>(v & 0xFF);
            if (p1 >= 0) r[p1] = static_cast<uint8_t>((v >> 8) & 0xFF);
        }
    }
}

// ---------------------------------------------------------------------------
// polynomial stream codec (reference util.cpp:118-170 format):
//   i64 degree, then per coefficient u8 nbytes + nbytes LE bytes.
// Works on fixed-width little-endian coefficient rows.
// ---------------------------------------------------------------------------

// Returns encoded byte count; out may be null to query the size.
int64_t kzg_poly_encode(const uint8_t* rows_le, int64_t n, int32_t width,
                        uint8_t* out) {
    int64_t degree = n - 1;
    int64_t pos = 0;
    if (out) memcpy(out, &degree, 8);
    pos = 8;
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* row = rows_le + i * width;
        int32_t nb = width;
        while (nb > 0 && row[nb - 1] == 0) nb--;
        if (out) out[pos] = static_cast<uint8_t>(nb);
        pos += 1;
        if (out && nb) memcpy(out + pos, row, nb);
        pos += nb;
    }
    return pos;
}

// Decodes into fixed-width rows; returns coefficient count or -1 on
// malformed input. rows_le may be null to query the count.
int64_t kzg_poly_decode(const uint8_t* data, int64_t data_len,
                        int32_t width, uint8_t* rows_le) {
    if (data_len < 8) return -1;
    int64_t degree;
    memcpy(&degree, data, 8);
    if (degree < -1) return -1;
    int64_t n = degree + 1;
    int64_t pos = 8;
    for (int64_t i = 0; i < n; i++) {
        if (pos >= data_len) return -1;
        int32_t nb = data[pos++];
        if (nb > width || pos + nb > data_len) return -1;
        if (rows_le) {
            uint8_t* row = rows_le + i * width;
            memset(row, 0, width);
            memcpy(row, data + pos, nb);
        }
        pos += nb;
    }
    return n;
}

// ---------------------------------------------------------------------------
// trusted-setup file scanning (reference trusted_setup.cpp:76-121 format):
// u64 count, then count x (u32 len + octet) G1 records, same for G2.
// Extracts the packed coordinate bytes (without 0x04 tags) for bulk
// conversion; returns 0 on success, negative error codes otherwise.
// ---------------------------------------------------------------------------

int64_t kzg_setup_scan_count(const uint8_t* data, int64_t len) {
    if (len < 8) return -1;
    uint64_t count;
    memcpy(&count, data, 8);
    return static_cast<int64_t>(count);
}

// kind: 1 = G1 block (records of 2*modbytes+1), 2 = G2 (4*modbytes+1).
// coords_out: count * (2 or 4) * modbytes big-endian coordinate bytes.
int kzg_setup_extract(const uint8_t* data, int64_t len, int32_t modbytes,
                      int32_t kind, uint8_t* coords_out) {
    if (len < 8) return -1;
    uint64_t count;
    memcpy(&count, data, 8);
    int64_t pos = 8;
    const int32_t g1len = 2 * modbytes + 1;
    const int32_t g2len = 4 * modbytes + 1;
    // skip or read the G1 block
    for (uint64_t i = 0; i < count; i++) {
        if (pos + 4 > len) return -2;
        uint32_t ln;
        memcpy(&ln, data + pos, 4);
        pos += 4;
        if (ln != static_cast<uint32_t>(g1len) || pos + ln > len) return -3;
        if (data[pos] != 0x04) return -4;
        if (kind == 1) {
            memcpy(coords_out + i * 2 * modbytes, data + pos + 1,
                   2 * modbytes);
        }
        pos += ln;
    }
    if (kind == 1) return 0;
    for (uint64_t i = 0; i < count; i++) {
        if (pos + 4 > len) return -2;
        uint32_t ln;
        memcpy(&ln, data + pos, 4);
        pos += 4;
        if (ln != static_cast<uint32_t>(g2len) || pos + ln > len) return -3;
        if (data[pos] != 0x04) return -4;
        memcpy(coords_out + i * 4 * modbytes, data + pos + 1, 4 * modbytes);
        pos += ln;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// trusted-setup file writing: bulk-assemble records from coordinate bytes
// ---------------------------------------------------------------------------

int64_t kzg_setup_write(const uint8_t* g1_coords, const uint8_t* g2_coords,
                        int64_t count, int32_t modbytes, uint8_t* out) {
    const uint32_t g1len = 2 * modbytes + 1;
    const uint32_t g2len = 4 * modbytes + 1;
    int64_t pos = 0;
    uint64_t c64 = static_cast<uint64_t>(count);
    if (out) memcpy(out, &c64, 8);
    pos = 8;
    for (int64_t i = 0; i < count; i++) {
        if (out) {
            memcpy(out + pos, &g1len, 4);
            out[pos + 4] = 0x04;
            memcpy(out + pos + 5, g1_coords + i * 2 * modbytes, 2 * modbytes);
        }
        pos += 4 + g1len;
    }
    for (int64_t i = 0; i < count; i++) {
        if (out) {
            memcpy(out + pos, &g2len, 4);
            out[pos + 4] = 0x04;
            memcpy(out + pos + 5, g2_coords + i * 4 * modbytes, 4 * modbytes);
        }
        pos += 4 + g2len;
    }
    return pos;
}

}  // extern "C"
