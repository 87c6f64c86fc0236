// Native PIZ scanline-block decoder — C++ port of the repo's own Python
// implementation (gltf_renderer/env/piz.py: bitmap/LUT + canonical
// Huffman with zero-run codes + 2D wavelet, written to the OpenEXR PIZ
// specification). The Python path is correct but bit-serial and costs
// ~minutes on a real 4k environment map; this is the hot loader path the
// reference delegates to tinyexr (C++) — see EnvironmentMap.cpp:148-251.
//
// Exported: piz_decode(raw, raw_len, width, n_lines, chan_u16s, n_chans, out)
//   chan_u16s[i] = u16 components per pixel of channel i in ALPHABETICAL
//   order (1 for half, 2 for float/uint). out receives scanline-interleaved
//   u16 rows (per line, channels alphabetical) — identical layout to the
//   Python piz_uncompress return. Returns 0 on success, negative error.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int HUF_ENCBITS = 16;
constexpr int HUF_ENCSIZE = (1 << HUF_ENCBITS) + 1;
constexpr int HUF_DECBITS = 14;
constexpr int HUF_DECSIZE = 1 << HUF_DECBITS;
constexpr int HUF_DECMASK = HUF_DECSIZE - 1;
constexpr int MOD_MASK = (1 << 16) - 1;
constexpr int A_OFFSET = 1 << 15;

struct BitReader {
  const uint8_t* data;
  int len;
  int pos = 0;
  uint64_t c = 0;
  int lc = 0;

  bool get_bits(int n, uint32_t* out) {
    while (lc < n) {
      if (pos >= len) return false;
      c = (c << 8) | data[pos++];
      lc += 8;
    }
    lc -= n;
    *out = (uint32_t)((c >> lc) & ((1u << n) - 1));
    return true;
  }
};

// lengths -> canonical codes in place: hcode[i] = code << 6 | length.
void build_canonical(std::vector<uint64_t>& hcode) {
  uint64_t n[59] = {0};
  for (int i = 0; i < HUF_ENCSIZE; ++i) n[hcode[i] & 63]++;
  uint64_t c = 0;
  for (int i = 58; i > 0; --i) {
    uint64_t nc = (c + n[i]) >> 1;
    n[i] = c;
    c = nc;
  }
  for (int i = 0; i < HUF_ENCSIZE; ++i) {
    uint64_t l = hcode[i] & 63;
    if (l > 0) hcode[i] = l | (n[l]++ << 6);
  }
}

int unpack_enc_table(BitReader& br, int im, int iM, std::vector<uint64_t>& hcode) {
  hcode.assign(HUF_ENCSIZE, 0);
  for (int i = im; i <= iM; ++i) {
    uint32_t l;
    if (!br.get_bits(6, &l)) return -2;
    if (i < 0 || i >= HUF_ENCSIZE) return -3;
    hcode[i] = l;
    if (l == 63) {  // long zero run
      uint32_t z;
      if (!br.get_bits(8, &z)) return -2;
      int zerun = (int)z + 6;
      for (int k = 0; k < zerun && i < HUF_ENCSIZE; ++k) hcode[i++] = 0;
      --i;
    } else if (l >= 59) {  // short zero run (2..5)
      int zerun = (int)l - 59 + 2;
      for (int k = 0; k < zerun && i < HUF_ENCSIZE; ++k) hcode[i++] = 0;
      --i;
    }
  }
  build_canonical(hcode);
  return 0;
}

struct DecTable {
  std::vector<int32_t> fast_len;   // HUF_DECSIZE
  std::vector<int32_t> fast_lit;
  // long codes: per 14-bit prefix, candidate symbol list (flattened)
  std::vector<int32_t> long_start;  // HUF_DECSIZE+1 prefix offsets
  std::vector<int32_t> long_syms;
};

void build_dec_table(const std::vector<uint64_t>& hcode, int im, int iM, DecTable& dt) {
  dt.fast_len.assign(HUF_DECSIZE, 0);
  dt.fast_lit.assign(HUF_DECSIZE, 0);
  std::vector<int32_t> counts(HUF_DECSIZE + 1, 0);
  for (int c2 = im; c2 <= iM; ++c2) {
    int l = (int)(hcode[c2] & 63);
    if (l > HUF_DECBITS) counts[(int)((hcode[c2] >> 6) >> (l - HUF_DECBITS))]++;
  }
  dt.long_start.assign(HUF_DECSIZE + 1, 0);
  for (int i = 0; i < HUF_DECSIZE; ++i) dt.long_start[i + 1] = dt.long_start[i] + counts[i];
  dt.long_syms.assign(dt.long_start[HUF_DECSIZE], 0);
  std::vector<int32_t> fill(dt.long_start.begin(), dt.long_start.end() - 1);
  for (int c2 = im; c2 <= iM; ++c2) {
    int l = (int)(hcode[c2] & 63);
    uint64_t code = hcode[c2] >> 6;
    if (l == 0) continue;
    if (l > HUF_DECBITS) {
      int pl = (int)(code >> (l - HUF_DECBITS));
      dt.long_syms[fill[pl]++] = c2;
    } else {
      uint64_t base = code << (HUF_DECBITS - l);
      uint64_t count = 1ull << (HUF_DECBITS - l);
      for (uint64_t k = 0; k < count; ++k) {
        dt.fast_len[base + k] = l;
        dt.fast_lit[base + k] = c2;
      }
    }
  }
}

int huf_decode(const uint8_t* data, int data_len, int nbits,
               const std::vector<uint64_t>& hcode, const DecTable& dt, int rlc,
               uint16_t* out, int64_t n_out) {
  int64_t oi = 0;
  uint64_t c = 0;
  int lc = 0;
  int pos = 0;
  int n_bytes = (nbits + 7) / 8;
  if (n_bytes > data_len) return -4;

  auto emit_run = [&](int run) -> bool {
    if (oi == 0 || oi + run > n_out) return false;
    uint16_t prev = out[oi - 1];
    for (int k = 0; k < run; ++k) out[oi++] = prev;
    return true;
  };

  while (pos < n_bytes) {
    c = (c << 8) | data[pos++];
    lc += 8;
    while (lc >= HUF_DECBITS) {
      int idx = (int)((c >> (lc - HUF_DECBITS)) & HUF_DECMASK);
      int l = dt.fast_len[idx];
      if (l > 0) {
        lc -= l;
        int sym = dt.fast_lit[idx];
        if (sym == rlc) {
          if (lc < 8) {
            if (pos >= n_bytes) return -5;
            c = (c << 8) | data[pos++];
            lc += 8;
          }
          int run = (int)((c >> (lc - 8)) & 0xFF);
          lc -= 8;
          if (!emit_run(run)) return -6;
        } else {
          if (oi >= n_out) return -6;
          out[oi++] = (uint16_t)sym;
        }
      } else {
        bool found = false;
        for (int j = dt.long_start[idx]; j < dt.long_start[idx + 1]; ++j) {
          int sym = dt.long_syms[j];
          int code_l = (int)(hcode[sym] & 63);
          uint64_t code_c = hcode[sym] >> 6;
          while (lc < code_l && pos < n_bytes) {
            c = (c << 8) | data[pos++];
            lc += 8;
          }
          if (lc >= code_l &&
              code_c == ((c >> (lc - code_l)) & ((1ull << code_l) - 1))) {
            lc -= code_l;
            if (sym == rlc) {
              if (lc < 8) {
                if (pos >= n_bytes) return -5;
                c = (c << 8) | data[pos++];
                lc += 8;
              }
              int run = (int)((c >> (lc - 8)) & 0xFF);
              lc -= 8;
              if (!emit_run(run)) return -6;
            } else {
              if (oi >= n_out) return -6;
              out[oi++] = (uint16_t)sym;
            }
            found = true;
            break;
          }
        }
        if (!found) return -7;
      }
    }
  }
  // Tail: strip byte padding, keep decoding short codes.
  int i = 8 - nbits % 8;
  if (i == 8) i = 0;
  c >>= i;
  lc -= i;
  while (lc > 0 && oi < n_out) {
    int idx = (int)((c << (HUF_DECBITS - lc)) & HUF_DECMASK);
    int l = dt.fast_len[idx];
    if (l > 0 && l <= lc) {
      lc -= l;
      int sym = dt.fast_lit[idx];
      if (sym == rlc) {
        if (lc < 8) return -5;
        int run = (int)((c >> (lc - 8)) & 0xFF);
        lc -= 8;
        if (!emit_run(run)) return -6;
      } else {
        out[oi++] = (uint16_t)sym;
      }
    } else {
      return -7;
    }
  }
  return oi == n_out ? 0 : -8;
}

inline void wdec14(uint16_t l, uint16_t h, uint16_t* a, uint16_t* b) {
  int16_t ls = (int16_t)l;
  int16_t hs = (int16_t)h;
  int hi = hs;
  int ai = ls + (hi & 1) + (hi >> 1);
  *a = (uint16_t)(ai & MOD_MASK);
  *b = (uint16_t)((ai - hi) & MOD_MASK);
}

inline void wdec16(uint16_t l, uint16_t h, uint16_t* a, uint16_t* b) {
  int m = l;
  int d = h;
  int bb = (m - (d >> 1)) & MOD_MASK;
  int aa = (d + bb - A_OFFSET) & MOD_MASK;
  *a = (uint16_t)aa;
  *b = (uint16_t)bb;
}

void wav2_decode(uint16_t* a, int nx, int ox, int ny, int oy, int mx) {
  bool w14 = mx < (1 << 14);
  int n = nx > ny ? ny : nx;
  int p = 1;
  while (p <= n) p <<= 1;
  p >>= 1;
  int p2 = p;
  p >>= 1;
  auto dec = w14 ? wdec14 : wdec16;
  while (p >= 1) {
    int row_step = p * oy;
    int col_step = p * ox;
    for (int y = 0; y <= ny - p2; y += p2) {
      int base_y = y * oy;
      for (int x = 0; x <= nx - p2; x += p2) {
        int i00 = base_y + x * ox;
        int i01 = i00 + col_step;
        int i10 = i00 + row_step;
        int i11 = i10 + col_step;
        uint16_t v00, v10, v01, v11;
        dec(a[i00], a[i10], &v00, &v10);
        dec(a[i01], a[i11], &v01, &v11);
        dec(v00, v01, &a[i00], &a[i01]);
        dec(v10, v11, &a[i10], &a[i11]);
      }
      if (nx & p) {
        int i00 = base_y + (nx - p) * ox;
        int i10 = i00 + row_step;
        dec(a[i00], a[i10], &a[i00], &a[i10]);
      }
    }
    if (ny & p) {
      int base_y = (ny - p) * oy;
      for (int x = 0; x <= nx - p2; x += p2) {
        int i00 = base_y + x * ox;
        int i01 = i00 + col_step;
        dec(a[i00], a[i01], &a[i00], &a[i01]);
      }
    }
    p2 = p;
    p >>= 1;
  }
}

}  // namespace

extern "C" int piz_decode(const uint8_t* raw, int64_t raw_len, int width,
                          int n_lines, const int32_t* chan_u16s, int n_chans,
                          uint16_t* out) {
  if (raw_len < 8) return -1;
  int64_t pos = 0;
  uint16_t min_nz, max_nz;
  std::memcpy(&min_nz, raw + pos, 2);
  std::memcpy(&max_nz, raw + pos + 2, 2);
  pos += 4;
  std::vector<uint8_t> bitmap(8192, 0);
  if (min_nz <= max_nz) {
    // Corrupt/malicious headers: the bitmap span must lie inside the
    // 8192-byte table or the memcpy writes out of bounds.
    if (max_nz >= 8192) return -10;
    int n = max_nz - min_nz + 1;
    if (pos + n > raw_len) return -1;
    std::memcpy(bitmap.data() + min_nz, raw + pos, n);
    pos += n;
  }
  // reverse LUT (value 0 always present)
  std::vector<uint16_t> lut(1 << 16, 0);
  int k = 0;
  for (int i = 0; i < (1 << 16); ++i) {
    if (i == 0 || (bitmap[i >> 3] & (1 << (i & 7)))) lut[k++] = (uint16_t)i;
  }
  int max_value = k - 1;

  if (pos + 4 > raw_len) return -1;
  int32_t length;
  std::memcpy(&length, raw + pos, 4);
  pos += 4;
  if (length < 20 || pos + length > raw_len) return -1;

  const uint8_t* huf = raw + pos;
  int32_t im, iM, nbits;
  std::memcpy(&im, huf, 4);
  std::memcpy(&iM, huf + 4, 4);
  std::memcpy(&nbits, huf + 12, 4);
  if (im < 0 || iM < im || iM >= HUF_ENCSIZE) return -1;

  int64_t total = 0;
  for (int ci = 0; ci < n_chans; ++ci) total += (int64_t)width * n_lines * chan_u16s[ci];

  BitReader br{huf + 20, (int)(length - 20)};
  std::vector<uint64_t> hcode;
  int rc = unpack_enc_table(br, im, iM, hcode);
  if (rc != 0) return rc;
  DecTable dt;
  build_dec_table(hcode, im, iM, dt);
  std::vector<uint16_t> data(total);
  rc = huf_decode(huf + 20 + br.pos, (int)(length - 20 - br.pos), nbits, hcode,
                  dt, iM, data.data(), total);
  if (rc != 0) return rc;

  // Per-channel: wavelet decode each 16-bit slice, apply LUT.
  int64_t offset = 0;
  std::vector<int64_t> chan_off(n_chans);
  for (int ci = 0; ci < n_chans; ++ci) {
    chan_off[ci] = offset;
    int n16 = chan_u16s[ci];
    uint16_t* plane = data.data() + offset;
    for (int j = 0; j < n16; ++j)
      wav2_decode(plane + j, width, n16, n_lines, width * n16, max_value);
    int64_t count = (int64_t)width * n_lines * n16;
    for (int64_t t = 0; t < count; ++t) plane[t] = lut[plane[t]];
    offset += count;
  }

  // Interleave to scanline layout.
  uint16_t* op = out;
  for (int y = 0; y < n_lines; ++y) {
    for (int ci = 0; ci < n_chans; ++ci) {
      int w16 = width * chan_u16s[ci];
      const uint16_t* row = data.data() + chan_off[ci] + (int64_t)y * w16;
      std::memcpy(op, row, (size_t)w16 * 2);
      op += w16;
    }
  }
  return 0;
}
