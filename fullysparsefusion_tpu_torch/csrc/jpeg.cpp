// Baseline JPEG decoder for the offline mask tool (data/jpeg.py), bitwise
// what libjpeg-turbo gives through its jpeg62 API with the library's
// defaults (the decoder behind PIL's Image.open(...).convert("RGB")):
//
//   * sequential Huffman JPEG (SOF0 and SOF1), 8-bit, 1 or 3 components,
//     every DQT and DHT (optimized tables too), restart intervals, APPn and
//     COM skipped;
//   * the accurate integer IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2,
//     libjpeg's range-limit table);
//   * libjpeg-turbo's "fancy" upsampling of jdsample.c: h2v1 (4:2:2) and
//     h2v2 (4:2:0) triangle filters when the subsampled width exceeds 2
//     samples (else plain replication, as the library chooses), h1v2
//     (4:4:0) always; the rows above the first and below the last repeat
//     them, as jdmainct.c's context pointers do;
//   * jdcolor.c's fixed-point YCbCr -> RGB tables (SCALEBITS 16).
//
// A grayscale image is returned as its one plane; data/jpeg.py repeats it
// into RGB. What this decoder does not read raises (status 1 with the
// reason in ``err``): progressive, lossless, hierarchical or arithmetic
// coding, other precisions than 8 bits, 2 or 4 components (CMYK), Adobe
// transform 0 or RGB component ids, samplings other than the four above,
// and scans that do not hold every component (non-interleaved).
//
// Built with g++ at first use by data/native.py into build/torch_host/.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr int kLook = 9;  // Huffman lookahead bits

// zigzag index -> natural index; 16 extra entries catch corrupt runs
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << kLook];  // (length << 8) | value, 0 = longer than kLook
};

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int dw = 0, dh = 0;       // downsampled width and height (samples)
  int bw = 0, bh = 0;       // blocks allocated across and down
  std::vector<uint8_t> plane;  // bh*8 rows of bw*8 samples
  int dc = 0;
};

struct Error {
  int status;  // 1 unsupported, 2 corrupt
};

struct Decoder {
  Decoder(const uint8_t* data, long long size, char* e, int elen)
      : d(data), n(size), err(e), errlen(elen) {}
  const uint8_t* d;
  long long n, pos = 0;
  char* err;
  int errlen;
  int16_t qt[4][64];  // natural order, as libjpeg's ISLOW_MULT_TYPE (short)
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0, restart = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  Comp c[3];
  int hmax = 1, vmax = 1;
  // bit reader
  uint64_t acc = 0;
  int bits = 0;
  bool marker_hit = false;

  [[noreturn]] void fail(int status, const char* msg) {
    std::snprintf(err, (size_t)errlen, "%s", msg);
    throw Error{status};
  }
  [[noreturn]] void unsupported(const char* msg) { fail(1, msg); }
  [[noreturn]] void corrupt(const char* msg) { fail(2, msg); }

  int u8() {
    if (pos >= n) corrupt("truncated JPEG");
    return d[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  // -- markers ---------------------------------------------------------------
  int next_marker() {
    int b = u8();
    if (b != 0xFF) corrupt("expected a marker");
    do b = u8();
    while (b == 0xFF);  // fill bytes
    return b;
  }

  void read_dqt(long long end) {
    while (pos < end) {
      int pq_tq = u8(), pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) corrupt("DQT table id > 3");
      for (int k = 0; k < 64; ++k) {
        int q = pq ? u16() : u8();
        qt[tq][kNatural[k]] = (int16_t)q;
      }
      qt_defined[tq] = true;
    }
  }

  void read_dht(long long end) {
    while (pos < end) {
      int tc_th = u8(), tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) corrupt("bad DHT class or id");
      uint8_t counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += counts[l] = (uint8_t)u8();
      if (total > 256) corrupt("DHT with more than 256 codes");
      Huff& t = tc ? ac[th] : dc[th];
      for (int i = 0; i < total; ++i) t.vals[i] = (uint8_t)u8();
      // canonical codes (jdhuff.c jpeg_make_d_derived_tbl)
      int huffcode[257];
      int p = 0, code = 0;
      for (int l = 1; l <= 16; ++l) {
        for (int i = 0; i < counts[l]; ++i) huffcode[p++] = code++;
        if (code > (1 << l)) corrupt("bad Huffman table");
        code <<= 1;
      }
      std::memset(t.look, 0, sizeof(t.look));
      p = 0;
      for (int l = 1; l <= 16; ++l) {
        if (counts[l]) {
          t.valoffset[l] = p - huffcode[p];
          p += counts[l];
          t.maxcode[l] = huffcode[p - 1];
        } else {
          t.maxcode[l] = -1;
        }
      }
      t.maxcode[17] = 0xFFFFF;
      p = 0;
      for (int l = 1; l <= kLook; ++l) {
        for (int i = 0; i < counts[l]; ++i, ++p) {
          int lookbits = huffcode[p] << (kLook - l);
          for (int k = 0; k < (1 << (kLook - l)); ++k)
            t.look[lookbits + k] = (uint16_t)((l << 8) | t.vals[p]);
        }
      }
      t.defined = true;
    }
  }

  void read_sof(int marker, long long end) {
    if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA || marker == 0xCE)
      unsupported("progressive JPEG (SOF2) is not supported");
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF)
      unsupported("lossless JPEG is not supported");
    if (marker >= 0xC9) unsupported("arithmetic-coded JPEG is not supported");
    if (marker == 0xC5) unsupported("hierarchical JPEG is not supported");
    if (frame) corrupt("two SOF markers");
    frame = true;
    int precision = u8();
    if (precision != 8)
      fail(1, precision == 12 ? "12-bit JPEG is not supported"
                              : "JPEG sample precision other than 8 bits is not supported");
    height = u16();
    width = u16();
    ncomp = u8();
    if (height == 0) unsupported("JPEG height defined by DNL is not supported");
    if (width == 0) corrupt("JPEG width 0");
    if (ncomp == 4) unsupported("CMYK / YCCK JPEG (4 components) is not supported");
    if (ncomp != 1 && ncomp != 3) unsupported("JPEG with other than 1 or 3 components");
    for (int i = 0; i < ncomp; ++i) {
      c[i].id = u8();
      int hv = u8();
      c[i].h = hv >> 4;
      c[i].v = hv & 15;
      c[i].tq = u8();
      if (c[i].h < 1 || c[i].h > 4 || c[i].v < 1 || c[i].v > 4 || c[i].tq > 3)
        corrupt("bad JPEG component parameters");
      if (c[i].h > hmax) hmax = c[i].h;
      if (c[i].v > vmax) vmax = c[i].v;
    }
    if (pos != end) corrupt("bad SOF length");
  }

  void read_app(int marker, long long end) {
    long long len = end - pos;
    if (marker == 0xE0 && len >= 14 && !std::memcmp(d + pos, "JFIF\0", 5)) jfif = true;
    if (marker == 0xEE && len >= 12 && !std::memcmp(d + pos, "Adobe", 5)) {
      adobe = true;
      adobe_transform = d[pos + 11];
    }
  }

  // Reads the headers up to (and including) the first SOS; returns after
  // the SOS segment with the scan's components in scan_comp.
  int scan_comp[3];
  int scan_ncomp = 0;

  void read_headers(bool stop_at_frame) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) corrupt("not a JPEG (no SOI marker)");
    pos = 2;
    while (true) {
      int m = next_marker();
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // no length
      if (m == 0xD9) corrupt("JPEG ends before its first scan");
      long long len = u16();
      if (len < 2 || pos + len - 2 > n) corrupt("truncated JPEG segment");
      long long end = pos + len - 2;
      if (m == 0xDB) {
        read_dqt(end);
      } else if (m == 0xC4) {
        read_dht(end);
      } else if (m == 0xCC) {
        unsupported("arithmetic-coded JPEG (DAC) is not supported");
      } else if (m >= 0xC0 && m <= 0xCF) {
        read_sof(m, end);
        if (stop_at_frame) return;
      } else if (m == 0xDD) {
        restart = u16();
      } else if (m == 0xDA) {
        if (!frame) corrupt("SOS before SOF");
        scan_ncomp = u8();
        for (int i = 0; i < scan_ncomp; ++i) {
          int id = u8(), t = u8(), k = 0;
          while (k < ncomp && c[k].id != id) ++k;
          if (k == ncomp) corrupt("SOS names an unknown component");
          c[k].td = t >> 4;
          c[k].ta = t & 15;
          if (c[k].td > 3 || c[k].ta > 3) corrupt("bad Huffman table id");
          scan_comp[i] = k;
        }
        int ss = u8(), se = u8(), a = u8();
        if (ss != 0 || se != 63 || a != 0) corrupt("bad spectral selection for a sequential scan");
        pos = end;
        return;
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m, end);
      }
      pos = end;  // APPn, COM, DNL, ... skipped
    }
  }

  // -- entropy decoding --------------------------------------------------------
  void fill() {
    while (bits <= 56) {
      int b = 0;
      if (!marker_hit) {
        if (pos >= n) {
          marker_hit = true;
        } else if (d[pos] != 0xFF) {
          b = d[pos++];
        } else {
          long long q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;  // fill bytes before a marker
          if (q < n && d[q] == 0x00) {
            b = 0xFF;
            pos = q + 1;
          } else {
            marker_hit = true;  // leave pos at the marker; zeros from here
          }
        }
      }
      acc |= (uint64_t)b << (56 - bits);
      bits += 8;
    }
  }
  int get_bits(int k) {
    if (k == 0) return 0;
    if (bits < k) fill();
    int v = (int)(acc >> (64 - k));
    acc <<= k;
    bits -= k;
    return v;
  }
  int decode(const Huff& t) {
    if (bits < 16) fill();
    int e = t.look[acc >> (64 - kLook)];
    if (e) {
      int l = e >> 8;
      acc <<= l;
      bits -= l;
      return e & 0xFF;
    }
    for (int l = kLook + 1; l <= 16; ++l) {
      int code = (int)(acc >> (64 - l));
      if (code <= t.maxcode[l]) {
        acc <<= l;
        bits -= l;
        return t.vals[(code + t.valoffset[l]) & 0xFF];
      }
    }
    // libjpeg warns (bad Huffman code), skips the bits and returns 0
    acc <<= 16;
    bits -= 16;
    return 0;
  }
  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  void restart_marker() {
    acc = 0;
    bits = 0;
    marker_hit = false;
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7)) ++pos;
    if (pos + 1 < n) pos += 2;
    for (int i = 0; i < ncomp; ++i) c[i].dc = 0;
  }

  void decode_block(Comp& k, int16_t* blk) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    int s = decode(dc[k.td]);
    if (s) s = extend(get_bits(s), s);
    k.dc += s;
    blk[0] = (int16_t)k.dc;
    const Huff& a = ac[k.ta];
    for (int i = 1; i < 64; ++i) {
      int rs = decode(a), r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        blk[kNatural[i]] = (int16_t)extend(get_bits(s), s);
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
  }

  // -- the accurate integer IDCT (jidctint.c jpeg_idct_islow) -------------------
  uint8_t range[1024];  // IDCT_range_limit(cinfo)[x & RANGE_MASK]
  void init_range() {
    // jdmaster.c prepare_range_limit_table, seen from the IDCT: the centred
    // sample x lands at x & 1023; [-128, 127] -> x + 128, above -> 255 up to
    // 383, below -> 0 down to -512
    for (int i = 0; i < 1024; ++i)
      range[i] = (uint8_t)(i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896);
  }

  void idct(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
    constexpr int CB = 13, P1 = 2;
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;
    int ws[64];
    auto descale = [](int64_t x, int nb) { return (x + ((int64_t)1 << (nb - 1))) >> nb; };
    for (int col = 0; col < 8; ++col) {
      const int16_t* ip = in + col;
      const int16_t* qp = q + col;
      int* wp = ws + col;
      auto dq = [&](int r) { return (int64_t)((int)ip[8 * r] * (int)qp[8 * r]); };
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        int dcval = (int)(dq(0) * (1 << P1));
        for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
        continue;
      }
      int64_t z2 = dq(2), z3 = dq(6);
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
      z2 = dq(0);
      z3 = dq(4);
      int64_t tmp0 = (z2 + z3) * (1 << CB), tmp1 = (z2 - z3) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = dq(7);
      tmp1 = dq(5);
      tmp2 = dq(3);
      tmp3 = dq(1);
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      wp[0] = (int)descale(tmp10 + tmp3, CB - P1);
      wp[56] = (int)descale(tmp10 - tmp3, CB - P1);
      wp[8] = (int)descale(tmp11 + tmp2, CB - P1);
      wp[48] = (int)descale(tmp11 - tmp2, CB - P1);
      wp[16] = (int)descale(tmp12 + tmp1, CB - P1);
      wp[40] = (int)descale(tmp12 - tmp1, CB - P1);
      wp[24] = (int)descale(tmp13 + tmp0, CB - P1);
      wp[32] = (int)descale(tmp13 - tmp0, CB - P1);
    }
    for (int row = 0; row < 8; ++row) {
      const int* wp = ws + 8 * row;
      uint8_t* op = out + (long long)row * stride;
      auto lim = [&](int64_t x, int nb) { return range[(int)descale(x, nb) & 1023]; };
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
        uint8_t v = lim(wp[0], P1 + 3);
        for (int k = 0; k < 8; ++k) op[k] = v;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CB);
      int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      constexpr int NB = CB + P1 + 3;
      op[0] = lim(tmp10 + tmp3, NB);
      op[7] = lim(tmp10 - tmp3, NB);
      op[1] = lim(tmp11 + tmp2, NB);
      op[6] = lim(tmp11 - tmp2, NB);
      op[2] = lim(tmp12 + tmp1, NB);
      op[5] = lim(tmp12 - tmp1, NB);
      op[3] = lim(tmp13 + tmp0, NB);
      op[4] = lim(tmp13 - tmp0, NB);
    }
  }

  void block_out(Comp& k, int by, int bx, int16_t* blk) {
    decode_block(k, blk);
    if (by < k.bh && bx < k.bw) {
      int stride = k.bw * 8;
      idct(blk, qt[k.tq], k.plane.data() + (long long)by * 8 * stride + bx * 8, stride);
    }
  }

  void decode_scan() {
    init_range();
    for (int i = 0; i < ncomp; ++i) {
      Comp& k = c[i];
      if (!qt_defined[k.tq]) corrupt("JPEG quantization table not defined");
      if (!dc[k.td].defined || !ac[k.ta].defined) corrupt("JPEG Huffman table not defined");
    }
    int16_t blk[64];
    long long done = 0;
    if (scan_ncomp == 1) {  // one component: its blocks in raster order
      Comp& k = c[scan_comp[0]];
      int nbx = (k.dw + 7) / 8, nby = (k.dh + 7) / 8;
      for (int by = 0; by < nby; ++by)
        for (int bx = 0; bx < nbx; ++bx) {
          if (restart && done && done % restart == 0) restart_marker();
          block_out(k, by, bx, blk);
          ++done;
        }
      return;
    }
    int mx = (width + 8 * hmax - 1) / (8 * hmax), my = (height + 8 * vmax - 1) / (8 * vmax);
    for (int m_y = 0; m_y < my; ++m_y)
      for (int m_x = 0; m_x < mx; ++m_x) {
        if (restart && done && done % restart == 0) restart_marker();
        for (int s = 0; s < scan_ncomp; ++s) {
          Comp& k = c[scan_comp[s]];
          for (int yy = 0; yy < k.v; ++yy)
            for (int xx = 0; xx < k.h; ++xx) block_out(k, m_y * k.v + yy, m_x * k.h + xx, blk);
        }
        ++done;
      }
  }

  // -- upsampling (jdsample.c) --------------------------------------------------
  // Component k's samples for output row y, upsampled to the full width, in row.
  void upsample_row(const Comp& k, int y, uint8_t* row, int fancy_kind) const {
    int stride = k.bw * 8;
    auto in_row = [&](int i) {
      if (i < 0) i = 0;
      if (i > k.dh - 1) i = k.dh - 1;
      return k.plane.data() + (long long)i * stride;
    };
    int dw = k.dw;
    switch (fancy_kind) {
      case 0: {  // full size
        std::memcpy(row, in_row(y), (size_t)width);
        return;
      }
      case 1: {  // h2v1
        const uint8_t* in = in_row(y);
        if (dw > 2) {
          row[0] = in[0];
          row[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
          for (int i = 1; i < dw - 1; ++i) {
            int v = in[i] * 3;
            row[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
            row[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
          }
          row[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
          row[2 * dw - 1] = in[dw - 1];
        } else {
          for (int i = 0; i < dw; ++i) row[2 * i] = row[2 * i + 1] = in[i];
        }
        return;
      }
      case 2: {  // h1v2
        int i = y >> 1;
        const uint8_t* near = in_row(i);
        const uint8_t* far = in_row(y & 1 ? i + 1 : i - 1);
        int bias = y & 1 ? 2 : 1;
        for (int x = 0; x < dw; ++x) row[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
        return;
      }
      case 3: {  // h2v2
        int i = y >> 1;
        const uint8_t* near = in_row(i);
        if (dw <= 2) {
          for (int x = 0; x < dw; ++x) row[2 * x] = row[2 * x + 1] = near[x];
          return;
        }
        const uint8_t* far = in_row(y & 1 ? i + 1 : i - 1);
        int this_ = near[0] * 3 + far[0], next = near[1] * 3 + far[1], last;
        row[0] = (uint8_t)((this_ * 4 + 8) >> 4);
        row[1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
        last = this_;
        this_ = next;
        for (int x = 1; x < dw - 1; ++x) {
          next = near[x + 1] * 3 + far[x + 1];
          row[2 * x] = (uint8_t)((this_ * 3 + last + 8) >> 4);
          row[2 * x + 1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
          last = this_;
          this_ = next;
        }
        row[2 * dw - 2] = (uint8_t)((this_ * 3 + last + 8) >> 4);
        row[2 * dw - 1] = (uint8_t)((this_ * 4 + 7) >> 4);
        return;
      }
    }
  }

  int kind_of(const Comp& k) {
    if (k.h == hmax && k.v == vmax) return 0;
    if (k.h * 2 == hmax && k.v == vmax) return 1;
    if (k.h == hmax && k.v * 2 == vmax) return 2;
    if (k.h * 2 == hmax && k.v * 2 == vmax) return 3;
    unsupported("JPEG sampling other than 4:4:4, 4:2:2, 4:2:0 and 4:4:0 is not supported");
  }

  void setup_components() {
    int mx = (width + 8 * hmax - 1) / (8 * hmax), my = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Comp& k = c[i];
      k.dw = (int)(((long long)width * k.h + hmax - 1) / hmax);
      k.dh = (int)(((long long)height * k.v + vmax - 1) / vmax);
      k.bw = ncomp == 1 ? (k.dw + 7) / 8 : mx * k.h;
      k.bh = ncomp == 1 ? (k.dh + 7) / 8 : my * k.v;
      k.plane.assign((size_t)k.bw * 8 * (size_t)k.bh * 8, 0);
    }
  }

  void check_supported() {
    if (ncomp == 3) {
      if (!jfif && adobe && adobe_transform == 0)
        unsupported("Adobe transform=0 (RGB-coded) JPEG is not supported");
      if (!jfif && !adobe && c[0].id == 82 && c[1].id == 71 && c[2].id == 66)
        unsupported("RGB-coded JPEG (component ids R, G, B) is not supported");
      if (scan_ncomp != 3) unsupported("JPEG scans that are not interleaved are not supported");
    }
    for (int i = 0; i < ncomp; ++i) kind_of(c[i]);
  }

  void output(uint8_t* out) {
    if (ncomp == 1) {
      int kind = kind_of(c[0]);
      for (int y = 0; y < height; ++y) upsample_row(c[0], y, out + (long long)y * width, kind);
      return;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
    constexpr int SB = 16;
    constexpr int64_t HALF = (int64_t)1 << (SB - 1);
    auto fix = [](double x) { return (int64_t)(x * (double)(1L << SB) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    int kinds[3] = {kind_of(c[0]), kind_of(c[1]), kind_of(c[2])};
    int wpad = width + 16;
    std::vector<uint8_t> rows((size_t)wpad * 3 * 2);
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (int y = 0; y < height; ++y) {
      uint8_t* r[3] = {rows.data(), rows.data() + 2 * wpad, rows.data() + 4 * wpad};
      for (int i = 0; i < 3; ++i) upsample_row(c[i], y, r[i], kinds[i]);
      uint8_t* op = out + (long long)y * width * 3;
      for (int x = 0; x < width; ++x) {
        int yy = r[0][x], cb = r[1][x], cr = r[2][x];
        op[3 * x] = clamp(yy + cr_r[cr]);
        op[3 * x + 1] = clamp(yy + (int)((cb_g[cb] + cr_g[cr]) >> SB));
        op[3 * x + 2] = clamp(yy + cb_b[cb]);
      }
    }
  }
};

int run(Decoder& dec, bool full, int* h, int* w, int* comps, uint8_t* out, long long cap) {
  try {
    dec.read_headers(!full);
    if (!dec.frame) dec.corrupt("no SOF marker");
    *h = dec.height;
    *w = dec.width;
    *comps = dec.ncomp;
    if (!full) {
      for (int i = 0; i < dec.ncomp; ++i) dec.kind_of(dec.c[i]);
      return 0;
    }
    dec.check_supported();
    if ((long long)dec.height * dec.width * dec.ncomp > cap) dec.corrupt("output buffer too small");
    dec.setup_components();
    dec.decode_scan();
    dec.output(out);
    return 0;
  } catch (const Error& e) {
    return e.status;
  }
}

}  // namespace

extern "C" {

// Header only: height, width and components (1 or 3). Returns 0, or 1
// (unsupported) / 2 (corrupt) with the reason in err.
int fsf_jpeg_info(const uint8_t* data, long long n, int* h, int* w, int* comps, char* err,
                  int errlen) {
  Decoder dec(data, n, err, errlen);
  return run(dec, false, h, w, comps, nullptr, 0);
}

// Decode into out[h * w * comps] (comps from fsf_jpeg_info): interleaved
// RGB for 3 components, the plane for 1. Returns as fsf_jpeg_info.
int fsf_jpeg_decode(const uint8_t* data, long long n, uint8_t* out, long long cap, char* err,
                    int errlen) {
  Decoder dec(data, n, err, errlen);
  int h, w, comps;
  return run(dec, true, &h, &w, &comps, out, cap);
}

}  // extern "C"
