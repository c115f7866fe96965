// LZ4 frame decompression for the Arrow IPC reader of data/feather.py.
//
// Arrow's LZ4_FRAME body compression stores each buffer as one or more LZ4
// frames (https://github.com/lz4/lz4/blob/dev/doc/lz4_Frame_format.md):
// a frame header (magic, FLG, BD, optional content size and dictionary id,
// header checksum), blocks that are compressed or stored (the high bit of
// the block size), an optional checksum after each block, an end mark and
// an optional content checksum. Checksums are skipped, not verified. With
// the block-independence flag set, a match may not reach before its own
// block.
//
// Built with g++ at first use by data/native.py into build/torch_host/.
#include <cstdint>
#include <cstring>

namespace {

uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

// One LZ4 block (the sequence format) appended at out[*pos]; matches may
// reach back to out[floor]. Returns 0 or a negative error.
int lz4_block(const uint8_t* src, long long n, uint8_t* out, long long cap, long long* pos,
              long long floor) {
  long long i = 0, o = *pos;
  while (i < n) {
    unsigned token = src[i++];
    long long lit = token >> 4;
    if (lit == 15) {
      unsigned b;
      do {
        if (i >= n) return -2;
        b = src[i++];
        lit += b;
      } while (b == 255);
    }
    if (i + lit > n || o + lit > cap) return -3;
    std::memcpy(out + o, src + i, (size_t)lit);
    i += lit;
    o += lit;
    if (i == n) break;  // the last sequence holds literals only
    if (i + 2 > n) return -4;
    long long off = src[i] | (src[i + 1] << 8);
    i += 2;
    if (off == 0 || o - off < floor) return -5;
    long long len = token & 15;
    if (len == 15) {
      unsigned b;
      do {
        if (i >= n) return -6;
        b = src[i++];
        len += b;
      } while (b == 255);
    }
    len += 4;
    if (o + len > cap) return -3;
    const uint8_t* m = out + o - off;
    for (long long k = 0; k < len; ++k) out[o + k] = m[k];  // may overlap forward
    o += len;
  }
  *pos = o;
  return 0;
}

}  // namespace

extern "C" {

// Decompress the LZ4 frames of src[0:n] into out[0:cap]. Returns the bytes
// written, or a negative error: -1 bad magic or header, -2..-6 a corrupt
// block, -3 output past cap, -7 truncated input, -8 a dictionary id
// (unsupported).
long long fsf_lz4_frame_decompress(const uint8_t* src, long long n, uint8_t* out,
                                   long long cap) {
  long long i = 0, o = 0;
  while (i < n) {
    if (i + 4 > n) return -7;
    if (le32(src + i) != 0x184D2204u) return -1;
    i += 4;
    if (i + 2 > n) return -7;
    unsigned flg = src[i];
    if ((flg >> 6) != 1) return -1;
    bool independent = flg & 0x20, block_sum = flg & 0x10, content_size = flg & 0x08,
         content_sum = flg & 0x04, dict_id = flg & 0x01;
    if (dict_id) return -8;
    i += 2 + (content_size ? 8 : 0) + 1;  // FLG, BD, content size, header checksum
    if (i > n) return -7;
    long long frame_start = o;
    while (true) {
      if (i + 4 > n) return -7;
      uint32_t size = le32(src + i);
      i += 4;
      if (size == 0) break;  // end mark
      long long len = size & 0x7FFFFFFFu;
      if (i + len > n) return -7;
      if (size & 0x80000000u) {  // stored
        if (o + len > cap) return -3;
        std::memcpy(out + o, src + i, (size_t)len);
        o += len;
      } else {
        int err = lz4_block(src + i, len, out, cap, &o, independent ? o : frame_start);
        if (err) return err;
      }
      i += len + (block_sum ? 4 : 0);
    }
    i += content_sum ? 4 : 0;
    if (i > n) return -7;
  }
  return o;
}

}  // extern "C"
