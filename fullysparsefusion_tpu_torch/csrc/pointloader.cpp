// Native data-loading runtime of fullysparsefusion_tpu_torch: the .bin
// reads of the JAX package's csrc/pointloader.cpp, plus the PNG row unfilter.
//
// Two functions of the reference's host path live here, driven through
// ctypes by data/native.py:
//   * zero-copy .bin reads into caller-provided buffers (the sweep
//     transforms stay in NumPy, where the reader matches the JAX reader
//     bitwise);
//   * the PNG row unfilter (filter types 0-4) that data/png.py runs after
//     zlib, since Average and Paeth walk each row byte by byte.
//
// Built with g++ at first use by data/native.py into build/torch_host/.
#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Number of float32 elements in the file, or -1 on error.
long long fsf_file_num_floats(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long long bytes = std::ftell(f);
  std::fclose(f);
  return bytes / 4;
}

// Read up to max_floats float32s; returns count read or -1.
long long fsf_read_floats(const char* path, float* out, long long max_floats) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  long long n = (long long)std::fread(out, 4, (size_t)max_floats, f);
  std::fclose(f);
  return n;
}

// PNG unfilter (PNG spec section 9): ``data`` holds ``h`` rows of one
// filter-type byte followed by ``stride`` filtered bytes; ``out`` receives
// the h x stride reconstructed bytes. ``bpp`` is the bytes per complete
// pixel (at least 1). Returns 0, or -(row + 1) for a row whose filter type
// is not 0-4.
int fsf_png_unfilter(const uint8_t* data, long long h, long long stride, int bpp,
                     uint8_t* out) {
  for (long long y = 0; y < h; ++y) {
    const uint8_t* src = data + y * (stride + 1);
    const uint8_t ft = src[0];
    ++src;
    uint8_t* cur = out + y * stride;
    const uint8_t* prev = y > 0 ? out + (y - 1) * stride : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(cur, src, (size_t)stride);
        break;
      case 1:
        for (long long i = 0; i < stride; ++i)
          cur[i] = (uint8_t)(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (long long i = 0; i < stride; ++i)
          cur[i] = (uint8_t)(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (long long i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          cur[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long long i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
          int p = a + b - c;
          int pa = p > a ? p - a : a - p;
          int pb = p > b ? p - b : b - p;
          int pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        return (int)(-(y + 1));
    }
  }
  return 0;
}

}  // extern "C"
