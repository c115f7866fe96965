// Host-side facts of each device, shared by every kernel source: attributes
// read once per device, and each kernel's dynamic shared-memory limit set
// once per device (a device past the last slot is asked, or set, on every
// call).
#pragma once

#include <cuda_runtime.h>

namespace fsf {

constexpr int MAX_DEVICES = 64;

template <cudaDeviceAttr ATTR>
inline int device_attr(int dev) {
  static int value[MAX_DEVICES];
  int v = dev < MAX_DEVICES ? value[dev] : 0;
  if (v == 0) {
    cudaDeviceGetAttribute(&v, ATTR, dev);
    if (dev < MAX_DEVICES) value[dev] = v;
  }
  return v;
}

inline int sm_count(int dev) { return device_attr<cudaDevAttrMultiProcessorCount>(dev); }

// the most dynamic shared memory a block may opt in to
inline int optin_smem(int dev) {
  return device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>(dev);
}

// One kernel's dynamic shared-memory limit, raised on a device only past the
// largest set there so far; keep one static instance per kernel.
struct SmemLimit {
  int set[MAX_DEVICES] = {};

  cudaError_t raise(const void* kernel, int dev, int bytes) {
    if (dev < MAX_DEVICES && bytes <= set[dev]) return cudaSuccess;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && dev < MAX_DEVICES) set[dev] = bytes;
    return err;
  }
};

}  // namespace fsf
