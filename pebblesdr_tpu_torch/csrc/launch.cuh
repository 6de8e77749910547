// Host-side launch helpers shared by K1 (front.cu) and K2 (wfm_tail.cu):
// the 2D tensor maps (the descriptors a Hopper TMA box load reads) of
// row-major planes, encoded by libcuda's cuTensorMapEncodeTiled and
// cached, and the resident block count that sizes a persistent grid.
//
// A map describes a [rows, width] plane of elem-byte lanes (float32, or
// int16 as uint16) in boxes of box_w lanes x box_rows rows; a box that
// lies partly or wholly outside the plane lands as zeros.  The plane's row
// pitch and every box's first lane must be multiples of 16 bytes (the
// callers check); the map is encoded once per (pointer, shape, element
// size, box), since a dispatch that is bound by its host enqueue pays the
// encoding on every call otherwise.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace launch {

constexpr int kMaxDynamicSmem = 232448;  // a Hopper block's shared memory

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (so
// the library needs no -lcuda); found once.
inline cudaError_t encode_tiled(EncodeTiled* fn) {
  static std::mutex mu;
  static EncodeTiled found = nullptr;
  std::lock_guard<std::mutex> lock(mu);
  if (found == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    found = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = found;
  return cudaSuccess;
}

// The map of the [rows, width] plane at x (elem 4: float32, 2: int16) in
// boxes of box_w x box_rows, zeros outside.
inline cudaError_t plane_map(const void* x, int width, int rows, int elem,
                             int box_w, int box_rows, CUtensorMap* map) {
  struct Entry {
    const void* x;
    int width, rows, elem, box_w, box_rows;
    CUtensorMap map;
  };
  static std::mutex mu;
  static Entry cache[32];
  static int used = 0, next = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used; ++i) {
      const Entry& e = cache[i];
      if (e.x == x && e.width == width && e.rows == rows && e.elem == elem
          && e.box_w == box_w && e.box_rows == box_rows) {
        *map = e.map;
        return cudaSuccess;
      }
    }
  }
  EncodeTiled fn;
  cudaError_t err = encode_tiled(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)width * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_w, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  if (fn(map, elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_UINT16,
         2, const_cast<void*>(x), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(mu);
  cache[next] = Entry{x, width, rows, elem, box_w, box_rows, *map};
  next = (next + 1) % 32;
  used = used < 32 ? used + 1 : 32;
  return cudaSuccess;
}

// Blocks of `kernel` (threads each, smem bytes of dynamic shared memory)
// that the device holds at once, at most max_per_sm on each SM; found once
// per kernel, device and smem.
template <typename K>
cudaError_t resident_blocks(K* kernel, int device, int threads, int smem,
                            int max_per_sm, int* blocks) {
  struct Entry { const void* k; int device, smem, blocks; };
  static std::mutex mu;
  static Entry cache[64];
  static int used = 0;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].k == key && cache[i].device == device
        && cache[i].smem == smem) {
      *blocks = cache[i].blocks;
      return cudaSuccess;
    }
  int sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kMaxDynamicSmem)) != cudaSuccess
      || (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       device)) != cudaSuccess
      || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  *blocks = max(sms * min(per_sm, max_per_sm), 1);
  if (used < 64) cache[used++] = Entry{key, device, smem, *blocks};
  return cudaSuccess;
}

}  // namespace launch
