// Host side of the TMA loads of the flash-attention kernels, forward and
// backward: 4-D tensor maps over (d, heads, rows, n) of bf16 tensors, and
// the card's SM count for the persistent grids.  The library links no CUDA
// driver library: cuTensorMapEncodeTiled is found through
// cudaGetDriverEntryPoint.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D tensor map over (d, heads, rows, n) of a bf16 tensor whose strides
// (elements) are s_head, s_row, s_n, with boxes of 64 columns x box_rows
// rows of one (head, n), 128-byte swizzled.  Rows past `rows` read as
// zeros.  A dimension of extent 1 is never stepped: its stride is replaced
// by 16 bytes when it is not a positive multiple of 16.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int d, int heads,
                     int rows, int n, long long s_head, long long s_row,
                     long long s_n, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  auto stride = [](long long s, int extent) -> cuuint64_t {
    const long long bytes = 2 * s;
    return extent == 1 && (bytes <= 0 || bytes % 16 != 0)
               ? 16
               : static_cast<cuuint64_t>(bytes);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows > 0 ? rows : 1),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {stride(s_head, heads), stride(s_row, rows),
                                 stride(s_n, n)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int sm_count() {
  int dev = 0, count = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return count;
}

}  // namespace
