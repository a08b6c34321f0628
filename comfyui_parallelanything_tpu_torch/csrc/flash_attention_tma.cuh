// What K1's TMA variants (`sm90`, flash_attention_sm90.cuh, `wide`,
// flash_attention_wide.cuh, and `tf32x3`, flash_attention_tf32x3.cu) share: packing,
// exp2 and the row max of the online softmax on wgmma accumulators, and the BSHD
// tensor maps their TMA loads and stores go through.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pa_tma {

constexpr int kBoxCols = 64;  // head-dim columns per 128-byte swizzled row of a box

template <typename T>
struct IsBf16 {
  static constexpr bool value = false;
};
template <>
struct IsBf16<__nv_bfloat16> {
  static constexpr bool value = true;
};

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Each of the thread's two rows' max of one 64 × (2N) logits accumulator (N per
// thread, unscaled). With kMask, keys at column ≥ `n_valid` (counted from this
// thread's first column, 2t) first become -inf.
template <bool kMask, int N>
__device__ __forceinline__ void row_max(float (&s)[N], float (&mx)[2], int n_valid) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (kMask && i * 8 + e >= n_valid) {
        s[4 * i + e] = -INFINITY;
        s[4 * i + 2 + e] = -INFINITY;
      }
      mx[0] = fmaxf(mx[0], s[4 * i + e]);
      mx[1] = fmaxf(mx[1], s[4 * i + 2 + e]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime so the library needs
// no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over (D, H, S, B) of a BSHD tensor with element strides (sb, ss, sh, 1)
// and `elem_bytes`-byte elements; boxes of `box_cols` head-dim columns (one 128-byte
// row: 64 16-bit or 32 f32 values) × `box_rows` sequence rows of one (b, h), stored
// with the 128-byte swizzle. Reads outside the tensor are zero-filled.
inline bool encode_bshd(CUtensorMap* map, CUtensorMapDataType dt, const void* ptr, int batch,
                        int seq, int heads, int head_dim, long long sb, long long ss,
                        long long sh, int box_rows, int elem_bytes = 2,
                        int box_cols = kBoxCols) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)(sh * elem_bytes), (cuuint64_t)(ss * elem_bytes),
                                 (cuuint64_t)(sb * elem_bytes)};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return enc(map, dt, 4, const_cast<void*>(ptr), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace pa_tma
