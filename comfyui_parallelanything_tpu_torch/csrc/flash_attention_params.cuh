// What K1's mma.sync and f32 kernels (flash_attention.cu, flash_attention_f32.cu)
// share: the launch parameters, read in place from BSHD strides, and the launch.
#pragma once

#include <cuda_runtime.h>

namespace pa_flash {

constexpr int kThreads = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int heads, seq_q, seq_k, head_dim;
  float scale_log2;  // scale · log2(e): the softmax runs on exp2
  int vec_ok;        // every row 16-byte aligned and head_dim % 8 == 0
};

template <typename Kernel>
inline cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                          cudaStream_t stream, const Params& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace pa_flash
