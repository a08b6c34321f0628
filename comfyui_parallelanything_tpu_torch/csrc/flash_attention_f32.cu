// The `f32` variant of K1 as a translation unit of its own: it compiles with its own
// nvcc, beside flash_attention.cu, and links into the same library. It serves the
// float32 calls tf32x3 cannot take (unaligned views, head dims not a multiple of 4 or
// above 256, a scale ≤ 0): its one call on a model path is an fp32 VAE's 512-wide
// head. Its dot-product loops unroll by 16: fully unrolled they made this unit the
// build's longest by far (PERF.md); at the FLUX shape, which tf32x3 now serves, full
// unrolls run faster (chip_smoke.py times the kernel forced there and at the VAE's).

#include <math.h>
#include <stdint.h>

#include "flash_attention_params.cuh"

namespace {

using pa_flash::kThreads;
using pa_flash::launch;
using pa_flash::Params;

// ---------------------------------------------------------------------------
// float32 kernel: same tiling idea, scalar FMA in full f32
// ---------------------------------------------------------------------------

constexpr int kF32Block = 32;  // query rows and keys per tile

template <int D_PAD>
__device__ __forceinline__ void load_tile_f32(float* dst, int ld, const float* src,
                                              long long row_stride, int row0, int n_rows,
                                              int head_dim) {
  for (int idx = threadIdx.x; idx < kF32Block * D_PAD; idx += kThreads) {
    const int r = idx / D_PAD;
    const int c = idx % D_PAD;
    const int row = row0 + r;
    dst[r * ld + c] =
        (row < n_rows && c < head_dim) ? src[(long long)row * row_stride + c] : 0.f;
  }
}

template <int D_PAD>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(Params p) {
  constexpr int LDQ = D_PAD + 1;       // odd stride: column walks are conflict free
  constexpr int LDP = kF32Block + 1;
  constexpr int kPerThread = D_PAD / 4;  // output columns owned by one thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + kF32Block * LDQ;
  float* v_s = k_s + kF32Block * LDQ;
  float* p_s = v_s + kF32Block * D_PAD;
  float* row_s = p_s + kF32Block * LDP;  // per-row alpha, then 1/l

  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = blockIdx.x * kF32Block;
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  load_tile_f32<D_PAD>(q_s, LDQ, qb, p.q_ss, q0, p.seq_q, p.head_dim);

  const int t = threadIdx.x;
  const int my_row = t / 4;  // row this thread accumulates
  const int my_col = t % 4;  // first of its interleaved columns
  float acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) acc[i] = 0.f;
  float m_run = -INFINITY;  // threads t < 32 own the softmax state of row t
  float l_run = 0.f;

  const int n_kblocks = (p.seq_k + kF32Block - 1) / kF32Block;
  for (int j = 0; j < n_kblocks; ++j) {
    __syncthreads();
    load_tile_f32<D_PAD>(k_s, LDQ, kb, p.k_ss, j * kF32Block, p.seq_k, p.head_dim);
    load_tile_f32<D_PAD>(v_s, D_PAD, vb, p.v_ss, j * kF32Block, p.seq_k, p.head_dim);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kF32Block / 4; ++i) {
      const int col = my_col + 4 * i;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D_PAD; ++d) dot = fmaf(q_s[my_row * LDQ + d], k_s[col * LDQ + d], dot);
      p_s[my_row * LDP + col] =
          (j * kF32Block + col < p.seq_k) ? dot * p.scale_log2 : -INFINITY;
    }
    __syncthreads();
    if (t < kF32Block) {
      float mx = m_run;
      for (int c = 0; c < kF32Block; ++c) mx = fmaxf(mx, p_s[t * LDP + c]);
      const float alpha = exp2f(m_run - mx);
      float sum = 0.f;
      for (int c = 0; c < kF32Block; ++c) {
        const float e = exp2f(p_s[t * LDP + c] - mx);
        p_s[t * LDP + c] = e;
        sum += e;
      }
      l_run = l_run * alpha + sum;
      m_run = mx;
      row_s[t] = alpha;
    }
    __syncthreads();
    const float alpha = row_s[my_row];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int d = my_col + 4 * i;
      float o = acc[i] * alpha;
#pragma unroll 16
      for (int c = 0; c < kF32Block; ++c) o = fmaf(p_s[my_row * LDP + c], v_s[c * D_PAD + d], o);
      acc[i] = o;
    }
  }
  __syncthreads();
  if (t < kF32Block) row_s[t] = 1.f / l_run;
  __syncthreads();
  const int row = q0 + my_row;
  if (row < p.seq_q) {
    float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + (long long)row * p.o_ss;
    const float inv = row_s[my_row];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int d = my_col + 4 * i;
      if (d < p.head_dim) ob[d] = acc[i] * inv;
    }
  }
}

template <int D_PAD>
cudaError_t dispatch_f32(int batch, cudaStream_t stream, const Params& p) {
  const size_t smem = (size_t)(2 * kF32Block * (D_PAD + 1) + kF32Block * D_PAD +
                               kF32Block * (kF32Block + 1) + kF32Block) * sizeof(float);
  const dim3 grid((p.seq_q + kF32Block - 1) / kF32Block, batch * p.heads);
  return launch(flash_fwd_f32<D_PAD>, grid, kThreads, smem, stream, p);
}

}  // namespace

// Launches the f32 variant on one chunk of at most 65535 batch·head slices; the
// caller has checked the call (see pa_flash_attention_fwd).
extern "C" cudaError_t pa_flash_attention_f32(int batch, cudaStream_t stream, const Params& p) {
  if (p.head_dim <= 64) return dispatch_f32<64>(batch, stream, p);
  if (p.head_dim <= 128) return dispatch_f32<128>(batch, stream, p);
  if (p.head_dim <= 256) return dispatch_f32<256>(batch, stream, p);
  return dispatch_f32<512>(batch, stream, p);
}
