// Flash attention forward for Hopper (sm_90a): non-causal softmax(q·kᵀ·scale)·v
// on (B, S, H, D) tensors, read in place through their strides.
//
// Replaces the TPU kernel comfyui_parallelanything_tpu/ops/pallas/flash_attention.py
// (`flash_attention`, body `_flash_kernel`): same result, f32 running max / sum /
// accumulator, keys past seq_k masked to -inf, head dim zero-padded with the scale
// taken from the original D, output cast to the input dtype.
//
// Bound on an H100 SXM at the FLUX-dev 1024² shape (B=1, S=4608, H=24, D=128):
// 4·B·H·S²·D = 261 GFLOP per call (0.264 ms at 989 TFLOP/s bf16) against 113 MB of
// q/k/v/o (0.034 ms at 3.35 TB/s), so the call is bound by tensor-core operations.
// Every variant keeps the S×S logits out of device memory. Six variants; the
// caller names one and exactly that one is launched (see `kernel_variant` in
// ops/kernels/flash_attention.py for the rule):
//   - `sm90` (flash_attention_sm90.cuh): bf16/f16, head_dim ≤ 128 and a multiple of
//     8, 16-byte aligned data and strides, a positive scale: TMA loads, a
//     warp-specialised producer and two wgmma consumer warpgroups. It serves the
//     FLUX-dev main path and the UNets' head dims 40, 64 and 80.
//   - `wide` (flash_attention_wide.cuh, compiled in flash_attention_wide.cu): the
//     same conditions with head_dim in (128, 512]: the VAE mid-block's 512-wide head
//     and SD1.5's 160-wide heads. Two wgmma warpgroups share 64 query rows and split
//     the output's columns.
//   - `mma` (below): the bf16/f16 calls that TMA cannot take with head_dim ≤ 256
//     (unaligned views, head_dim % 8 != 0, a scale ≤ 0), on mma.sync m16n8k16 with
//     f32 accumulation:
//       - one CTA of 4 warps per (batch·head, 64-query tile); each warp owns 16 rows;
//       - the TPU grid's sequential key-block axis is a loop inside the CTA; each
//         64-key K/V tile is staged in shared memory (rows padded by 8 elements so
//         every fragment load is bank-conflict free);
//       - running max, sum and accumulator live in f32 registers; the logits fragment
//         is re-packed in registers as the A operand of P·V;
//       - the ragged seq_k tail is masked in the loop, the seq_q tail on store, and the
//         head dim is padded to 64/128/256 by zero-filling shared memory.
//   - `d512` (below): the bf16/f16 calls that TMA cannot take with head_dim in
//     (256, 512]. One 64-query tile's f32 output is 128 KB, more than one
//     warpgroup's registers hold, so the CTA has 8 warps and splits it: for
//     S = Q·Kᵀ each warp takes 16 rows × 32 keys of a 64-key block; the scaled,
//     masked logits go to shared memory, where 4 threads per row run the online
//     softmax and write P (16-bit) back; for O += P·V each warp takes 16 rows ×
//     256 output columns (128 f32 accumulators a thread). Q, K and V tiles of
//     64 × 512 live in shared memory together (222 KB with S, P and the row
//     state).
//   - `tf32x3` (flash_attention_tf32x3.cu): float32, head_dim ≤ 256 and a multiple of
//     4, 16-byte aligned data and strides, a positive scale: TMA loads, a converter
//     warpgroup that splits every tile into TF32 high and low parts (V transposed),
//     and a wgmma consumer warpgroup that takes each product as three TF32 products
//     (error-compensated TF32), to the scalar kernel's f32 limits.
//   - `f32` (flash_attention_f32.cu): the float32 calls tf32x3 cannot take
//     (unaligned views, head_dim % 4 != 0 or in (256, 512], a scale ≤ 0), a
//     scalar-FMA kernel with the same tiling in full f32.
// The wide, tf32x3 and f32 variants are translation units of their own, compiled in
// parallel with this one and linked into the same library.
// Grids cover at most 65535 batch·head slices (gridDim.y), so larger batches are
// launched in chunks of whole batch rows.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_params.cuh"
#include "flash_attention_sm90.cuh"

// The f32 variant, compiled in flash_attention_f32.cu.
extern "C" cudaError_t pa_flash_attention_f32(int batch, cudaStream_t stream,
                                              const pa_flash::Params& p);

// The wide variant, compiled in flash_attention_wide.cu.
extern "C" cudaError_t pa_flash_attention_wide(
    const void* q, const void* k, const void* v, void* o, int dtype, int batch, int heads,
    int seq_q, int seq_k, int head_dim, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, float scale_log2,
    cudaStream_t stream);

// The tf32x3 variant, compiled in flash_attention_tf32x3.cu.
extern "C" cudaError_t pa_flash_attention_tf32x3(
    const void* q, const void* k, const void* v, void* o, int batch, int heads, int seq_q,
    int seq_k, int head_dim, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale_log2, cudaStream_t stream);

namespace {

using pa_flash::kLog2e;
using pa_flash::kThreads;
using pa_flash::launch;
using pa_flash::Params;

constexpr int kBlockQ = 64;    // 16 query rows per warp
constexpr int kBlockK = 64;
constexpr int kSmemPad = 8;    // 16-bit elements of padding per shared-memory row

// ---------------------------------------------------------------------------
// bf16 / f16 tensor-core kernel
// ---------------------------------------------------------------------------

// Stage rows [row0, row0 + 64) of one (batch, head) slice into shared memory as a
// 64 × D_PAD tile of 16-bit elements; rows past `n_rows` and columns past `head_dim` are zero.
template <int D_PAD, int NTHREADS = kThreads>
__device__ __forceinline__ void load_tile_16bit(uint16_t* dst, const uint16_t* src,
                                               long long row_stride, int row0,
                                               int n_rows, int head_dim, bool vec_ok) {
  constexpr int LD = D_PAD + kSmemPad;
  constexpr int kChunks = D_PAD / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < 64 * kChunks; idx += NTHREADS) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_rows && c < head_dim) {
      const uint16_t* p = src + (long long)row * row_stride + c;
      if (vec_ok) {
        val = *reinterpret_cast<const uint4*>(p);
      } else {
        uint16_t tmp[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) tmp[e] = (c + e < head_dim) ? p[e] : (uint16_t)0;
        val = make_uint4(tmp[0] | ((uint32_t)tmp[1] << 16), tmp[2] | ((uint32_t)tmp[3] << 16),
                         tmp[4] | ((uint32_t)tmp[5] << 16), tmp[6] | ((uint32_t)tmp[7] << 16));
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// What differs between the bf16 and f16 kernels: the mma's input type, packing two
// floats into one register (the lower column in the low half), and the store.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ __nv_bfloat16 cvt(float x) { return __float2bfloat16(x); }
};

template <>
struct Elem<__half> {
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ __half cvt(float x) { return __float2half_rn(x); }
};

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D_PAD, typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma(Params p) {
  using E = Elem<T>;
  constexpr int LD = D_PAD + kSmemPad;
  constexpr int kNTiles = kBlockK / 8;  // 8-key column tiles of the logits
  constexpr int kDTiles = D_PAD / 8;    // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* k_s = q_s + kBlockQ * LD;
  uint16_t* v_s = k_s + kBlockK * LD;

  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = blockIdx.x * kBlockQ;
  const uint16_t* qb = static_cast<const uint16_t*>(p.q) + b * p.q_sb + h * p.q_sh;
  const uint16_t* kb = static_cast<const uint16_t*>(p.k) + b * p.k_sb + h * p.k_sh;
  const uint16_t* vb = static_cast<const uint16_t*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile_16bit<D_PAD>(q_s, qb, p.q_ss, q0, p.seq_q, p.head_dim, p.vec_ok);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row group
  const int tig = lane & 3;  // thread in group
  const int wrow = warp * 16;

  float acc[kDTiles][4];
#pragma unroll
  for (int dn = 0; dn < kDTiles; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  // Per thread: rows g and g + 8 of the warp's 16. l is this thread's partial sum
  // over its own columns (the quad shares alpha, so partials combine at the end).
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};

  const int n_kblocks = (p.seq_k + kBlockK - 1) / kBlockK;
  for (int j = 0; j < n_kblocks; ++j) {
    __syncthreads();  // the previous tile is no longer read
    load_tile_16bit<D_PAD>(k_s, kb, p.k_ss, j * kBlockK, p.seq_k, p.head_dim, p.vec_ok);
    load_tile_16bit<D_PAD>(v_s, vb, p.v_ss, j * kBlockK, p.seq_k, p.head_dim, p.vec_ok);
    __syncthreads();

    // S = Q · Kᵀ for this warp's 16 rows × 64 keys.
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D_PAD / 16; ++ks) {
      const uint16_t* qr = q_s + (wrow + g) * LD + ks * 16 + tig * 2;
      const uint32_t a[4] = {ld32(qr), ld32(qr + 8 * LD), ld32(qr + 8), ld32(qr + 8 * LD + 8)};
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const uint16_t* kr = k_s + (nt * 8 + g) * LD + ks * 16 + tig * 2;
        const uint32_t bf[2] = {ld32(kr), ld32(kr + 8)};
        E::mma(s[nt], a, bf);
      }
    }

    // Online softmax in the log2 domain; columns past seq_k are -inf.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = j * kBlockK + nt * 8 + tig * 2 + e < p.seq_k;
        s[nt][e] = valid ? s[nt][e] * p.scale_log2 : -INFINITY;
        s[nt][2 + e] = valid ? s[nt][2 + e] * p.scale_log2 : -INFINITY;
        mx[0] = fmaxf(mx[0], s[nt][e]);
        mx[1] = fmaxf(mx[1], s[nt][2 + e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // Every key block holds at least one valid key, so the new max is finite.
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m_r[0]);
      s[nt][1] = exp2f(s[nt][1] - m_r[0]);
      s[nt][2] = exp2f(s[nt][2] - m_r[1]);
      s[nt][3] = exp2f(s[nt][3] - m_r[1]);
      rs[0] += s[nt][0] + s[nt][1];
      rs[1] += s[nt][2] + s[nt][3];
    }
    l_r[0] = l_r[0] * alpha[0] + rs[0];
    l_r[1] = l_r[1] * alpha[1] + rs[1];
#pragma unroll
    for (int dn = 0; dn < kDTiles; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // O += P · V. The two logits tiles of a 16-key step are exactly the A fragment.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a[4] = {E::pack(s[2 * kk][0], s[2 * kk][1]),
                             E::pack(s[2 * kk][2], s[2 * kk][3]),
                             E::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             E::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < kDTiles; ++dn) {
        // B(key, d) = V[key][d]: keys kk·16 + 2·tig (+1, +8, +9), column dn·8 + g.
        const uint16_t* vp = v_s + (kk * 16 + tig * 2) * LD + dn * 8 + g;
        const uint32_t bf[2] = {vp[0] | ((uint32_t)vp[LD] << 16),
                                vp[8 * LD] | ((uint32_t)vp[9 * LD] << 16)};
        E::mma(acc[dn], a, bf);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv[r] = 1.f / l_r[r];
  }
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int row0 = q0 + wrow + g;
  const int row1 = row0 + 8;
#pragma unroll
  for (int dn = 0; dn < kDTiles; ++dn) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = dn * 8 + tig * 2 + e;
      if (d < p.head_dim) {
        if (row0 < p.seq_q) ob[(long long)row0 * p.o_ss + d] = E::cvt(acc[dn][e] * inv[0]);
        if (row1 < p.seq_q) ob[(long long)row1 * p.o_ss + d] = E::cvt(acc[dn][2 + e] * inv[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / f16 tensor-core kernel for head dims in (256, 512]: the `d512` variant
// ---------------------------------------------------------------------------

constexpr int kD512Threads = 256;           // 8 warps
constexpr int kD512 = 512;                  // padded head dim
constexpr int kD512Cols = kD512 / 2;        // output columns per warp
constexpr int kSLd = kBlockK + 4;           // f32 logits row stride in shared memory
constexpr int kPLd = kBlockK + kSmemPad;    // 16-bit P row stride

constexpr size_t d512_smem_bytes() {
  return (size_t)(kBlockQ + 2 * kBlockK) * (kD512 + kSmemPad) * sizeof(uint16_t) +
         (size_t)kBlockQ * kSLd * sizeof(float) + (size_t)kBlockQ * kPLd * sizeof(uint16_t) +
         2 * kBlockQ * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kD512Threads, 1) flash_fwd_d512(Params p) {
  using E = Elem<T>;
  constexpr int LD = kD512 + kSmemPad;
  constexpr int kOutTiles = kD512Cols / 8;  // 8-wide output tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* k_s = q_s + kBlockQ * LD;
  uint16_t* v_s = k_s + kBlockK * LD;
  float* s_s = reinterpret_cast<float*>(v_s + kBlockK * LD);     // logits, log2 domain
  uint16_t* p_s = reinterpret_cast<uint16_t*>(s_s + kBlockQ * kSLd);
  float* alpha_s = reinterpret_cast<float*>(p_s + kBlockQ * kPLd);  // per-row rescale
  float* l_s = alpha_s + kBlockQ;                                   // per-row sum

  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = blockIdx.x * kBlockQ;
  const uint16_t* qb = static_cast<const uint16_t*>(p.q) + b * p.q_sb + h * p.q_sh;
  const uint16_t* kb = static_cast<const uint16_t*>(p.k) + b * p.k_sb + h * p.k_sh;
  const uint16_t* vb = static_cast<const uint16_t*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile_16bit<kD512, kD512Threads>(q_s, qb, p.q_ss, q0, p.seq_q, p.head_dim, p.vec_ok);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wrow = (warp & 3) * 16;          // the warp's 16 query rows (both products)
  const int wkey = (warp >> 2) * 32;         // its 32 keys of the logits block
  const int wcol = (warp >> 2) * kD512Cols;  // its 256 output columns
  // Softmax: row srow is shared by 4 neighbouring threads, 16 columns each; the
  // four hold the same running max and sum.
  const int srow = threadIdx.x >> 2;
  const int scol = (threadIdx.x & 3) * 16;

  float acc[kOutTiles][4];
#pragma unroll
  for (int dn = 0; dn < kOutTiles; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;

  const int n_kblocks = (p.seq_k + kBlockK - 1) / kBlockK;
  for (int j = 0; j < n_kblocks; ++j) {
    __syncthreads();  // the previous K/V tiles and P are no longer read
    load_tile_16bit<kD512, kD512Threads>(k_s, kb, p.k_ss, j * kBlockK, p.seq_k, p.head_dim,
                                         p.vec_ok);
    load_tile_16bit<kD512, kD512Threads>(v_s, vb, p.v_ss, j * kBlockK, p.seq_k, p.head_dim,
                                         p.vec_ok);
    __syncthreads();

    // S = Q · Kᵀ for this warp's 16 rows × 32 keys, over the whole head dim.
    float s[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < kD512 / 16; ++ks) {
      const uint16_t* qr = q_s + (wrow + g) * LD + ks * 16 + tig * 2;
      const uint32_t a[4] = {ld32(qr), ld32(qr + 8 * LD), ld32(qr + 8), ld32(qr + 8 * LD + 8)};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint16_t* kr = k_s + (wkey + nt * 8 + g) * LD + ks * 16 + tig * 2;
        const uint32_t bf[2] = {ld32(kr), ld32(kr + 8)};
        E::mma(s[nt], a, bf);
      }
    }
    // Scaled logits to shared memory; keys past seq_k are -inf.
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wkey + nt * 8 + tig * 2 + e;
        const bool valid = j * kBlockK + col < p.seq_k;
        s_s[(wrow + g) * kSLd + col] = valid ? s[nt][e] * p.scale_log2 : -INFINITY;
        s_s[(wrow + g + 8) * kSLd + col] = valid ? s[nt][2 + e] * p.scale_log2 : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax of row srow over this block; P goes back as 16-bit values.
    float e16[16];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      e16[c] = s_s[srow * kSLd + scol + c];
      mx = fmaxf(mx, e16[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // Every key block holds at least one valid key, so the new max is finite.
    const float m_new = fmaxf(m_run, mx);
    const float alpha = exp2f(m_run - m_new);
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < 16; c += 2) {
      const float e0 = exp2f(e16[c] - m_new);
      const float e1 = exp2f(e16[c + 1] - m_new);
      rs += e0 + e1;
      *reinterpret_cast<uint32_t*>(p_s + srow * kPLd + scol + c) = E::pack(e0, e1);
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_run = l_run * alpha + rs;
    m_run = m_new;
    if ((threadIdx.x & 3) == 0) alpha_s[srow] = alpha;
    __syncthreads();

    // O = alpha · O + P · V for this warp's 16 rows × 256 columns.
    const float a_lo = alpha_s[wrow + g];
    const float a_hi = alpha_s[wrow + g + 8];
#pragma unroll
    for (int dn = 0; dn < kOutTiles; ++dn) {
      acc[dn][0] *= a_lo;
      acc[dn][1] *= a_lo;
      acc[dn][2] *= a_hi;
      acc[dn][3] *= a_hi;
    }
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint16_t* pr = p_s + (wrow + g) * kPLd + kk * 16 + tig * 2;
      const uint32_t a[4] = {ld32(pr), ld32(pr + 8 * kPLd), ld32(pr + 8),
                             ld32(pr + 8 * kPLd + 8)};
#pragma unroll
      for (int dn = 0; dn < kOutTiles; ++dn) {
        const uint16_t* vp = v_s + (kk * 16 + tig * 2) * LD + wcol + dn * 8 + g;
        const uint32_t bf[2] = {vp[0] | ((uint32_t)vp[LD] << 16),
                                vp[8 * LD] | ((uint32_t)vp[9 * LD] << 16)};
        E::mma(acc[dn], a, bf);
      }
    }
  }

  if ((threadIdx.x & 3) == 0) l_s[srow] = l_run;
  __syncthreads();
  const float inv_lo = 1.f / l_s[wrow + g];
  const float inv_hi = 1.f / l_s[wrow + g + 8];
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int row0 = q0 + wrow + g;
  const int row1 = row0 + 8;
#pragma unroll
  for (int dn = 0; dn < kOutTiles; ++dn) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = wcol + dn * 8 + tig * 2 + e;
      if (d < p.head_dim) {
        if (row0 < p.seq_q) ob[(long long)row0 * p.o_ss + d] = E::cvt(acc[dn][e] * inv_lo);
        if (row1 < p.seq_q) ob[(long long)row1 * p.o_ss + d] = E::cvt(acc[dn][2 + e] * inv_hi);
      }
    }
  }
}

template <int D_PAD>
cudaError_t dispatch_mma(int dtype, int batch, cudaStream_t stream, const Params& p) {
  const size_t smem = (size_t)(kBlockQ + 2 * kBlockK) * (D_PAD + kSmemPad) * sizeof(uint16_t);
  const dim3 grid((p.seq_q + kBlockQ - 1) / kBlockQ, batch * p.heads);
  return dtype == 0 ? launch(flash_fwd_mma<D_PAD, __nv_bfloat16>, grid, kThreads, smem, stream, p)
                    : launch(flash_fwd_mma<D_PAD, __half>, grid, kThreads, smem, stream, p);
}

cudaError_t dispatch_d512(int dtype, int batch, cudaStream_t stream, const Params& p) {
  const dim3 grid((p.seq_q + kBlockQ - 1) / kBlockQ, batch * p.heads);
  return dtype == 0
             ? launch(flash_fwd_d512<__nv_bfloat16>, grid, kD512Threads, d512_smem_bytes(),
                      stream, p)
             : launch(flash_fwd_d512<__half>, grid, kD512Threads, d512_smem_bytes(), stream, p);
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32, 2 = float16. variant: 0 = mma (head_dim <= 256),
// 1 = f32, 2 = sm90 (head_dim <= 128), 3 = d512 (bf16/f16, head_dim <= 512), 4 = wide
// (head_dim in (128, 512]), 5 = tf32x3 (float32, head_dim <= 256); sm90 and wide also
// need head_dim % 8 == 0, tf32x3 head_dim % 4 == 0, and all three 16-byte aligned
// pointers, strides that are positive multiples of 16 bytes and a positive scale. A
// variant that cannot take the call is refused, never replaced by another. Strides are in
// elements; the head dim is contiguous. Launches on `stream`, which must belong to the
// current device. Returns the CUDA error of the launch (0 on success).
extern "C" int pa_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      int dtype, int variant, int batch, int heads, int seq_q,
                                      int seq_k, int head_dim, long long q_sb, long long q_ss,
                                      long long q_sh, long long k_sb, long long k_ss,
                                      long long k_sh, long long v_sb, long long v_ss,
                                      long long v_sh, long long o_sb, long long o_ss,
                                      long long o_sh, float scale, int vec_ok, void* stream) {
  if (dtype < 0 || dtype > 2 || head_dim < 1 || head_dim > kD512 || seq_q < 1 || seq_k < 1 ||
      batch < 1 || heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  if ((variant == 1 || variant == 5) != (dtype == 1) || variant < 0 || variant > 5 ||
      (variant == 0 && head_dim > 256))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 2 || variant == 4 || variant == 5) {
    const long long strides[] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                                 v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
    const int align = variant == 5 ? 4 : 8;  // elements in 16 bytes
    bool ok = (variant == 2 ? head_dim <= 128 : variant == 4 ? head_dim > 128 : head_dim <= 256) &&
              head_dim % align == 0 && scale > 0.f;
    for (long long st : strides) ok = ok && st > 0 && st % align == 0;
    const void* ptrs[] = {q, k, v, o};
    for (const void* p : ptrs) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    if (!ok) return (int)cudaErrorInvalidValue;
    if (variant == 5)
      return (int)pa_flash_attention_tf32x3(q, k, v, o, batch, heads, seq_q, seq_k, head_dim,
                                            q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                                            v_sh, o_sb, o_ss, o_sh, scale * kLog2e, s);
    const auto launch_tma = variant == 2 ? pa_sm90::launch : pa_flash_attention_wide;
    return (int)launch_tma(q, k, v, o, dtype, batch, heads, seq_q, seq_k, head_dim, q_sb, q_ss,
                           q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                           scale * kLog2e, s);
  }
  const long long esize = dtype == 1 ? 4 : 2;
  const int max_batch = 65535 / heads;  // gridDim.y limit on batch·head slices
  cudaError_t err = cudaSuccess;
  for (int b0 = 0; b0 < batch && err == cudaSuccess; b0 += max_batch) {
    const int nb = batch - b0 < max_batch ? batch - b0 : max_batch;
    Params p{static_cast<const char*>(q) + b0 * q_sb * esize,
             static_cast<const char*>(k) + b0 * k_sb * esize,
             static_cast<const char*>(v) + b0 * v_sb * esize,
             static_cast<char*>(o) + b0 * o_sb * esize,
             q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
             heads, seq_q, seq_k, head_dim, scale * kLog2e, vec_ok};
    if (variant == 3) err = dispatch_d512(dtype, nb, s, p);
    else if (variant == 1) err = pa_flash_attention_f32(nb, s, p);
    else {
      if (head_dim <= 64) err = dispatch_mma<64>(dtype, nb, s, p);
      else if (head_dim <= 128) err = dispatch_mma<128>(dtype, nb, s, p);
      else err = dispatch_mma<256>(dtype, nb, s, p);
    }
  }
  return (int)err;
}
