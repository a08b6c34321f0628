// The `sm90` variant of K1: flash attention forward for Hopper with TMA, mbarriers,
// warp specialisation and wgmma, for bf16 or f16 with head_dim ≤ 128 (a multiple of 8),
// 16-byte aligned data, strides that are multiples of 8 elements and a positive scale.
//
// Computes what the `mma` kernel in flash_attention.cu computes (non-causal
// softmax(q·kᵀ·scale)·v on BSHD, f32 running max / sum / accumulator, keys past seq_k
// masked, head dim zero-padded with the scale from the original D, output in the
// input dtype). At the FLUX-dev shape the call is bound by tensor-core operations, so
// the design keeps the tensor cores fed:
//   - one CTA of 3 warpgroups per (batch·head, 128-query tile). Warpgroup 0 is the
//     producer: it gives up registers (setmaxnreg.dec) and one thread issues every
//     TMA load, the Q tile once and 128-key K and V tiles through a ring of stages,
//     each stage with a `full` mbarrier per tile (armed with the bytes to expect) and
//     one `empty` mbarrier. Warpgroups 1 and 2 are consumers (setmaxnreg.inc), 64
//     query rows each;
//   - tiles land in shared memory with the 128-byte swizzle, as boxes of 64 head-dim
//     columns (128 bytes) by 128 rows, and are read there by wgmma: S = Q·Kᵀ as
//     m64n128k16 with both operands K-major in shared memory, O += P·V as
//     m64n{D_PAD}k16 with P in registers and V as an MN-major (transposed) operand;
//   - the online softmax runs in registers in the log2 domain; the wgmma accumulator
//     gives each warp 16 rows with 4 threads per row, so row reductions are two quad
//     shuffles, and the S accumulator is already P's register operand layout once
//     packed to 16 bits;
//   - the tensor maps are 4-D over (D, H, S, B) with the tensors' own strides, so the
//     sequence tail and the head-dim padding are zero-filled by TMA (never read from
//     the next batch row), and the output goes back through shared memory (the
//     consumer's own rows of the Q tile) by a TMA store that clips rows ≥ seq_q and
//     columns ≥ head_dim.
// Not yet done: overlap of the softmax with the next Q·Kᵀ inside a warpgroup,
// ping-pong scheduling of the two consumers, a persistent tile scheduler.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_tma.cuh"
#include "hopper.cuh"

namespace pa_sm90 {

using pa_tma::encode_bshd;
using pa_tma::fast_exp2;
using pa_tma::IsBf16;
using pa_tma::kBoxCols;
using pa_tma::pack2;
using pa_tma::row_max;

constexpr int kThreads = 384;      // producer warpgroup + 2 consumer warpgroups
constexpr int kBlockQ = 128;       // 64 query rows per consumer
constexpr int kBlockK = 128;       // keys per K/V tile
constexpr int kRowBytes = 128;
constexpr int kBoxBytes = kBlockK * kRowBytes;  // one 64-column box of 128 rows
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128 · (24 + 2 · 240) ≤ 65536 registers per SM

template <int D_PAD>
struct Config {
  static_assert(D_PAD == 64 || D_PAD == 128, "the sm90 variant takes D_PAD = 64 or 128");
  static constexpr int kBoxes = D_PAD / kBoxCols;   // boxes per tile
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // one Q, K or V tile
  static constexpr int kStages = D_PAD == 64 ? 4 : 3;
  static constexpr int kBarriers = 1 + 3 * kStages;  // q_full, k_full[], v_full[], empty[]
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's 1024-byte atom.
  static constexpr int kSmemBytes =
      1024 + kTileBytes * (1 + 2 * kStages) + 8 * kBarriers;
};

struct Args {
  int heads;
  int seq_k;
  int bh0;           // first batch·head slice of this launch
  float scale_log2;  // scale · log2(e) > 0: the softmax runs on exp2
};

template <int D_PAD, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap o_map, const Args args) {
  using C = Config<D_PAD>;
  constexpr bool kBf16 = IsBf16<T>::value;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  unsigned char* q_s = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* kv_s = q_s + C::kTileBytes;  // stage s: K at 2s, V at 2s + 1 tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_s + 2 * C::kStages * C::kTileBytes);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + C::kStages;
  uint64_t* empty = bars + 1 + 2 * C::kStages;

  const int bh = args.bh0 + blockIdx.y;
  const int b = bh / args.heads;
  const int h = bh % args.heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int n_kblocks = (args.seq_k + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring of K/V stages full ----
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, C::kTileBytes);
#pragma unroll
      for (int c = 0; c < C::kBoxes; ++c)
        hopper::tma_load_4d(q_s + c * kBoxBytes, &q_map, q_full, c * kBoxCols, h, q0, b);
      for (int j = 0; j < n_kblocks; ++j) {
        const int stage = j % C::kStages;
        // Round 0 finds every stage empty; round r waits for the consumers' release
        // of round r - 1.
        hopper::mbar_wait(&empty[stage], ((j / C::kStages) & 1) ^ 1);
        unsigned char* k_dst = kv_s + (2 * stage) * C::kTileBytes;
        unsigned char* v_dst = k_dst + C::kTileBytes;
        hopper::mbar_arrive_expect_tx(&k_full[stage], C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c)
          hopper::tma_load_4d(k_dst + c * kBoxBytes, &k_map, &k_full[stage], c * kBoxCols, h,
                              j * kBlockK, b);
        hopper::mbar_arrive_expect_tx(&v_full[stage], C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c)
          hopper::tma_load_4d(v_dst + c * kBoxBytes, &v_map, &v_full[stage], c * kBoxCols, h,
                              j * kBlockK, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int cg = wg - 1;               // consumer index
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;   // accumulator row within the warp's 8 (and + 8)
    const int t = lane & 3;    // column pair within each 8-column tile
    constexpr int kON = D_PAD / 2;  // f32 output accumulators per thread

    float o[kON];
#pragma unroll
    for (int i = 0; i < kON; ++i) o[i] = 0.f;
    // Per thread: rows g and g + 8 of the warp's 16. l is this thread's partial sum
    // over its own columns (the quad shares the max, so partials combine at the end).
    float m_r[2] = {-INFINITY, -INFINITY};
    float l_r[2] = {0.f, 0.f};

    const uint32_t q_addr = hopper::smem_u32(q_s) + cg * 64 * kRowBytes;
    hopper::mbar_wait(q_full, 0);

    for (int j = 0; j < n_kblocks; ++j) {
      const int stage = j % C::kStages;
      const uint32_t parity = (j / C::kStages) & 1;
      const uint32_t k_addr = hopper::smem_u32(kv_s) + (2 * stage) * C::kTileBytes;
      const uint32_t v_addr = k_addr + C::kTileBytes;

      // S = Q · Kᵀ: 64 rows × 128 keys, K-major operands, 16 head-dim columns a step
      // (32 bytes inside a 128-byte swizzled row; the next box every 4 steps).
      float s[64];
      hopper::mbar_wait(&k_full[stage], parity);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D_PAD / 16; ++ks) {
        const uint32_t off = (ks / 4) * kBoxBytes + (ks % 4) * 32;
        hopper::wgmma_ss_m64n128k16<kBf16>(s, hopper::desc_sw128(q_addr + off, 16, 1024),
                                           hopper::desc_sw128(k_addr + off, 16, 1024), ks > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);

      // Online softmax in the log2 domain; keys past seq_k are -inf (TMA's zero fill
      // would make them logit 0). Only a ragged last block pays for the mask. The
      // scale is positive (the wrapper's rule), so the max is taken on the raw logits
      // and the scale folds into exp2's argument: exp2(s · scale_log2 − m) is one FFMA.
      float mx[2] = {-INFINITY, -INFINITY};
      if (j * kBlockK + kBlockK > args.seq_k)
        row_max<true>(s, mx, args.seq_k - j * kBlockK - 2 * t);
      else
        row_max<false>(s, mx, 0);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // Every key block holds at least one valid key, so the new max is finite.
        const float m_new = fmaxf(m_r[r], mx[r] * args.scale_log2);
        alpha[r] = fast_exp2(m_r[r] - m_new);
        m_r[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        s[4 * i + 0] = fast_exp2(fmaf(s[4 * i + 0], args.scale_log2, -m_r[0]));
        s[4 * i + 1] = fast_exp2(fmaf(s[4 * i + 1], args.scale_log2, -m_r[0]));
        s[4 * i + 2] = fast_exp2(fmaf(s[4 * i + 2], args.scale_log2, -m_r[1]));
        s[4 * i + 3] = fast_exp2(fmaf(s[4 * i + 3], args.scale_log2, -m_r[1]));
        rs[0] += s[4 * i + 0] + s[4 * i + 1];
        rs[1] += s[4 * i + 2] + s[4 * i + 3];
      }
      l_r[0] = l_r[0] * alpha[0] + rs[0];
      l_r[1] = l_r[1] * alpha[1] + rs[1];
#pragma unroll
      for (int i = 0; i < kON / 4; ++i) {
        o[4 * i + 0] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
      // P in the register layout of wgmma's A operand: for the 16 keys of step kk,
      // the accumulators of 8-column tiles 2kk and 2kk + 1.
      uint32_t p[32];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        p[2 * i + 0] = pack2<T>(s[4 * i + 0], s[4 * i + 1]);
        p[2 * i + 1] = pack2<T>(s[4 * i + 2], s[4 * i + 3]);
      }

      // O += P · V: V is the MN-major B operand (head dim contiguous); 16 keys a step
      // are 2048 bytes, the next 8 keys 1024 bytes on (SBO), the next 64 head-dim
      // columns one box on (LBO).
      hopper::mbar_wait(&v_full[stage], parity);
      hopper::fence_regs(o);
      hopper::fence_regs(p);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk + 0], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
        hopper::wgmma_rs_m64k16<kBf16, D_PAD>(
            o, a, hopper::desc_sw128(v_addr + kk * 16 * kRowBytes, kBoxBytes, 1024));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(o);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
      inv[r] = 1.f / l_r[r];
    }
    // Epilogue: this consumer's 64 rows of the Q tile are no longer read, so O goes
    // there in the same swizzled layout (16-byte group c of row r sits at c ^ (r % 8);
    // rows g and g + 8 of every warp share r % 8 == g), then out by TMA store.
    unsigned char* o_s = q_s + cg * 64 * kRowBytes;
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int i = 0; i < D_PAD / 8; ++i) {
      unsigned char* col = o_s + (i / 8) * kBoxBytes + (((i % 8) ^ g) * 16) + t * 4;
      *reinterpret_cast<uint32_t*>(col + r0 * kRowBytes) =
          pack2<T>(o[4 * i + 0] * inv[0], o[4 * i + 1] * inv[0]);
      *reinterpret_cast<uint32_t*>(col + (r0 + 8) * kRowBytes) =
          pack2<T>(o[4 * i + 2] * inv[1], o[4 * i + 3] * inv[1]);
    }
    hopper::fence_proxy_async_shared();
    hopper::named_barrier_sync(1 + cg, 128);
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < C::kBoxes; ++c)
        hopper::tma_store_4d(&o_map, o_s + c * kBoxBytes, c * kBoxCols, h, q0 + cg * 64, b);
      hopper::tma_store_commit_and_wait();
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: launch
// ---------------------------------------------------------------------------

template <int D_PAD, typename T>
cudaError_t launch_t(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                     const CUtensorMap& om, const Args& a, int seq_q, int n_bh,
                     cudaStream_t stream) {
  auto kernel = flash_fwd_sm90<D_PAD, T>;
  const int smem = Config<D_PAD>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, n_bh);
  kernel<<<grid, kThreads, smem, stream>>>(qm, km, vm, om, a);
  return cudaGetLastError();
}

// Launches the sm90 variant over every batch·head slice, in chunks of at most 65535
// (gridDim.y). dtype: 0 = bfloat16, 2 = float16. Strides are in elements.
inline cudaError_t launch(const void* q, const void* k, const void* v, void* o, int dtype,
                          int batch, int heads, int seq_q, int seq_k, int head_dim,
                          long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                          long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                          long long v_sh, long long o_sb, long long o_ss, long long o_sh,
                          float scale_log2, cudaStream_t stream) {
  const CUtensorMapDataType dt =
      dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap qm, km, vm, om;
  if (!encode_bshd(&qm, dt, q, batch, seq_q, heads, head_dim, q_sb, q_ss, q_sh, kBlockQ) ||
      !encode_bshd(&km, dt, k, batch, seq_k, heads, head_dim, k_sb, k_ss, k_sh, kBlockK) ||
      !encode_bshd(&vm, dt, v, batch, seq_k, heads, head_dim, v_sb, v_ss, v_sh, kBlockK) ||
      !encode_bshd(&om, dt, o, batch, seq_q, heads, head_dim, o_sb, o_ss, o_sh, kBlockQ / 2))
    return cudaErrorInvalidValue;
  const int max_batch = 65535 / heads;
  cudaError_t err = cudaSuccess;
  for (int b0 = 0; b0 < batch && err == cudaSuccess; b0 += max_batch) {
    const int nb = batch - b0 < max_batch ? batch - b0 : max_batch;
    const Args a{heads, seq_k, b0 * heads, scale_log2};
    const int n_bh = nb * heads;
    if (head_dim <= 64)
      err = dtype == 0 ? launch_t<64, __nv_bfloat16>(qm, km, vm, om, a, seq_q, n_bh, stream)
                       : launch_t<64, __half>(qm, km, vm, om, a, seq_q, n_bh, stream);
    else
      err = dtype == 0 ? launch_t<128, __nv_bfloat16>(qm, km, vm, om, a, seq_q, n_bh, stream)
                       : launch_t<128, __half>(qm, km, vm, om, a, seq_q, n_bh, stream);
  }
  return err;
}

}  // namespace pa_sm90
