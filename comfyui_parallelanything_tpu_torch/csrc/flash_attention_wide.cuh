// The `wide` variant of K1: flash attention forward for Hopper with TMA, mbarriers
// and wgmma, for bf16 or f16 with head_dim in (128, 512] (a
// multiple of 8), 16-byte aligned data, strides that are multiples of 8 elements and
// a positive scale: the VAE mid-block's one 512-wide head and SD1.5's 160-wide heads.
//
// Computes what the `sm90` variant (flash_attention_sm90.cuh) computes: non-causal
// softmax(q·kᵀ·scale)·v on BSHD, f32 running max / sum / accumulator, keys past seq_k
// masked, the head dim zero-padded with the scale from the original D, output in the
// input dtype. It replaces the `d512` and `mma` kernels of flash_attention.cu on those
// calls (mma.sync with synchronous staging, 5.7 % and about 10 % of their bounds).
//
// Bound: at the FLUX VAE's 1024² shape (1, 16384, 1, 512) by tensor-core operations,
// 4·S²·D = 550 GFLOP (0.556 ms at 989 TFLOP/s) against 67 MB of q/k/v/o. Every one of
// the 256 query tiles reads all of K and V (32 MB, held in the 50 MB L2), so the L2
// traffic (8.6 GB) is the next limit. What the design does about it:
//   - one 64-query tile's f32 output is 64 × 512 × 4 B = 128 KB, more than one
//     warpgroup's registers, so the CTA has two consumer warpgroups on the same 64
//     query rows, each holding half of O's columns (D_PAD / 2 = 128, 192 or 256:
//     at most 128 f32 registers a thread), and no producer warpgroup: with 256
//     threads a CTA ptxas may give a thread up to 255 registers, and at D = 512 it
//     takes 186 with nothing spilled. With a producer warpgroup (384 threads, as
//     `sm90` has) ptxas caps every thread at 168 whatever setmaxnreg later grants,
//     and at D = 512 spills and serialises the wgmma; a producer warp (288
//     threads) gets the same cap. Instead, of the 8 warps the last to
//     release a ring slot refills it: each warp's lane 0 counts its release on the
//     slot's counter in shared memory, and the one that brings it to a multiple of 8
//     issues the TMA loads of the tile that goes there next;
//   - both consumers compute the whole of S = Q·Kᵀ (64 queries × 64 keys, wgmma
//     m64n64k16 with both operands K-major in shared memory) and run the same online
//     softmax on it, so they need no exchange and no lock-step: one's softmax runs
//     under the other's products. That costs 50 % more tensor-core work than
//     splitting S over the head dim and adding the two halves through shared memory,
//     which at D = 512 has no room beside a double-buffered ring (64 KB of Q, 128 KB
//     of ring, 35 KB left) and would make both consumers wait for each other twice
//     a key block;
//   - O_half += P·V_half as wgmma m64n{D_PAD/2}k16 with P in registers (the S
//     accumulator packed to 16 bits is already its A-operand layout) and V as the
//     MN-major operand; D_PAD is a multiple of 128, so each half starts on a
//     64-column (128-byte) box of the swizzled tile;
//   - K and V tiles (64 keys × D_PAD, 32 to 64 KB) share one ring of slots (6, 3 or
//     2 at D_PAD = 256, 384, 512) loaded K0, V0, K1, V1, …: K_j's slot is released
//     as soon as both consumers have S_j, so K_{j+1} loads under softmax_j and P·V_j;
//   - head-dim boxes wholly past head_dim (D = 160 in a 256 tile) are zeroed once
//     and never loaded; a partial box is zero-filled by TMA, as are rows past seq_q
//     or seq_k (the maps are 4-D over (D, H, S, B), so never the next batch row);
//     the output goes back through the Q tile by a TMA store that clips rows ≥ seq_q
//     and columns ≥ head_dim.
// The grid is one CTA per (batch·head, 64-query tile); at the VAE shape that is 256
// CTAs on 132 SMs, 1.94 waves, so the second wave's tail idles 8 SMs. Not yet done:
// a persistent tile scheduler, a cluster that multicasts K and V to two CTAs (half the
// L2 traffic), and S over only the head-dim columns below head_dim.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_tma.cuh"
#include "hopper.cuh"

namespace pa_wide {

using pa_tma::encode_bshd;
using pa_tma::fast_exp2;
using pa_tma::IsBf16;
using pa_tma::kBoxCols;
using pa_tma::pack2;
using pa_tma::row_max;

constexpr int kThreads = 256;  // 2 consumer warpgroups, no producer warpgroup
constexpr int kBlockQ = 64;    // both consumers share the 64 query rows
constexpr int kBlockK = 64;    // keys per K or V tile
constexpr int kRowBytes = 128;
constexpr int kBoxBytes = 64 * kRowBytes;  // one 64-column box of 64 rows
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmemBytes = 232448;

template <int D_PAD>
struct Config {
  static_assert(D_PAD == 256 || D_PAD == 384 || D_PAD == 512,
                "the wide variant takes D_PAD = 256, 384 or 512");
  static constexpr int kBoxes = D_PAD / kBoxCols;        // boxes per tile
  static constexpr int kHalfBoxes = kBoxes / 2;          // boxes per consumer's O half
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // one Q, K or V tile
  static constexpr int kSlots = D_PAD == 256 ? 6 : D_PAD == 384 ? 3 : 2;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's 1024-byte atom;
  // then the barriers q_full and full[kSlots], and a release counter per slot.
  static constexpr int kSmemBytes = 1024 + kTileBytes * (1 + kSlots) + 8 * (1 + kSlots) +
                                    4 * kSlots;
  static_assert(kSmemBytes <= kMaxSmemBytes, "the wide variant's tiles exceed shared memory");
};

struct Args {
  int heads;
  int seq_k;
  int head_dim;
  int bh0;           // first batch·head slice of this launch
  float scale_log2;  // scale · log2(e) > 0: the softmax runs on exp2
};

template <int D_PAD, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wide(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap o_map, const Args args) {
  using C = Config<D_PAD>;
  constexpr bool kBf16 = IsBf16<T>::value;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  unsigned char* q_s = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* ring = q_s + C::kTileBytes;  // slot s at s · kTileBytes
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + C::kSlots * C::kTileBytes);
  uint64_t* full = q_full + 1;
  uint32_t* released = reinterpret_cast<uint32_t*>(full + C::kSlots);

  const int bh = args.bh0 + blockIdx.y;
  const int b = bh / args.heads;
  const int h = bh % args.heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int n_kblocks = (args.seq_k + kBlockK - 1) / kBlockK;
  const int n_tiles = 2 * n_kblocks;  // K0, V0, K1, V1, …
  // Boxes holding a column below head_dim; the rest of each tile stays zero.
  const int n_boxes = (args.head_dim + kBoxCols - 1) / kBoxCols;
  const uint32_t tile_bytes = n_boxes * kBoxBytes;

  // Tile t (K or V of key block t / 2) into ring slot t % kSlots, counted on full[slot].
  auto load_tile = [&](int t) {
    const int slot = t % C::kSlots;
    unsigned char* dst = ring + slot * C::kTileBytes;
    const CUtensorMap* map = (t & 1) ? &v_map : &k_map;
    hopper::mbar_arrive_expect_tx(&full[slot], tile_bytes);
    for (int c = 0; c < n_boxes; ++c)
      hopper::tma_load_4d(dst + c * kBoxBytes, map, &full[slot], c * kBoxCols, h,
                          (t >> 1) * kBlockK, b);
  };

  if (n_boxes < C::kBoxes) {
    const int per_tile = (C::kBoxes - n_boxes) * kBoxBytes / 16;
    for (int i = threadIdx.x; i < (1 + C::kSlots) * per_tile; i += kThreads) {
      unsigned char* tile = q_s + (i / per_tile) * C::kTileBytes + n_boxes * kBoxBytes;
      reinterpret_cast<uint4*>(tile)[i % per_tile] = make_uint4(0u, 0u, 0u, 0u);
    }
    hopper::fence_proxy_async_shared();  // wgmma reads them through the async proxy
  }
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < C::kSlots; ++s) {
      hopper::mbar_init(&full[s], 1);
      released[s] = 0;
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(q_full, tile_bytes);
    for (int c = 0; c < n_boxes; ++c)
      hopper::tma_load_4d(q_s + c * kBoxBytes, &q_map, q_full, c * kBoxCols, h, q0, b);
    for (int t = 0; t < C::kSlots && t < n_tiles; ++t) load_tile(t);
  }
  // After this warp's last read of tile t: the eighth release of its slot refills the
  // slot with tile t + kSlots. The fences order every warp's reads before the count
  // and the count before the loads that overwrite the slot.
  auto release = [&](int t) {
    __syncwarp();
    if (threadIdx.x % 32 == 0) {
      __threadfence_block();
      const uint32_t n = atomicAdd(&released[t % C::kSlots], 1u);
      if (n % kWarps == kWarps - 1 && t + C::kSlots < n_tiles) {
        __threadfence_block();
        load_tile(t + C::kSlots);
      }
    }
  };

  // ---- both warpgroups: the same 64 query rows, half of O's columns each ----
  const int cg = threadIdx.x / 128;  // O columns [cg · D_PAD/2, (cg + 1) · D_PAD/2)
  const int tid = threadIdx.x - 128 * cg;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // accumulator row within the warp's 8 (and + 8)
  const int t = lane & 3;   // column pair within each 8-column tile
  constexpr int kON = D_PAD / 4;  // f32 output accumulators per thread (D_PAD / 2 columns)

  float o[kON];
#pragma unroll
  for (int i = 0; i < kON; ++i) o[i] = 0.f;
  // Per thread: rows g and g + 8 of the warp's 16. l is this thread's partial sum
  // over its own columns (the quad shares the max, so partials combine at the end).
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};

  const uint32_t q_addr = hopper::smem_u32(q_s);
  const uint32_t ring_addr = hopper::smem_u32(ring);
  hopper::mbar_wait(q_full, 0);

  for (int j = 0; j < n_kblocks; ++j) {
    const int k_slot = (2 * j) % C::kSlots;
    const int v_slot = (2 * j + 1) % C::kSlots;
    const uint32_t k_addr = ring_addr + k_slot * C::kTileBytes;
    // This consumer's half of V: D_PAD / 128 boxes on from the tile's start.
    const uint32_t v_addr = ring_addr + v_slot * C::kTileBytes + cg * C::kHalfBoxes * kBoxBytes;

    // S = Q · Kᵀ: 64 rows × 64 keys over all D_PAD columns, 16 a step (32 bytes
    // inside a 128-byte swizzled row; the next box every 4 steps).
    float s[32];
    hopper::mbar_wait(&full[k_slot], ((2 * j) / C::kSlots) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D_PAD / 16; ++ks) {
      const uint32_t off = (ks / 4) * kBoxBytes + (ks % 4) * 32;
      hopper::wgmma_ss_m64n64k16<kBf16>(s, hopper::desc_sw128(q_addr + off, 16, 1024),
                                        hopper::desc_sw128(k_addr + off, 16, 1024), ks > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(s);
    release(2 * j);  // K_j is read: its slot can take the next tile

    // Online softmax in the log2 domain, as in the sm90 variant: keys past seq_k
    // are -inf (TMA's zero fill would make them logit 0), the max is taken on the
    // raw logits and the positive scale folds into exp2's argument.
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
    for (int i = 0; i < 8; ++i) {
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
    uint32_t p[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      p[2 * i + 0] = pack2<T>(s[4 * i + 0], s[4 * i + 1]);
      p[2 * i + 1] = pack2<T>(s[4 * i + 2], s[4 * i + 3]);
    }

    // O_half += P · V_half: V is the MN-major B operand (head dim contiguous); 16
    // keys a step are 2048 bytes, the next 8 keys 1024 bytes on (SBO), the next 64
    // head-dim columns one box on (LBO).
    hopper::mbar_wait(&full[v_slot], ((2 * j + 1) / C::kSlots) & 1);
    hopper::fence_regs(o);
    hopper::fence_regs(p);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk + 0], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      hopper::wgmma_rs_m64k16<kBf16, D_PAD / 2>(
          o, a, hopper::desc_sw128(v_addr + kk * 16 * kRowBytes, kBoxBytes, 1024));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(o);
    release(2 * j + 1);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv[r] = 1.f / l_r[r];
  }
  // Epilogue: once both consumers are past their last Q·Kᵀ, this consumer's O
  // columns go into the same columns of the Q tile, in its swizzled layout (16-byte
  // group c of row r sits at c ^ (r % 8); rows g and g + 8 of every warp share
  // r % 8 == g), then out by TMA store of the boxes that hold a column < head_dim.
  __syncthreads();
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int i = 0; i < kON / 4; ++i) {
    unsigned char* col = q_s + (cg * C::kHalfBoxes + i / 8) * kBoxBytes +
                         (((i % 8) ^ g) * 16) + t * 4;
    *reinterpret_cast<uint32_t*>(col + r0 * kRowBytes) =
        pack2<T>(o[4 * i + 0] * inv[0], o[4 * i + 1] * inv[0]);
    *reinterpret_cast<uint32_t*>(col + (r0 + 8) * kRowBytes) =
        pack2<T>(o[4 * i + 2] * inv[1], o[4 * i + 3] * inv[1]);
  }
  hopper::fence_proxy_async_shared();
  hopper::named_barrier_sync(1 + cg, 128);
  if (tid == 0) {
    for (int c = cg * C::kHalfBoxes; c < (cg + 1) * C::kHalfBoxes && c < n_boxes; ++c)
      hopper::tma_store_4d(&o_map, q_s + c * kBoxBytes, c * kBoxCols, h, q0, b);
    hopper::tma_store_commit_and_wait();
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launch
// ---------------------------------------------------------------------------

template <int D_PAD, typename T>
cudaError_t launch_t(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                     const CUtensorMap& om, const Args& a, int seq_q, int n_bh,
                     cudaStream_t stream) {
  auto kernel = flash_fwd_wide<D_PAD, T>;
  const int smem = Config<D_PAD>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, n_bh);
  kernel<<<grid, kThreads, smem, stream>>>(qm, km, vm, om, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                     const CUtensorMap& om, const Args& a, int seq_q, int n_bh,
                     cudaStream_t stream) {
  if (a.head_dim <= 256) return launch_t<256, T>(qm, km, vm, om, a, seq_q, n_bh, stream);
  if (a.head_dim <= 384) return launch_t<384, T>(qm, km, vm, om, a, seq_q, n_bh, stream);
  return launch_t<512, T>(qm, km, vm, om, a, seq_q, n_bh, stream);
}

// Launches the wide variant over every batch·head slice, in chunks of at most 65535
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
      !encode_bshd(&om, dt, o, batch, seq_q, heads, head_dim, o_sb, o_ss, o_sh, kBlockQ))
    return cudaErrorInvalidValue;
  const int max_batch = 65535 / heads;
  cudaError_t err = cudaSuccess;
  for (int b0 = 0; b0 < batch && err == cudaSuccess; b0 += max_batch) {
    const int nb = batch - b0 < max_batch ? batch - b0 : max_batch;
    const Args a{heads, seq_k, head_dim, b0 * heads, scale_log2};
    err = dtype == 0 ? launch_d<__nv_bfloat16>(qm, km, vm, om, a, seq_q, nb * heads, stream)
                     : launch_d<__half>(qm, km, vm, om, a, seq_q, nb * heads, stream);
  }
  return err;
}

}  // namespace pa_wide
