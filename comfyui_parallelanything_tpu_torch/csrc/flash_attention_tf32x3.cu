// The `tf32x3` variant of K1: flash attention forward for Hopper on float32 data,
// on the tensor cores with error-compensated TF32, for head_dim ≤ 256 (a multiple of
// 4), 16-byte aligned data, strides that are multiples of 4 elements and a positive
// scale. Compiled as a translation unit of its own and linked into the library whose
// entry point, pa_flash_attention_fwd (flash_attention.cu), dispatches to it.
//
// Computes what the scalar `f32` kernel (flash_attention_f32.cu) computes, to the
// same f32 limits: non-causal softmax(q·kᵀ·scale)·v on BSHD, f32 running max / sum /
// accumulator, keys past seq_k masked, the head dim zero-padded with the scale from
// the original D, output in f32. Each f32 operand x is split into hi, its raw word,
// which the tensor cores read as x truncated to TF32, and lo = x − trunc(x), exact
// in f32 and truncated to TF32 in turn; a·b is taken as a_lo·b_hi + a_hi·b_lo +
// a_hi·b_hi (the small products first), dropping a_lo·b_lo (about 2^-21 relative),
// for both S = Q·Kᵀ and O += P·V, in f32 wgmma accumulators: S's from zero each key
// block, and each block's P·V from zero, added to O in registers (see the P·V step).
//
// Bound: at the FLUX-dev shape (1, 4608, 24, 128) in f32 by tensor-core operations,
// 3 passes × 4·S²·H·D = 3 × 261 GFLOP at 495 TFLOP/s dense TF32 = 1.581 ms, against
// 227 MB of q/k/v/o (0.068 ms). What the design does about it:
//   - TF32 wgmma has no transpose: both shared-memory operands are K-major. S = Q·Kᵀ
//     takes Q and K as TMA lands them (head dim contiguous, the reduction dim). For
//     P·V the B operand must be Vᵀ (keys contiguous), so every V tile is transposed
//     in shared memory. P is the register A operand, so P·V needs only B from shared
//     memory, and the transposition also permutes the keys of each group of 8: the
//     S accumulator holds keys 2t and 2t + 1 of a group where the TF32 A fragment
//     wants t and t + 4, so Vᵀ stores keys 0, 2, 4, 6, 1, 3, 5, 7 and the
//     accumulator passes to P·V as it is (no shuffles).
//   - One CTA of 2 warpgroups per (batch·head, 64-query tile). Warpgroup 0 converts:
//     it writes Q's low parts beside Q (the raw tile is its hi) once, then each K
//     tile's the same way (1 shared-memory byte read and 1 written per tile byte),
//     and loads each V tile into registers (4 × 4 blocks, read and written
//     conflict-free through the 128-byte swizzle), waits on a named barrier and
//     writes Vᵀ hi in place and Vᵀ lo beside it (1 read, 2 written), under the
//     consumer's products. Warpgroup 1 runs the products and the online softmax on
//     64 query rows. With 256 threads a CTA ptxas may give every thread up to 255
//     registers (a 384-thread CTA caps them at 168): the consumer holds O, a fresh
//     P·V accumulator and P's two halves, 168 to 240 registers with nothing
//     spilled, but 255 and a few hundred bytes spilled at D_PAD = 256 (head dims in
//     (160, 256], which no model uses).
//   - The raw word serves as hi because the tensor cores truncate a raw f32 word
//     read as TF32: chip_smoke.py's probe checks that on the card and fails the run
//     otherwise, and a rounding card would also fail the float32 kernel cases (hi +
//     lo would then miss x by up to 2^-11 relative). Rounding both parts explicitly
//     (cvt.rna) would not depend on the hardware but costs an in-place write of
//     every Q and K tile, half again the converter's traffic for K.
//   - Shared memory (227 KB a block): Q hi + lo is 64 × D_PAD × 8 bytes (64 KB at
//     D_PAD = 128, 128 KB at 256) and every K or V tile needs a hi and a lo copy.
//     K and V tiles go through one ring of (hi, lo) slots in the order K0, V0, K1,
//     V1, …; TMA loads a raw tile into a slot's hi half and the converter writes
//     the lo half (for V both halves, transposed). Per D_PAD (key tile, slots,
//     bytes): 64 (64 keys, 6, 230,536), 96 (64, 3, 197,708), 128 (64, 2, 197,688),
//     160 (32, 3, 205,900), 256 (32, 1, 197,668). At D_PAD = 128 K_{j+1} loads and
//     converts under softmax_j and P·V_j, V_{j+1} under S_{j+1}; at 256 one slot
//     serialises them.
//   - The consumer's last warp to release a slot issues the TMA loads that refill it
//     (a counter in shared memory, as in flash_attention_wide.cuh), so the converter
//     never waits on the consumer.
//   - exp2 is ex2.approx.ftz (fast_exp2): its error and exp2f's are measured by
//     chip_smoke.py's probe against the 1e-5 rtol of KERNEL_LIMITS["float32"].
// Not yet done: a second consumer warpgroup (ping-pong) to hide the softmax, Q hi in
// registers (less shared-memory traffic for S), a persistent tile scheduler.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_tma.cuh"
#include "hopper.cuh"

namespace pa_tf32x3 {

using pa_tma::encode_bshd;
using pa_tma::fast_exp2;
using pa_tma::row_max;

constexpr int kThreads = 256;  // converter warpgroup + consumer warpgroup
constexpr int kBlockQ = 64;    // query rows of a CTA: the consumer warpgroup's 64
constexpr int kBoxCols = 32;   // f32 head-dim columns (or keys) per 128-byte row
constexpr int kRowBytes = 128;
constexpr int kMaxSmemBytes = 232448;
constexpr int kBarrierBytes = 16;  // q_full, q_ready; then 20 bytes per slot

template <int D_PAD>
struct Config {
  static_assert(D_PAD == 64 || D_PAD == 96 || D_PAD == 128 || D_PAD == 160 || D_PAD == 256,
                "the tf32x3 variant takes D_PAD = 64, 96, 128, 160 or 256");
  static constexpr int kBlockK = D_PAD <= 128 ? 64 : 32;   // keys per K or V tile
  static constexpr int kBoxes = D_PAD / kBoxCols;          // head-dim boxes of Q, K, V
  static constexpr int kKeyBoxes = kBlockK / kBoxCols;     // key boxes of a Vᵀ tile
  static constexpr int kQBytes = kBlockQ * D_PAD * 4;      // Q hi or Q lo
  static constexpr int kTileBytes = kBlockK * D_PAD * 4;   // one K or V tile, hi or lo
  // (hi, lo) slots that fit beside Q after 1024 bytes of slack for the swizzle's
  // 1024-byte atom and the barriers; at most 8.
  static constexpr int kFit =
      (kMaxSmemBytes - 1024 - kBarrierBytes - 2 * kQBytes) / (2 * kTileBytes + 20);
  static constexpr int kSlots = kFit < 8 ? kFit : 8;
  static constexpr int kSmemBytes =
      1024 + 2 * kQBytes + 2 * kSlots * kTileBytes + kBarrierBytes + 20 * kSlots;
  static_assert(kSlots >= 1 && kSmemBytes <= kMaxSmemBytes, "the tiles exceed shared memory");
  // A V tile is transposed in 4 × 4 blocks, 64 per 32 keys × 32 columns.
  static constexpr int kVTasks = kKeyBoxes * kBoxes * 64;
  static constexpr int kVIters = (kVTasks + 127) / 128;
};

struct Args {
  int heads;
  int seq_k;
  int bh0;           // first batch·head slice of this launch
  float scale_log2;  // scale · log2(e) > 0: the softmax runs on exp2
};

// The low part of x: x less the TF32 value the tensor cores read from x's raw word
// (its top 19 bits: they truncate the rest, which chip_smoke.py's probe checks).
// Exact in f32; the tensor cores truncate it to TF32 in turn.
__device__ __forceinline__ float tf32_lo(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

__device__ __forceinline__ float4 tf32_lo4(const float4& x) {
  return make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
}

// Writes the low parts of a tile of kBytes to `lo`, at the same offsets (the split
// is elementwise, so the swizzled layout carries over); the raw tile is its hi.
template <int kBytes>
__device__ __forceinline__ void write_lo(const unsigned char* hi, unsigned char* lo, int tid) {
  const float4* h4 = reinterpret_cast<const float4*>(hi);
  float4* l4 = reinterpret_cast<float4*>(lo);
#pragma unroll 4
  for (int i = tid; i < kBytes / 16; i += 128) l4[i] = tf32_lo4(h4[i]);
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// Transposes the raw V tile in `hi` (kBlockK keys × D_PAD columns, boxes of 32
// columns, rows swizzled) into Vᵀ (D_PAD rows × kBlockK keys, boxes of 32 keys,
// rows swizzled), raw in place and its low parts in `lo`; within each group of 8
// keys, key κ goes to position κ / 2 + 4 (κ % 2). A task is a 4 × 4 block: 4 keys
// of one parity (8g + p + 2i) × 4 columns (4e + u). The 8 lanes of a quarter warp
// take the 8 (g, p) pairs of 32 keys and 8 distinct column groups e, so both the
// reads and the writes land in 8 distinct 16-byte bank groups.
template <int D_PAD>
__device__ __forceinline__ void transpose_v(unsigned char* hi, unsigned char* lo, int tid) {
  using C = Config<D_PAD>;
  float4 r[C::kVIters][4];
#pragma unroll
  for (int it = 0; it < C::kVIters; ++it) {
    const int task = tid + 128 * it;
    if (task < C::kVTasks) {
      const int tau = task & 7;
      const int shift = (task >> 3) & 7;
      const int kbox = (task >> 6) % C::kKeyBoxes;
      const int dbox = (task >> 6) / C::kKeyBoxes;
      const int e = tau ^ (tau & 1) ^ shift;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kBoxCols * kbox + 8 * (tau >> 1) + (tau & 1) + 2 * i;
        r[it][i] = *reinterpret_cast<const float4*>(
            hi + dbox * (C::kBlockK * kRowBytes) + key * kRowBytes + ((e ^ (key & 7)) << 4));
      }
    }
  }
  hopper::named_barrier_sync(1, 128);  // every read of the tile before any write
#pragma unroll
  for (int it = 0; it < C::kVIters; ++it) {
    const int task = tid + 128 * it;
    if (task < C::kVTasks) {
      const int tau = task & 7;
      const int shift = (task >> 3) & 7;
      const int kbox = (task >> 6) % C::kKeyBoxes;
      const int dbox = (task >> 6) / C::kKeyBoxes;
      const int e = tau ^ (tau & 1) ^ shift;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = kBoxCols * dbox + 4 * e + u;
        const int off = kbox * (D_PAD * kRowBytes) + n * kRowBytes + ((tau ^ (n & 7)) << 4);
        const float4 x = make_float4(lane_of(r[it][0], u), lane_of(r[it][1], u),
                                     lane_of(r[it][2], u), lane_of(r[it][3], u));
        *reinterpret_cast<float4*>(hi + off) = x;
        *reinterpret_cast<float4*>(lo + off) = tf32_lo4(x);
      }
    }
  }
}

template <int D_PAD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tf32x3(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap o_map, const Args args) {
  using C = Config<D_PAD>;
  constexpr int kBlockK = C::kBlockK;
  constexpr int kSlots = C::kSlots;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  unsigned char* q_hi = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* q_lo = q_hi + C::kQBytes;
  unsigned char* ring = q_lo + C::kQBytes;  // slot s: hi at tile 2s, lo at tile 2s + 1
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + 2 * kSlots * C::kTileBytes);
  uint64_t* q_ready = q_full + 1;
  uint64_t* full = q_full + 2;      // TMA has landed a raw tile in the slot
  uint64_t* ready = full + kSlots;  // the converter has written the slot's hi and lo
  uint32_t* released = reinterpret_cast<uint32_t*>(ready + kSlots);

  const int bh = args.bh0 + blockIdx.y;
  const int b = bh / args.heads;
  const int h = bh % args.heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int n_kblocks = (args.seq_k + kBlockK - 1) / kBlockK;
  const int n_tiles = 2 * n_kblocks;  // K0, V0, K1, V1, …

  auto hi_tile = [&](int slot) { return ring + 2 * slot * C::kTileBytes; };
  auto lo_tile = [&](int slot) { return ring + (2 * slot + 1) * C::kTileBytes; };
  // Raw tile t (K or V of key block t / 2) into the hi half of slot t % kSlots.
  auto load_tile = [&](int t) {
    const int slot = t % kSlots;
    const CUtensorMap* map = (t & 1) ? &v_map : &k_map;
    hopper::mbar_arrive_expect_tx(&full[slot], C::kTileBytes);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c)
      hopper::tma_load_4d(hi_tile(slot) + c * kBlockK * kRowBytes, map, &full[slot],
                          c * kBoxCols, h, (t >> 1) * kBlockK, b);
  };

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_ready, 128);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&ready[s], 128);
      released[s] = 0;
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(q_full, C::kQBytes);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c)
      hopper::tma_load_4d(q_hi + c * kBlockQ * kRowBytes, &q_map, q_full, c * kBoxCols, h, q0, b);
    for (int t = 0; t < kSlots && t < n_tiles; ++t) load_tile(t);
  }

  if (threadIdx.x < 128) {
    // ---- converter: Q once, then every K and V tile as it lands ----
    const int tid = threadIdx.x;
    hopper::mbar_wait(q_full, 0);
    write_lo<C::kQBytes>(q_hi, q_lo, tid);
    hopper::fence_proxy_async_shared();  // wgmma reads the halves through the async proxy
    hopper::mbar_arrive(q_ready);
    for (int t = 0; t < n_tiles; ++t) {
      const int slot = t % kSlots;
      hopper::mbar_wait(&full[slot], (t / kSlots) & 1);
      if (t & 1)
        transpose_v<D_PAD>(hi_tile(slot), lo_tile(slot), tid);
      else
        write_lo<C::kTileBytes>(hi_tile(slot), lo_tile(slot), tid);
      hopper::fence_proxy_async_shared();
      hopper::mbar_arrive(&ready[slot]);
    }
    return;
  }

  // ---- consumer: 64 query rows ----
  const int tid = threadIdx.x - 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // accumulator row within the warp's 8 (and + 8)
  const int t = lane & 3;   // column pair within each 8-column tile
  constexpr int kON = D_PAD / 2;   // f32 output accumulators per thread
  constexpr int kSN = kBlockK / 2;  // S accumulators per thread
  // Output columns per P·V accumulator: all of them, or at D_PAD = 256 (128 f32
  // registers of O) four groups of 64, one after another.
  constexpr int kGroup = D_PAD <= 160 ? D_PAD : 64;

  // After this warp's last read of tile u: the fourth release of its slot refills the
  // slot with tile u + kSlots. The fences order every warp's reads before the count
  // and the count before the loads that overwrite the slot.
  auto release = [&](int u) {
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      const uint32_t n = atomicAdd(&released[u % kSlots], 1u);
      if (n % 4 == 3 && u + kSlots < n_tiles) {
        __threadfence_block();
        load_tile(u + kSlots);
      }
    }
  };

  float o[kON];
#pragma unroll
  for (int i = 0; i < kON; ++i) o[i] = 0.f;
  // Per thread: rows g and g + 8 of the warp's 16. l is this thread's partial sum
  // over its own columns (the quad shares the max, so partials combine at the end).
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  const uint32_t qh = hopper::smem_u32(q_hi);
  const uint32_t ql = hopper::smem_u32(q_lo);
  hopper::mbar_wait(q_ready, 0);

  for (int j = 0; j < n_kblocks; ++j) {
    const int k_slot = (2 * j) % kSlots;
    const int v_slot = (2 * j + 1) % kSlots;

    // S = Q_lo·K_hiᵀ + Q_hi·K_loᵀ + Q_hi·K_hiᵀ: 64 rows × kBlockK keys, K-major
    // operands, 8 head-dim columns (32 bytes) a step, the next box every 4 steps.
    float s[kSN];
    hopper::mbar_wait(&ready[k_slot], ((2 * j) / kSlots) & 1);
    const uint32_t kh = hopper::smem_u32(hi_tile(k_slot));
    const uint32_t kl = hopper::smem_u32(lo_tile(k_slot));
    hopper::wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
      const uint32_t qa = pass == 0 ? ql : qh;
      const uint32_t kb = pass == 1 ? kl : kh;
#pragma unroll
      for (int ks = 0; ks < D_PAD / 8; ++ks) {
        const uint64_t da =
            hopper::desc_sw128(qa + (ks / 4) * kBlockQ * kRowBytes + (ks % 4) * 32, 16, 1024);
        const uint64_t db =
            hopper::desc_sw128(kb + (ks / 4) * kBlockK * kRowBytes + (ks % 4) * 32, 16, 1024);
        if constexpr (kBlockK == 64)
          hopper::wgmma_ss_m64n64k8_tf32(s, da, db, pass > 0 || ks > 0);
        else
          hopper::wgmma_ss_m64n32k8_tf32(s, da, db, pass > 0 || ks > 0);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(s);
    release(2 * j);  // K_j is read: its slot can take the next tile

    // Online softmax in the log2 domain, as in the sm90 variant: keys past seq_k are
    // -inf (TMA's zero fill would make them logit 0), the max is taken on the raw
    // logits and the positive scale folds into exp2's argument. P's raw words are its
    // hi; its low parts go beside them in registers.
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
    uint32_t p_hi[kSN], p_lo[kSN];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kSN; ++i) {
      const int r = (i >> 1) & 1;  // s[4n + 0, 1]: row g; s[4n + 2, 3]: row g + 8
      const float p = fast_exp2(fmaf(s[i], args.scale_log2, -m_r[r]));
      rs[r] += p;
      p_hi[i] = __float_as_uint(p);
      p_lo[i] = __float_as_uint(tf32_lo(p));
    }
    l_r[0] = l_r[0] * alpha[0] + rs[0];
    l_r[1] = l_r[1] * alpha[1] + rs[1];

    // O = alpha · O + P_lo·V_hi + P_hi·V_lo + P_hi·V_hi: P is the register A operand;
    // for the 8 keys of step kk the TF32 fragment (rows g, g + 8; keys t, t + 4) is the
    // accumulator of 8-column tile kk (keys 2t, 2t + 1) in the order Vᵀ stores them.
    // Vᵀ is K-major: 8 keys a step (32 bytes), the next key box every 4 steps; 64
    // output columns per wgmma (8 KB of Vᵀ rows apart), then a 32-column tail. O is
    // not accumulated in the tensor cores across key blocks: their sums into the
    // accumulator do not round to nearest, and a running O drifted with the key
    // count, past the f32 limits at 4096 keys, as truncating sums predict. Each group
    // of kGroup columns of this block's P·V starts from zero and joins O in one
    // rounded FFMA.
    hopper::mbar_wait(&ready[v_slot], ((2 * j + 1) / kSlots) & 1);
    const uint32_t vh = hopper::smem_u32(hi_tile(v_slot));
    const uint32_t vl = hopper::smem_u32(lo_tile(v_slot));
#pragma unroll
    for (int col0 = 0; col0 < D_PAD; col0 += kGroup) {
      float acc[kGroup / 2];
#pragma unroll
      for (int i = 0; i < kGroup / 2; ++i) acc[i] = 0.f;
      hopper::fence_regs(acc);
      hopper::fence_regs(p_hi);
      hopper::fence_regs(p_lo);
      hopper::wgmma_fence();
      auto pv = [&](const uint32_t(&pa)[kSN], uint32_t vb) {
#pragma unroll
        for (int kk = 0; kk < kBlockK / 8; ++kk) {
          const uint32_t a[4] = {pa[4 * kk + 0], pa[4 * kk + 2], pa[4 * kk + 1],
                                 pa[4 * kk + 3]};
          const uint32_t step =
              vb + (kk / 4) * D_PAD * kRowBytes + (kk % 4) * 32 + col0 * kRowBytes;
#pragma unroll
          for (int c = 0; c < kGroup / 64; ++c)
            hopper::wgmma_rs_m64n64k8_tf32(
                reinterpret_cast<float(&)[32]>(acc[32 * c]), a,
                hopper::desc_sw128(step + c * 64 * kRowBytes, 16, 1024));
          if constexpr (kGroup % 64 != 0)
            hopper::wgmma_rs_m64n32k8_tf32(
                reinterpret_cast<float(&)[16]>(acc[32 * (kGroup / 64)]), a,
                hopper::desc_sw128(step + (kGroup / 64) * 64 * kRowBytes, 16, 1024));
        }
      };
      pv(p_lo, vh);
      pv(p_hi, vl);
      pv(p_hi, vh);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc);
#pragma unroll
      for (int i = 0; i < kGroup / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[col0 / 2 + 4 * i + e] =
              fmaf(o[col0 / 2 + 4 * i + e], alpha[e / 2], acc[4 * i + e]);
      }
    }
    release(2 * j + 1);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv[r] = 1.f / l_r[r];
  }
  // Epilogue: Q hi is no longer read, so O goes there in its swizzled layout (16-byte
  // group c of row r sits at c ^ (r % 8); rows g and g + 8 of every warp share
  // r % 8 == g), then out by TMA store, which clips rows ≥ seq_q and columns ≥
  // head_dim.
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int i = 0; i < D_PAD / 8; ++i) {
    unsigned char* col = q_hi + (i / 4) * kBlockQ * kRowBytes +
                         (((2 * (i % 4) + t / 2) ^ g) << 4) + (t & 1) * 8;
    *reinterpret_cast<float2*>(col + r0 * kRowBytes) =
        make_float2(o[4 * i + 0] * inv[0], o[4 * i + 1] * inv[0]);
    *reinterpret_cast<float2*>(col + (r0 + 8) * kRowBytes) =
        make_float2(o[4 * i + 2] * inv[1], o[4 * i + 3] * inv[1]);
  }
  hopper::fence_proxy_async_shared();
  hopper::named_barrier_sync(2, 128);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c)
      hopper::tma_store_4d(&o_map, q_hi + c * kBlockQ * kRowBytes, c * kBoxCols, h, q0, b);
    hopper::tma_store_commit_and_wait();
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launch
// ---------------------------------------------------------------------------

template <int D_PAD>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int batch,
                     int heads, int seq_q, int seq_k, int head_dim, long long q_sb,
                     long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                     long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                     long long o_sb, long long o_ss, long long o_sh, float scale_log2,
                     cudaStream_t stream) {
  using C = Config<D_PAD>;
  const CUtensorMapDataType dt = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap qm, km, vm, om;
  if (!encode_bshd(&qm, dt, q, batch, seq_q, heads, head_dim, q_sb, q_ss, q_sh, kBlockQ, 4,
                   kBoxCols) ||
      !encode_bshd(&km, dt, k, batch, seq_k, heads, head_dim, k_sb, k_ss, k_sh, C::kBlockK, 4,
                   kBoxCols) ||
      !encode_bshd(&vm, dt, v, batch, seq_k, heads, head_dim, v_sb, v_ss, v_sh, C::kBlockK, 4,
                   kBoxCols) ||
      !encode_bshd(&om, dt, o, batch, seq_q, heads, head_dim, o_sb, o_ss, o_sh, kBlockQ, 4,
                   kBoxCols))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_tf32x3<D_PAD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  const int max_batch = 65535 / heads;
  for (int b0 = 0; b0 < batch && err == cudaSuccess; b0 += max_batch) {
    const int nb = batch - b0 < max_batch ? batch - b0 : max_batch;
    const Args a{heads, seq_k, b0 * heads, scale_log2};
    const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, nb * heads);
    kernel<<<grid, kThreads, C::kSmemBytes, stream>>>(qm, km, vm, om, a);
    err = cudaGetLastError();
  }
  return err;
}

// exp2 of n values both ways (fast: ex2.approx.ftz, as the kernel; precise: exp2f),
// and one mma.sync TF32 product per raw f32 word w of `words`: w · 1, which tells
// whether the tensor cores truncate or round a word's low 13 mantissa bits.
__global__ void probe(const float* x, float* fast, float* precise, int n, const float* words,
                      float* products, int n_words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    fast[i] = fast_exp2(x[i]);
    precise[i] = exp2f(x[i]);
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    for (int w = 0; w < n_words; ++w) {
      // Lane 0 holds A[0][0] and B[0][0], every other element is 0: D[0][0] = A · B.
      const uint32_t a0 = threadIdx.x == 0 ? __float_as_uint(words[w]) : 0u;
      const uint32_t b0 = threadIdx.x == 0 ? __float_as_uint(1.f) : 0u;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
          "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
          : "r"(a0), "r"(0u), "r"(0u), "r"(0u), "r"(b0), "r"(0u));
      if (threadIdx.x == 0) products[w] = d[0];
    }
  }
}

}  // namespace pa_tf32x3

// Launches the tf32x3 variant over every batch·head slice, in chunks of at most 65535
// (gridDim.y); the caller has checked that it takes the call (see
// pa_flash_attention_fwd). Strides are in elements.
extern "C" cudaError_t pa_flash_attention_tf32x3(
    const void* q, const void* k, const void* v, void* o, int batch, int heads, int seq_q,
    int seq_k, int head_dim, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale_log2, cudaStream_t stream) {
#define PA_TF32X3_LAUNCH(D)                                                                   \
  pa_tf32x3::launch_d<D>(q, k, v, o, batch, heads, seq_q, seq_k, head_dim, q_sb, q_ss, q_sh, \
                         k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale_log2,   \
                         stream)
  if (head_dim <= 64) return PA_TF32X3_LAUNCH(64);
  if (head_dim <= 96) return PA_TF32X3_LAUNCH(96);
  if (head_dim <= 128) return PA_TF32X3_LAUNCH(128);
  if (head_dim <= 160) return PA_TF32X3_LAUNCH(160);
  return PA_TF32X3_LAUNCH(256);
#undef PA_TF32X3_LAUNCH
}

// chip_smoke.py's probe of the kernel's numerics on the card (see pa_tf32x3::probe):
// x, fast and precise hold n floats, words and products n_words. Returns the CUDA
// error of the launch.
extern "C" int pa_tf32x3_probe(const float* x, float* fast, float* precise, int n,
                               const float* words, float* products, int n_words,
                               void* stream) {
  pa_tf32x3::probe<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, fast, precise, n, words, products, n_words);
  return (int)cudaGetLastError();
}
