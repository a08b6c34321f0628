// The `wide` variant of K1 (flash_attention_wide.cuh) as a translation unit of its
// own: it compiles with its own nvcc, beside flash_attention.cu, and the two objects
// link into one library whose entry point, pa_flash_attention_fwd, dispatches to it.

#include "flash_attention_wide.cuh"

// Launches the wide variant; the caller has checked that it takes the call (see
// pa_flash_attention_fwd). Arguments as pa_wide::launch.
extern "C" cudaError_t pa_flash_attention_wide(
    const void* q, const void* k, const void* v, void* o, int dtype, int batch, int heads,
    int seq_q, int seq_k, int head_dim, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, float scale_log2,
    cudaStream_t stream) {
  return pa_wide::launch(q, k, v, o, dtype, batch, heads, seq_q, seq_k, head_dim, q_sb, q_ss,
                         q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale_log2,
                         stream);
}
