// Causal / sliding-window flash attention for prefill, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel + pl.pallas_call). Computes the same function: q [B,Sq,H,hd]
// against k/v [B,Skv,K,hd] with per-sequence q_offsets[B] and kv_lens[B];
// query row i of b sits at q_offsets[b] + i and attends to keys
// kp <= its position, kp < kv_lens[b], and inside the window when window > 0.
// Tiles above the diagonal or past kv_len are skipped, not just masked.
//
// Bound on an H100: operations for long prompts, bytes and operations
// about even at 512 tokens. A yi-6b prefill of 512 tokens (H=32, hd=128)
// does ~4 * 512 * 512 / 2 * 128 * 32 = 2.1 GFLOP a sequence and a layer,
// ~2.2 us at 989 TFLOP/s (bf16 tensor cores), and moves ~9.4 MB (q and o
// in bf16, K/V once), ~2.8 us at 3.35 TB/s; the operations grow with the
// square of the length. This first version uses scalar fp32 FMAs
// (attention_tile.cuh), so it sits far above both; its design keeps K/V
// traffic at one read per (q tile, kv head) for all G query heads of the
// group and skips dead tiles.
#include "attention_tile.cuh"

extern "C" int aios_flash_attention(AIOS_LAUNCHER_PARAMS) {
  const aios::AttnArgs a = AIOS_LAUNCHER_ARGS;
  dim3 grid((Sq + BQ - 1) / BQ, K, B);
  return aios::launch<aios::FLASH>(dtype, hd, a, grid, static_cast<cudaStream_t>(stream));
}
