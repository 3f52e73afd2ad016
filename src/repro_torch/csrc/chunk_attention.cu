// Chunk and token-packed chunk attention over a contiguous KV cache, CUDA C++
// for sm_90a.
//
// Replaces the TPU kernels of repro/kernels/decode_attention.py:
//   * chunk_attention (_chunk_kernel + pl.pallas_call): q [B,C,H,hd], row i
//     of b at q_offsets[b] + i, attending to cache positions <= its own;
//     rows at or past q_lens[b] are zeros, and the kv loop of a tile stops at
//     its last live row's position, so a decode row (q_len 1) in a wide chunk
//     pays only its own context. decode_attention is its C == 1 case.
//   * packed_chunk_attention (_packed_chunk_kernel): the same attention on a
//     token-packed q axis [Np,H,hd], row b owning row_starts[b] ..
//     row_starts[b] + q_lens[b] - 1. Where the TPU kernel scalar-prefetched
//     one row per q block (and so needed block-aligned row starts), this
//     kernel binary-searches each position's row itself and runs one kv pass
//     per row a tile spans, so row starts need no alignment.
//
// Bound on an H100: bytes. A decode tick of yi-6b at B=8, kv width 1024,
// K=4, hd=128 in bf16 reads 2 * 8 * 1024 * 4 * 128 * 2 B = 16.8 MB a layer,
// >= 5.0 us at 3.35 TB/s. Each block reads its row's live K/V tiles once
// for all G query heads of its kv head and skips dead tiles; this first
// version has one block per (row, kv head, q tile) and no split over the kv
// axis, so a pure decode tick launches only B * K blocks.
#include "attention_tile.cuh"

extern "C" int aios_chunk_attention(AIOS_LAUNCHER_PARAMS) {
  const aios::AttnArgs a = AIOS_LAUNCHER_ARGS;
  dim3 grid((Sq + BQ - 1) / BQ, K, B);
  return aios::launch<aios::CHUNK>(dtype, hd, a, grid, static_cast<cudaStream_t>(stream));
}

extern "C" int aios_packed_chunk_attention(AIOS_LAUNCHER_PARAMS) {
  const aios::AttnArgs a = AIOS_LAUNCHER_ARGS;
  dim3 grid((Sq + BQ - 1) / BQ, K, 1);
  return aios::launch<aios::PACKED>(dtype, hd, a, grid, static_cast<cudaStream_t>(stream));
}
