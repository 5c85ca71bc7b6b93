// Causal chunk attention through the paged KV cache's block table: a
// C-token prompt chunk at per-row offset q_off attends over the row's
// prior K/V and its own. Replaces the TPU kernel
// repro/kernels/flash_prefill/kernel.py (_fp_kernel, launched by
// flash_prefill's pallas_call).
//
// What bounds it on the H100: at serving chunk sizes (C = 128, G = 4) a
// (row, KV head) does about 4 * C * G * hd FLOPs per K/V position it
// reads, which is below the card's ratio of bf16 tensor-core FLOPs to HBM
// bytes for hd 64 and near it for hd 128; this first kernel runs its dot
// products on the CUDA cores, so it is bound by operations long before
// either limit. The byte floor is (q_off + C) positions of K and V per
// (row, KV head).
//
// Design: one CTA per (row, KV head, tile of 16 of the C * G c-major query
// rows): row r is chunk position r / G and group member r % G, at query
// position q_off + r / G. Each K/V tile loaded into shared memory serves
// every query row of the tile; the CTA stops at its own last visible
// position, (q_off + c_last), so the upper triangle of later blocks is
// never read. Softmax and accumulator are fp32, as in the TPU kernel.
// Body: block_table_attention.cuh.
#include "block_table_attention.cuh"

extern "C" int flash_prefill_launch(const void* q, const void* k_pool,
                                    const void* v_pool, const void* table,
                                    const void* q_off, void* out, int B,
                                    int C, int H, int KV, int hd, int block,
                                    int bpr, int dtype, void* stream) {
  return repro::launch_block_table_attention<16>(
      q, k_pool, v_pool, table, q_off, 0, out, B, C, H, KV, hd, block, bpr,
      dtype, stream);
}
