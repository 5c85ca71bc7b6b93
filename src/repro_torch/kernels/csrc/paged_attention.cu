// Single-token GQA decode attention through the paged KV cache's block
// table. Replaces the TPU kernel repro/kernels/paged_attention/kernel.py
// (_pa_kernel, launched by paged_attention's pallas_call).
//
// What bounds it on the H100: bytes. Each (row, KV head) reads cur_len
// positions of K and V once and does 4 * G * hd FLOPs per position, far
// below the ~295 FLOPs per byte at which the tensor cores would become
// the limit, so the floor is the K/V bytes over the 3.35 TB/s of HBM.
//
// Design: one CTA per (row b, KV head), holding all G = H / KV query
// heads of the group (grid z splits G into 8-row tiles when G > 8), so
// each K/V element loaded from device memory serves the whole group. The
// CTA loads its own table entries and cur_len (no scalar prefetch) and
// walks only the ceil(cur_len / 32) position tiles the row holds, which
// replaces the TPU kernel's clamped index map.
// Body: block_table_attention.cuh.
#include "block_table_attention.cuh"

extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* table,
                                      const void* cur_len, void* out, int B,
                                      int H, int KV, int hd, int block,
                                      int bpr, int dtype, void* stream) {
  // a decode row of length cur_len sees positions [0, cur_len - 1]
  return repro::launch_block_table_attention<8>(
      q, k_pool, v_pool, table, cur_len, -1, out, B, 1, H, KV, hd, block,
      bpr, dtype, stream);
}
