// Single-token decode against a paged KV cache: the shared page pool
// (P, ps, Kv, hd) read through a per-slot page table (B, n_log), bf16 or
// f32 pages, or int8 pages with per-(row, kv head) f32 scales dequantized
// in the kernel before the ladder's dots.
//
// Replaces the TPU kernel kernels/attention_paged.py:_paged_kernel
// (pallas_call at :163), which scalar-prefetches the page table and walks
// one page per grid step.  Here a block loads its own table entries and
// gathers the pages into the same 32-row KV tiles the dense decode walks
// (flash_common.cuh, PAGED), so a bf16 pool sums in the dense kernel's
// order.  Grid (Kv, B): one block per (row, kv head), covering the
// group's query heads.
#include "flash_common.cuh"

extern "C" int attention_paged_decode_launch(const void* q, const void* k_pages,
                                             const void* v_pages, const float* k_scale,
                                             const float* v_scale, const int* table, float* o,
                                             const int* pos, int q_bf16, int kv_type, int B,
                                             int s_cache, int n_log, int ps, int Kv, int G,
                                             int hd, int ring, float softcap, int policy,
                                             void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  rt::AttnArgs a{q, k_pages, v_pages, o, nullptr, pos, q_bf16, B, 1, s_cache, Kv, G, hd, 0, 0,
                 ring, softcap, kv_type, table, k_scale, v_scale, n_log, ps};
  dim3 grid(Kv, B);
  return rt::dispatch_attn<16, true, true>(a, policy, grid, static_cast<cudaStream_t>(stream));
}
