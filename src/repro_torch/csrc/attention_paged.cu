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
// order.  Grid (splits, Kv, B): one block per (KV split, row, kv head),
// covering the group's query heads; the host picks the split by the dense
// decode's rule, so a bf16 pool stays bit-equal to the dense kernel.
#include "flash_common.cuh"

extern "C" int attention_paged_decode_launch(const void* q, const void* k_pages,
                                             const void* v_pages, const float* k_scale,
                                             const float* v_scale, const int* table, float* o,
                                             const int* pos, int q_bf16, int kv_type, int B,
                                             int s_cache, int n_log, int ps, int Kv, int G,
                                             int hd, int ring, float softcap, int policy,
                                             int splits, float* ws, long long ws_floats,
                                             int* tickets, int n_tickets, void* stream,
                                             int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  rt::AttnArgs a{q, k_pages, v_pages, o, nullptr, pos, q_bf16, B, 1, s_cache, Kv, G, hd, 0, 0,
                 ring, softcap, kv_type, table, k_scale, v_scale, n_log, ps};
  const rt::SplitWs sw{splits, ws, ws_floats, tickets, n_tickets};
  if (!rt::decode_split_ok(a, sw, policy)) return (int)cudaErrorInvalidValue;
  dim3 grid(splits, Kv, B);
  return rt::dispatch_attn<16, true, true>(a, policy, grid, static_cast<cudaStream_t>(stream),
                                           sw);
}
