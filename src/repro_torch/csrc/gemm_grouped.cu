// The grouped forward / dx at bf16 (the Hopper mainloop at 64- and 128-row
// tiles), refine_a, bf16x3, refine_ab (WMMA at 64) and f32 (WMMA); bf16 and
// the refined rungs at 16-row tiles run the split-K weight stream over the
// tiles with live rows (`counts`: each run's real rows, or nullptr), split
// `splits` ways into the workspace `ws` and `tickets`.  The other rungs are
// in gemm_grouped_ext.cu, dW in gemm_grouped_dw.cu (gemm_grouped.cuh).
#include "gemm_grouped.cuh"

using namespace rt;

extern "C" int grouped_gemm_launch(const void* a, int a_bf16, long long sam, long long sak,
                                   const void* b, int b_bf16, long long sbb, long long sbk,
                                   long long sbn, const int* gids, int num_groups,
                                   const int* offsets, const int* counts, float* c, int m, int n,
                                   int k, int cta_bm, int policy, int splits, float* ws,
                                   long long ws_floats, int* tickets, int n_tickets, int* loop,
                                   void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const GemmArgs g = grouped_fwd_args(a, a_bf16, sam, sak, b, b_bf16, sbb, sbk, sbn, gids,
                                      num_groups, c, m, n, k);
  const splitk::GroupRuns runs{offsets, counts};
  const SplitWs w{splits, ws, ws_floats, tickets, n_tickets};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (policy) {
    case P_BF16: return grouped_rows<P_BF16>(g, cta_bm, runs, w, s, loop);
    case P_REFINE_A: return grouped_rows<P_REFINE_A>(g, cta_bm, runs, w, s, loop);
    case P_BF16X3: return grouped_rows<P_BF16X3>(g, cta_bm, runs, w, s, loop);
    case P_REFINE_AB: return grouped_rows<P_REFINE_AB>(g, cta_bm, runs, w, s, loop);
    case P_F32: return grouped_rows<P_F32>(g, cta_bm, runs, w, s, loop);
    default: return (int)cudaErrorInvalidValue;
  }
}
