// The grouped forward / dx at bf16x6 and the fp8 / int8 rungs (WMMA; the
// int8 rungs on the fp8 instantiations, GemmArgs::q_int8 set).  See
// gemm_grouped.cuh.  The arguments are gemm_grouped.cu's; these rungs do
// not run the split-K stream, so `offsets`, `counts` and the split
// workspace go unread.
#include "gemm_grouped.cuh"

using namespace rt;

extern "C" int grouped_gemm_ext_launch(const void* a, int a_bf16, long long sam, long long sak,
                                       const void* b, int b_bf16, long long sbb, long long sbk,
                                       long long sbn, const int* gids, int num_groups,
                                       const int* offsets, const int* counts, float* c, int m,
                                       int n, int k, int cta_bm, int policy, int splits, float* ws,
                                       long long ws_floats, int* tickets, int n_tickets, int* loop,
                                       void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  GemmArgs g = grouped_fwd_args(a, a_bf16, sam, sak, b, b_bf16, sbb, sbk, sbn, gids,
                                num_groups, c, m, n, k);
  g.q_int8 = policy == P_INT8 || policy == P_INT8X3;
  const splitk::GroupRuns runs{offsets, counts};
  const SplitWs w{splits, ws, ws_floats, tickets, n_tickets};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (policy) {
    case P_BF16X6: return grouped_rows<P_BF16X6>(g, cta_bm, runs, w, s, loop);
    case P_FP8: case P_INT8: return grouped_rows<P_FP8>(g, cta_bm, runs, w, s, loop);
    case P_FP8X3: case P_INT8X3: return grouped_rows<P_FP8X3>(g, cta_bm, runs, w, s, loop);
    default: return (int)cudaErrorInvalidValue;
  }
}
