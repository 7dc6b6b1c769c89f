// Grouped (ragged) expert GEMMs of the MoE FFN on the tensor cores,
// every rung of the bf16 ladder the kernel fuses (bf16, refine_a,
// bf16x3, refine_ab), f32 out.  Both run gemm_common.cuh's tiled kernel
// in a group mode:
//
//   grouped_gemm_launch     out[r] = x[r].w[g(r)] (or .w[g]^T for dx),
//                           G_ROWS: one group id per block of BM rows.
//                           Replaces kernels/gemm_grouped.py:_gmm_kernel
//                           (pallas_call at gemm_grouped.py:184).
//   grouped_gemm_dw_launch  dw[g] = x_g^T.dy_g over group g's run of
//                           rows, G_K: one block per (group, BM x BN tile
//                           of dw) walks its own run as K.  Replaces
//                           kernels/gemm_grouped.py:_dw_kernel
//                           (pallas_call at gemm_grouped.py:246).
#include "gemm_common.cuh"

namespace {

using namespace rt;

// The CTA row tile of the forward is the caller's (it computed the
// per-tile group ids at that granularity): 16 rows for decode-sized
// buffers, 64 otherwise.  B is w[g] row-major (forward) or K-major (dx,
// w[g] read through swapped strides).
template <int POL>
int grouped_rows(const GemmArgs& g, int cta_bm, cudaStream_t s) {
  const bool kmajor = g.sbk < g.sbn;
  if (cta_bm == 16)
    return kmajor ? run_gemm<16, 128, 64, 16, 16, true, POL, G_ROWS>(g, 1, s)
                  : run_gemm<16, 128, 64, 16, 16, false, POL, G_ROWS>(g, 1, s);
  if (cta_bm == 64)
    return kmajor ? run_gemm<64, 128, 32, 32, 32, true, POL, G_ROWS>(g, 1, s)
                  : run_gemm<64, 128, 32, 32, 32, false, POL, G_ROWS>(g, 1, s);
  return (int)cudaErrorInvalidValue;
}

// dw: A is x^T (M-contiguous, D x rows), B is dy (rows x F, row-major).
template <int POL>
int grouped_k(const GemmArgs& g, int num_groups, cudaStream_t s) {
  return run_gemm<64, 128, 32, 32, 32, false, POL, G_K>(g, num_groups, s);
}

}  // namespace

extern "C" int grouped_gemm_launch(const void* a, int a_bf16, long long sam, long long sak,
                                   const void* b, int b_bf16, long long sbb, long long sbk,
                                   long long sbn, const int* gids, int num_groups, float* c,
                                   int m, int n, int k, int cta_bm, int policy, void* stream,
                                   int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  GemmArgs g = make_args(a, a_bf16, 0, sam, sak, b, b_bf16, sbb, sbk, sbn, c, m, n, k);
  g.groups = gids;
  g.num_groups = num_groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (policy) {
    case P_BF16: return grouped_rows<P_BF16>(g, cta_bm, s);
    case P_REFINE_A: return grouped_rows<P_REFINE_A>(g, cta_bm, s);
    case P_BF16X3: return grouped_rows<P_BF16X3>(g, cta_bm, s);
    case P_REFINE_AB: return grouped_rows<P_REFINE_AB>(g, cta_bm, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int grouped_gemm_dw_launch(const void* x, int x_bf16, const void* dy, int dy_bf16,
                                      const int* offsets, int num_groups, float* dw, int d,
                                      int f, int policy, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // A = x^T (d x rows: m-stride 1, k-stride d); B = dy (rows x f); the
  // run's length is K, set per block from the offsets.
  GemmArgs g = make_args(x, x_bf16, 0, 1, d, dy, dy_bf16, 0, f, 1, dw, d, f, 0);
  g.groups = offsets;
  g.num_groups = num_groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (policy) {
    case P_BF16: return grouped_k<P_BF16>(g, num_groups, s);
    case P_REFINE_A: return grouped_k<P_REFINE_A>(g, num_groups, s);
    case P_BF16X3: return grouped_k<P_BF16X3>(g, num_groups, s);
    case P_REFINE_AB: return grouped_k<P_REFINE_AB>(g, num_groups, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
