// Grouped (ragged) expert GEMMs of the MoE FFN on the tensor cores, every
// rung of the ladder (bf16, refine_a, bf16x3, refine_ab, bf16x6, the
// fp8/int8 rungs with their quantization scales per staged tile, and f32
// on the CUDA cores), f32 out.  All run gemm_common.cuh's tiled kernel in
// a group mode (the bf16 forward at 64 or 128 rows: gemm_sm90.cuh; bf16
// and the refined rungs at 16 rows: gemm_splitk.cuh):
//
//   forward / dx     out[r] = x[r].w[g(r)] (or .w[g]^T for dx), G_ROWS:
//                    one group id per block of BM rows (bf16 and the
//                    refined rungs at 16 rows: gemm_splitk.cuh's
//                    group-rows mode, the live rows' experts only).  Replaces
//                    kernels/gemm_grouped.py:_gmm_kernel (pallas_call at
//                    gemm_grouped.py:184).
//   dW               dw[g] = x_g^T.dy_g over group g's run of rows, G_K:
//                    one block per (group, BM x BN tile of dw) walks its
//                    own run as K (bf16: gemm_sm90.cuh's group-K mode; the
//                    quantized rungs on a quantize pass's planes,
//                    gemm_grouped_dw.cu).
//                    Replaces kernels/gemm_grouped.py:_dw_kernel
//                    (pallas_call at gemm_grouped.py:246).
//
// Three sources instantiate them, so that they compile in parallel:
// gemm_grouped.cu (the forward at bf16, its refinements and f32),
// gemm_grouped_ext.cu (the forward at bf16x6 and the fp8 / int8 rungs) and
// gemm_grouped_dw.cu (dW at every rung).  The int8 rungs run the fp8
// rungs' instantiations with GemmArgs::q_int8 set, so each pass count of
// the quantized rungs compiles once.
#pragma once

#include "gemm_common.cuh"

namespace rt {

// The CTA row tile of the forward is the caller's (it computed the
// per-tile group ids at that granularity): 16 rows for decode-sized
// buffers, 64 or 128 otherwise.  At 16 rows bf16 and the refined rungs run
// the split-K weight stream's group-rows mode (gemm_splitk.cuh: only the
// tiles with live rows, per `runs`, read their expert's weights; split
// `w.splits` ways), the other rungs the WMMA kernel; the bf16 rung at 64
// or 128 rows runs the Hopper mainloop (gemm_sm90.cuh), every other case
// the WMMA kernel.  B is w[g] row-major (forward) or K-major (dx, w[g] read
// through swapped strides).
template <int POL>
int grouped_rows(const GemmArgs& g, int cta_bm, const splitk::GroupRuns& runs,
                 const SplitWs& w, cudaStream_t s, int* loop) {
  const bool kmajor = g.sbk < g.sbn;
  *loop = LOOP_WMMA;
  if constexpr (POL == P_BF16 || Splits<POL>::a_lo) {
    if (cta_bm == 16) {
      *loop = LOOP_SPLITK;
      return splitk::run<POL, true>(g, (g.m + splitk::MAX_M - 1) / splitk::MAX_M, w, s, runs);
    }
  } else {
    if (cta_bm == 16)
      return kmajor ? run_gemm<16, 128, 64, 16, 16, true, POL, G_ROWS>(g, 1, s)
                    : run_gemm<16, 128, 64, 16, 16, false, POL, G_ROWS>(g, 1, s);
  }
  if constexpr (POL == P_BF16) {
    if (cta_bm == 64 || cta_bm == 128) {
      *loop = LOOP_SM90;
      return sm90::run<G_ROWS>(g, 1, cta_bm, s);
    }
  }
  if (cta_bm == 64)
    return kmajor ? run_gemm<64, 128, 32, 32, 32, true, POL, G_ROWS>(g, 1, s)
                  : run_gemm<64, 128, 32, 32, 32, false, POL, G_ROWS>(g, 1, s);
  return (int)cudaErrorInvalidValue;
}

// dw: A is x^T (M-contiguous, D x rows), B is dy (rows x F, row-major).
// bf16 runs the Hopper mainloop's group-K mode (128 x 128 tiles); every
// other rung runs the WMMA kernel's 64 x 128 tile, 32 deep (the quantize
// pass's tiles).
template <int POL>
int grouped_k(const GemmArgs& g, int num_groups, cudaStream_t s, int* loop) {
  if constexpr (POL == P_BF16) {
    *loop = LOOP_SM90;
    return sm90::run_grouped_k<128>(g, s);
  } else {
    *loop = LOOP_WMMA;
    return run_gemm<DW_SCALE_D, DW_SCALE_F, DW_SCALE_K, 32, 32, false, POL, G_K>(g, num_groups,
                                                                                  s);
  }
}

// The forward's arguments: x (rows x K), w[g] as B through its strides.
inline GemmArgs grouped_fwd_args(const void* a, int a_bf16, long long sam, long long sak,
                                 const void* b, int b_bf16, long long sbb, long long sbk,
                                 long long sbn, const int* gids, int num_groups, float* c,
                                 int m, int n, int k) {
  GemmArgs g = make_args(a, a_bf16, 0, sam, sak, b, b_bf16, sbb, sbk, sbn, c, m, n, k);
  g.groups = gids;
  g.num_groups = num_groups;
  return g;
}

}  // namespace rt
