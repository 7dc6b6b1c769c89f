// Fused precision-refined C = A.B (the paper's Eq. 2-3 in one kernel):
// refine_a, bf16x3 or refine_ab, the operands split into bf16 hi/lo on
// their way into shared memory (M > 16) or into fragments (M <= 16), the
// small terms in their own f32 accumulator.  Replaces
// kernels/gemm_refined.py:_refined_kernel (pallas_call at
// gemm_refined.py:113).  M > 16 runs the refined Hopper mainloop
// (gemm_refined_sm90.cuh) and M <= 16 the split-K weight stream
// (gemm_splitk.cuh), each split `splits` ways into the workspace `ws`
// (`ws_floats` floats) and `tickets` (`n_tickets` ints, zero); *loop says
// which ran.
#include "gemm_refined_sm90.cuh"

extern "C" int gemm_refined_launch(const void* a, int a_bf16, long long sab, long long sam,
                                   long long sak, const void* b, int b_bf16, long long sbb,
                                   long long sbk, long long sbn, float* c, int batch, int m, int n,
                                   int k, int policy, int splits, float* ws, long long ws_floats,
                                   int* tickets, int n_tickets, int* loop, void* stream,
                                   int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  rt::GemmArgs g = rt::make_args(a, a_bf16, sab, sam, sak, b, b_bf16, sbb, sbk, sbn, c, m, n, k);
  const rt::SplitWs split{splits, ws, ws_floats, tickets, n_tickets};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (policy) {
    case rt::P_REFINE_A: return rt::refined::dispatch<rt::P_REFINE_A>(g, batch, split, s, loop);
    case rt::P_BF16X3: return rt::refined::dispatch<rt::P_BF16X3>(g, batch, split, s, loop);
    case rt::P_REFINE_AB: return rt::refined::dispatch<rt::P_REFINE_AB>(g, batch, split, s, loop);
    default: return (int)cudaErrorInvalidValue;
  }
}
