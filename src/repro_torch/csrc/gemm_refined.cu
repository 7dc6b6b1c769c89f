// Fused precision-refined C = A.B (the paper's Eq. 2-3 in one kernel):
// operands are split into bf16 hi/lo on their way into shared memory and
// the policy's 2 (refine_a), 3 (bf16x3) or 4 (refine_ab) tensor-core
// passes run on the staged tiles, small terms in their own f32
// accumulator.  Replaces kernels/gemm_refined.py:_refined_kernel
// (pallas_call at gemm_refined.py:113).  See gemm_common.cuh.
#include "gemm_common.cuh"

extern "C" int gemm_refined_launch(const void* a, int a_bf16, long long sab, long long sam,
                                   long long sak, const void* b, int b_bf16, long long sbb,
                                   long long sbk, long long sbn, float* c, int batch, int m, int n,
                                   int k, int policy, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  rt::GemmArgs g = rt::make_args(a, a_bf16, sab, sam, sak, b, b_bf16, sbb, sbk, sbn, c, m, n, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (policy) {
    case rt::P_REFINE_A: return rt::dispatch_gemm<rt::P_REFINE_A>(g, batch, s);
    case rt::P_BF16X3: return rt::dispatch_gemm<rt::P_BF16X3>(g, batch, s);
    case rt::P_REFINE_AB: return rt::dispatch_gemm<rt::P_REFINE_AB>(g, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
