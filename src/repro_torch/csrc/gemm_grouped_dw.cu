// The grouped dW at every rung (gemm_grouped.cuh; the int8 rungs on the
// fp8 instantiations, GemmArgs::q_int8 set).
#include "gemm_grouped.cuh"

using namespace rt;

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
  g.q_int8 = policy == P_INT8 || policy == P_INT8X3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (policy) {
    case P_BF16: return grouped_k<P_BF16>(g, num_groups, s);
    case P_REFINE_A: return grouped_k<P_REFINE_A>(g, num_groups, s);
    case P_BF16X3: return grouped_k<P_BF16X3>(g, num_groups, s);
    case P_REFINE_AB: return grouped_k<P_REFINE_AB>(g, num_groups, s);
    case P_F32: return grouped_k<P_F32>(g, num_groups, s);
    case P_BF16X6: return grouped_k<P_BF16X6>(g, num_groups, s);
    case P_FP8: case P_INT8: return grouped_k<P_FP8>(g, num_groups, s);
    case P_FP8X3: case P_INT8X3: return grouped_k<P_FP8X3>(g, num_groups, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
