// C = A.B on the bf16 rung: one tensor-core pass, f32 accumulation.
// Replaces the TPU kernel kernels/gemm_tiled.py:_gemm_kernel (pallas_call
// at gemm_tiled.py:91).  M > 16 runs the Hopper mainloop (gemm_sm90.cuh),
// M <= 16 the split-K weight stream (gemm_splitk.cuh) split `splits` ways
// into the workspace `ws` (`ws_floats` floats) and `tickets` (`n_tickets`
// ints, zero); *loop says which ran.
#include "gemm_common.cuh"

extern "C" int gemm_tiled_launch(const void* a, int a_bf16, long long sab, long long sam,
                                 long long sak, const void* b, int b_bf16, long long sbb,
                                 long long sbk, long long sbn, float* c, int batch, int m, int n,
                                 int k, int splits, float* ws, long long ws_floats, int* tickets,
                                 int n_tickets, int* loop, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  rt::GemmArgs g = rt::make_args(a, a_bf16, sab, sam, sak, b, b_bf16, sbb, sbk, sbn, c, m, n, k);
  const rt::SplitWs split{splits, ws, ws_floats, tickets, n_tickets};
  return rt::dispatch_gemm<rt::P_BF16>(g, batch, static_cast<cudaStream_t>(stream), loop, &split);
}
