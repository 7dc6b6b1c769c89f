// C = A.B on bf16 operands with an f32 accumulator: the paper's Listing 1
// (its Fig. 6 "WMMA without shared memory" column) as written.
// Replaces the TPU kernel kernels/gemm_naive.py:_naive_kernel (pallas_call
// at gemm_naive.py:60).
//
// One warp owns one 16x16 output tile.  Blocks are 128 x 4 threads, i.e.
// 4 x 4 warps, as in the listing.  The warp walks K in 16-steps:
// wmma::load_matrix_sync reads each operand fragment straight from global
// memory (no shared-memory staging, no reuse between warps), one
// mma_sync accumulates into a single f32 fragment, and the tile is
// stored once.  Kept unstaged on purpose: it is the baseline that the
// paper shows losing to SGEMM, and the tiled kernel (gemm_tiled.cu) is
// the staged one.
//
// Operands are bf16 with M, N and K multiples of 16 (the wrapper pads),
// each row-major or column-major (A_COL / B_COL: a transposed view read
// in place), leading dimensions multiples of 8 elements and 32-byte
// aligned fragments.  C is row-major f32 (ldc = n).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

template <bool A_COL, bool B_COL>
__global__ void __launch_bounds__(512) gemm_naive_kernel(
    const bf16* __restrict__ a, long long lda, long long sab,
    const bf16* __restrict__ b, long long ldb, long long sbb,
    float* __restrict__ c, int batch, int m, int n, int k) {
  using LA = typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
  using LB = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
  const int warp_m = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int warp_n = blockIdx.y * blockDim.y + threadIdx.y;
  const int row = warp_m * 16, col = warp_n * 16;
  if (row >= m || col >= n) return;  // the whole warp leaves together
  for (int z = blockIdx.z; z < batch; z += gridDim.z) {
    const bf16* az = a + z * sab;
    const bf16* bz = b + z * sbb;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> af;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> bfr;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < k; kk += 16) {
      wmma::load_matrix_sync(af, A_COL ? az + row + kk * lda : az + row * lda + kk, lda);
      wmma::load_matrix_sync(bfr, B_COL ? bz + kk + col * ldb : bz + kk * ldb + col, ldb);
      wmma::mma_sync(acc, af, bfr, acc);
    }
    wmma::store_matrix_sync(c + (long long)z * m * n + (long long)row * n + col, acc, n,
                            wmma::mem_row_major);
  }
}

}  // namespace

extern "C" int gemm_naive_launch(const void* a, int a_col, long long lda, long long sab,
                                 const void* b, int b_col, long long ldb, long long sbb,
                                 float* c, int batch, int m, int n, int k, void* stream,
                                 int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(128, 4);
  const dim3 grid((m / 16 + 3) / 4, (n / 16 + 3) / 4, batch < 65535 ? batch : 65535);
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const bf16*>(a);
  auto pb = static_cast<const bf16*>(b);
  if (a_col && b_col)
    gemm_naive_kernel<true, true><<<grid, block, 0, s>>>(pa, lda, sab, pb, ldb, sbb, c, batch, m, n, k);
  else if (a_col)
    gemm_naive_kernel<true, false><<<grid, block, 0, s>>>(pa, lda, sab, pb, ldb, sbb, c, batch, m, n, k);
  else if (b_col)
    gemm_naive_kernel<false, true><<<grid, block, 0, s>>>(pa, lda, sab, pb, ldb, sbb, c, batch, m, n, k);
  else
    gemm_naive_kernel<false, false><<<grid, block, 0, s>>>(pa, lda, sab, pb, ldb, sbb, c, batch, m, n, k);
  return (int)cudaGetLastError();
}
