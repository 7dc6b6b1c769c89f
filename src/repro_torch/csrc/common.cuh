// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel here runs the paper's precision ladder on the tensor
// cores through the WMMA API (nvcuda::wmma, bf16 16x16x16 fragments with
// f32 accumulators), operands staged through shared memory:
//
//   bf16       main  = a_hi.b_hi
//   refine_a   small = a_lo.b_hi                       ; main = a_hi.b_hi
//   bf16x3     small = a_lo.b_hi + a_hi.b_lo           ; main = a_hi.b_hi
//   refine_ab  small = a_lo.b_lo + a_lo.b_hi + a_hi.b_lo; main = a_hi.b_hi
//
// and the result is small + main: the small terms keep their own f32
// accumulator and are added before the leading term, smallest first, as
// core/precision.py:policy_terms orders them.  hi/lo are the bf16
// round-to-nearest-even of x and of its residual (Eq. 1), computed with
// __float2bfloat16_rn so they equal torch's `.to(torch.bfloat16)`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace rt {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

enum Policy { P_BF16 = 0, P_REFINE_A = 1, P_BF16X3 = 2, P_REFINE_AB = 3, P_F32 = 4 };

// Whether the policy splits the A (left) / B (right) operand into hi+lo.
template <int POL> struct Splits {
  static constexpr bool a_lo = POL == P_REFINE_A || POL == P_BF16X3 || POL == P_REFINE_AB;
  static constexpr bool b_lo = POL == P_BF16X3 || POL == P_REFINE_AB;
};

template <typename Layout = wmma::row_major>
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, Layout>;
template <typename Layout>
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, Layout>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// One element of an f32 or bf16 tensor, as f32.
__device__ __forceinline__ float load_elem(const void* p, long long i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// Store x as its bf16 hi part (and lo residual when `with_lo`).
template <bool with_lo>
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, long long i, float x) {
  bf16 h = __float2bfloat16_rn(x);
  hi[i] = h;
  if constexpr (with_lo) lo[i] = __float2bfloat16_rn(x - __bfloat162float(h));
}

// One 16-deep step of the policy's passes into (small, main).  A is read
// row-major unless LayoutA says col_major (a transposed tile in place).
template <int POL, typename LayoutB, typename LayoutA = wmma::row_major>
__device__ __forceinline__ void policy_mma(FragC& small, FragC& main,
                                           const bf16* a_hi, const bf16* a_lo, unsigned lda,
                                           const bf16* b_hi, const bf16* b_lo, unsigned ldb) {
  FragA<LayoutA> ahi;
  FragB<LayoutB> bhi;
  wmma::load_matrix_sync(ahi, a_hi, lda);
  wmma::load_matrix_sync(bhi, b_hi, ldb);
  if constexpr (Splits<POL>::a_lo) {
    FragA<LayoutA> alo;
    wmma::load_matrix_sync(alo, a_lo, lda);
    if constexpr (Splits<POL>::b_lo) {
      FragB<LayoutB> blo;
      wmma::load_matrix_sync(blo, b_lo, ldb);
      if constexpr (POL == P_REFINE_AB) wmma::mma_sync(small, alo, blo, small);
      wmma::mma_sync(small, alo, bhi, small);
      wmma::mma_sync(small, ahi, blo, small);
    } else {
      wmma::mma_sync(small, alo, bhi, small);
    }
  }
  wmma::mma_sync(main, ahi, bhi, main);
}

// Eight consecutive elements (16 bytes of bf16, 32 of f32) as f32; the
// caller guarantees 8-element alignment.
__device__ __forceinline__ void load8(const void* p, long long i, int is_bf16, float (&x)[8]) {
  if (is_bf16) {
    const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p) + i);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
      x[2 * j] = __low2float(h);
      x[2 * j + 1] = __high2float(h);
    }
  } else {
    const float4* f = reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    const float4 f0 = f[0], f1 = f[1];
    x[0] = f0.x; x[1] = f0.y; x[2] = f0.z; x[3] = f0.w;
    x[4] = f1.x; x[5] = f1.y; x[6] = f1.z; x[7] = f1.w;
  }
}

// Round a shared-memory section size up so every section starts 128-byte aligned
// (WMMA loads and stores need 256-bit aligned pointers).
__host__ __device__ constexpr size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

}  // namespace rt
