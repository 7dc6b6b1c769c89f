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
//
// The rungs above and below those ("carried" rungs, Carried<POL>) keep
// their operand tiles in f32 in shared memory and make the bf16 terms of
// each 16 x 16 fragment as it is loaded (fly_mma; the tiled GEMM does so
// for bf16x6 only, and quantizes the fp8 / int8 rungs into bf16 planes as
// it stages them, gemm_common.cuh):
//   bf16x6     the 3-way split hi/mid/lo (hi = bf16(x), mid = bf16(x - hi),
//              lo = bf16(x - hi - mid)), six passes:
//              small = (2,0) + (0,2) + (1,1) + (1,0) + (0,1); main = (0,0)
//   fp8, int8  q(x) = quantize-dequantize under a power-of-two scale
//              s = 2^ceil(log2(amax / qmax)) (qmax 224 for e4m3, 127 for
//              int8), one pass: main = q(a).q(b)
//   fp8x3,     hi = q(x), lo = q(x - hi) under its own scale; small =
//   int8x3     lo.hi + hi.lo, main = hi.hi
// A dequantized e4m3 or int8 value is exact in bf16 (pow2 scale, <= 8
// significant bits), so the quantized rungs ride the bf16 passes.  amax is
// taken over the staged tile the product reads (tile_scales), so the
// kernels' scale domains are their tiles; each plain twin takes the same.
#pragma once

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace rt {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

enum Policy { P_BF16 = 0, P_REFINE_A = 1, P_BF16X3 = 2, P_REFINE_AB = 3, P_F32 = 4,
              P_BF16X6 = 5, P_FP8 = 6, P_INT8 = 7, P_FP8X3 = 8, P_INT8X3 = 9 };

// Rungs whose bf16 terms are made from f32 tiles at fragment load.
template <int POL> struct Carried {
  static constexpr bool value = POL >= P_BF16X6;
  static constexpr bool quant = POL >= P_FP8;
  static constexpr bool fp8 = POL == P_FP8 || POL == P_FP8X3;
  static constexpr bool x3 = POL == P_FP8X3 || POL == P_INT8X3;
  static constexpr int terms = POL == P_BF16X6 ? 3 : (x3 ? 2 : 1);
};

// Whether the policy splits the A (left) / B (right) operand into hi+lo.
template <int POL> struct Splits {
  static constexpr bool a_lo = POL == P_REFINE_A || POL == P_BF16X3 || POL == P_REFINE_AB;
  static constexpr bool b_lo = POL == P_BF16X3 || POL == P_REFINE_AB;
};

// The small terms a refined launch multiplies (its term set, a template
// argument of the refined mainloops): a bf16 operand's lo term is
// identically zero, so every term that reads it adds exact zeros and is
// skipped.  T_LH = a_lo.b_hi, T_HL = a_hi.b_lo, T_LL = a_lo.b_lo; the
// leading a_hi.b_hi always runs.  0 for the bf16 rung.
enum Terms { T_LH = 1, T_HL = 2, T_LL = 4 };

template <int POL>
constexpr int term_set(bool a_bf16, bool b_bf16) {
  const bool a_lo = Splits<POL>::a_lo && !a_bf16, b_lo = Splits<POL>::b_lo && !b_bf16;
  return (a_lo ? T_LH : 0) | (b_lo ? T_HL : 0) | (POL == P_REFINE_AB && a_lo && b_lo ? T_LL : 0);
}

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

// ------------------------------------------------------- carried rungs

// Max over the whole block (every thread calls it; `red` holds 32 floats).
__device__ __forceinline__ float block_amax(float v, float* red) {
  for (int off = 16; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // earlier readers of red are done
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < (blockDim.x + 31) / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

// 2^ceil(log2(amax / qmax)), evaluated as exp(e ln 2) in f32 like the plain
// twins (core/precision.py:_pow2_scale).
__device__ __forceinline__ float pow2_scale(float amax, float qmax) {
  const float e = ceilf(log2f(__fdiv_rn(fmaxf(amax, 1e-30f), qmax)));
  return expf(e * 0.693147182464599609375f);
}

// Quantize-dequantize under scale s, as bf16 (exact for a pow2 s).
template <bool FP8>
__device__ __forceinline__ bf16 qdq(float x, float s) {
  const float y = __fdiv_rn(x, s);
  float q;
  if constexpr (FP8) q = float(__nv_fp8_e4m3(y));
  else q = fminf(fmaxf(rintf(y), -127.f), 127.f);
  return __float2bfloat16_rn(q * s);
}

// The terms of x under a carried rung: t[0] = hi, t[1] = lo / mid, t[2] = lo.
template <int POL>
__device__ __forceinline__ void carry_terms(float x, float s_hi, float s_lo, bf16 (&t)[3]) {
  if constexpr (POL == P_BF16X6) {
    t[0] = __float2bfloat16_rn(x);
    const float r1 = x - __bfloat162float(t[0]);
    t[1] = __float2bfloat16_rn(r1);
    t[2] = __float2bfloat16_rn(r1 - __bfloat162float(t[1]));
  } else {
    t[0] = qdq<Carried<POL>::fp8>(x, s_hi);
    if constexpr (Carried<POL>::x3) t[1] = qdq<Carried<POL>::fp8>(x - __bfloat162float(t[0]), s_lo);
  }
}

// The pow2 scales (hi, lo) of a staged f32 tile: amax over its rows x cols
// (ld apart; the block reduces), and for the x3 rungs the amax of the
// residual x - hi.  Every thread of the block calls it and gets both.
template <int POL>
__device__ __forceinline__ float2 tile_scales(const float* t, int rows, int cols, int ld,
                                              float* red) {
  if constexpr (!Carried<POL>::quant) {
    return make_float2(1.f, 1.f);
  } else {
    constexpr float qmax = Carried<POL>::fp8 ? 224.f : 127.f;
    float m = 0.f;
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x)
      m = fmaxf(m, fabsf(t[(i / cols) * ld + i % cols]));
    const float s_hi = pow2_scale(block_amax(m, red), qmax);
    float s_lo = 1.f;
    if constexpr (Carried<POL>::x3) {
      m = 0.f;
      for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
        const float x = t[(i / cols) * ld + i % cols];
        m = fmaxf(m, fabsf(x - __bfloat162float(qdq<Carried<POL>::fp8>(x, s_hi))));
      }
      s_lo = pow2_scale(block_amax(m, red), qmax);
    }
    return make_float2(s_hi, s_lo);
  }
}

// One f32 tile operand of fly_mma: element (i, j) of the fragment's 16 x 16
// block at p[i * ld + j] (ROW) or p[j * ld + i], with its scales.
struct FlyOp {
  const float* p;
  int ld;
  float2 s;
};

// One 16-deep step of a carried rung into (small, main): the lane makes the
// terms of 8 elements of A (16 x 16, element (i, k)) and of B (element (k,
// j)) and the warp loads them, term by term, through `scratch` (512 bf16,
// 32-byte aligned, the warp's own).  A_ROW / B_ROW: the f32 tiles are
// row-major along i / k (else transposed in place).
template <int POL, bool A_ROW, bool B_ROW>
__device__ __forceinline__ void fly_mma(FragC& small, FragC& main, FlyOp a, FlyOp b,
                                        bf16* scratch) {
  constexpr int T = Carried<POL>::terms;
  const int lane = threadIdx.x % 32, r = lane / 2, c0 = (lane % 2) * 8;
  bf16 ta[8][3], tb[8][3];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = c0 + e;
    carry_terms<POL>(A_ROW ? a.p[r * a.ld + c] : a.p[c * a.ld + r], a.s.x, a.s.y, ta[e]);
    carry_terms<POL>(B_ROW ? b.p[r * b.ld + c] : b.p[c * b.ld + r], b.s.x, b.s.y, tb[e]);
  }
  FragA<wmma::row_major> fa[T];
  FragB<wmma::row_major> fb[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      scratch[r * 16 + c0 + e] = ta[e][t];
      scratch[256 + r * 16 + c0 + e] = tb[e][t];
    }
    __syncwarp();
    wmma::load_matrix_sync(fa[t], scratch, 16);
    wmma::load_matrix_sync(fb[t], scratch + 256, 16);
    __syncwarp();
  }
  if constexpr (POL == P_BF16X6) {
    wmma::mma_sync(small, fa[2], fb[0], small);
    wmma::mma_sync(small, fa[0], fb[2], small);
    wmma::mma_sync(small, fa[1], fb[1], small);
  }
  if constexpr (T > 1) {
    wmma::mma_sync(small, fa[1], fb[0], small);
    wmma::mma_sync(small, fa[0], fb[1], small);
  }
  wmma::mma_sync(main, fa[0], fb[0], main);
}

// A launch split over CTAs along its long axis (gemm_splitk.cuh's K, the
// bf16 decode's KV walk, flash_common.cuh): the host's split count, the f32
// workspace for the splits' partials and one ticket per output tile, all
// zero between launches (kernels/gemm_tiled.py:split_workspace allocates
// them once per device and stream).  splits == 1 uses neither.
struct SplitWs {
  int splits;
  float* ws;
  long long ws_floats;
  int* tickets;
  int n_tickets;
};

// Raise `kern`'s dynamic shared-memory limit to `bytes` once per device
// (`ready`: one bit per device, the kernel's own), so that a launch does
// not pay for a cudaFuncSetAttribute call.
template <class K>
inline cudaError_t smem_once(std::atomic<unsigned long long>& ready, K kern, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (ready.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
  return err;
}

// Round a shared-memory section size up so every section starts 128-byte aligned
// (WMMA loads and stores need 256-bit aligned pointers).
__host__ __device__ constexpr size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

}  // namespace rt
