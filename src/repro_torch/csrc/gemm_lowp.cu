// Quantized GEMM with per-tile scales, the ladder's fp8 / int8 rungs below
// bf16: C = A.B, f32 in, f32 out, one pass (fp8, int8) or three
// error-corrected passes (fp8x3, int8x3: lo.hi + hi.lo + hi.hi).
//
// Replaces the TPU kernel kernels/gemm_lowp.py:_lowp_kernel with
// _quant_tile (pallas_call at gemm_lowp.py:125).  A is quantized per
// (bm, bk) tile and B per (bk, bn) tile of a grid anchored at 0 (the
// ragged last tile is masked, which is what the TPU kernel's zero padding
// computes).  Within a tile: s = amax / qmax (127 for int8, 448 for
// e4m3), y = x / s; int8 takes rint (half to even) and clips to +-127,
// e4m3 clips to +-448 and rounds to nearest even in the cast.  The x3
// rungs quantize the residual x - q*s under its own tile scale.  The
// products of one quantization K-tile are summed exactly (int8) or in f32
// (e4m3) in one accumulator per pass and dequantized into the f32 result
// at each bk boundary:
//   acc += (P_lohi * (sra*sb) + P_hilo * (sa*srb)) + P_hihi * (sa*sb)
// in that order, every operation rounded on its own (__fmul_rn, __fadd_rn:
// nvcc would otherwise contract them into FMAs, and so the residual too).
//
// Two kernels: a scale pass writes the small per-tile scale planes (and the
// residuals' for x3), then the GEMM quantizes each operand tile on its way
// into shared memory (gemm_common.cuh's fetch, 4-wide where aligned).  Quantized values ride bf16 carriers through WMMA
// (int8 and e4m3 values fit bf16's significand, so the products are exact
// in f32), the CTA's M/N tile nests inside one quantization tile, and its
// K walk keeps one partial per pass and flushes it, scaled, at the
// quantization K-tile's end.  Native e4m3 / s8 MMA comes later.
#include <cuda_fp8.h>

#include "gemm_common.cuh"

namespace rt {

constexpr int LOWP_NT = 256;

template <bool FP8>
__device__ __forceinline__ float quant(float x, float s) {
  const float y = __fdiv_rn(x, s);
  if constexpr (FP8) {
    const float c = fminf(fmaxf(y, -448.f), 448.f);
    const __nv_fp8_storage_t v = __nv_cvt_float_to_fp8(c, __NV_SATFINITE, __NV_E4M3);
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(v, __NV_E4M3)));
  } else {
    return fminf(fmaxf(rintf(y), -127.f), 127.f);
  }
}

// x - q*s, each operation rounded
__device__ __forceinline__ float residual(float x, float q, float s) {
  return __fsub_rn(x, __fmul_rn(q, s));
}

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red is reused
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < LOWP_NT / 32; ++w) v = fmaxf(v, red[w]);
  return v;
}

// One block per (tr, tc) tile of x (batch, R, C), row-major: s = amax/qmax
// and, for x3, the residual's scale.  Planes are (batch, nt_r, nt_c).
template <bool FP8, bool X3>
__global__ void __launch_bounds__(LOWP_NT)
lowp_scale_kernel(const float* x, int R, int C, int tr, int tc, float* s, float* sr) {
  __shared__ float red[LOWP_NT / 32];
  const int nt_c = gridDim.x, nt_r = gridDim.y;
  const int r0 = blockIdx.y * tr, c0 = blockIdx.x * tc;
  const int w = min(C, c0 + tc) - c0, n = (min(R, r0 + tr) - r0) * w;
  const float* xb = x + (long long)blockIdx.z * R * C + (long long)r0 * C + c0;
  const float qmax = FP8 ? 448.f : 127.f;
  float amax = 0.f;
  for (int i = threadIdx.x; i < n; i += LOWP_NT) amax = fmaxf(amax, fabsf(xb[(long long)(i / w) * C + i % w]));
  const float sc = __fdiv_rn(fmaxf(block_max(amax, red), 1e-30f), qmax);
  const long long si = ((long long)blockIdx.z * nt_r + blockIdx.y) * nt_c + blockIdx.x;
  if (threadIdx.x == 0) s[si] = sc;
  if constexpr (X3) {
    float ramax = 0.f;
    for (int i = threadIdx.x; i < n; i += LOWP_NT) {
      const float v = xb[(long long)(i / w) * C + i % w];
      ramax = fmaxf(ramax, fabsf(residual(v, quant<FP8>(v, sc), sc)));
    }
    const float rs = __fdiv_rn(fmaxf(block_max(ramax, red), 1e-30f), qmax);
    if (threadIdx.x == 0) sr[si] = rs;
  }
}

struct LowpArgs {
  const float* a;    // (batch, m, k) row-major
  const float* b;    // (batch, k, n) row-major
  float* c;          // (batch, m, n)
  const float* sa;   // (batch, mt, kt) tile scales of A, sra its residual's
  const float* sra;
  const float* sb;   // (batch, kt, nt) tile scales of B, srb its residual's
  const float* srb;
  int m, n, k;
  int bm, bn, bk;    // the quantization grid
  int mt, nt, kt;    // its tile counts
  int a_vec, b_vec;  // 4-wide loads are safe (fetch_tile)
};

template <int BM, int BN, int BK, int WM, int WN>
struct LowpTile {
  static constexpr int NWARPS = (BM / WM) * (BN / WN);
  static constexpr int NT = NWARPS * 32;
  static constexpr int LDA = BK + 8;  // A tile [BM][LDA]
  static constexpr int LDB = BN + 8;  // B tile [BK][LDB]
  static constexpr int A_PER_T = BM * BK / NT;
  static constexpr int B_PER_T = BK * BN / NT;
  static constexpr size_t a_bytes = align128(BM * LDA * sizeof(bf16));
  static constexpr size_t b_bytes = align128(BK * LDB * sizeof(bf16));
  static constexpr size_t smem = 2 * a_bytes + 2 * b_bytes + NWARPS * 256 * sizeof(float);
};

// Quantize a fetched tile under (s, sr) into bf16 carriers of the exact
// quantized values: hi, and the residual's lo for x3.
template <int OUTER, int INNER, int NT, int PER_T, bool FP8, bool X3>
__device__ __forceinline__ void lowp_stage(const float (&r)[PER_T], bf16* hi, bf16* lo, int ld,
                                           bool vec, float s, float sr) {
  stage_each<OUTER, INNER, NT>(r, ld, 1, vec, [&](int i, float x) {
    const float q = quant<FP8>(x, s);
    hi[i] = __float2bfloat16_rn(q);
    if constexpr (X3) lo[i] = __float2bfloat16_rn(quant<FP8>(residual(x, q, s), sr));
  });
}

template <int BM, int BN, int BK, int WM, int WN, bool FP8, bool X3>
__global__ void __launch_bounds__(LowpTile<BM, BN, BK, WM, WN>::NT) lowp_gemm_kernel(LowpArgs g) {
  using T = LowpTile<BM, BN, BK, WM, WN>;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int NP = X3 ? 3 : 1;  // partials: hi.hi, and lo.hi, hi.lo for x3

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_hi = reinterpret_cast<bf16*>(smem);
  bf16* a_lo = reinterpret_cast<bf16*>(smem + T::a_bytes);
  bf16* b_hi = reinterpret_cast<bf16*>(smem + 2 * T::a_bytes);
  bf16* b_lo = reinterpret_cast<bf16*>(smem + 2 * T::a_bytes + T::b_bytes);
  float* scratch = reinterpret_cast<float*>(smem + 2 * T::a_bytes + 2 * T::b_bytes);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long bz = blockIdx.z;
  const float* a = g.a + bz * g.m * g.k;
  const float* b = g.b + bz * g.k * g.n;
  // the quantization tile this CTA's rows and columns nest in
  const int ti = m0 / g.bm, tj = n0 / g.bn;
  const float* sa = g.sa + (bz * g.mt + ti) * g.kt;
  const float* sra = g.sra + (bz * g.mt + ti) * g.kt;
  const float* sb = g.sb + bz * g.kt * g.nt + tj;
  const float* srb = g.srb + bz * g.kt * g.nt + tj;

  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  FragC acc[FM][FN], part[NP][FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll
      for (int p = 0; p < NP; ++p) wmma::fill_fragment(part[p][i][j], 0.f);
    }

  float ra[T::A_PER_T], rb[T::B_PER_T];
  const char* a_base = reinterpret_cast<const char*>(a);
  const char* b_base = reinterpret_cast<const char*>(b);
  const int nk = (g.k + BK - 1) / BK;
  fetch_tile<BM, BK, T::NT>(ra, a_base, 0, g.k, 1, m0, 0, g.m, g.k, g.a_vec);
  fetch_tile<BK, BN, T::NT>(rb, b_base, 0, g.n, 1, 0, n0, g.k, g.n, g.b_vec);
  for (int t = 0; t < nk; ++t) {
    const int kq = t * BK / g.bk;
    const float s_a = sa[kq], s_b = sb[(long long)kq * g.nt];
    const float s_ra = X3 ? sra[kq] : 0.f, s_rb = X3 ? srb[(long long)kq * g.nt] : 0.f;
    lowp_stage<BM, BK, T::NT, T::A_PER_T, FP8, X3>(ra, a_hi, a_lo, T::LDA, g.a_vec, s_a, s_ra);
    lowp_stage<BK, BN, T::NT, T::B_PER_T, FP8, X3>(rb, b_hi, b_lo, T::LDB, g.b_vec, s_b, s_rb);
    __syncthreads();
    if (t + 1 < nk) {
      fetch_tile<BM, BK, T::NT>(ra, a_base, 0, g.k, 1, m0, (t + 1) * BK, g.m, g.k, g.a_vec);
      fetch_tile<BK, BN, T::NT>(rb, b_base, 0, g.n, 1, (t + 1) * BK, n0, g.k, g.n, g.b_vec);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int ao = (wm * WM + i * 16) * T::LDA + kk;
        FragA<> ahi, alo;
        wmma::load_matrix_sync(ahi, a_hi + ao, T::LDA);
        if constexpr (X3) wmma::load_matrix_sync(alo, a_lo + ao, T::LDA);
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          const int bo = kk * T::LDB + wn * WN + j * 16;
          FragB<wmma::row_major> bhi, blo;
          wmma::load_matrix_sync(bhi, b_hi + bo, T::LDB);
          if constexpr (X3) {
            wmma::load_matrix_sync(blo, b_lo + bo, T::LDB);
            wmma::mma_sync(part[1][i][j], alo, bhi, part[1][i][j]);
            wmma::mma_sync(part[2][i][j], ahi, blo, part[2][i][j]);
          }
          wmma::mma_sync(part[0][i][j], ahi, bhi, part[0][i][j]);
        }
      }
    }
    // the quantization K-tile ends: dequantize its partials into acc
    if ((t + 1) * BK % g.bk == 0 || t + 1 == nk) {
      const float c_hh = __fmul_rn(s_a, s_b);
      const float c_lh = __fmul_rn(s_ra, s_b), c_hl = __fmul_rn(s_a, s_rb);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) {
#pragma unroll
          for (int e = 0; e < acc[i][j].num_elements; ++e) {
            float u = __fmul_rn(part[0][i][j].x[e], c_hh);
            if constexpr (X3)
              u = __fadd_rn(__fadd_rn(__fmul_rn(part[1][i][j].x[e], c_lh),
                                      __fmul_rn(part[2][i][j].x[e], c_hl)), u);
            acc[i][j].x[e] = __fadd_rn(acc[i][j].x[e], u);
          }
#pragma unroll
          for (int p = 0; p < NP; ++p) wmma::fill_fragment(part[p][i][j], 0.f);
        }
    }
    __syncthreads();
  }

  float* ws = scratch + warp * 256;
  float* c_base = g.c + bz * (long long)g.m * g.n;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(ws, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = m0 + wm * WM + i * 16, c0 = n0 + wn * WN + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int gm = r0 + e / 16, gn = c0 + e % 16;
        if (gm < g.m && gn < g.n) c_base[(long long)gm * g.n + gn] = ws[e];
      }
      __syncwarp();
    }
}

template <bool FP8, bool X3>
int run_scales(const float* x, int batch, int R, int C, int tr, int tc, float* s, float* sr,
               cudaStream_t stream) {
  dim3 grid((C + tc - 1) / tc, (R + tr - 1) / tr, batch);
  lowp_scale_kernel<FP8, X3><<<grid, LOWP_NT, 0, stream>>>(x, R, C, tr, tc, s, sr);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int BK, int WM, int WN, bool FP8, bool X3>
int run_lowp(const LowpArgs& g, int batch, cudaStream_t stream) {
  using T = LowpTile<BM, BN, BK, WM, WN>;
  // every CTA tile must nest in one quantization tile
  if ((g.bm < g.m && g.bm % BM) || (g.bn < g.n && g.bn % BN) || (g.bk < g.k && g.bk % BK))
    return (int)cudaErrorInvalidValue;
  int err = run_scales<FP8, X3>(g.a, batch, g.m, g.k, g.bm, g.bk, const_cast<float*>(g.sa),
                            const_cast<float*>(g.sra), stream);
  if (err) return err;
  err = run_scales<FP8, X3>(g.b, batch, g.k, g.n, g.bk, g.bn, const_cast<float*>(g.sb),
                            const_cast<float*>(g.srb), stream);
  if (err) return err;
  auto kern = lowp_gemm_kernel<BM, BN, BK, WM, WN, FP8, X3>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)T::smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((g.n + BN - 1) / BN, (g.m + BM - 1) / BM, batch);
  kern<<<grid, T::NT, T::smem, stream>>>(g);
  return (int)cudaGetLastError();
}

// A 16-row tile for decode (M <= 16: a weight stream), 64 x 128 otherwise.
template <bool FP8, bool X3>
int dispatch_lowp(const LowpArgs& g, int batch, cudaStream_t stream) {
  if (g.m <= 16) return run_lowp<16, 128, 64, 16, 16, FP8, X3>(g, batch, stream);
  return run_lowp<64, 128, 32, 32, 32, FP8, X3>(g, batch, stream);
}

}  // namespace rt

// policy: 0 int8, 1 fp8, 2 int8x3, 3 fp8x3.  The scale planes are written
// here: sa/sra (batch, mt, kt) and sb/srb (batch, kt, nt); the one-pass
// rungs leave sra/srb untouched.
extern "C" int gemm_lowp_launch(const float* a, const float* b, float* c, float* sa, float* sra,
                                float* sb, float* srb, int batch, int m, int n, int k, int bm,
                                int bn, int bk, int policy, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  rt::LowpArgs g{a, b, c, sa, sra, sb, srb, m, n, k, bm, bn, bk,
                 (m + bm - 1) / bm, (n + bn - 1) / bn, (k + bk - 1) / bk,
                 rt::vec4_ok(a, 0, 1, k, (long long)m * k, k),
                 rt::vec4_ok(b, 0, 1, n, (long long)k * n, n)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (policy) {
    case 0: return rt::dispatch_lowp<false, false>(g, batch, s);
    case 1: return rt::dispatch_lowp<true, false>(g, batch, s);
    case 2: return rt::dispatch_lowp<false, true>(g, batch, s);
    case 3: return rt::dispatch_lowp<true, true>(g, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
