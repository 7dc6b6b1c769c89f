// Tiled tensor-core GEMM (WMMA) of the grouped GEMMs (gemm_grouped.cuh:
// every rung but the bf16 forward at 64/128-row tiles, bf16 and the
// refined rungs at 16-row tiles (gemm_splitk.cuh) and the bf16 dW):
// C = A.B, f32 out.  gemm_tiled.cu's bf16 rung and gemm_refined.cu's
// refine_a / bf16x3 / refine_ab run none of it: M > 16 takes a Hopper
// mainloop (gemm_sm90.cuh; the refined rungs' gemm_refined_sm90.cuh) and
// M <= 16 the split-K weight stream of gemm_splitk.cuh.  bf16x6 (a carried
// rung, common.cuh) stages f32 tiles and makes its terms per fragment; the
// fp8 / int8 rungs quantize each K step's A and B tiles on their way into
// shared memory, under the tile's pow2 scales (block reductions over the
// fetched registers), into bf16 hi (and lo) planes that bf16's one pass or
// bf16x3's three multiply; f32 multiplies the f32 tiles on the CUDA cores.
//
// A is (batch, M, K) and B is (batch, K, N), each f32 or bf16 with
// arbitrary element strides, so the router hands views (the unembed's
// transposed 262144x1152 table, a batched attention plan) without a
// copy.  Operands are rounded to bf16 (and split into hi/lo for the
// refined rungs of the grouped forward) on their way into shared memory,
// so f32 weights are never rewritten as bf16 in device memory.  Ragged
// edges are masked in the kernel: no operand is padded.
//
// One block computes a BM x BN tile of C, walking K in BK steps: the next
// K step's operands are fetched into registers while the tensor cores work
// on the current one out of shared memory (register double buffering).
// Global reads run along each operand's contiguous dimension, four
// elements (16 or 8 bytes) per thread where strides and alignment allow.
// Each warp owns a WM x WN sub-tile of 16x16 WMMA fragments; the bf16
// rung keeps one accumulator per fragment, the refined rungs two.
//
// The grouped GEMMs (gemm_grouped.cuh) run the same kernel in one of two
// group modes, reading `groups` from device memory:
//   G_ROWS  groups[blockIdx.y] is the group of the block's BM rows; B is
//           batch `group` (w[g], through the batch stride); a group id
//           of num_groups marks a dead tile, which stores zeros.
//   G_K     blockIdx.z is the group; groups holds the (num_groups + 1)
//           offsets, and the block contracts rows [groups[z],
//           groups[z + 1]) of A's K and B's K (an empty run stores 0).
//           The quantized rungs read the bf16 planes that the dW quantize
//           pass wrote (gemm_grouped_dw.cu: hi, and lo for x3, each tile
//           under its own pow2 scales) and stage them as they are, instead
//           of quantizing every staged tile under block-reduced scales.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace rt {

struct GemmArgs {
  const void* a;
  const void* b;
  float* c;
  long long sab, sam, sak;  // A strides in elements: batch, m, k
  long long sbb, sbk, sbn;  // B strides in elements: batch, k, n
  int a_bf16, b_bf16;
  int a_vec, b_vec;         // 4-wide loads along the contiguous dim are safe (make_args:
                            // A's only where K is contiguous; dW sets x^T's along M)
  int m, n, k;
  const int* groups;        // group modes only (see above)
  int num_groups;
  int q_int8;               // the P_FP8 / P_FP8X3 instantiations run int8 / int8x3
  const void* a_lo;         // G_K quantized rungs: A and B are the quantize pass's bf16 hi
  const void* b_lo;         // planes, these its lo planes (x3)
};

// The dW quantize pass's tiles: K runs of DW_SCALE_K rows (the WMMA
// kernel's BK), x^T's columns in 64s and dy's in 128s (its BM and BN).
// Group g's K tile t has slot groups[g] / DW_SCALE_K + g + t: the slots of
// one group never reach the next group's (a run of n rows spans at most
// n / DW_SCALE_K + 1 tiles past its first slot), so the scale buffer holds
// rows / DW_SCALE_K + num_groups + 1 slots of (x^T tiles, then dy tiles)
// (hi, lo) scale pairs.
constexpr int DW_SCALE_K = 32, DW_SCALE_D = 64, DW_SCALE_F = 128;

// The quantized rungs' planes run bf16x3's passes (x3: lo.hi + hi.lo,
// then hi.hi) or bf16's one; every other rung runs its own.
template <int POL> struct PlaneRung {
  static constexpr int value = !Carried<POL>::quant ? POL : (Carried<POL>::x3 ? P_BF16X3 : P_BF16);
};

__device__ __forceinline__ bf16 qdq_fmt(float x, float s, bool fp8) {
  return fp8 ? qdq<true>(x, s) : qdq<false>(x, s);
}

// hi = q(x) of a fetched tile held in the block's registers, under the
// tile's pow2 scale, as tile_scales takes it over a staged tile; returns
// the scale of the residual x - hi (x3 rungs, else 1).
template <int POL, int PER_T>
__device__ __forceinline__ float quant_hi(const float (&r)[PER_T], bf16 (&h)[PER_T], bool fp8,
                                          float* red) {
  const float qmax = fp8 ? 224.f : 127.f;
  float m = 0.f;
#pragma unroll
  for (int e = 0; e < PER_T; ++e) m = fmaxf(m, fabsf(r[e]));
  const float s_hi = pow2_scale(block_amax(m, red), qmax);
  m = 0.f;
#pragma unroll
  for (int e = 0; e < PER_T; ++e) {
    h[e] = qdq_fmt(r[e], s_hi, fp8);
    m = fmaxf(m, fabsf(r[e] - __bfloat162float(h[e])));
  }
  if constexpr (Carried<POL>::x3) return pow2_scale(block_amax(m, red), qmax);
  return 1.f;
}

enum GroupMode { G_NONE = 0, G_ROWS = 1, G_K = 2 };

// Fetch an OUTER x INNER tile whose INNER index is contiguous in global
// memory when `vec`, else strided by s_inner (zeros off the edge).
// Register r[e] holds element (o, i) of the tile as mapped here; stage()
// below uses the same mapping.
template <int OUTER, int INNER, int NT, int PER_T>
__device__ __forceinline__ void fetch_tile(float (&r)[PER_T], const char* base, int is_bf16,
                                           long long s_outer, long long s_inner, int o0, int i0,
                                           int n_outer, int n_inner, bool vec) {
  static_assert(PER_T == OUTER * INNER / NT && PER_T % 4 == 0, "tile/threads mismatch");
  if (vec) {
#pragma unroll
    for (int g = 0; g < PER_T / 4; ++g) {
      const int gi = threadIdx.x + g * NT;
      const int go = o0 + gi / (INNER / 4), gin = i0 + (gi % (INNER / 4)) * 4;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (go < n_outer && gin < n_inner) {
        const long long off = go * s_outer + gin;
        if (is_bf16) {
          const uint2 u = *reinterpret_cast<const uint2*>(base + off * 2);
          const __nv_bfloat162 p0 = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
          const __nv_bfloat162 p1 = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
          f = make_float4(__low2float(p0), __high2float(p0), __low2float(p1), __high2float(p1));
        } else {
          f = *reinterpret_cast<const float4*>(base + off * 4);
        }
      }
      r[g * 4 + 0] = f.x;
      r[g * 4 + 1] = f.y;
      r[g * 4 + 2] = f.z;
      r[g * 4 + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < PER_T; ++e) {
      const int ei = threadIdx.x + e * NT;
      const int go = o0 + ei / INNER, gin = i0 + ei % INNER;
      r[e] = (go < n_outer && gin < n_inner)
                 ? load_elem(base, go * s_outer + gin * s_inner, is_bf16) : 0.f;
    }
  }
}

// Hand each fetched element's place to store(smem index, register
// index): element (o, i) of the tile goes to o * ld_o + i * ld_i
// (fetch_tile's mapping).
template <int OUTER, int INNER, int NT, int PER_T, class Store>
__device__ __forceinline__ void stage_index(int ld_o, int ld_i, bool vec, Store store) {
  if (vec) {
#pragma unroll
    for (int g = 0; g < PER_T / 4; ++g) {
      const int gi = threadIdx.x + g * NT;
      const int o = gi / (INNER / 4), i = (gi % (INNER / 4)) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) store(o * ld_o + (i + j) * ld_i, g * 4 + j);
    }
  } else {
#pragma unroll
    for (int e = 0; e < PER_T; ++e) {
      const int ei = threadIdx.x + e * NT;
      store((ei / INNER) * ld_o + (ei % INNER) * ld_i, e);
    }
  }
}

// Hand each fetched element to store(smem index, value).
template <int OUTER, int INNER, int NT, int PER_T, class Store>
__device__ __forceinline__ void stage_each(const float (&r)[PER_T], int ld_o, int ld_i, bool vec,
                                           Store store) {
  stage_index<OUTER, INNER, NT, PER_T>(ld_o, ld_i, vec, [&](int i, int e) { store(i, r[e]); });
}

// Round (and split) a fetched tile into shared memory.
template <int OUTER, int INNER, int NT, int PER_T, bool WITH_LO>
__device__ __forceinline__ void stage_tile(const float (&r)[PER_T], bf16* hi, bf16* lo,
                                           int ld_o, int ld_i, bool vec) {
  stage_each<OUTER, INNER, NT>(r, ld_o, ld_i, vec,
                               [&](int i, float x) { store_split<WITH_LO>(hi, lo, i, x); });
}

// Quantize a fetched tile into the hi plane (and, for x3, lo = q(x - hi)
// under the residual's scale into the lo plane).
template <int OUTER, int INNER, int NT, int PER_T, int POL>
__device__ __forceinline__ void stage_quant(const float (&r)[PER_T], bool fp8, float* red,
                                            bf16* hi, bf16* lo, int ld_o, int ld_i, bool vec) {
  bf16 h[PER_T];
  const float s_lo = quant_hi<POL>(r, h, fp8, red);
  stage_index<OUTER, INNER, NT, PER_T>(ld_o, ld_i, vec, [&](int i, int e) {
    hi[i] = h[e];
    if constexpr (Carried<POL>::x3) lo[i] = qdq_fmt(r[e] - __bfloat162float(h[e]), s_lo, fp8);
  });
}

template <int BM_, int BN_, int BK_, int WM, int WN, bool B_KMAJOR>
struct GemmTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int NWARPS = (BM / WM) * (BN / WN);
  static constexpr int NT = NWARPS * 32;
  static constexpr int LDA = BK + 8;                      // A tile [BM][LDA]
  static constexpr int LDB = B_KMAJOR ? BK + 8 : BN + 8;  // [BN][BK+8] or [BK][BN+8]
  static constexpr int A_PER_T = BM * BK / NT;
  static constexpr int B_PER_T = BK * BN / NT;
  static constexpr size_t a_bytes = align128(BM * LDA * sizeof(bf16));
  static constexpr size_t b_bytes = align128((B_KMAJOR ? BN : BK) * LDB * sizeof(bf16));
  // A and B planes (or f32 tiles), the per-warp epilogue / term scratch,
  // 32 floats for the quantized rungs' block reductions
  static constexpr size_t smem = 2 * a_bytes + 2 * b_bytes + NWARPS * 256 * sizeof(float) + 128;
};

// One K step of both operands into registers, then into shared memory.
template <class T, bool B_KMAJOR>
__device__ __forceinline__ void fetch_ab(float (&ra)[T::A_PER_T], float (&rb)[T::B_PER_T],
                                         const GemmArgs& g, const char* a_base,
                                         const char* b_base, int m0, int n0, int k0,
                                         bool a_kcontig) {
  if (a_kcontig)
    fetch_tile<T::BM, T::BK, T::NT>(ra, a_base, g.a_bf16, g.sam, g.sak, m0, k0, g.m, g.k, g.a_vec);
  else
    fetch_tile<T::BK, T::BM, T::NT>(ra, a_base, g.a_bf16, g.sak, g.sam, k0, m0, g.k, g.m,
                                     g.a_vec);
  if constexpr (B_KMAJOR)
    fetch_tile<T::BN, T::BK, T::NT>(rb, b_base, g.b_bf16, g.sbn, g.sbk, n0, k0, g.n, g.k, g.b_vec);
  else
    fetch_tile<T::BK, T::BN, T::NT>(rb, b_base, g.b_bf16, g.sbk, g.sbn, k0, n0, g.k, g.n, g.b_vec);
}

template <class T, bool B_KMAJOR, int POL>
__device__ __forceinline__ void stage_ab(const float (&ra)[T::A_PER_T],
                                         const float (&rb)[T::B_PER_T], bf16* a_hi, bf16* a_lo,
                                         bf16* b_hi, bf16* b_lo, const GemmArgs& g,
                                         bool a_kcontig, float* red) {
  if constexpr (Carried<POL>::quant) {
    const bool fp8 = !g.q_int8;
    if (a_kcontig)
      stage_quant<T::BM, T::BK, T::NT, T::A_PER_T, POL>(ra, fp8, red, a_hi, a_lo, T::LDA, 1,
                                                         g.a_vec);
    else
      stage_quant<T::BK, T::BM, T::NT, T::A_PER_T, POL>(ra, fp8, red, a_hi, a_lo, 1, T::LDA,
                                                         g.a_vec);
    stage_quant<B_KMAJOR ? T::BN : T::BK, B_KMAJOR ? T::BK : T::BN, T::NT, T::B_PER_T, POL>(
        rb, fp8, red, b_hi, b_lo, T::LDB, 1, g.b_vec);
    return;
  }
  if constexpr (POL == P_F32 || POL == P_BF16X6) {  // f32 tiles over both planes
    float* af = reinterpret_cast<float*>(a_hi);
    float* bf = reinterpret_cast<float*>(b_hi);
    auto put_a = [&](int i, float x) { af[i] = x; };
    if (a_kcontig) stage_each<T::BM, T::BK, T::NT>(ra, T::LDA, 1, g.a_vec, put_a);
    else stage_each<T::BK, T::BM, T::NT>(ra, 1, T::LDA, g.a_vec, put_a);
    stage_each<B_KMAJOR ? T::BN : T::BK, B_KMAJOR ? T::BK : T::BN, T::NT>(
        rb, T::LDB, 1, g.b_vec, [&](int i, float x) { bf[i] = x; });
    return;
  }
  if (a_kcontig)
    stage_tile<T::BM, T::BK, T::NT, T::A_PER_T, Splits<POL>::a_lo>(ra, a_hi, a_lo, T::LDA, 1,
                                                                  g.a_vec);
  else
    stage_tile<T::BK, T::BM, T::NT, T::A_PER_T, Splits<POL>::a_lo>(ra, a_hi, a_lo, 1, T::LDA,
                                                                  g.a_vec);
  stage_tile<B_KMAJOR ? T::BN : T::BK, B_KMAJOR ? T::BK : T::BN, T::NT, T::B_PER_T,
             Splits<POL>::b_lo>(rb, b_hi, b_lo, T::LDB, 1, g.b_vec);
}

// The dW quantize pass's planes, fetched as bf16 values (hi in ra / rb,
// lo in ra_lo / rb_lo for x3), into the shared planes as they are.
template <class T, bool B_KMAJOR, bool X3>
__device__ __forceinline__ void stage_planes(const float (&ra)[T::A_PER_T],
                                             const float (&rb)[T::B_PER_T],
                                             const float (&ra_lo)[T::A_PER_T],
                                             const float (&rb_lo)[T::B_PER_T], bf16* a_hi,
                                             bf16* a_lo, bf16* b_hi, bf16* b_lo,
                                             const GemmArgs& g, bool a_kcontig) {
  constexpr int BO = B_KMAJOR ? T::BN : T::BK, BI = B_KMAJOR ? T::BK : T::BN;
  if (a_kcontig) {
    stage_tile<T::BM, T::BK, T::NT, T::A_PER_T, false>(ra, a_hi, nullptr, T::LDA, 1, g.a_vec);
    if constexpr (X3)
      stage_tile<T::BM, T::BK, T::NT, T::A_PER_T, false>(ra_lo, a_lo, nullptr, T::LDA, 1, g.a_vec);
  } else {
    stage_tile<T::BK, T::BM, T::NT, T::A_PER_T, false>(ra, a_hi, nullptr, 1, T::LDA, g.a_vec);
    if constexpr (X3)
      stage_tile<T::BK, T::BM, T::NT, T::A_PER_T, false>(ra_lo, a_lo, nullptr, 1, T::LDA, g.a_vec);
  }
  stage_tile<BO, BI, T::NT, T::B_PER_T, false>(rb, b_hi, nullptr, T::LDB, 1, g.b_vec);
  if constexpr (X3)
    stage_tile<BO, BI, T::NT, T::B_PER_T, false>(rb_lo, b_lo, nullptr, T::LDB, 1, g.b_vec);
}

template <int BM, int BN, int BK, int WM, int WN, bool B_KMAJOR, int POL, int MODE = G_NONE>
__global__ void __launch_bounds__(GemmTile<BM, BN, BK, WM, WN, B_KMAJOR>::NT)
gemm_kernel(GemmArgs g) {
  using T = GemmTile<BM, BN, BK, WM, WN, B_KMAJOR>;
  using LayoutB = typename std::conditional<B_KMAJOR, wmma::col_major, wmma::row_major>::type;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int PR = PlaneRung<POL>::value;
  constexpr bool SPLIT = PR != P_BF16;    // refined rungs keep a second accumulator

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_hi = reinterpret_cast<bf16*>(smem);
  bf16* a_lo = reinterpret_cast<bf16*>(smem + T::a_bytes);
  bf16* b_hi = reinterpret_cast<bf16*>(smem + 2 * T::a_bytes);
  bf16* b_lo = reinterpret_cast<bf16*>(smem + 2 * T::a_bytes + T::b_bytes);
  float* scratch = reinterpret_cast<float*>(smem + 2 * T::a_bytes + 2 * T::b_bytes);
  float* red = scratch + T::NWARPS * 256;
  const float* af = reinterpret_cast<const float*>(a_hi);  // f32 and bf16x6
  const float* bf = reinterpret_cast<const float*>(b_hi);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long bz = blockIdx.z;
  long long a_off = bz * g.sab, b_off = bz * g.sbb;
  if constexpr (MODE == G_ROWS) {
    const int gid = g.groups[blockIdx.y];
    if (gid >= g.num_groups) {  // dead tile: zeros, no tensor-core work
      for (int e = threadIdx.x; e < BM * BN; e += T::NT) {
        const int gm = m0 + e / BN, gn = n0 + e % BN;
        if (gm < g.m && gn < g.n) g.c[(long long)gm * g.n + gn] = 0.f;
      }
      return;
    }
    b_off = gid * g.sbb;
  }
  if constexpr (MODE == G_K) {
    const int k0 = g.groups[blockIdx.z];
    g.k = g.groups[blockIdx.z + 1] - k0;
    a_off = k0 * g.sak;
    b_off = k0 * g.sbk;
  }
  const bool a_kcontig = g.sak == 1;
  const char* a_base = static_cast<const char*>(g.a) + a_off * (g.a_bf16 ? 2 : 4);
  const char* b_base = static_cast<const char*>(g.b) + b_off * (g.b_bf16 ? 2 : 4);

  float ra[T::A_PER_T], rb[T::B_PER_T];
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  constexpr int FE = POL == P_F32 ? WM * WN / 32 : 1;  // f32: outputs per lane, CUDA cores
  float facc[FE];
#pragma unroll
  for (int e = 0; e < FE; ++e) facc[e] = 0.f;
  const float2 unit = make_float2(1.f, 1.f);  // bf16x6 takes no scales
  bf16* fly_scr = reinterpret_cast<bf16*>(scratch + warp * 256);
  FragC main[FM][FN];
  FragC small[SPLIT ? FM : 1][SPLIT ? FN : 1];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::fill_fragment(main[i][j], 0.f);
      if constexpr (SPLIT) wmma::fill_fragment(small[i][j], 0.f);
    }

  // G_K's quantized rungs on the quantize pass's planes: A and B are the
  // hi planes, a_lo / b_lo the lo planes (x3)
  constexpr bool PLANES = MODE == G_K && Carried<POL>::quant;
  constexpr bool X3 = Carried<POL>::x3;
  float ra_lo[PLANES ? T::A_PER_T : 1], rb_lo[PLANES ? T::B_PER_T : 1];
  const char* a_lo_base = PLANES ? static_cast<const char*>(g.a_lo) + a_off * 2 : nullptr;
  const char* b_lo_base = PLANES ? static_cast<const char*>(g.b_lo) + b_off * 2 : nullptr;
  auto fetch = [&](int k0) {
    fetch_ab<T, B_KMAJOR>(ra, rb, g, a_base, b_base, m0, n0, k0, a_kcontig);
    if constexpr (PLANES && X3)
      fetch_ab<T, B_KMAJOR>(ra_lo, rb_lo, g, a_lo_base, b_lo_base, m0, n0, k0, a_kcontig);
  };

  const int nk = (g.k + BK - 1) / BK;
  fetch(0);
  for (int t = 0; t < nk; ++t) {
    if constexpr (PLANES)
      stage_planes<T, B_KMAJOR, X3>(ra, rb, ra_lo, rb_lo, a_hi, a_lo, b_hi, b_lo, g, a_kcontig);
    else
      stage_ab<T, B_KMAJOR, POL>(ra, rb, a_hi, a_lo, b_hi, b_lo, g, a_kcontig, red);
    __syncthreads();
    if (t + 1 < nk) fetch((t + 1) * BK);
    if constexpr (POL == P_F32) {
      const int c = wn * WN + lane % WN;
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        const float bv = B_KMAJOR ? bf[c * T::LDB + kk] : bf[kk * T::LDB + c];
#pragma unroll
        for (int e = 0; e < FE; ++e) {
          const int r = wm * WM + (lane + 32 * e) / WN;
          facc[e] = fmaf(af[r * T::LDA + kk], bv, facc[e]);
        }
      }
      __syncthreads();
      continue;
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int ao = (wm * WM + i * 16) * T::LDA + kk;
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          const int nc = wn * WN + j * 16;
          const int bo = B_KMAJOR ? nc * T::LDB + kk : kk * T::LDB + nc;
          if constexpr (POL == P_BF16X6)
            fly_mma<POL, true, !B_KMAJOR>(small[i][j], main[i][j], FlyOp{af + ao, T::LDA, unit},
                                          FlyOp{bf + bo, T::LDB, unit}, fly_scr);
          else
            policy_mma<PR, LayoutB>(small[SPLIT ? i : 0][SPLIT ? j : 0], main[i][j], a_hi + ao,
                                    a_lo + ao, T::LDA, b_hi + bo, b_lo + bo, T::LDB);
        }
      }
    }
    __syncthreads();
  }

  // Epilogue: small terms + leading term, staged per warp, masked store
  // (f32: each lane's outputs straight from registers).
  float* ws = scratch + warp * 256;
  float* c_base = g.c + bz * (long long)g.m * g.n;
  if constexpr (POL == P_F32) {
#pragma unroll
    for (int e = 0; e < FE; ++e) {
      const int idx = lane + 32 * e;
      const int gm = m0 + wm * WM + idx / WN, gn = n0 + wn * WN + idx % WN;
      if (gm < g.m && gn < g.n) c_base[(long long)gm * g.n + gn] = facc[e];
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      if constexpr (SPLIT) {
#pragma unroll
        for (int e = 0; e < main[i][j].num_elements; ++e)
          main[i][j].x[e] = small[i][j].x[e] + main[i][j].x[e];
      }
      wmma::store_matrix_sync(ws, main[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = m0 + wm * WM + i * 16, c0 = n0 + wn * WN + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int gm = r0 + e / 16, gn = c0 + e % 16;
        if (gm < g.m && gn < g.n) c_base[(long long)gm * g.n + gn] = ws[e];
      }
      __syncwarp();
    }
}

template <int BM, int BN, int BK, int WM, int WN, bool B_KMAJOR, int POL, int MODE = G_NONE>
int run_gemm(const GemmArgs& g, int batch, cudaStream_t stream) {
  using T = GemmTile<BM, BN, BK, WM, WN, B_KMAJOR>;
  auto kern = gemm_kernel<BM, BN, BK, WM, WN, B_KMAJOR, POL, MODE>;
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t err = smem_once(ready, kern, T::smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g.n + BN - 1) / BN, (g.m + BM - 1) / BM, batch);
  kern<<<grid, T::NT, T::smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace rt

#include "gemm_sm90.cuh"
#include "gemm_splitk.cuh"

namespace rt {

// Mainloop ids reported to the wrappers (LAUNCHES_BY_LOOP).
enum Mainloop { LOOP_WMMA = 0, LOOP_SM90 = 1, LOOP_SPLITK = 2 };

// The bf16 rung (gemm_tiled.cu) runs the Hopper mainloop at M > 16
// (gemm_sm90.cuh: BM 64 up to 64 rows, else 128) and the split-K weight
// stream at M <= 16 (gemm_splitk.cuh, split `split->splits` ways).  A
// template, so that only gemm_tiled.cu compiles their kernels.
template <int POL>
int dispatch_gemm(const GemmArgs& g, int batch, cudaStream_t stream, int* loop,
                  const SplitWs* split) {
  static_assert(POL == P_BF16, "the bf16 rung; the refined rungs: gemm_refined_sm90.cuh");
  if (g.m > 16) {
    if (loop != nullptr) *loop = LOOP_SM90;
    return sm90::run<G_NONE>(g, batch, g.m <= 64 ? 64 : 128, stream);
  }
  if (split == nullptr) return (int)cudaErrorInvalidValue;
  if (loop != nullptr) *loop = LOOP_SPLITK;
  return splitk::run<POL>(g, batch, *split, stream);
}

// Whether an operand can be read four elements at a time along the
// dimension whose stride is `s_contig` (== 1), given its other strides,
// that dimension's extent and the base address.
inline bool vec4_ok(const void* p, int bf16, long long s_contig, long long s_other,
                    long long s_batch, int extent) {
  const unsigned long long align = bf16 ? 8 : 16;
  return s_contig == 1 && extent % 4 == 0 && s_other % 4 == 0 && s_batch % 4 == 0 &&
         reinterpret_cast<unsigned long long>(p) % align == 0;
}

inline GemmArgs make_args(const void* a, int a_bf16, long long sab, long long sam, long long sak,
                          const void* b, int b_bf16, long long sbb, long long sbk, long long sbn,
                          float* c, int m, int n, int k) {
  GemmArgs g;
  g.a = a; g.b = b; g.c = c;
  g.sab = sab; g.sam = sam; g.sak = sak;
  g.sbb = sbb; g.sbk = sbk; g.sbn = sbn;
  g.a_bf16 = a_bf16; g.b_bf16 = b_bf16;
  g.m = m; g.n = n; g.k = k;
  g.groups = nullptr; g.num_groups = 0;
  g.q_int8 = 0;
  g.a_lo = g.b_lo = nullptr;
  g.a_vec = vec4_ok(a, a_bf16, sak, sam, sab, k);
  g.b_vec = sbk < sbn ? vec4_ok(b, b_bf16, sbk, sbn, sbb, k) : vec4_ok(b, b_bf16, sbn, sbk, sbb, n);
  return g;
}

}  // namespace rt
