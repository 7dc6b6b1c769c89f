// The weight-stream loop for M <= 16 rows (decode): K split over CTAs
// until the card is full, the partials summed inside the same launch.
// Included by gemm_common.cuh; gemm_tiled's bf16 rung (dispatch_gemm) and
// gemm_refined's refine_a / bf16x3 / refine_ab (gemm_refined_sm90.cuh's
// dispatch) send every launch with m <= 16 here, and the grouped forward
// and dx at those rungs every launch at a 16-row CTA tile (gemm_grouped.cuh,
// the group-rows mode below).
//
// C = A.B with A (batch, m, k), m <= 16 (the activations), and B (batch, k,
// n) (the weights: N-contiguous NN, or the K-contiguous NT unembed table),
// each f32 or bf16, any strides.  At decode the product is a weight stream:
// bytes bound it (4 x 6912 x 1152 against f32 weights moves 32 MB, 9.5 us
// at 3.35 TB/s) and the tensor cores idle.  What decides the time is how
// many bytes are in flight across the card: the WMMA skinny tile this loop
// replaces ran ceil(N / 128) CTAs (9 for the MLP down projection), each
// walking all of K with one register-held prefetch (0.14 ms for those 32
// MB on an H100 80GB HBM3 at 700 W, PERF.md).
//
// Grid (N tiles of BN = 64, K splits, batch).  The host picks the split
// count (kernels/gemm_tiled.py:splitk_splits): one when the N tiles alone
// give twice the SM count, else enough splits of at least four K tiles
// (BK = 64 rows each) to reach it, none empty.  Split s walks K tiles
// [s * per, min((s + 1) * per, kt)) with per = ceil(kt / splits).
//
// A CTA of four warps streams its B slice (64 columns by 64 K rows a tile:
// 16 KB of f32) and the matching A tile through a ring of STAGES = 3
// shared-memory stages filled by 16-byte cp.async copies of the operands as
// stored (f32 or bf16): up to 69 KB of shared memory, so three CTAs share an
// SM (96 KB of f32 weights in flight) and a grid of 2-3x the SM count runs
// in one wave.  An operand whose contiguous dimension, strides or base do not
// allow 16-byte chunks is staged by plain element loads instead (correct,
// slower; not on the serve paths).  Each warp owns 16 of the tile's weight
// columns and runs mma.sync m16n8k16 with the operands swapped, C^T =
// B^T.A^T: the 16 weight columns are the MMA's rows and the <= 16 rows of
// A its n (one n8 block up to 8 rows, two above).  Operands are rounded to
// bf16 (__floats2bfloat162_rn, torch's `.to(torch.bfloat16)`) on their way
// from shared memory into fragments; the accumulators are f32.  The
// shared-memory rows are padded so that each fragment load is free of bank
// conflicts in both B layouts.
//
// The refined rungs (template argument TS, common.cuh's term set) split an
// f32 operand's fragments into hi and lo in the same place, keep a second
// accumulator for the small terms and issue the policy's mma.sync in
// core/precision.py:policy_terms order (a_lo.b_lo, a_lo.b_hi, a_hi.b_lo),
// then a_hi.b_hi into the first; a term that reads a bf16 operand's lo
// (identically zero) is not issued.  A CTA's partial is small + main.  The
// staging, the grid and the split count are the bf16 rung's (the second
// accumulator costs registers, not shared memory: three CTAs an SM still).
//
// Reduction.  With one split a CTA stores its tile of C.  Otherwise each
// CTA writes its f32 partial (its fragment registers, 4 KB) to slot
// (batch, N tile, split) of a workspace, fences, and draws a ticket of its
// (batch, N tile) with atomicAdd; the CTA that draws splits - 1 sums the
// partials in split order (so the result does not depend on which CTA
// arrived last: deterministic), stores C and resets the ticket to 0 for
// the next launch.  No atomics touch C, and no CTA waits for another.  The
// wrapper allocates the workspace and the zeroed tickets once per device
// and stream (kernels/gemm_tiled.py:split_workspace).
//
// Group-rows mode (GROUPS, gemm_grouped.cuh: the grouped forward and dx
// at a 16-row CTA tile, every decode call of the MoE FFN).  A is the token
// buffer sorted by group (N rows, any N), B the expert stack: grid z walks
// A's 16-row tiles, and tile z reads A at row 16 z and B at w + gid[z] *
// sbb (GemmArgs::groups, the per-tile group ids; num_groups marks a dead
// tile) and stores its rows at 16 z.  The tile's live rows end at its
// group's next offset or, where the caller passes the real row counts
// (GroupRuns::counts), at offsets[gid] + counts[gid]: a tile with no live
// row (dead, or only the alignment padding of its run) issues no load and
// no MMA, and its split-0 CTA stores zeros; rows past the live ones in a
// live tile store zeros too (they are zero rows of A: the same bits as
// computing them).  So a decode call streams the weights of the experts
// that have rows and no other.  Splits, workspace and tickets are the
// batch mode's, with the tiles of A in place of the batch.
#pragma once

#include "common.cuh"

namespace rt {
namespace splitk {

constexpr int BN = 64, BK = 64, STAGES = 3, NT = 128, MAX_M = 16;
constexpr int PART = 8 * NT;  // floats of one CTA's partial (8 accumulators a thread)

// The group-rows mode's runs: (num_groups + 1) offsets, and each run's
// real row count (nullptr: every row up to the next offset may be live).
struct GroupRuns {
  const int* offsets;
  const int* counts;
};

template <bool B_KMAJOR, bool B_BF16, bool A_BF16>
struct Tile {
  static constexpr int EB = B_BF16 ? 2 : 4, EA = A_BF16 ? 2 : 4;
  // B as stored: NT [BN][LDB] (K contiguous), NN [BK][LDB] (N contiguous);
  // A [MAX_M][LDA] (K contiguous).  Rows stay 16-byte aligned.
  static constexpr int LDB = B_KMAJOR ? BK + 8 : BN + (B_BF16 ? 8 : 4);
  static constexpr int LDA = BK + 8;
  static constexpr size_t b_bytes = align128((size_t)(B_KMAJOR ? BN : BK) * LDB * EB);
  static constexpr size_t a_bytes = align128((size_t)MAX_M * LDA * EA);
  static constexpr size_t stage = b_bytes + a_bytes;
  static constexpr size_t smem = STAGES * stage;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One element copied as stored (2 or 4 bytes), 0 off the edge.
template <bool BF16>
__device__ __forceinline__ void copy_elem(unsigned char* dst, int i, const char* src,
                                          long long off, bool ok) {
  if constexpr (BF16)
    reinterpret_cast<unsigned short*>(dst)[i] =
        ok ? reinterpret_cast<const unsigned short*>(src)[off] : (unsigned short)0;
  else
    reinterpret_cast<float*>(dst)[i] = ok ? reinterpret_cast<const float*>(src)[off] : 0.f;
}

// Elements i and i + 1 (i even) of a staged tile as a bf16x2 register.
template <bool BF16>
__device__ __forceinline__ unsigned pair_adj(const unsigned char* t, int i) {
  if constexpr (BF16) {
    return *reinterpret_cast<const unsigned*>(t + 2 * i);
  } else {
    const float2 f = *reinterpret_cast<const float2*>(t + 4 * i);
    __nv_bfloat162 v = __floats2bfloat162_rn(f.x, f.y);
    return *reinterpret_cast<unsigned*>(&v);
  }
}

// Elements i (low half) and j of a staged tile as a bf16x2 register.
template <bool BF16>
__device__ __forceinline__ unsigned pair_apart(const unsigned char* t, int i, int j) {
  if constexpr (BF16) {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(t);
    return (unsigned)h[i] | ((unsigned)h[j] << 16);
  } else {
    const float* f = reinterpret_cast<const float*>(t);
    __nv_bfloat162 v = __floats2bfloat162_rn(f[i], f[j]);
    return *reinterpret_cast<unsigned*>(&v);
  }
}

// hi = bf16(x, y) and lo = bf16 of the residuals, each as a bf16x2 register
// (core/precision.py:split2; x - hi is exact in f32).
__device__ __forceinline__ void split_pair(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// pair_adj / pair_apart with the lo residuals too when LO (an f32 tile).
template <bool BF16, bool LO>
__device__ __forceinline__ void pair_adj2(const unsigned char* t, int i, unsigned& hi,
                                          unsigned& lo) {
  if constexpr (LO && !BF16) {
    const float2 f = *reinterpret_cast<const float2*>(t + 4 * i);
    split_pair(f.x, f.y, hi, lo);
  } else {
    hi = pair_adj<BF16>(t, i);
  }
}

template <bool BF16, bool LO>
__device__ __forceinline__ void pair_apart2(const unsigned char* t, int i, int j, unsigned& hi,
                                            unsigned& lo) {
  if constexpr (LO && !BF16) {
    const float* f = reinterpret_cast<const float*>(t);
    split_pair(f[i], f[j], hi, lo);
  } else {
    hi = pair_apart<BF16>(t, i, j);
  }
}

__device__ __forceinline__ void mma16816(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Stage K tile k0 of B's N tile n0 and of A into one ring stage: 16-byte
// cp.async chunks where the operand allows them (zero-filled off the edge),
// plain element copies otherwise.
template <bool B_KMAJOR, bool B_BF16, bool A_BF16>
__device__ __forceinline__ void load_stage(unsigned char* st, const GemmArgs& g,
                                           const char* a_base, const char* b_base, int n0,
                                           int k0, int m, bool a16, bool b16) {
  using T = Tile<B_KMAJOR, B_BF16, A_BF16>;
  unsigned char* sb = st;
  unsigned char* sa = st + T::b_bytes;
  const int tid = threadIdx.x;
  constexpr int B_OUT = B_KMAJOR ? BN : BK, B_IN = B_KMAJOR ? BK : BN;  // rows, contiguous
  if (b16) {
    constexpr int E = 16 / T::EB, CPR = B_IN / E;
#pragma unroll
    for (int c = tid; c < B_OUT * CPR; c += NT) {
      const int o = c / CPR, i = (c % CPR) * E;
      const int gn = n0 + (B_KMAJOR ? o : i), gk = k0 + (B_KMAJOR ? i : o);
      const bool ok = gn < g.n && gk < g.k;
      const char* src = ok ? b_base + (gn * g.sbn + gk * g.sbk) * T::EB : b_base;
      cp_async16(sb + (o * T::LDB + i) * T::EB, src, ok);
    }
  } else {
    for (int e = tid; e < B_OUT * B_IN; e += NT) {
      const int o = e / B_IN, i = e % B_IN;
      const int gn = n0 + (B_KMAJOR ? o : i), gk = k0 + (B_KMAJOR ? i : o);
      copy_elem<B_BF16>(sb, o * T::LDB + i, b_base, gn * g.sbn + gk * g.sbk,
                        gn < g.n && gk < g.k);
    }
  }
  if (a16) {
    constexpr int E = 16 / T::EA, CPR = BK / E;
    for (int c = tid; c < m * CPR; c += NT) {
      const int r = c / CPR, i = (c % CPR) * E, gk = k0 + i;
      const bool ok = gk < g.k;
      const char* src = ok ? a_base + (r * g.sam + gk) * T::EA : a_base;
      cp_async16(sa + (r * T::LDA + i) * T::EA, src, ok);
    }
  } else {
    for (int e = tid; e < m * BK; e += NT) {
      const int r = e / BK, i = e % BK, gk = k0 + i;
      copy_elem<A_BF16>(sa, r * T::LDA + i, a_base, r * g.sam + gk * g.sak, gk < g.k);
    }
  }
}

template <bool B_KMAJOR, bool B_BF16, bool A_BF16, int TS, bool GROUPS>
__global__ void __launch_bounds__(NT, 3)
splitk_kernel(GemmArgs g, SplitWs w, GroupRuns runs, int a16, int b16) {
  using T = Tile<B_KMAJOR, B_BF16, A_BF16>;
  constexpr bool A_LO = (TS & T_LH) != 0, B_LO = (TS & T_HL) != 0;  // split the fragments
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int is_last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int n0 = blockIdx.x * BN, split = blockIdx.y;
  const long long bz = blockIdx.z;
  // m: the rows of A this CTA multiplies; rows: the rows of C it stores
  // (zeros past m)
  int m = g.m, rows = g.m;
  const char* a_base = static_cast<const char*>(g.a);
  const char* b_base = static_cast<const char*>(g.b);
  float* c_base = g.c;
  if constexpr (GROUPS) {
    const int r0 = blockIdx.z * MAX_M, grp = g.groups[blockIdx.z];
    rows = min(MAX_M, g.m - r0);
    m = 0;
    if (grp < g.num_groups) {
      int end = runs.offsets[grp + 1];
      if (runs.counts != nullptr) end = min(end, runs.offsets[grp] + runs.counts[grp]);
      m = max(0, min(rows, end - r0));
    }
    c_base += (long long)r0 * g.n;
    if (m == 0) {  // dead or padding only: zeros, no loads, no MMA
      if (split == 0)
        for (int e = tid; e < rows * BN; e += NT)
          if (n0 + e % BN < g.n) c_base[(long long)(e / BN) * g.n + n0 + e % BN] = 0.f;
      return;
    }
    a_base += r0 * g.sam * T::EA;
    b_base += grp * g.sbb * T::EB;
  } else {
    a_base += bz * g.sab * T::EA;
    b_base += bz * g.sbb * T::EB;
    c_base += bz * (long long)g.m * g.n;
  }

  const int kt = (g.k + BK - 1) / BK;
  const int per = (kt + w.splits - 1) / w.splits;
  const int t0 = min(kt, split * per), nt = min(kt, t0 + per) - t0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt)
      load_stage<B_KMAJOR, B_BF16, A_BF16>(smem + s * T::stage, g, a_base, b_base, n0,
                                           (t0 + s) * BK, m, a16, b16);
    cp_async_commit();
  }

  const bool two = m > 8;              // rows 8..15 of A: a second n8 block
  const int nw = warp * 16 + gid;      // this lane's first weight column in the tile
  float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float ds[TS ? 2 : 1][4] = {};        // the small terms (refined rungs)
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage t landed for every thread; stage t - 1 is free
    if (t + STAGES - 1 < nt)
      load_stage<B_KMAJOR, B_BF16, A_BF16>(smem + ((t + STAGES - 1) % STAGES) * T::stage, g,
                                           a_base, b_base, n0, (t0 + t + STAGES - 1) * BK, m,
                                           a16, b16);
    cp_async_commit();
    const unsigned char* sb = smem + (t % STAGES) * T::stage;
    const unsigned char* sa = sb + T::b_bytes;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const int ka = kk + tig * 2;
      unsigned a0, a1, a2, a3, l0 = 0, l1 = 0, l2 = 0, l3 = 0;  // weights: hi, lo
      if constexpr (B_KMAJOR) {
        pair_adj2<B_BF16, B_LO>(sb, nw * T::LDB + ka, a0, l0);
        pair_adj2<B_BF16, B_LO>(sb, (nw + 8) * T::LDB + ka, a1, l1);
        pair_adj2<B_BF16, B_LO>(sb, nw * T::LDB + ka + 8, a2, l2);
        pair_adj2<B_BF16, B_LO>(sb, (nw + 8) * T::LDB + ka + 8, a3, l3);
      } else {
        pair_apart2<B_BF16, B_LO>(sb, ka * T::LDB + nw, (ka + 1) * T::LDB + nw, a0, l0);
        pair_apart2<B_BF16, B_LO>(sb, ka * T::LDB + nw + 8, (ka + 1) * T::LDB + nw + 8, a1, l1);
        pair_apart2<B_BF16, B_LO>(sb, (ka + 8) * T::LDB + nw, (ka + 9) * T::LDB + nw, a2, l2);
        pair_apart2<B_BF16, B_LO>(sb, (ka + 8) * T::LDB + nw + 8, (ka + 9) * T::LDB + nw + 8,
                                  a3, l3);
      }
      // n8 block j: rows 8j.. of A (the activations: hi, lo), the policy's
      // small terms in policy_terms order, then the leading one
      auto block = [&](int j) {
        unsigned x0, x1, y0 = 0, y1 = 0;
        pair_adj2<A_BF16, A_LO>(sa, (gid + 8 * j) * T::LDA + ka, x0, y0);
        pair_adj2<A_BF16, A_LO>(sa, (gid + 8 * j) * T::LDA + ka + 8, x1, y1);
        if constexpr ((TS & T_LL) != 0) mma16816(ds[j], l0, l1, l2, l3, y0, y1);
        if constexpr (A_LO) mma16816(ds[j], a0, a1, a2, a3, y0, y1);
        if constexpr (B_LO) mma16816(ds[j], l0, l1, l2, l3, x0, x1);
        mma16816(d[j], a0, a1, a2, a3, x0, x1);
      };
      block(0);
      if (two) block(1);
    }
  }
  cp_async_wait<0>();

  // d[j][q] is C[j * 8 + tig * 2 + (q & 1)][n0 + nw + (q >> 1) * 8]
  auto store = [&](const float (&v)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int row = (e / 4) * 8 + tig * 2 + (e & 1), col = n0 + nw + ((e % 4) >> 1) * 8;
      if (row < rows && col < g.n) c_base[(long long)row * g.n + col] = row < m ? v[e] : 0.f;
    }
  };
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if constexpr (TS != 0) v[e] = ds[e / 4][e % 4] + d[e / 4][e % 4];  // small + main
    else v[e] = d[e / 4][e % 4];
  }
  if (w.splits == 1) {
    store(v);
    return;
  }
  const long long tile = bz * gridDim.x + blockIdx.x;
  float* part = w.ws + (tile * w.splits + split) * PART;
#pragma unroll
  for (int e = 0; e < 8; ++e) part[e * NT + tid] = v[e];
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(w.tickets + tile, 1) == w.splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* parts = w.ws + tile * w.splits * PART;
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
#pragma unroll 4
  for (int s = 0; s < w.splits; ++s) {  // unrolled: the L2 reads of 4 splits overlap
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = v[e] + __ldcg(parts + s * PART + e * NT + tid);
  }
  store(v);
  if (tid == 0) w.tickets[tile] = 0;
}

// Whether an operand can be staged in 16-byte chunks along the dimension
// whose stride is `s_contig` (== 1), given its other strides, that
// dimension's extent and the base address.
inline bool vec16_ok(const void* p, int bf16, long long s_contig, long long s_other,
                     long long s_batch, int extent) {
  const int e = bf16 ? 8 : 4;
  return s_contig == 1 && extent % e == 0 && s_other % e == 0 && s_batch % e == 0 &&
         reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// `static`: gemm_tiled.cu and gemm_refined.cu both instantiate the TS = 0
// kernels, and the host compiler makes the static `ready` of an external
// template one object for the whole process (STB_GNU_UNIQUE, even across
// libraries loaded with RTLD_LOCAL): the first library to set its kernel's
// shared-memory limit would mark the other's as set, whose launch then fails.
template <bool B_KMAJOR, bool B_BF16, bool A_BF16, int TS, bool GROUPS>
static int launch(const GemmArgs& g, int batch, const SplitWs& w, const GroupRuns& runs,
                  bool a16, bool b16, cudaStream_t stream) {
  using T = Tile<B_KMAJOR, B_BF16, A_BF16>;
  static std::atomic<unsigned long long> ready{0};
  auto kern = splitk_kernel<B_KMAJOR, B_BF16, A_BF16, TS, GROUPS>;
  const cudaError_t err = smem_once(ready, kern, T::smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g.n + BN - 1) / BN, w.splits, batch);
  kern<<<grid, NT, T::smem, stream>>>(g, w, runs, a16, b16);
  return (int)cudaGetLastError();
}

// One operand-type combination for term set TS, instantiated only where it
// can occur: a lo term only on an f32 operand, and every refined rung
// splits an f32 A (so a refined launch without a_lo.b_hi has a bf16 A).
template <int POL, int TS, bool GROUPS, bool B_KMAJOR, bool B_BF16, bool A_BF16>
int launch_if(const GemmArgs& g, int batch, const SplitWs& w, const GroupRuns& runs, bool a16,
              bool b16, cudaStream_t stream) {
  constexpr bool ok = !((TS & T_LH) && A_BF16) && !((TS & T_HL) && B_BF16) &&
                      !(POL != P_BF16 && !(TS & T_LH) && !A_BF16);
  if constexpr (ok)
    return launch<B_KMAJOR, B_BF16, A_BF16, TS, GROUPS>(g, batch, w, runs, a16, b16, stream);
  else return (int)cudaErrorInvalidValue;
}

template <int POL, int TS, bool GROUPS>
int launch_terms(const GemmArgs& g, int batch, const SplitWs& w, const GroupRuns& runs,
                 bool kmajor, bool a16, bool b16, cudaStream_t stream) {
  switch ((kmajor ? 4 : 0) | (g.b_bf16 ? 2 : 0) | (g.a_bf16 ? 1 : 0)) {
    case 0:
      return launch_if<POL, TS, GROUPS, false, false, false>(g, batch, w, runs, a16, b16, stream);
    case 1:
      return launch_if<POL, TS, GROUPS, false, false, true>(g, batch, w, runs, a16, b16, stream);
    case 2:
      return launch_if<POL, TS, GROUPS, false, true, false>(g, batch, w, runs, a16, b16, stream);
    case 3:
      return launch_if<POL, TS, GROUPS, false, true, true>(g, batch, w, runs, a16, b16, stream);
    case 4:
      return launch_if<POL, TS, GROUPS, true, false, false>(g, batch, w, runs, a16, b16, stream);
    case 5:
      return launch_if<POL, TS, GROUPS, true, false, true>(g, batch, w, runs, a16, b16, stream);
    case 6:
      return launch_if<POL, TS, GROUPS, true, true, false>(g, batch, w, runs, a16, b16, stream);
    default:
      return launch_if<POL, TS, GROUPS, true, true, true>(g, batch, w, runs, a16, b16, stream);
  }
}

// The host's split count is checked, not chosen, here: every split must
// hold at least one K tile, and the workspace and tickets must cover the
// grid.  GROUPS: the group-rows mode, `batch` A's 16-row tiles (g.m rows,
// any count; `runs` its offsets and counts).  A template, so that only the
// sources that call it (gemm_tiled.cu for the bf16 rung, gemm_refined.cu
// for the refined ones, gemm_grouped.cu for the group-rows mode) compile
// its kernels: every other source that includes gemm_common.cuh would
// otherwise build them too.
template <int POL, bool GROUPS = false>
int run(const GemmArgs& g, int batch, const SplitWs& w, cudaStream_t stream,
        const GroupRuns& runs = GroupRuns{nullptr, nullptr}) {
  static_assert(POL == P_BF16 || Splits<POL>::a_lo, "bf16 and the refined rungs only");
  if (w.splits < 1 || w.splits > 65535 || batch > 65535) return (int)cudaErrorInvalidValue;
  if (GROUPS ? (batch != (g.m + MAX_M - 1) / MAX_M || g.groups == nullptr ||
                runs.offsets == nullptr)
             : g.m > MAX_M)
    return (int)cudaErrorInvalidValue;
  if (w.splits > 1) {
    const int kt = (g.k + BK - 1) / BK, per = (kt + w.splits - 1) / w.splits;
    const long long tiles = (long long)batch * ((g.n + BN - 1) / BN);
    if ((long long)(w.splits - 1) * per >= kt || w.ws == nullptr || w.tickets == nullptr ||
        tiles > w.n_tickets || tiles * w.splits * PART > w.ws_floats)
      return (int)cudaErrorInvalidValue;
  }
  const bool kmajor = g.sbk < g.sbn;
  const bool a16 = vec16_ok(g.a, g.a_bf16, g.sak, g.sam, g.sab, g.k);
  const bool b16 = kmajor ? vec16_ok(g.b, g.b_bf16, g.sbk, g.sbn, g.sbb, g.k)
                          : vec16_ok(g.b, g.b_bf16, g.sbn, g.sbk, g.sbb, g.n);
  if constexpr (POL == P_BF16) {
    return launch_terms<POL, 0, GROUPS>(g, batch, w, runs, kmajor, a16, b16, stream);
  } else {
    switch (term_set<POL>(g.a_bf16, g.b_bf16)) {
      case 0: return launch_terms<POL, 0, GROUPS>(g, batch, w, runs, kmajor, a16, b16, stream);
      case T_LH:
        return launch_terms<POL, T_LH, GROUPS>(g, batch, w, runs, kmajor, a16, b16, stream);
      case T_HL:
        return launch_terms<POL, T_HL, GROUPS>(g, batch, w, runs, kmajor, a16, b16, stream);
      case T_LH | T_HL:
        return launch_terms<POL, T_LH | T_HL, GROUPS>(g, batch, w, runs, kmajor, a16, b16,
                                                      stream);
      default:
        return launch_terms<POL, T_LH | T_HL | T_LL, GROUPS>(g, batch, w, runs, kmajor, a16,
                                                             b16, stream);
    }
  }
}

}  // namespace splitk
}  // namespace rt
