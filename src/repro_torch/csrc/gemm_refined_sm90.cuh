// The refined rungs' Hopper mainloop (refine_a / bf16x3 / refine_ab, the
// paper's Eq. 2-3) for M > 16, and their dispatch: M <= 16 runs the split-K
// weight stream of gemm_splitk.cuh.  Included by gemm_refined.cu alone.
//
// C = A.B as a sum of terms: each operand x is split into bf16 hi = bf16(x)
// and lo = bf16(x - hi) (core/precision.py:split2), and per 16-deep step
// the policy's small terms are issued in policy_terms order (a_lo.b_lo,
// a_lo.b_hi, a_hi.b_lo) and then a_hi.b_hi, into one wgmma accumulator.
// A bf16 operand's lo is identically zero, so the host drops every term that
// reads it (the term set TS, common.cuh): refine_ab on f32 x f32 runs 4
// terms, on a bf16 A or B 2, refine_a on a bf16 A the bf16 product alone.
//
// Promotion: the tensor cores' f32 accumulation loses precision with the
// products it sums (on an H100 80GB HBM3 a whole-K accumulator reads 16x
// SGEMM's max error at K = 8192, 256-deep chunks summed in f32 half of
// it; tools/probe_accumulation.py).  So the accumulator spans a chunk of
// sixteen wgmma (Ring::PROMOTE stages: four for one term, two for two, one
// for three or four), is then added into an f32 total on the CUDA cores,
// and the next chunk's first wgmma overwrites it (scale_d 0).  The total is
// the tile's product.
//
// The shape is gemm_sm90.cuh's: one producer warpgroup and two consumer
// warpgroups of 64 rows, a CTA a 128 x 128 tile of C, K in 64-deep stages of
// a ring in the 128-byte swizzled K-major or MN-major layout that wgmma
// reads.  A stage holds the planes the term set needs: A_hi, B_hi, and A_lo /
// B_lo only where a small term reads them (16 KB each), so 4 stages of two
// or three planes and 3 of four (192 KB either way).  The producer fills a
// bf16 operand by TMA into its hi plane (it has no lo plane), and an f32
// operand (or one TMA cannot take) by the converting path: each element is
// read once into registers and its hi and lo are written to their planes.
// Each consumer issues, per 16-deep step, the terms' wgmma m64n128k16,
// one commit group a stage, one group kept in flight but at a chunk's end.
//
// What bounds it: the converting path, by its loads' latency (one f32 tile
// of a stage in flight in the producer's registers: 1.8-2.7 us a stage
// against 0.6-1.1 us of wgmma on an H100, PERF.md).  More loads in flight
// need registers that the consumers' 64-float accumulator and total leave none
// of at 384 threads: a second producer warpgroup (512 threads, setmaxnreg)
// and a second tile in flight in the one producer both spilled.
//
// Filling the card: a grid of 128 x 128 tiles leaves the SMs idle for most
// of a last partial wave when the tiles are few (train dX, 2048 x 1152 out:
// 144 tiles on 132 SMs, two waves for 1.09 waves of work).  The host then
// splits K (kernels/gemm_tiled.py:sm90_splits, whole waves) and each CTA
// walks K tiles [s * per, min((s + 1) * per, kt)) with per = ceil(kt /
// splits); as in gemm_splitk.cuh each writes its f32 partial (its total)
// to a workspace slot and draws a ticket, and the CTA that draws the last
// sums the partials in split order (deterministic), stores C and resets the
// ticket.  With one split the consumers store C from registers, masked for
// ragged M and N.
#pragma once

#include "gemm_common.cuh"

namespace rt {
namespace refined {

using sm90::BK;
using sm90::BLOCK;
using sm90::BN;
using sm90::Operand;
using sm90::ROW;

constexpr int BM = 128, NT = 384;
constexpr int PLANE = BM * ROW;  // one 128 x 64 bf16 plane of A or B (BM == BN): 16 KB
constexpr int PART = BM * BN;    // floats of a CTA's partial

template <int TS>
struct Ring {
  static constexpr bool A_LO = (TS & T_LH) != 0, B_LO = (TS & T_HL) != 0;
  static constexpr int PLANES = 2 + A_LO + B_LO;
  static constexpr int STAGE = PLANES * PLANE;          // A_hi, B_hi, A_lo?, B_lo?
  static constexpr int STAGES = PLANES == 4 ? 3 : 4;
  static constexpr int TERMS = 1 + ((TS & T_LL) != 0) + A_LO + B_LO;
  static constexpr int PROMOTE = TERMS == 1 ? 4 : TERMS == 2 ? 2 : 1;  // 16 wgmma a chunk at most
  static constexpr int A_LO_AT = 2 * PLANE, B_LO_AT = (2 + A_LO) * PLANE;
  static constexpr size_t smem = 1024 + STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);
};

// The refined kernel's own arguments (sm90::Args stays as the bf16 kernels
// take it by value).
struct Args {
  Operand a, b;
  float* c;
  int m, n, k;
  SplitWs w;
};

// Eight elements as f32: (mn, k..k+7) when KMAJOR, else (mn..mn+7, k);
// zeros off the edge (sm90::load_chunk before its rounding).
template <bool KMAJOR>
__device__ __forceinline__ void load_chunk8(const Operand& o, const char* base, int mn, int k,
                                            float (&x)[8]) {
  const long long step = KMAJOR ? o.s_k : o.s_mn;
  const int left = KMAJOR ? o.k - k : o.mn - mn;
  const bool in = KMAJOR ? mn < o.mn : k < o.k;
  const long long off = static_cast<long long>(mn) * o.s_mn + static_cast<long long>(k) * o.s_k;
  if (in && left >= 8 && o.vec) {
    rt::load8(base, off, o.bf16, x);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    x[e] = (in && e < left) ? load_elem(base, off + e * step, o.bf16) : 0.f;
}

// Eight f32 values as their bf16 hi (sm90::pack2's rounding) and lo chunks.
__device__ __forceinline__ void split8(const float (&x)[8], uint4& hi, uint4& lo) {
  unsigned h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) splitk::split_pair(x[2 * j], x[2 * j + 1], h[j], l[j]);
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// The converting path for an R x 64 tile: hi into `hi` and, when LO, lo
// into `lo` (same swizzled layout).  Without LO it is gemm_sm90.cuh's
// convert_tile.  An f32 tile that lies inside the operand and is aligned
// issues all its 16-byte loads before splitting any; an edge or strided
// tile goes four chunks at a time, element by element where it must.
template <int R, bool KMAJOR, bool LO>
__device__ __forceinline__ void convert_split(unsigned char* hi, unsigned char* lo,
                                              const Operand& o, const char* base, int mn0,
                                              int k0, int t) {
  if constexpr (!LO) {
    sm90::convert_tile<R, KMAJOR>(hi, o, base, mn0, k0, t);
  } else {
    constexpr int PER = R * BK / 8 / 128;
    if (o.vec && !o.bf16 && mn0 + R <= o.mn && k0 + BK <= o.k) {
      float4 f[2 * PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        int dmn, dk, soff;
        sm90::chunk_at<R, KMAJOR>(t + j * 128, dmn, dk, soff);
        const long long off = (long long)(mn0 + dmn) * o.s_mn + (long long)(k0 + dk) * o.s_k;
        const float4* p = reinterpret_cast<const float4*>(base + off * 4);
        f[2 * j] = __ldg(p);
        f[2 * j + 1] = __ldg(p + 1);
      }
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        int dmn, dk, soff;
        sm90::chunk_at<R, KMAJOR>(t + j * 128, dmn, dk, soff);
        const float x[8] = {f[2 * j].x, f[2 * j].y, f[2 * j].z, f[2 * j].w,
                            f[2 * j + 1].x, f[2 * j + 1].y, f[2 * j + 1].z, f[2 * j + 1].w};
        uint4 h, l;
        split8(x, h, l);
        *reinterpret_cast<uint4*>(hi + soff) = h;
        *reinterpret_cast<uint4*>(lo + soff) = l;
      }
      return;
    }
#pragma unroll
    for (int i0 = 0; i0 < PER; i0 += 4) {
      uint4 h[4], l[4];
      int off[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int dmn, dk;
        sm90::chunk_at<R, KMAJOR>(t + (i0 + j) * 128, dmn, dk, off[j]);
        float x[8];
        load_chunk8<KMAJOR>(o, base, mn0 + dmn, k0 + dk, x);
        split8(x, h[j], l[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<uint4*>(hi + off[j]) = h[j];
        *reinterpret_cast<uint4*>(lo + off[j]) = l[j];
      }
    }
  }
}

// The producer's walk of one CTA's K tiles [kt0, kt0 + nk): each stage's
// planes by TMA (bf16 hi) or converted (all 128 threads; thread 0 alone
// when both operands take TMA).
template <bool A_K, bool B_K, int TS>
__device__ __forceinline__ void produce(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                        const Operand& oa, const Operand& ob, const char* a_base,
                                        const char* b_base, const CUtensorMap* map_a,
                                        const CUtensorMap* map_b, int m0, int n0, int za, int zb,
                                        int kt0, int nk, int t) {
  using Rg = Ring<TS>;
  const bool convert = !(oa.tma && ob.tma);
  const uint32_t tx = (oa.tma ? PLANE : 0) + (ob.tma ? PLANE : 0);
  int stage = 0, phase = 0;
  for (int kt = 0; kt < nk; ++kt) {
    sm90::mbar_wait(&empty[stage], phase ^ 1);
    unsigned char* st = smem + stage * Rg::STAGE;
    const int k0 = (kt0 + kt) * BK;
    if (convert) {
      if (!oa.tma) convert_split<BM, A_K, Rg::A_LO>(st, st + Rg::A_LO_AT, oa, a_base, m0, k0, t);
      if (!ob.tma)
        convert_split<BN, B_K, Rg::B_LO>(st + PLANE, st + Rg::B_LO_AT, ob, b_base, n0, k0, t);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, 128;" ::: "memory");
    }
    if (t == 0) {
      if (tx) {
        sm90::mbar_arrive_tx(&full[stage], tx);
        if (oa.tma) sm90::tma_tile<BM, A_K>(st, map_a, &full[stage], m0, k0, za);
        if (ob.tma) sm90::tma_tile<BN, B_K>(st + PLANE, map_b, &full[stage], n0, k0, zb);
      } else {
        sm90::mbar_arrive(&full[stage]);
      }
    }
    if (++stage == Rg::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// A consumer's walk (rows [64 cw, 64 cw + 64) of the tile): per 16-deep
// step the small terms in policy_terms order, then hi.hi, into `acc`; one
// commit group a stage, one kept in flight, each stage released once the
// next one's group is issued.  The stage that ends a chunk of Ring::PROMOTE
// (or the walk) waits for every group instead and adds `acc` into `total`.
template <bool A_K, bool B_K, int TS>
__device__ __forceinline__ void consume(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                        float (&acc)[64], float (&total)[64], int nk, int cw,
                                        int t) {
  using Rg = Ring<TS>;
  constexpr int TA = A_K ? 0 : 1, TB = B_K ? 0 : 1;
  auto desc_a = [](const unsigned char* p, int kk) {
    return A_K ? sm90::make_desc(p + kk * 32, 16, 1024)
               : sm90::make_desc(p + kk * 16 * ROW, BLOCK, 1024);
  };
  auto desc_b = [](const unsigned char* p, int kk) {
    return B_K ? sm90::make_desc(p + kk * 32, 16, 1024)
               : sm90::make_desc(p + kk * 16 * ROW, BLOCK, 1024);
  };
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] = 0.f;
  int stage = 0, phase = 0, prev = 0;
  for (int kt = 0; kt < nk; ++kt) {
    sm90::mbar_wait(&full[stage], phase);
    const unsigned char* st = smem + stage * Rg::STAGE;
    const unsigned char* ah = st + cw * 64 * ROW;
    const unsigned char* bh = st + PLANE;
    const unsigned char* al = st + Rg::A_LO_AT + cw * 64 * ROW;
    const unsigned char* bl = st + Rg::B_LO_AT;
    const int chunk_on = kt % Rg::PROMOTE != 0;  // 0: the chunk's first product writes `acc`
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int on = chunk_on || kk > 0;
      if constexpr ((TS & T_LL) != 0)
        sm90::wgmma_m64n128k16<TA, TB>(acc, desc_a(al, kk), desc_b(bl, kk), on);
      if constexpr ((TS & T_LH) != 0)
        sm90::wgmma_m64n128k16<TA, TB>(acc, desc_a(al, kk), desc_b(bh, kk),
                                       (TS & T_LL) ? 1 : on);
      if constexpr ((TS & T_HL) != 0)
        sm90::wgmma_m64n128k16<TA, TB>(acc, desc_a(ah, kk), desc_b(bl, kk),
                                       (TS & (T_LL | T_LH)) ? 1 : on);
      sm90::wgmma_m64n128k16<TA, TB>(acc, desc_a(ah, kk), desc_b(bh, kk), TS ? 1 : on);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if ((kt + 1) % Rg::PROMOTE == 0 || kt + 1 == nk) {
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      sm90::fence_acc(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += acc[i];
    } else {
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      sm90::fence_acc(acc);
    }
    if (kt > 0 && t % 32 == 0) sm90::mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == Rg::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (nk > 0 && t % 32 == 0) sm90::mbar_arrive(&empty[prev]);
}

// Grid (M tiles, N tiles, batch x splits): blockIdx.z = batch * splits + split.
template <bool A_K, bool B_K, int TS>
__global__ void __launch_bounds__(NT, 1)
refined_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, const Args g) {
  using Rg = Ring<TS>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int is_last;
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Rg::STAGES * Rg::STAGE);
  uint64_t* empty = full + Rg::STAGES;

  const int splits = g.w.splits;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int bz = blockIdx.z / splits, split = blockIdx.z % splits;
  const int za = g.a.s_batch ? bz : 0, zb = g.b.s_batch ? bz : 0;
  const char* a_base = g.a.p + za * g.a.s_batch * (g.a.bf16 ? 2 : 4);
  const char* b_base = g.b.p + zb * g.b.s_batch * (g.b.bf16 ? 2 : 4);
  if (threadIdx.x == 0) {
    for (int s = 0; s < Rg::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int kt_all = (g.k + BK - 1) / BK, per = (kt_all + splits - 1) / splits;
  const int kt0 = min(kt_all, split * per), nk = min(kt_all, kt0 + per) - kt0;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wg == 0) {
    if (!(g.a.tma && g.b.tma) || t == 0)
      produce<A_K, B_K, TS>(smem, full, empty, g.a, g.b, a_base, b_base, &map_a, &map_b, m0, n0,
                            za, zb, kt0, nk, t);
    return;
  }
  float acc[64], main[64];  // acc written first by a wgmma with scale_d 0; main the total
  consume<A_K, B_K, TS>(smem, full, empty, acc, main, nk, wg - 1, t);
  float* cb = g.c + static_cast<long long>(bz) * g.m * g.n;
  const int r_first = m0 + (wg - 1) * 64;
  if (splits == 1) {
    sm90::store_tile(main, cb, g.m, g.n, r_first, n0, nk, t);
    return;
  }
  // split K: partial to the workspace, a ticket, the last CTA sums in split order
  const int ct = threadIdx.x - 128;
  const long long tile =
      (static_cast<long long>(bz) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  float* part = g.w.ws + (tile * splits + split) * PART;
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i * 256 + ct] = main[i];
  __threadfence();
  asm volatile("bar.sync 2, 256;" ::: "memory");
  if (ct == 0) is_last = atomicAdd(g.w.tickets + tile, 1) == splits - 1;
  asm volatile("bar.sync 2, 256;" ::: "memory");
  if (!is_last) return;
  __threadfence();
  const float* parts = g.w.ws + tile * splits * PART;
#pragma unroll
  for (int i = 0; i < 64; ++i) main[i] = 0.f;
  for (int s = 0; s < splits; ++s) {
#pragma unroll
    for (int i = 0; i < 64; ++i) main[i] = main[i] + __ldcg(parts + s * PART + i * 256 + ct);
  }
  sm90::store_tile(main, cb, g.m, g.n, r_first, n0, 1, t);
  if (ct == 0) g.w.tickets[tile] = 0;
}

// ---------------------------------------------------------------- host side

template <bool A_K, bool B_K, int TS>
int launch(const Args& s, const CUtensorMap& ma, const CUtensorMap& mb, int batch,
           cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  auto kern = refined_sm90_kernel<A_K, B_K, TS>;
  const cudaError_t err = smem_once(ready, kern, Ring<TS>::smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s.m + BM - 1) / BM, (s.n + BN - 1) / BN, batch * s.w.splits);
  kern<<<grid, NT, Ring<TS>::smem, stream>>>(ma, mb, s);
  return (int)cudaGetLastError();
}

template <int TS>
int launch_layout(const Args& s, const CUtensorMap& ma, const CUtensorMap& mb, bool a_k,
                  bool b_k, int batch, cudaStream_t stream) {
  if (a_k)
    return b_k ? launch<true, true, TS>(s, ma, mb, batch, stream)
               : launch<true, false, TS>(s, ma, mb, batch, stream);
  return b_k ? launch<false, true, TS>(s, ma, mb, batch, stream)
             : launch<false, false, TS>(s, ma, mb, batch, stream);
}

// C = A.B at M > 16 on the refined mainloop, split `w.splits` ways along K
// (the host's count is checked here: none empty, the workspace and tickets
// cover the grid).
template <int POL>
int run(const GemmArgs& g, int batch, const SplitWs& w, cudaStream_t stream) {
  const long long tiles =
      static_cast<long long>(batch) * ((g.m + BM - 1) / BM) * ((g.n + BN - 1) / BN);
  if (w.splits < 1 || static_cast<long long>(batch) * w.splits > 65535 ||
      (g.n + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  if (w.splits > 1) {
    const int kt = (g.k + BK - 1) / BK, per = (kt + w.splits - 1) / w.splits;
    if ((long long)(w.splits - 1) * per >= kt || w.ws == nullptr || w.tickets == nullptr ||
        tiles > w.n_tickets || tiles * w.splits * PART > w.ws_floats)
      return (int)cudaErrorInvalidValue;
  }
  const bool a_k = !(g.sam == 1 && g.sak != 1);
  const bool b_k = !(g.sbn == 1 && g.sbk != 1);
  Args s;
  s.a = sm90::operand(g.a, g.a_bf16, g.sam, g.sak, g.sab, g.m, g.k, a_k);
  s.b = sm90::operand(g.b, g.b_bf16, g.sbn, g.sbk, g.sbb, g.n, g.k, b_k);
  s.c = g.c;
  s.m = g.m; s.n = g.n; s.k = g.k;
  s.w = w;
  // bf16 operands by TMA where it takes them (they have no lo plane)
  CUtensorMap ma{}, mb{};
  if (g.a_bf16)
    s.a.tma = a_k ? sm90::encode(&ma, g.a, g.k, g.m, batch, g.sam, g.sab, BM)
                  : sm90::encode(&ma, g.a, g.m, g.k, batch, g.sak, g.sab, 64);
  if (g.b_bf16)
    s.b.tma = b_k ? sm90::encode(&mb, g.b, g.k, g.n, batch, g.sbn, g.sbb, BN)
                  : sm90::encode(&mb, g.b, g.n, g.k, batch, g.sbk, g.sbb, 64);
  switch (term_set<POL>(g.a_bf16, g.b_bf16)) {
    case 0: return launch_layout<0>(s, ma, mb, a_k, b_k, batch, stream);
    case T_LH: return launch_layout<T_LH>(s, ma, mb, a_k, b_k, batch, stream);
    case T_HL: return launch_layout<T_HL>(s, ma, mb, a_k, b_k, batch, stream);
    case T_LH | T_HL: return launch_layout<T_LH | T_HL>(s, ma, mb, a_k, b_k, batch, stream);
    default: return launch_layout<T_LH | T_HL | T_LL>(s, ma, mb, a_k, b_k, batch, stream);
  }
}

// refine_a / bf16x3 / refine_ab: M <= 16 on the split-K weight stream, else
// the mainloop above; *loop says which ran.
template <int POL>
int dispatch(const GemmArgs& g, int batch, const SplitWs& w, cudaStream_t stream, int* loop) {
  static_assert(Splits<POL>::a_lo, "the refined rungs only");
  if (g.m <= splitk::MAX_M) {
    *loop = LOOP_SPLITK;
    return splitk::run<POL>(g, batch, w, stream);
  }
  *loop = LOOP_SM90;
  return run<POL>(g, batch, w, stream);
}

}  // namespace refined
}  // namespace rt
