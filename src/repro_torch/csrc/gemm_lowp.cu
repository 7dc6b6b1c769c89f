// Quantized GEMM with per-tile scales, the ladder's fp8 / int8 rungs below
// bf16: C = A.B, one pass (fp8, int8) or three error-corrected passes
// (fp8x3, int8x3: lo.hi + hi.lo + hi.hi), f32 out.
//
// Replaces the TPU kernel kernels/gemm_lowp.py:_lowp_kernel with
// _quant_tile (pallas_call at gemm_lowp.py:125).  A is quantized per
// (bm, bk) tile and B per (bk, bn) tile of a grid anchored at 0 (the
// ragged last tile is masked, which is what the TPU kernel's zero padding
// computes).  Within a tile: s = amax / qmax (amax floored at 1e-30; qmax
// 127 for int8, 448 for e4m3), y = x / s; int8 takes rint (half to even)
// and clips to +-127, e4m3 clips to +-448 and rounds to nearest even in the
// cast.  The x3 rungs quantize the residual x - q*s under its own tile
// scale.  Each quantization K-tile kq contributes
//   u_kq = (P_lohi * (sra*sb) + P_hilo * (sa*srb)) + P_hihi * (sa*sb)
// (one pass: P_hihi * (sa*sb)), and C = ((0 + u_0) + u_1) + ..., every
// operation rounded on its own (__fmul_rn, __fadd_rn: nvcc would otherwise
// contract them into FMAs, and so the residual too).  Quantized values ride
// bf16 carriers (an int8 or e4m3 value is exact in bf16, so every product
// is exact in f32, and int8 sums of a K tile of <= 1040 are exact too).
//
// Two regimes, each reported to the wrapper as its mainloop (rt::Mainloop):
//
// M <= 16 (decode; LOOP_SPLITK): one launch on the weight stream.  The
//   product is bounded by the bytes of B (4 x 1152 x 6912 against f32
//   weights: 31.9 MB, 9.5 us at 3.35 TB/s).  A thread-block cluster owns one
//   B quantization tile (kq, nq): CSIZE = ceil(tile width / 64) CTAs, each
//   holding all the tile's K rows of 64 of its columns in shared memory
//   (256 x 64 f32 = 64 KB, 16-byte cp.async copies in four groups, the
//   amax taken over each group as it lands), so B is read from device
//   memory once.  Each CTA stages A's <= 16 x bk tile beside it and reduces
//   its row tiles' scales itself (A is a few KB), then writes each A
//   element's hi and lo bf16 carriers in its place.  The cluster reduces
//   the B tile's amax over distributed shared memory; under that scale each
//   weight is quantized once into bf16 fragments for mma.sync m16n8k16 with
//   the operands swapped (16 weight columns as the MMA's rows, the <= 16
//   activation rows as its n, gemm_splitk.cuh's scheme): hi.hi and lo.hi
//   at once, the residual x - hi*sb kept in x's place and its amax reduced
//   over the cluster; then lo of each residual and hi.lo.  Eight warps, two
//   for each 16 columns, each half of the K tile's steps; the halves' sums
//   meet in shared memory (int8's are exact integers).  A CTA forms its
//   tile's u_kq, writes it to a workspace slot and draws a ticket of its 64
//   columns; the CTA that draws the last sums the kt slots in kq order (the
//   plain version's association, so the int8 rungs stay bit-equal), stores
//   C and resets the ticket (kernels/gemm_tiled.py:split_workspace, or a
//   larger one of the same shape).  Divisions by a tile's scale use its
//   reciprocal and two exact corrections (div_rn: __fdiv_rn's result).
//   At gemma3's decode MLP (bn = bk = 256) a tile has 4 CTAs of ~72 KB (m
//   <= 8), 3 an SM: 540 CTAs over 396 slots on 132 SMs
//   (kernels/gemm_lowp.py:decode_plan).  What bounds it on the H100: the
//   32 MB do not fit the card's shared memory at once, so it runs in two
//   waves, each loading (~7 us for the first, at the bytes rate) and then
//   computing (~10 us: the quantization's ALU work and the cluster's two
//   barriers); the second wave, ~1 CTA an SM, computes at low occupancy
//   (tools/probe_lowp.py times the phases).
//
// M > 16 (prefill; LOOP_SM90): a quantize pass, then a wgmma mainloop.
//   At the prefill MLP (700 x 1152 x 6912) three bf16-carrier passes are
//   33.4 GFLOP, 0.034 ms at 989 TFLOP/s.  The quantize pass (one launch
//   for both operands) gives each tile of A and of B a cluster of CTAs of
//   <= 256 rows x 64 columns (loaded once into shared memory through
//   registers, amax on the way), reduces the scales as above, writes the
//   scale planes and the tile's hi (and lo) as bf16 carrier planes: A
//   (m x k, K contiguous), B (k x n, N contiguous), rows padded to 8
//   elements for TMA.  Every element is quantized once, not once for each M
//   tile that reads it.  The mainloop is gemm_refined_sm90.cuh's shape:
//   one producer thread issues TMA for every plane of a stage (no converting
//   producer) into a ring of four 128-byte swizzled 64-deep stages, and two
//   consumer warpgroups, each 64 rows x 64 columns of a 64 x 128 CTA tile,
//   issue wgmma m64n64k16 for hi.hi, lo.hi and hi.lo into three f32
//   partials (they carry different scales).  Where a quantization K-tile
//   ends they wait for their wgmmas, fold the partials into the f32
//   result in the plain version's order and start the next tile's partials
//   afresh.  A consumer's 64 columns nest in one B quantization tile (bn a
//   multiple of 64 or covering N); its rows may span A tiles (bm < 64), so
//   each thread takes the scales of its own two rows.  acc + three
//   partials are 128 floats a consumer thread (167-168 registers, no
//   spill).  bk is a multiple of the 64-deep stage (or covers K), so every
//   fold falls on a stage's end, outside any branch: a wait or a register
//   read there in a branch makes ptxas serialize the wgmmas (C7518-C7520).
#include <cuda_fp8.h>

#include "gemm_common.cuh"

namespace {

using namespace rt;

// ------------------------------------------------------------ shared pieces

// x / s rounded to nearest even, as __fdiv_rn(x, s) gives it, from rs =
// __frcp_rn(s) (taken once a tile): q = x rs, then two corrections q + rs (x
// - s q), each remainder exact in an FMA (Markstein: a correctly rounded
// reciprocal and a quotient within an ulp give the correctly rounded one).
// s is normal and |x / s| <= qmax here; where x is so small that a
// remainder could underflow, the quotient quantizes to 0 either way.
__device__ __forceinline__ float div_rn(float x, float s, float rs) {
  float q = __fmul_rn(x, rs);
  q = __fmaf_rn(__fmaf_rn(-s, q, x), rs, q);
  return __fmaf_rn(__fmaf_rn(-s, q, x), rs, q);
}

// A tile's scale and its reciprocal.
struct Scale {
  float s, rs;
};

// The quantized value of x under its tile's scale.  |x| <= amax, so |x / s|
// exceeds qmax by at most the scale's rounding (2^-24 qmax): int8's rint
// already lands in [-127, 127] and e4m3's saturating cast clips at 448, as
// the plain version's clamps do.
template <bool FP8>
__device__ __forceinline__ float quant(float x, Scale sc) {
  const float y = div_rn(x, sc.s, sc.rs);
  if constexpr (FP8) {
    const __nv_fp8_storage_t v = __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(v, __NV_E4M3)));
  } else {
    return rintf(y);
  }
}

// x - q*s, each operation rounded
__device__ __forceinline__ float residual(float x, float q, Scale sc) {
  return __fsub_rn(x, __fmul_rn(q, sc.s));
}

template <bool FP8>
__device__ __forceinline__ Scale tile_scale(float amax) {
  const float s = __fdiv_rn(fmaxf(amax, 1e-30f), FP8 ? 448.f : 127.f);
  return {s, __frcp_rn(s)};
}

// A K tile's term from the passes' sums: (lh*(sra*sb) + hl*(sa*srb)) + hh*(sa*sb)
template <bool X3>
__device__ __forceinline__ float term(float lh, float hl, float hh, float sa, float sra, float sb,
                                      float srb) {
  const float u = __fmul_rn(hh, __fmul_rn(sa, sb));
  if constexpr (X3)
    return __fadd_rn(__fadd_rn(__fmul_rn(lh, __fmul_rn(sra, sb)), __fmul_rn(hl, __fmul_rn(sa, srb))),
                     u);
  return u;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

__device__ __forceinline__ float amax4(float m, float4 v) {
  return fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
}

template <bool FP8>
__device__ __forceinline__ float ramax1(float m, float x, Scale sc) {
  return fmaxf(m, fabsf(residual(x, quant<FP8>(x, sc), sc)));
}

// ---- thread-block clusters: a tile's CTAs reduce its scales together

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// `p` in the shared memory of cluster CTA `rank`
__device__ __forceinline__ float ld_cluster(const float* p, int rank) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// The largest `mine` over the cluster (`mine`: the CTA's value, the same
// in each of its threads).  Each CTA posts it in `slot`; after the cluster
// barrier thread 0 reads every CTA's slot and shares the maximum through
// `out`.  A slot is written once a launch, so the reads of one reduction
// never race the next one's writes; the caller's last cluster_arrive /
// cluster_wait pair keeps every CTA alive until the others have read it.
__device__ __forceinline__ float cluster_max(float mine, float* slot, float* out, int csize) {
  if (threadIdx.x == 0) *slot = mine;
  cluster_arrive();
  cluster_wait();
  if (threadIdx.x == 0) {
    float v = mine;
    for (int r = 0; r < csize; ++r) v = fmaxf(v, ld_cluster(slot, r));
    *out = v;
  }
  __syncthreads();
  return *out;
}

template <class K, class Args>
cudaError_t launch_cluster(K kern, dim3 grid, int threads, size_t smem, int csize,
                           cudaStream_t stream, const Args& args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

constexpr int SLICE = 64;       // columns of a tile that one CTA holds
constexpr int MAX_CLUSTER = 8;  // the portable cluster size

// ====================================================== M <= 16: decode

namespace dec {

// NT threads: eight warps, two a 16-column group (one for each half of the
// K tile's 16-deep steps); the first four hold the sums and the term.
constexpr int NT = 256, MAX_DEPTH = 512, MAX_M = 16;
constexpr int TERM_NT = 128;
constexpr int PART = 8 * TERM_NT;   // floats of one CTA's term (8 a thread of the first four warps)
constexpr int XCH = 4 * 32 * 24;    // floats of the K halves' exchange, in the slice's place
constexpr int SMEM_MAX = 200 * 1024;

struct Args {
  const char* a;
  long long sab, sam, sak;
  int a_bf16;
  const char* b;
  long long sbb, sbk, sbn;
  int b_bf16;
  float* c;
  int m, n, k, bm, bn, bk;
  int kt, nt, csize;  // K tiles, N tiles, CTAs a tile (the cluster)
  int depth;          // rows of a staged slice: min(bk, k) rounded up to 16
  int a_rows, lda;    // A rows staged (8 or 16) and their pitch in words
  int b16;            // slices by 16-byte cp.async (f32, N contiguous, aligned)
  float* ws;
  int* tickets;
};

// Word offset of element (r, col) of a staged 64-column f32 slice: the
// 16-byte chunk col / 4 of row r sits at chunk (col / 4) ^ 2 ((r / 2) % 4),
// so a warp's fragment loads (8 columns by 4 even rows) hit 32 banks.
__device__ __forceinline__ int swz(int r, int col) {
  return r * SLICE + ((((col >> 2) ^ (((r >> 1) & 3) << 1))) << 2) + (col & 3);
}

// Grid (N tiles x CSIZE, K tiles, batch), clusters of CSIZE along x.
template <bool FP8, bool X3>
__global__ void __launch_bounds__(NT, 3) lowp_decode_kernel(const __grid_constant__ Args g) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[32], slot[2], outv[2], rowmax[MAX_M];
  __shared__ Scale a_s[MAX_M], a_sr[MAX_M];
  __shared__ int is_last;
  float* bs = reinterpret_cast<float*>(smem);
  float* as = reinterpret_cast<float*>(smem + static_cast<size_t>(max(g.depth * SLICE, XCH)) * 4);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = cluster_rank();
  const int nq = blockIdx.x / g.csize, kq = blockIdx.y;
  const long long bz = blockIdx.z;
  const int k0 = kq * g.bk, rows = min(g.k, k0 + g.bk) - k0;
  const int t0 = nq * g.bn, t1 = min(g.n, t0 + g.bn);          // the B tile's columns
  const int c0 = t0 + rank * SLICE, c1 = min(t1, c0 + SLICE);  // this CTA's
  const int width = c1 - c0;  // <= 0: an idle CTA of a narrow tile
  const char* a_base = g.a + bz * g.sab * (g.a_bf16 ? 2 : 4);
  const char* b_base = g.b + bz * g.sbb * (g.b_bf16 ? 2 : 4);

  // 1. stage the slice: K rows [k0, k0 + depth) x columns [c0, c0 + 64),
  //    zeros outside [rows) x [width); four copy groups of depth / 4 rows
  constexpr int CPR = SLICE / 4;
  const int quarter = g.depth / 4;
  if (g.b16) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      for (int i = tid; i < quarter * CPR; i += NT) {
        const int r = q * quarter + i / CPR, col = (i % CPR) * 4;
        const bool ok = r < rows && col < width;
        const char* src = ok ? b_base + ((long long)(k0 + r) * g.sbk + (c0 + col)) * 4 : b_base;
        splitk::cp_async16(bs + swz(r, col), src, ok);
      }
      splitk::cp_async_commit();
    }
  } else {
    for (int i = tid; i < g.depth * SLICE; i += NT) {
      const int r = i / SLICE, col = i % SLICE;
      bs[swz(r, col)] = (r < rows && col < width)
                            ? load_elem(b_base, (long long)(k0 + r) * g.sbk +
                                                    (long long)(c0 + col) * g.sbn, g.b_bf16)
                            : 0.f;
    }
  }

  // 2. A's tile, rows [0, m) x K [k0, k0 + rows), staged as f32 [a_rows][lda]
  //    (eight loads a thread in flight; zeros outside) while the copies land;
  //    its scales by row tiles of bm (a row's amax by one warp); then each
  //    element's hi and lo bf16 carriers in place of it, hi in the low half
  const int total = g.a_rows * g.depth;
  for (int i0 = tid; i0 < total; i0 += 8 * NT) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * NT, r = i / g.depth, kk = i % g.depth;
      v[j] = i < total && r < g.m && kk < rows
                 ? load_elem(a_base, (long long)r * g.sam + (long long)(k0 + kk) * g.sak,
                             g.a_bf16)
                 : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * NT;
      if (i < total) as[(i / g.depth) * g.lda + i % g.depth] = v[j];
    }
  }
  __syncthreads();
  const int atiles = (g.m + g.bm - 1) / g.bm;
  auto row_tiles = [&](Scale* out) {  // rowmax -> the row tiles' scales
    __syncthreads();
    if (tid < atiles) {
      float v = 0.f;
      for (int r = tid * g.bm; r < min(g.m, (tid + 1) * g.bm); ++r) v = fmaxf(v, rowmax[r]);
      out[tid] = tile_scale<FP8>(v);
    }
    __syncthreads();
  };
  for (int r = warp; r < g.m; r += NT / 32) {
    float v = 0.f;
    for (int kk = lane; kk < rows; kk += 32) v = fmaxf(v, fabsf(as[r * g.lda + kk]));
    for (int off = 16; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) rowmax[r] = v;
  }
  row_tiles(a_s);
  if constexpr (X3) {
    for (int r = warp; r < g.m; r += NT / 32) {
      const Scale sc = a_s[r / g.bm];
      float v = 0.f;
      for (int kk = lane; kk < rows; kk += 32) v = ramax1<FP8>(v, as[r * g.lda + kk], sc);
      for (int off = 16; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) rowmax[r] = v;
    }
    row_tiles(a_sr);
  }
  for (int i = tid; i < g.m * g.depth; i += NT) {
    const int r = i / g.depth, kk = i % g.depth;
    float* p = as + r * g.lda + kk;
    const Scale sc = a_s[r / g.bm];
    const float x = *p, h = quant<FP8>(x, sc);
    const float l = X3 ? quant<FP8>(residual(x, h, sc), a_sr[r / g.bm]) : 0.f;
    *reinterpret_cast<unsigned*>(p) = pack_bf16(h, l);
  }

  // 3. B's tile scale over the cluster (the amax of each copy group as it
  //    lands)
  float amax = 0.f;
  const float4* bs4 = reinterpret_cast<const float4*>(bs);
  if (g.b16) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q == 0) splitk::cp_async_wait<3>();
      else if (q == 1) splitk::cp_async_wait<2>();
      else if (q == 2) splitk::cp_async_wait<1>();
      else splitk::cp_async_wait<0>();
      __syncthreads();
      for (int i = tid; i < quarter * CPR; i += NT) amax = amax4(amax, bs4[q * quarter * CPR + i]);
    }
  } else {
    __syncthreads();
    for (int i = tid; i < g.depth * CPR; i += NT) amax = amax4(amax, bs4[i]);
  }
  const Scale sb =
      tile_scale<FP8>(cluster_max(block_amax(amax, red), &slot[0], &outv[0], g.csize));

  // 4. the products: warp w's 16 weight columns nw.. (the MMA's rows) by
  //    the <= 16 activation rows (its n, one n8 block up to 8 rows); an
  //    activation pair (k, k + 1) is two staged words, its hi halves one
  //    bf16x2 register and its lo halves another.  Under sb alone: hi of
  //    each weight, hi.hi and lo.hi, and (x3) the residual x - hi*sb, kept
  //    in x's place, and its amax; then, under srb, lo of each residual
  //    and hi.lo.  Each weight is quantized once a scale.
  const int gid = lane / 4, tig = lane % 4, nw = (warp % 4) * 16;
  const int steps = g.depth / 16, half = (steps + 1) / 2;
  const int s_lo = warp < 4 ? 0 : half * 16, s_hi = warp < 4 ? half * 16 : g.depth;
  const bool two = g.m > 8;
  const unsigned* aw = reinterpret_cast<const unsigned*>(as);
  float dhh[2][4] = {}, dlh[2][4] = {}, dhl[2][4] = {};
  // a lane's eight weights of the first k16 step: a0..a3 are (k, k + 1) at
  // column nw + gid, +8 for odd j, k = 2 tig (j < 2) or 2 tig + 8.  The
  // swizzle of row s16 + r is row r's (s16 is a multiple of 16), so step
  // s16's are these plus s16 rows.
  int at[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = tig * 2 + (j / 2) * 8, col = nw + gid + (j & 1) * 8;
    at[2 * j] = swz(k, col);
    at[2 * j + 1] = swz(k + 1, col);
  }
  auto acts = [&](int s16, int jb, unsigned (&xh)[2], unsigned (&xl)[2]) {
    const int ai = (gid + 8 * jb) * g.lda + s16 + tig * 2;
    const uint2 p0 = *reinterpret_cast<const uint2*>(aw + ai);
    const uint2 p1 = *reinterpret_cast<const uint2*>(aw + ai + 8);
    xh[0] = __byte_perm(p0.x, p0.y, 0x5410);
    xh[1] = __byte_perm(p1.x, p1.y, 0x5410);
    xl[0] = __byte_perm(p0.x, p0.y, 0x7632);
    xl[1] = __byte_perm(p1.x, p1.y, 0x7632);
  };
  float ra = 0.f;
  if (width > 0) {
#pragma unroll 2
    for (int s16 = s_lo; s16 < s_hi; s16 += 16) {
      float* w0 = bs + s16 * SLICE;
      unsigned wh[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x0 = w0[at[2 * j]], x1 = w0[at[2 * j + 1]];
        const float h0 = quant<FP8>(x0, sb), h1 = quant<FP8>(x1, sb);
        wh[j] = pack_bf16(h0, h1);
        if constexpr (X3) {
          const float r0 = residual(x0, h0, sb), r1 = residual(x1, h1, sb);
          ra = fmaxf(ra, fmaxf(fabsf(r0), fabsf(r1)));
          w0[at[2 * j]] = r0;
          w0[at[2 * j + 1]] = r1;
        }
      }
#pragma unroll
      for (int jb = 0; jb < 2; ++jb) {
        if (jb == 1 && !two) break;
        unsigned xh[2], xl[2];
        acts(s16, jb, xh, xl);
        splitk::mma16816(dhh[jb], wh[0], wh[1], wh[2], wh[3], xh[0], xh[1]);
        if constexpr (X3) splitk::mma16816(dlh[jb], wh[0], wh[1], wh[2], wh[3], xl[0], xl[1]);
      }
    }
  }
  Scale srb{0.f, 0.f};
  if constexpr (X3) {
    srb = tile_scale<FP8>(cluster_max(block_amax(ra, red), &slot[1], &outv[1], g.csize));
    if (width > 0) {
#pragma unroll 2
      for (int s16 = s_lo; s16 < s_hi; s16 += 16) {
        const float* w0 = bs + s16 * SLICE;
        unsigned wl[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wl[j] = pack_bf16(quant<FP8>(w0[at[2 * j]], srb), quant<FP8>(w0[at[2 * j + 1]], srb));
#pragma unroll
        for (int jb = 0; jb < 2; ++jb) {
          if (jb == 1 && !two) break;
          unsigned xh[2], xl[2];
          acts(s16, jb, xh, xl);
          splitk::mma16816(dhl[jb], wl[0], wl[1], wl[2], wl[3], xh[0], xh[1]);
        }
      }
    }
  }
  cluster_arrive();  // done with the other CTAs' slots; each waits below before leaving

  // the second K half's sums onto the first's (the slice is free now); the
  // int8 sums are exact integers, so the order does not change them
  __syncthreads();
  float* xch = bs + (warp % 4) * 32 * 24 + lane;
  if (warp >= 4) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      xch[e * 32] = dhh[e / 4][e % 4];
      xch[(8 + e) * 32] = dlh[e / 4][e % 4];
      xch[(16 + e) * 32] = dhl[e / 4][e % 4];
    }
  }
  __syncthreads();
  if (warp < 4) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      dhh[e / 4][e % 4] += xch[e * 32];
      if constexpr (X3) {
        dlh[e / 4][e % 4] += xch[(8 + e) * 32];
        dhl[e / 4][e % 4] += xch[(16 + e) * 32];
      }
    }
  }

  // 5. the tile's term; element e of a thread is C[8 (e / 4) + 2 tig + (e & 1)]
  //    [c0 + nw + gid + 8 ((e % 4) / 2)]
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int r = (e / 4) * 8 + tig * 2 + (e & 1), ta = min(r, g.m - 1) / g.bm;
    v[e] = term<X3>(dlh[e / 4][e % 4], dhl[e / 4][e % 4], dhh[e / 4][e % 4], a_s[ta].s,
                    X3 ? a_sr[ta].s : 0.f, sb.s, srb.s);
  }
  cluster_wait();
  if (width <= 0) return;
  const bool holds = tid < TERM_NT;  // the first four warps hold the term
  float* cb = g.c + bz * static_cast<long long>(g.m) * g.n;
  auto store = [&](const float (&x)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int r = (e / 4) * 8 + tig * 2 + (e & 1), col = c0 + nw + gid + ((e % 4) >> 1) * 8;
      if (r < g.m && col < c1) cb[static_cast<long long>(r) * g.n + col] = x[e];
    }
  };
  if (g.kt == 1) {
    if (!holds) return;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(0.f, v[e]);
    store(v);
    return;
  }
  // the K tiles' terms summed in kq order by the CTA that draws the last ticket
  const long long blk = (bz * g.nt + nq) * g.csize + rank;
  float* part = g.ws + (blk * g.kt + kq) * PART;
  if (holds) {
#pragma unroll
    for (int e = 0; e < 8; ++e) part[e * TERM_NT + tid] = v[e];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(g.tickets + blk, 1) == g.kt - 1;
  __syncthreads();
  if (!is_last || !holds) return;
  __threadfence();
  const float* parts = g.ws + blk * g.kt * PART;
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
#pragma unroll 4
  for (int q = 0; q < g.kt; ++q) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = __fadd_rn(v[e], __ldcg(parts + q * PART + e * TERM_NT + tid));
  }
  store(v);
  if (tid == 0) g.tickets[blk] = 0;
}

template <bool FP8, bool X3>
int launch(const Args& g, int batch, size_t smem, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  auto kern = lowp_decode_kernel<FP8, X3>;
  const cudaError_t err = smem_once(ready, kern, SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_cluster(kern, dim3(g.nt * g.csize, g.kt, batch), NT, smem, g.csize, stream,
                             g);
}

// The launch's plan (kernels/gemm_lowp.py:decode_plan computes the same),
// checked against the workspace.
template <bool FP8, bool X3>
int run(Args g, int batch, long long ws_floats, int n_tickets, cudaStream_t stream) {
  const int tile_w = min(g.bn, g.n), depth = min(g.bk, g.k);
  g.kt = (g.k + g.bk - 1) / g.bk;
  g.nt = (g.n + g.bn - 1) / g.bn;
  g.csize = (tile_w + SLICE - 1) / SLICE;
  g.depth = (depth + 15) / 16 * 16;
  g.a_rows = g.m <= 8 ? 8 : 16;
  g.lda = g.depth + 8;
  if (g.m > MAX_M || g.m < 1 || g.csize > MAX_CLUSTER || g.depth > MAX_DEPTH || g.kt > 65535 ||
      batch > 65535 || (long long)g.nt * g.csize > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)batch * g.nt * g.csize;
  if (g.kt > 1 && (g.ws == nullptr || g.tickets == nullptr || blocks > n_tickets ||
                   blocks * g.kt * PART > ws_floats))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)max(g.depth * SLICE, XCH) * 4 + (size_t)g.a_rows * g.lda * 4;
  return launch<FP8, X3>(g, batch, smem, stream);
}

}  // namespace dec

// ================================================ M > 16: quantize pass

namespace quantize {

constexpr int NT = 256, MAX_ROWS = 256;
constexpr int SMEM_MAX = MAX_ROWS * SLICE * 4;  // 64 KB

// One operand (per batch rows x cols, element (r, c) at p + r*s_r + c*s_c)
// under its quantization grid, and where its planes and scales go.
struct Op {
  const char* p;
  long long s_b, s_r, s_c;
  int is_bf16;
  int rows, cols;
  int tr, tc;     // the quantization tile
  int nr, nc;     // tiles along rows and columns
  int sr, sc;     // a tile's slices (CTAs) along rows and columns
  int srows;      // rows of a slice
  int vec;        // four elements along cols load as one aligned run
  bf16* hi;
  bf16* lo;
  long long ld;   // plane pitch (batch, rows, ld)
  float* s;       // scale planes (batch, nr, nc)
  float* r;
};

struct Args {
  Op op[2];          // A's tiles first, then B's
  long long tiles0;  // A's tiles over the batch
  int csize;
};

__device__ __forceinline__ float4 load4(const char* base, long long off, int is_bf16) {
  if (is_bf16) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(base + off * 2));
    const __nv_bfloat162 p0 = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 p1 = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    return make_float4(__low2float(p0), __high2float(p0), __low2float(p1), __high2float(p1));
  }
  return __ldg(reinterpret_cast<const float4*>(base + off * 4));
}

// Grid (tiles of A and B x CSIZE), clusters of CSIZE along x; a CTA holds
// rows [r0, r1) x columns [c0, c1) of its tile as f32 [srows][64].
template <bool FP8, bool X3>
__global__ void __launch_bounds__(NT, 3) lowp_quant_kernel(const __grid_constant__ Args g) {
  extern __shared__ __align__(16) float xs[];
  __shared__ float red[32], slot[2], outv[2];
  const int tid = threadIdx.x, rank = cluster_rank();
  long long ti = blockIdx.x / g.csize;
  const bool is_b = ti >= g.tiles0;
  const Op& o = g.op[is_b ? 1 : 0];
  if (is_b) ti -= g.tiles0;
  const long long per_batch = static_cast<long long>(o.nr) * o.nc;
  const long long bz = ti / per_batch, within = ti % per_batch;
  const int ir = static_cast<int>(within / o.nc), ic = static_cast<int>(within % o.nc);
  const int R1 = min(o.rows, (ir + 1) * o.tr), C1 = min(o.cols, (ic + 1) * o.tc);
  const int r0 = ir * o.tr + (rank / o.sc) * o.srows, r1 = min(R1, r0 + o.srows);
  const int c0 = ic * o.tc + (rank % o.sc) * SLICE, c1 = min(C1, c0 + SLICE);
  const int nrow = rank < o.sr * o.sc ? max(0, r1 - r0) : 0, ncol = max(0, c1 - c0);
  const int chunks = nrow * (SLICE / 4);
  const char* base = o.p + bz * o.s_b * (o.is_bf16 ? 2 : 4);
  float4* xs4 = reinterpret_cast<float4*>(xs);

  // load the slice (eight 16-byte runs a thread in flight), amax on the way
  constexpr int PER = MAX_ROWS * SLICE / 4 / NT;
  float amax = 0.f;
#pragma unroll
  for (int j0 = 0; j0 < PER; j0 += 8) {
    float4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = tid + (j0 + j) * NT, r = i / (SLICE / 4), ch = (i % (SLICE / 4)) * 4;
      v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < chunks && ch < ncol) {
        const long long off = (long long)(r0 + r) * o.s_r + (long long)(c0 + ch) * o.s_c;
        if (o.vec && ch + 4 <= ncol) {
          v[j] = load4(base, off, o.is_bf16);
        } else {
          float e4[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            e4[e] = ch + e < ncol ? load_elem(base, off + e * o.s_c, o.is_bf16) : 0.f;
          v[j] = make_float4(e4[0], e4[1], e4[2], e4[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = tid + (j0 + j) * NT;
      if (i < chunks) {
        xs4[i] = v[j];
        amax = amax4(amax, v[j]);
      }
    }
  }
  const Scale s = tile_scale<FP8>(cluster_max(block_amax(amax, red), &slot[0], &outv[0], g.csize));
  Scale sr{0.f, 0.f};
  if constexpr (X3) {
    float ra = 0.f;
    for (int i = tid; i < chunks; i += NT) {
      const float4 v = xs4[i];
      ra = ramax1<FP8>(ramax1<FP8>(ramax1<FP8>(ramax1<FP8>(ra, v.x, s), v.y, s), v.z, s), v.w, s);
    }
    sr = tile_scale<FP8>(cluster_max(block_amax(ra, red), &slot[1], &outv[1], g.csize));
  }
  cluster_arrive();
  if (rank == 0 && tid == 0) {
    o.s[ti] = s.s;  // ti = bz * nr * nc + ir * nc + ic
    if constexpr (X3) o.r[ti] = sr.s;
  }
  // the carrier planes: hi = q(x), lo = q(x - hi*s) under sr
  bf16* hi = o.hi + bz * o.rows * o.ld;
  bf16* lo = X3 ? o.lo + bz * o.rows * o.ld : nullptr;
  for (int i = tid; i < chunks; i += NT) {
    const int r = i / (SLICE / 4), ch = (i % (SLICE / 4)) * 4;
    if (ch >= ncol) continue;
    const float4 v = xs4[i];
    const float x[4] = {v.x, v.y, v.z, v.w};
    float h[4], l[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[e] = quant<FP8>(x[e], s);
      if constexpr (X3) l[e] = quant<FP8>(residual(x[e], h[e], s), sr);
    }
    const long long at = (long long)(r0 + r) * o.ld + c0 + ch;
    if (ch + 4 <= ncol && at % 4 == 0) {
      *reinterpret_cast<uint2*>(hi + at) = make_uint2(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]));
      if constexpr (X3)
        *reinterpret_cast<uint2*>(lo + at) =
            make_uint2(pack_bf16(l[0], l[1]), pack_bf16(l[2], l[3]));
    } else {
      for (int e = 0; e < min(4, ncol - ch); ++e) {
        hi[at + e] = __float2bfloat16_rn(h[e]);
        if constexpr (X3) lo[at + e] = __float2bfloat16_rn(l[e]);
      }
    }
  }
  cluster_wait();
}

inline Op make_op(const void* p, int is_bf16, long long s_b, long long s_r, long long s_c, int rows,
                  int cols, int tr, int tc, void* hi, void* lo, long long ld, float* s, float* r) {
  Op o;
  o.p = static_cast<const char*>(p);
  o.s_b = s_b; o.s_r = s_r; o.s_c = s_c;
  o.is_bf16 = is_bf16;
  o.rows = rows; o.cols = cols;
  o.tr = tr; o.tc = tc;
  o.nr = (rows + tr - 1) / tr;
  o.nc = (cols + tc - 1) / tc;
  const int tr_eff = min(tr, rows), tc_eff = min(tc, cols);
  o.sr = (tr_eff + MAX_ROWS - 1) / MAX_ROWS;
  o.srows = (tr_eff + o.sr - 1) / o.sr;
  o.sc = (tc_eff + SLICE - 1) / SLICE;
  const unsigned long long align = is_bf16 ? 8 : 16;
  o.vec = s_c == 1 && s_r % 4 == 0 && s_b % 4 == 0 && (o.nc == 1 || tc % 4 == 0) &&
          reinterpret_cast<unsigned long long>(p) % align == 0;
  o.hi = static_cast<bf16*>(hi);
  o.lo = static_cast<bf16*>(lo);
  o.ld = ld;
  o.s = s;
  o.r = r;
  return o;
}

template <bool FP8, bool X3>
int run(const Args& g, int batch, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  auto kern = lowp_quant_kernel<FP8, X3>;
  const cudaError_t err = smem_once(ready, kern, SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = g.tiles0 + (long long)batch * g.op[1].nr * g.op[1].nc;
  const int srows = max(g.op[0].srows, g.op[1].srows);
  if (tiles * g.csize > 0x7fffffff) return (int)cudaErrorInvalidValue;
  return (int)launch_cluster(kern, dim3(static_cast<unsigned>(tiles * g.csize)), NT,
                             (size_t)srows * SLICE * 4, g.csize, stream, g);
}

}  // namespace quantize

// ================================================ M > 16: the mainloop

namespace wg {

constexpr int BM = 64, BN = 128, BK = 64, NT = 384, STAGES = 4;
constexpr int A_PLANE = BM * sm90::ROW;  // 64 rows x 64 K of bf16, K-major: 8 KB
constexpr int B_PLANE = BN * sm90::ROW;  // 64 K x 128 columns, two MN-major blocks: 16 KB

// A stage: A_hi, B_hi, then A_lo, B_lo at x3
template <bool X3>
struct Ring {
  static constexpr int STAGE = (X3 ? 2 : 1) * (A_PLANE + B_PLANE);
  static constexpr size_t smem = 1024 + STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);
};

struct Args {
  float* c;
  const float* sa;   // (batch, mt, kt), and sra the residual's
  const float* sra;
  const float* sb;   // (batch, kt, nt), and srb
  const float* srb;
  int m, n, k, bm, bn, bk, mt, nt, kt;
};

// One m64n64k16 bf16 wgmma into 32 f32 accumulators a thread (d = a.b when
// scale_d is 0, d += a.b otherwise); TA / TB: the operands' transpose bits.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

__device__ __forceinline__ void fence32(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Grid (M tiles of 64, N tiles of 128, batch).  Warpgroup 0's thread 0 is
// the producer; warpgroups 1 and 2 each own 64 of the tile's 128 columns.
template <bool X3>
__global__ void __launch_bounds__(NT, 1)
lowp_sm90_kernel(const __grid_constant__ CUtensorMap map_ahi,
                 const __grid_constant__ CUtensorMap map_bhi,
                 const __grid_constant__ CUtensorMap map_alo,
                 const __grid_constant__ CUtensorMap map_blo, const Args g) {
  using Rg = Ring<X3>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * Rg::STAGE);
  uint64_t* empty = full + STAGES;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, bz = blockIdx.z;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int nk = (g.k + BK - 1) / BK;
  const int wgi = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wgi == 0) {
    if (t == 0) {
      int stage = 0, phase = 0;
      for (int kt = 0; kt < nk; ++kt) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * Rg::STAGE;
        const int k0 = kt * BK;
        sm90::mbar_arrive_tx(&full[stage], Rg::STAGE);
        sm90::tma_tile<BM, true>(st, &map_ahi, &full[stage], m0, k0, bz);
        sm90::tma_tile<BN, false>(st + A_PLANE, &map_bhi, &full[stage], n0, k0, bz);
        if constexpr (X3) {
          sm90::tma_tile<BM, true>(st + A_PLANE + B_PLANE, &map_alo, &full[stage], m0, k0, bz);
          sm90::tma_tile<BN, false>(st + 2 * A_PLANE + B_PLANE, &map_blo, &full[stage], n0, k0,
                                    bz);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // a thread's two rows (h = 0, 1: row r0 + 8 h) may lie in two A tiles
  // (bm < 64); its 64 columns lie in one B tile
  const int cw = wgi - 1, lane = t % 32, r0 = m0 + (t / 32) * 16 + lane / 4;
  const int nj = min((n0 + 64 * cw) / g.bn, g.nt - 1);
  const float* sa[2];
  const float* sra[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long at = (static_cast<long long>(bz) * g.mt + min(r0 + 8 * h, g.m - 1) / g.bm) *
                         g.kt;
    sa[h] = g.sa + at;
    sra[h] = g.sra + at;
  }
  const float* sb = g.sb + static_cast<long long>(bz) * g.kt * g.nt + nj;
  const float* srb = g.srb + static_cast<long long>(bz) * g.kt * g.nt + nj;
  float acc[32], hh[32], lh[32], hl[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  auto desc_a = [](const unsigned char* p, int kk) { return sm90::make_desc(p + kk * 32, 16, 1024); };
  auto desc_b = [](const unsigned char* p, int kk) {
    return sm90::make_desc(p + kk * 16 * sm90::ROW, sm90::BLOCK, 1024);
  };
  auto release = [&](int s) {
    if (t % 32 == 0) sm90::mbar_arrive(&empty[s]);
  };
  // the partials of quantization K-tile kq, scaled, into acc in the plain
  // version's order (their wgmmas have completed)
  auto fold = [&](int kq) {
    const float s_b = sb[static_cast<long long>(kq) * g.nt];
    const float s_rb = X3 ? srb[static_cast<long long>(kq) * g.nt] : 0.f;
    const float s_a[2] = {sa[0][kq], sa[1][kq]};
    const float s_ra[2] = {X3 ? sra[0][kq] : 0.f, X3 ? sra[1][kq] : 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      acc[i] = __fadd_rn(acc[i], term<X3>(X3 ? lh[i] : 0.f, X3 ? hl[i] : 0.f, hh[i], s_a[h],
                                           s_ra[h], s_b, s_rb));
    }
  };
  auto fence_parts = [&] {
    fence32(hh);
    if constexpr (X3) {
      fence32(lh);
      fence32(hl);
    }
  };
  auto issue = [&](const unsigned char* st, int kk, int sd) {
    const unsigned char* ah = st;
    const unsigned char* bh = st + A_PLANE + cw * sm90::BLOCK;
    wgmma_m64n64k16<0, 1>(hh, desc_a(ah, kk), desc_b(bh, kk), sd);
    if constexpr (X3) {
      const unsigned char* al = st + A_PLANE + B_PLANE;
      const unsigned char* bl = st + 2 * A_PLANE + B_PLANE + cw * sm90::BLOCK;
      wgmma_m64n64k16<0, 1>(lh, desc_a(al, kk), desc_b(bh, kk), sd);
      wgmma_m64n64k16<0, 1>(hl, desc_a(ah, kk), desc_b(bl, kk), sd);
    }
  };
  int stage = 0, phase = 0, pending = -1;  // pending: a stage whose wgmmas may be in flight
  auto next = [&] {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  // every quantization K-tile is whole stages (bk a multiple of 64, or
  // one tile): its stages but the last keep one commit group in flight;
  // its last waits for all and folds.  No wait or fold sits in a branch,
  // so ptxas keeps the wgmmas asynchronous.  The K tail's steps multiply
  // TMA's zeros.
  auto stage_in = [&](int first) {
    sm90::mbar_wait(&full[stage], phase);
    const unsigned char* st = smem + stage * Rg::STAGE;
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) issue(st, kk, kk == 0 && first ? 0 : 1);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  };
  int kt = 0;
  const int tiles = (g.k + g.bk - 1) / g.bk;
  for (int kq = 0; kq < tiles; ++kq) {
    const int kt_end = min(nk, (int)(((long long)(kq + 1) * g.bk + BK - 1) / BK));
    int first = 1;
    for (; kt + 1 < kt_end; ++kt, first = 0) {
      stage_in(first);
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_parts();
      if (pending >= 0) release(pending);
      pending = stage;
      next();
    }
    stage_in(first);  // the tile's last stage
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_parts();
    if (pending >= 0) release(pending);
    release(stage);
    pending = -1;
    next();
    ++kt;
    fold(kq);
  }

  // accumulator i of thread t: row 16 (t / 32) + (t % 32) / 4 (+8 for i & 2),
  // column 8 (i / 4) + 2 (t % 4) (+1 for i & 1) of the consumer's 64 x 64
  float* cb = g.c + static_cast<long long>(bz) * g.m * g.n;
  const int cbase = n0 + 64 * cw;
  const bool pairs = g.n % 2 == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = cbase + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= g.m) continue;
      float* dst = cb + static_cast<long long>(r) * g.n + col;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pairs && col + 1 < g.n) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        if (col < g.n) dst[0] = v0;
        if (col + 1 < g.n) dst[1] = v1;
      }
    }
  }
}

template <bool X3>
int launch(const Args& s, const CUtensorMap (&maps)[4], int batch, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  auto kern = lowp_sm90_kernel<X3>;
  const cudaError_t err = smem_once(ready, kern, Ring<X3>::smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s.m + BM - 1) / BM, (s.n + BN - 1) / BN, batch);
  kern<<<grid, NT, Ring<X3>::smem, stream>>>(maps[0], maps[1], maps[2], maps[3], s);
  return (int)cudaGetLastError();
}

}  // namespace wg

// The planes' and scales' pointers (M > 16).
struct Planes {
  void* a_hi;
  void* a_lo;
  void* b_hi;
  void* b_lo;
  float* sa;
  float* sra;
  float* sb;
  float* srb;
};

template <bool FP8, bool X3>
int run_prefill(const GemmArgs& g, int batch, int bm, int bn, int bk, const Planes& p,
                cudaStream_t stream) {
  if ((bn < g.n && bn % 64) || (bk < g.k && bk % wg::BK) || batch > 65535 ||
      (g.n + wg::BN - 1) / wg::BN > 65535 || p.a_hi == nullptr || p.b_hi == nullptr ||
      (X3 && (p.a_lo == nullptr || p.b_lo == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long lda = (g.k + 7) / 8 * 8, ldb = (g.n + 7) / 8 * 8;
  quantize::Args q;
  q.op[0] = quantize::make_op(g.a, g.a_bf16, g.sab, g.sam, g.sak, g.m, g.k, bm, bk, p.a_hi,
                              p.a_lo, lda, p.sa, p.sra);
  q.op[1] = quantize::make_op(g.b, g.b_bf16, g.sbb, g.sbk, g.sbn, g.k, g.n, bk, bn, p.b_hi,
                              p.b_lo, ldb, p.sb, p.srb);
  q.tiles0 = (long long)batch * q.op[0].nr * q.op[0].nc;
  q.csize = max(q.op[0].sr * q.op[0].sc, q.op[1].sr * q.op[1].sc);
  if (q.csize > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  int err = quantize::run<FP8, X3>(q, batch, stream);
  if (err) return err;

  CUtensorMap maps[4] = {};
  bool ok = sm90::encode(&maps[0], p.a_hi, g.k, g.m, batch, lda, g.m * lda, 64) &&
            sm90::encode(&maps[1], p.b_hi, g.n, g.k, batch, ldb, g.k * ldb, 64);
  if (X3)
    ok = ok && sm90::encode(&maps[2], p.a_lo, g.k, g.m, batch, lda, g.m * lda, 64) &&
         sm90::encode(&maps[3], p.b_lo, g.n, g.k, batch, ldb, g.k * ldb, 64);
  if (!ok) return (int)cudaErrorInvalidValue;
  wg::Args s;
  s.c = g.c;
  s.sa = p.sa; s.sra = p.sra; s.sb = p.sb; s.srb = p.srb;
  s.m = g.m; s.n = g.n; s.k = g.k;
  s.bm = bm; s.bn = bn; s.bk = bk;
  s.mt = q.op[0].nr;
  s.kt = q.op[0].nc;
  s.nt = q.op[1].nc;
  return wg::launch<X3>(s, maps, batch, stream);
}

template <bool FP8, bool X3>
int run_decode(const GemmArgs& g, int batch, int bm, int bn, int bk, const SplitWs& w,
               cudaStream_t stream) {
  dec::Args d;
  d.a = static_cast<const char*>(g.a);
  d.sab = g.sab; d.sam = g.sam; d.sak = g.sak;
  d.a_bf16 = g.a_bf16;
  d.b = static_cast<const char*>(g.b);
  d.sbb = g.sbb; d.sbk = g.sbk; d.sbn = g.sbn;
  d.b_bf16 = g.b_bf16;
  d.c = g.c;
  d.m = g.m; d.n = g.n; d.k = g.k;
  d.bm = bm; d.bn = bn; d.bk = bk;
  d.b16 = !g.b_bf16 && g.sbn == 1 && g.sbk % 4 == 0 && g.sbb % 4 == 0 && g.n % 4 == 0 &&
          (bn >= g.n || bn % 4 == 0) && reinterpret_cast<unsigned long long>(g.b) % 16 == 0;
  d.ws = w.ws;
  d.tickets = w.tickets;
  return dec::run<FP8, X3>(d, batch, w.ws_floats, w.n_tickets, stream);
}

template <bool FP8, bool X3>
int dispatch(const GemmArgs& g, int batch, int bm, int bn, int bk, const SplitWs& w,
             const Planes& p, int* loop, cudaStream_t stream) {
  if (g.m <= dec::MAX_M) {
    *loop = LOOP_SPLITK;
    return run_decode<FP8, X3>(g, batch, bm, bn, bk, w, stream);
  }
  *loop = LOOP_SM90;
  return run_prefill<FP8, X3>(g, batch, bm, bn, bk, p, stream);
}

}  // namespace

// policy: 0 int8, 1 fp8, 2 int8x3, 3 fp8x3.  A (batch, m, k) and B (batch,
// k, n), each f32 or bf16 with element strides; (bm, bn, bk) the
// quantization grid.  M <= 16 runs the decode kernel on the workspace (ws,
// ws_floats, tickets, n_tickets: zero tickets, kernels/gemm_tiled.py); M >
// 16 writes the planes a_hi / a_lo (batch, m, ceil(k / 8) * 8) and b_hi /
// b_lo (batch, k, ceil(n / 8) * 8), bf16 (lo: x3 only), and the scales sa /
// sra (batch, mt, kt) and sb / srb (batch, kt, nt), then multiplies them.
// *loop reports the mainloop that ran (rt::Mainloop).
extern "C" int gemm_lowp_launch(const void* a, int a_bf16, long long sab, long long sam,
                                long long sak, const void* b, int b_bf16, long long sbb,
                                long long sbk, long long sbn, float* c, int batch, int m, int n,
                                int k, int bm, int bn, int bk, int policy, float* ws,
                                long long ws_floats, int* tickets, int n_tickets, void* a_hi,
                                void* a_lo, void* b_hi, void* b_lo, float* sa, float* sra,
                                float* sb, float* srb, int* loop, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bm < 1 || bn < 1 || bk < 1 || m < 1 || n < 1 || k < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  const GemmArgs g =
      make_args(a, a_bf16, sab, sam, sak, b, b_bf16, sbb, sbk, sbn, c, m, n, k);
  const SplitWs w{1, ws, ws_floats, tickets, n_tickets};
  const Planes p{a_hi, a_lo, b_hi, b_lo, sa, sra, sb, srb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (policy) {
    case 0: return dispatch<false, false>(g, batch, bm, bn, bk, w, p, loop, s);
    case 1: return dispatch<true, false>(g, batch, bm, bn, bk, w, p, loop, s);
    case 2: return dispatch<false, true>(g, batch, bm, bn, bk, w, p, loop, s);
    case 3: return dispatch<true, true>(g, batch, bm, bn, bk, w, p, loop, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
