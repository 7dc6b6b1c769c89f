// The Hopper mainloop of the bf16 rung: TMA or a converting producer
// warpgroup feeding wgmma, for gemm_tiled (M > 16) and the grouped forward
// and dx (CTA row tiles of 64 and 128).  Included by gemm_common.cuh.
//
// C = A.B, bf16 operands, f32 accumulators and output.  One CTA computes a
// BM x 128 tile of C (BM = 128: two consumer warpgroups of 64 rows; BM = 64:
// one) and walks K in 64-deep steps through a ring of STAGES shared-memory
// stages, each holding A (BM x 64) and B (64 x 128) in the 128-byte swizzled
// layout that wgmma reads.  Warpgroup 0 is the producer; each stage has a
// "full" and an "empty" mbarrier.
//
// The producer fills each operand by one of two paths, chosen per operand
// on the host:
//   (a) TMA: a bf16 operand whose contiguous dimension is K or M/N, with a
//       16-byte aligned base and strides, goes straight into the swizzled
//       layout by cp.async.bulk.tensor (one thread; the tensor map is
//       encoded on the host and passed as a __grid_constant__).  The
//       hardware's out-of-bounds fill gives the ragged edges' zeros.
//   (b) converting: an f32 operand, or any other stride pattern, is read by
//       the 128 producer threads (eight elements along the contiguous
//       dimension as one or two 16-byte loads where aligned, scalar loads
//       otherwise), rounded with __float2bfloat16_rn (torch's
//       `.to(torch.bfloat16)`) and stored into the same swizzled layout.
//       f32 weights are never rewritten as bf16 in device memory.
// The swizzle (16-byte chunk c of 128-byte row r at chunk c ^ (r % 8), in
// 1024-byte aligned atoms of 8 rows) is TMA's SWIZZLE_128B.  An operand
// whose contiguous dimension is K is stored K-major (a row of 64 K values
// per M/N index); one contiguous along M/N is stored MN-major (64 M/N values
// per K row, in 8 KB blocks of 64), read by wgmma with its transpose bit:
// train dW's x^T (M-contiguous A) and the NN weights (N-contiguous B).
//
// Each consumer issues four wgmma m64n128k16 per stage, keeps one group in
// flight (wait_group 1) and then releases the previous stage.  Every
// PROMOTE stages (256 of K) it waits for its groups and adds the wgmma
// accumulator into an f32 total on the CUDA cores, and the next stage's
// first wgmma overwrites the accumulator (scale_d 0): the tensor cores'
// own f32 accumulation loses precision with the K it spans (on an H100 80GB
// HBM3 a whole-K accumulator reads 16x SGEMM's max error at K = 8192,
// 256-deep chunks summed in f32 half of it; tools/probe_accumulation.py).
// No register rebalancing (setmaxnreg): a consumer holds 64 accumulators
// and 64 totals, and the CTA's ~130 KB of stages already keep it alone on
// its SM.  The epilogue stores the f32 totals straight to global memory,
// masked for ragged M and N (two-float stores where N is even); nothing is
// padded or copied.
//
// Group-rows mode (G_ROWS, the grouped forward): the CTA reads its tile's
// group id before any load; a dead tile (id E) stores zeros and loads
// nothing; B is w[g] (TMA: coordinate g of a 3-D map over (E, K, N)).  The
// grid's x walks row tiles fastest, so the row tiles that share an expert's
// weight N-tile run together and that tile comes from HBM once and from L2
// after; y walks N tiles, z the batch.
//
// Group-K mode (the grouped dW at bf16: dw[g] = x_g^T.dy_g), its own
// persistent kernel (gemm_sm90_group_k_kernel): one CTA per SM walks the
// 128 x 128 tiles of dw over every group, D tiles fastest, so one tile's
// epilogue overlaps the producer's loads of the next (a run is short: 256
// rows on average at Mixtral's train shape, four K stages).  A tile's K
// walk starts at offsets[g] and ends at offsets[g + 1]; A = x^T MN-major
// (M-contiguous), B = dy MN-major (row-major, N-contiguous), each by TMA
// where it is bf16 and aligned (the wrapper hands bf16), else converted.
// A run's end is not the tensor's edge, so TMA's out-of-bounds fill does
// not zero the next group's rows: the last K stage of a run that 64 does
// not divide has its TMA loads land on a barrier of the producer's own,
// which then zeros the rows at or past offsets[g + 1] in shared memory
// before it hands the stage to the consumers (the converting producer
// writes those zeros itself, reading the run as an operand of K extent =
// its length).  An empty run loads nothing and stores zeros.  No sum
// crosses tiles and no atomics are used, so the result is the same on
// every run.  (A converting producer for both operands read 48 KB a stage
// through registers and took 2.2-2.6 ms at Mixtral's train shape; TMA
// takes 1.25.)
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <stdint.h>

namespace rt {
namespace sm90 {

constexpr int BN = 128, BK = 64, STAGES = 4;
constexpr int PROMOTE = 4;         // K stages a wgmma accumulator spans before its f32 total takes it
constexpr int ROW = 128;           // bytes of one swizzle row: 64 bf16
constexpr int BLOCK = 64 * ROW;    // one MN-major block: 64 K rows of 64 M/N values
constexpr int B_TILE = BN * ROW;   // 16 KB

template <int BM>
struct Cfg {
  static constexpr int CONSUMERS = BM / 64;
  static constexpr int NT = 128 * (CONSUMERS + 1);
  static constexpr int A_TILE = BM * ROW;
  static constexpr int STAGE = A_TILE + B_TILE;
  static constexpr size_t smem = 1024 + STAGES * STAGE + (2 * STAGES + 1) * sizeof(uint64_t);
};

// An operand as the producer reads it: index (mn, k) at p + mn*s_mn + k*s_k
// (+ the batch or group offset), elements of 2 (bf16) or 4 bytes.
struct Operand {
  const char* p;
  long long s_mn, s_k, s_batch;
  int mn, k;
  int bf16;
  int tma;   // path (a); else (b)
  int vec;   // eight elements along the stored-contiguous dimension are one aligned run
};

struct Args {
  Operand a, b;
  float* c;
  int m, n, k;
  const int* groups;  // G_ROWS: group id per row tile
  int num_groups;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle.  K-major: SBO is the
// 8-row atom (1024 B), LBO unused.  MN-major: LBO is the stride between
// 64-wide M/N blocks, SBO between groups of 8 K rows.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// One m64n128k16 bf16 wgmma into 64 f32 accumulators per thread (d = a.b
// when scale_d is 0, d += a.b otherwise); TA / TB set the transpose
// (MN-major) bit of each shared-memory operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// Keep the compiler from touching accumulators that a wgmma still owns.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// Eight elements as bf16 bits: (mn, k..k+7) when KMAJOR, else (mn..mn+7, k);
// zeros off the edge.
template <bool KMAJOR>
__device__ __forceinline__ uint4 load_chunk(const Operand& o, const char* base, int mn, int k) {
  const long long step = KMAJOR ? o.s_k : o.s_mn;
  const int left = KMAJOR ? o.k - k : o.mn - mn;
  const bool in = KMAJOR ? mn < o.mn : k < o.k;
  const long long off = static_cast<long long>(mn) * o.s_mn + static_cast<long long>(k) * o.s_k;
  if (in && left >= 8 && o.vec) {
    if (o.bf16) return *reinterpret_cast<const uint4*>(base + off * 2);
    const float4* f = reinterpret_cast<const float4*>(base + off * 4);
    const float4 f0 = f[0], f1 = f[1];
    return make_uint4(pack2(f0.x, f0.y), pack2(f0.z, f0.w), pack2(f1.x, f1.y), pack2(f1.z, f1.w));
  }
  float x[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = (in && e < left) ? load_elem(base, off + e * step, o.bf16) : 0.f;
  return make_uint4(pack2(x[0], x[1]), pack2(x[2], x[3]), pack2(x[4], x[5]), pack2(x[6], x[7]));
}

// Chunk i of thread t in an R x 64 tile: its (mn, k) offset from the tile's
// corner (eight elements along the stored-contiguous dimension) and its
// byte offset in the swizzled tile.
template <int R, bool KMAJOR>
__device__ __forceinline__ void chunk_at(int q, int& dmn, int& dk, int& soff) {
  if constexpr (KMAJOR) {
    const int r = q / 8, c = q % 8;
    dmn = r;
    dk = 8 * c;
    soff = r * ROW + ((c ^ (r & 7)) << 4);
  } else {
    constexpr int CPR = R / 8;  // chunks per K row
    const int kr = q / CPR, cm = q % CPR;
    dmn = 8 * cm;
    dk = kr;
    soff = (cm / 8) * BLOCK + kr * ROW + (((cm % 8) ^ (kr & 7)) << 4);
  }
}

// Path (b): the producer warpgroup's thread t fills its share of an R x 64
// operand tile.  A tile that lies inside the operand and is aligned issues
// all its 16-byte loads before converting any (R / 16 chunks a thread in
// flight); an edge or strided tile goes four chunks at a time, element by
// element where it must.
template <int R, bool KMAJOR>
__device__ __forceinline__ void convert_tile(unsigned char* tile, const Operand& o,
                                             const char* base, int mn0, int k0, int t) {
  constexpr int PER = R * BK / 8 / 128;
  if (o.vec && mn0 + R <= o.mn && k0 + BK <= o.k) {
    if (o.bf16) {
      uint4 v[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        int dmn, dk, soff;
        chunk_at<R, KMAJOR>(t + j * 128, dmn, dk, soff);
        const long long off = (long long)(mn0 + dmn) * o.s_mn + (long long)(k0 + dk) * o.s_k;
        v[j] = __ldg(reinterpret_cast<const uint4*>(base + off * 2));
      }
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        int dmn, dk, soff;
        chunk_at<R, KMAJOR>(t + j * 128, dmn, dk, soff);
        *reinterpret_cast<uint4*>(tile + soff) = v[j];
      }
    } else {
      float4 f[2 * PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        int dmn, dk, soff;
        chunk_at<R, KMAJOR>(t + j * 128, dmn, dk, soff);
        const long long off = (long long)(mn0 + dmn) * o.s_mn + (long long)(k0 + dk) * o.s_k;
        const float4* p = reinterpret_cast<const float4*>(base + off * 4);
        f[2 * j] = __ldg(p);
        f[2 * j + 1] = __ldg(p + 1);
      }
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        int dmn, dk, soff;
        chunk_at<R, KMAJOR>(t + j * 128, dmn, dk, soff);
        const float4 a = f[2 * j], b = f[2 * j + 1];
        *reinterpret_cast<uint4*>(tile + soff) =
            make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y), pack2(b.z, b.w));
      }
    }
    return;
  }
#pragma unroll
  for (int i0 = 0; i0 < PER; i0 += 4) {
    uint4 v[4];
    int off[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int dmn, dk;
      chunk_at<R, KMAJOR>(t + (i0 + j) * 128, dmn, dk, off[j]);
      v[j] = load_chunk<KMAJOR>(o, base, mn0 + dmn, k0 + dk);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) *reinterpret_cast<uint4*>(tile + off[j]) = v[j];
  }
}

// TMA loads of one operand tile of R M/N rows: K-major one R x 64 box,
// MN-major R / 64 boxes of 64 x 64.
template <int R, bool KMAJOR>
__device__ __forceinline__ void tma_tile(unsigned char* tile, const CUtensorMap* map,
                                         uint64_t* bar, int mn0, int k0, int z) {
  if constexpr (KMAJOR) {
    tma_load(tile, map, bar, k0, mn0, z);
  } else {
#pragma unroll
    for (int h = 0; h < R / 64; ++h) tma_load(tile + h * BLOCK, map, bar, mn0 + 64 * h, k0, z);
  }
}

// Zero K rows [keep, 64) of an R x 64 MN-major tile (R / 64 blocks of 64 K
// rows of 128 bytes; a whole row, so the swizzle does not matter).
template <int R>
__device__ __forceinline__ void zero_k_rows(unsigned char* tile, int keep, int t, int nt) {
  const int n = (64 - keep) * 8;  // 16-byte chunks per block
  for (int i = t; i < n * (R / 64); i += nt) {
    const int h = i / n, c = i % n;
    *reinterpret_cast<uint4*>(tile + h * BLOCK + (keep + c / 8) * ROW + (c % 8) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// The producer's K walk of one tile: nk stages of A (BM x 64) and B (64 x
// 128) into the ring, TMA or converted (all 128 threads; thread 0 alone
// when both operands take TMA and there is no `tail`, warp 0 when there
// is).  (stage, phase)
// carry over from tile to tile in the persistent mode.  Group-K mode
// (`tail` set, both operands MN-major): the walk is the group's run, TMA
// boxes start at row k_begin + k0, and a stage that runs past the run's
// end (the last of a run that 64 does not divide) has its TMA loads land
// on `tail`; every producer thread waits for them, zeros the rows at or
// past the end, and then the stage is handed over, so no row of the next
// group is multiplied (the converting path writes those zeros itself).
// Only threads that are needed wait on `empty`: a warp that waits on a
// barrier whose phases it does not gate can fall two phases behind, read
// the parity it waits for as not yet reached, and never leave (the
// group-K kernel hung so, now and then, when all four producer warps
// walked a TMA-only ring; warp 0 alone stays in step with thread 0).
template <int BM, bool A_K, bool B_K>
__device__ __forceinline__ void produce(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                        int& stage, int& phase, const Operand& oa,
                                        const Operand& ob, const char* a_base,
                                        const char* b_base, const CUtensorMap* map_a,
                                        const CUtensorMap* map_b, int m0, int n0, int za, int zb,
                                        int nk, int t, uint64_t* tail = nullptr,
                                        int* tail_phase = nullptr, int k_begin = 0) {
  using C = Cfg<BM>;
  const bool convert = !(oa.tma && ob.tma);
  const uint32_t tx = (oa.tma ? C::A_TILE : 0) + (ob.tma ? B_TILE : 0);
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(&empty[stage], phase ^ 1);
    unsigned char* sa = smem + stage * C::STAGE;
    unsigned char* sb = sa + C::A_TILE;
    const int k0 = kt * BK;
    if constexpr (!A_K && !B_K) {
      if (tail != nullptr && tx && k0 + BK > oa.k) {  // a ragged last stage of a group's run
        if (t == 0) {
          mbar_arrive_tx(tail, tx);
          if (oa.tma) tma_tile<BM, false>(sa, map_a, tail, m0, k_begin + k0, za);
          if (ob.tma) tma_tile<BN, false>(sb, map_b, tail, n0, k_begin + k0, zb);
        }
        if (!oa.tma) convert_tile<BM, false>(sa, oa, a_base, m0, k0, t);
        if (!ob.tma) convert_tile<BN, false>(sb, ob, b_base, n0, k0, t);
        mbar_wait(tail, *tail_phase);
        *tail_phase ^= 1;
        if (oa.tma) zero_k_rows<BM>(sa, oa.k - k0, t, convert ? 128 : 32);
        if (ob.tma) zero_k_rows<BN>(sb, oa.k - k0, t, convert ? 128 : 32);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        if (convert) asm volatile("bar.sync 1, 128;" ::: "memory");
        else __syncwarp();
        if (t == 0) mbar_arrive(&full[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
        continue;
      }
    }
    if (convert) {
      if (!oa.tma) convert_tile<BM, A_K>(sa, oa, a_base, m0, k0, t);
      if (!ob.tma) convert_tile<BN, B_K>(sb, ob, b_base, n0, k0, t);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, 128;" ::: "memory");
    }
    if (t == 0) {
      if (tx) {
        mbar_arrive_tx(&full[stage], tx);
        if (oa.tma) tma_tile<BM, A_K>(sa, map_a, &full[stage], m0, k_begin + k0, za);
        if (ob.tma) tma_tile<BN, B_K>(sb, map_b, &full[stage], n0, k_begin + k0, zb);
      } else {
        mbar_arrive(&full[stage]);
      }
    }
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// A consumer's K walk of one tile (rows [64 cw, 64 cw + 64) of it): four
// wgmma m64n128k16 a stage, one group kept in flight (wait_group 1), each
// stage released once the next one's group is issued and the last one at
// the end, so the ring runs on into the next tile.  The stage that ends a
// chunk of PROMOTE (or the walk) waits for every group instead and adds
// `acc` into `total`, which holds the tile's product at the end.
template <int BM, bool A_K, bool B_K>
__device__ __forceinline__ void consume(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                        int& stage, int& phase, float (&acc)[64],
                                        float (&total)[64], int nk, int cw, int t) {
  using C = Cfg<BM>;
  int prev = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(&full[stage], phase);
    const unsigned char* sa = smem + stage * C::STAGE + cw * 64 * ROW;
    const unsigned char* sb = smem + stage * C::STAGE + C::A_TILE;
    const int chunk_on = kt % PROMOTE != 0;  // 0: the chunk's first product writes `acc`
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = A_K ? make_desc(sa + kk * 32, 16, 1024)
                              : make_desc(sa + kk * 16 * ROW, BLOCK, 1024);
      const uint64_t db = B_K ? make_desc(sb + kk * 32, 16, 1024)
                              : make_desc(sb + kk * 16 * ROW, BLOCK, 1024);
      wgmma_m64n128k16<A_K ? 0 : 1, B_K ? 0 : 1>(acc, da, db, chunk_on || kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if ((kt + 1) % PROMOTE == 0 || kt + 1 == nk) {
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += acc[i];
    } else {
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(acc);
    }
    if (kt > 0 && t % 32 == 0) mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (nk > 0 && t % 32 == 0) mbar_arrive(&empty[prev]);
}

// Epilogue: accumulator i of thread t is row 16*warp + t/4 (+8 for i & 2),
// column 8*(i/4) + 2*(t%4) (+1 for i & 1) of the consumer's rows; stored
// straight from registers, masked for ragged M and N (two-float stores
// where N is even); zeros where the walk was empty (nk == 0).
__device__ __forceinline__ void store_tile(const float (&acc)[64], float* cb, int m, int n,
                                           int r_first, int n0, int nk, int t) {
  const int lane = t % 32;
  const int r0 = r_first + (t / 32) * 16 + lane / 4;
  const bool pairs = (n % 2) == 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= m) continue;
      float* dst = cb + static_cast<long long>(r) * n + col;
      const float v0 = nk ? acc[4 * j + 2 * h] : 0.f, v1 = nk ? acc[4 * j + 2 * h + 1] : 0.f;
      if (pairs && col + 1 < n) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        if (col < n) dst[0] = v0;
        if (col + 1 < n) dst[1] = v1;
      }
    }
  }
}

template <int BM>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * Cfg<BM>::CONSUMERS);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

template <int BM, bool A_K, bool B_K, int MODE>
__global__ void __launch_bounds__(Cfg<BM>::NT, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, const Args g) {
  using C = Cfg<BM>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * C::STAGE);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, bz = blockIdx.z;
  int za = g.a.s_batch ? bz : 0, zb = g.b.s_batch ? bz : 0;
  if constexpr (MODE == G_ROWS) {
    zb = g.groups[blockIdx.x];
    if (zb >= g.num_groups) {  // dead tile: zeros, no loads
      for (int e = threadIdx.x; e < BM * BN; e += C::NT) {
        const int gm = m0 + e / BN, gn = n0 + e % BN;
        if (gm < g.m && gn < g.n) g.c[static_cast<long long>(gm) * g.n + gn] = 0.f;
      }
      return;
    }
    za = 0;
  }
  const char* a_base = g.a.p + za * g.a.s_batch * (g.a.bf16 ? 2 : 4);
  const char* b_base = g.b.p + zb * g.b.s_batch * (g.b.bf16 ? 2 : 4);
  init_ring<BM>(full, empty);

  const int nk = (g.k + BK - 1) / BK;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  int stage = 0, phase = 0;
  if (wg == 0) {
    if (!(g.a.tma && g.b.tma) || t == 0)
      produce<BM, A_K, B_K>(smem, full, empty, stage, phase, g.a, g.b, a_base, b_base, &map_a,
                            &map_b, m0, n0, za, zb, nk, t);
  } else {
    float acc[64], total[64];  // acc written first by a wgmma with scale_d 0
    consume<BM, A_K, B_K>(smem, full, empty, stage, phase, acc, total, nk, wg - 1, t);
    store_tile(total, g.c + static_cast<long long>(bz) * g.m * g.n, g.m, g.n,
               m0 + (wg - 1) * 64, n0, nk, t);
  }
}

// The grouped dW (group-K mode), persistent: each CTA walks the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... of (D / BM) x (F / BN) x E, D
// tiles fastest (the CTAs that share a dy tile run together), so one
// tile's epilogue overlaps the producer's loads of the next.  A tile's K
// walk is its group's run: A = x^T and B = dy from row offsets[g] on, each
// an operand of K extent = the run's length (`produce` zeros the rows at
// or past offsets[g + 1] of a ragged last stage, by TMA or converted).
template <int BM>
__global__ void __launch_bounds__(Cfg<BM>::NT, 1)
gemm_sm90_group_k_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b, const Args g) {
  using C = Cfg<BM>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * C::STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* tail = empty + STAGES;
  if (threadIdx.x == 0) mbar_init(tail, 1);
  init_ring<BM>(full, empty);
  int tail_phase = 0;

  const int tiles_m = (g.m + BM - 1) / BM, tiles_n = (g.n + BN - 1) / BN;
  const int n_tiles = tiles_m * tiles_n * g.num_groups;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  int stage = 0, phase = 0;
  float acc[64], total[64];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile % tiles_m) * BM, n0 = (tile / tiles_m % tiles_n) * BN;
    const int grp = tile / (tiles_m * tiles_n);
    const int k_begin = g.groups[grp];
    Operand oa = g.a, ob = g.b;
    oa.k = ob.k = g.groups[grp + 1] - k_begin;
    const int nk = (oa.k + BK - 1) / BK;
    if (wg == 0) {
      const char* a_run = oa.p + static_cast<long long>(k_begin) * oa.s_k * (oa.bf16 ? 2 : 4);
      const char* b_run = ob.p + static_cast<long long>(k_begin) * ob.s_k * (ob.bf16 ? 2 : 4);
      if (!(oa.tma && ob.tma) || t < 32)
        produce<BM, false, false>(smem, full, empty, stage, phase, oa, ob, a_run, b_run, &map_a,
                                  &map_b, m0, n0, 0, 0, nk, t, tail, &tail_phase, k_begin);
    } else {
      consume<BM, false, false>(smem, full, empty, stage, phase, acc, total, nk, wg - 1, t);
      store_tile(total, g.c + static_cast<long long>(grp) * g.m * g.n, g.m, g.n,
                 m0 + (wg - 1) * 64, n0, nk, t);
    }
  }
}

// ---------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, so the library needs no -lcuda.
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                  : nullptr;
  }();
  return fn;
}

// Encode a bf16 operand as a 3-D map (contiguous extent, other extent,
// batch) with a 128B-swizzled 64 x box_o box; false where TMA cannot take
// it (the caller then converts it in the producer).
inline bool encode(CUtensorMap* map, const void* p, long long ext_c, long long ext_o,
                   long long ext_b, long long s_o, long long s_b, int box_o) {
  EncodeTiled enc = encoder();
  if (enc == nullptr || ext_c <= 0 || ext_o <= 0 || s_o <= 0 || s_b < 0) return false;
  if (reinterpret_cast<uintptr_t>(p) % 16 || (s_o * 2) % 16 || (s_b * 2) % 16) return false;
  if (s_b == 0 || ext_b <= 1) {  // one batch (or a broadcast one): any valid stride
    ext_b = 1;
    s_b = (ext_o * s_o + 7) / 8 * 8;
  }
  if ((s_o * 2) >= (1ll << 40) || (s_b * 2) >= (1ll << 40)) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)ext_c, (cuuint64_t)ext_o, (cuuint64_t)ext_b};
  const cuuint64_t strides[2] = {(cuuint64_t)(s_o * 2), (cuuint64_t)(s_b * 2)};
  const cuuint32_t box[3] = {64u, (cuuint32_t)box_o, 1u};
  const cuuint32_t unit[3] = {1u, 1u, 1u};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The producer's view of one operand.  `kmajor`: stored K-major (its
// contiguous dimension is K, or neither is contiguous); else MN-major.
inline Operand operand(const void* p, int bf16, long long s_mn, long long s_k, long long s_batch,
                       int mn, int k, bool kmajor) {
  Operand o;
  o.p = static_cast<const char*>(p);
  o.s_mn = s_mn; o.s_k = s_k; o.s_batch = s_batch;
  o.mn = mn; o.k = k;
  o.bf16 = bf16;
  o.tma = 0;
  const long long s_c = kmajor ? s_k : s_mn, s_o = kmajor ? s_mn : s_k;
  const long long run = bf16 ? 8 : 4;  // elements per 16 bytes
  o.vec = s_c == 1 && s_o % run == 0 && s_batch % run == 0 &&
          reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return o;
}

template <int BM, bool A_K, bool B_K, int MODE>
int launch(const Args& s, const CUtensorMap& ma, const CUtensorMap& mb, int batch,
           cudaStream_t stream) {
  using C = Cfg<BM>;
  auto kern = gemm_sm90_kernel<BM, A_K, B_K, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s.m + BM - 1) / BM, (s.n + BN - 1) / BN, batch);
  kern<<<grid, C::NT, C::smem, stream>>>(ma, mb, s);
  return (int)cudaGetLastError();
}

template <int BM, int MODE>
int launch_layout(const Args& s, const CUtensorMap& ma, const CUtensorMap& mb, bool a_k,
                  bool b_k, int batch, cudaStream_t stream) {
  if constexpr (MODE == G_ROWS) {  // x is row-major: A is always K-major
    return b_k ? launch<BM, true, true, MODE>(s, ma, mb, batch, stream)
               : launch<BM, true, false, MODE>(s, ma, mb, batch, stream);
  } else {
    if (a_k)
      return b_k ? launch<BM, true, true, MODE>(s, ma, mb, batch, stream)
                 : launch<BM, true, false, MODE>(s, ma, mb, batch, stream);
    return b_k ? launch<BM, false, true, MODE>(s, ma, mb, batch, stream)
               : launch<BM, false, false, MODE>(s, ma, mb, batch, stream);
  }
}

// dw[g] = x_g^T.dy_g for the g.num_groups runs of g.groups (the offsets);
// g as gemm_grouped_dw.cu builds it: A = x^T (m-stride 1), B = dy (n-stride
// 1).  One persistent CTA per SM (or per tile, when there are fewer).
template <int BM>
int run_grouped_k(const GemmArgs& g, cudaStream_t stream) {
  Args s;
  s.a = operand(g.a, g.a_bf16, g.sam, g.sak, 0, g.m, g.k, false);
  s.b = operand(g.b, g.b_bf16, g.sbn, g.sbk, 0, g.n, g.k, false);
  s.c = g.c;
  s.m = g.m; s.n = g.n; s.k = g.k;
  s.groups = g.groups;
  s.num_groups = g.num_groups;
  // bf16 operands by TMA over all g.k rows (x^T: M-contiguous boxes of 64 x
  // 64; dy: N-contiguous), the converting producer otherwise
  CUtensorMap ma{}, mb{};
  if (g.a_bf16) s.a.tma = encode(&ma, g.a, g.m, g.k, 1, g.sak, 0, 64);
  if (g.b_bf16) s.b.tma = encode(&mb, g.b, g.n, g.k, 1, g.sbk, 0, 64);
  using C = Cfg<BM>;
  auto kern = gemm_sm90_group_k_kernel<BM>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  const long long tiles = static_cast<long long>((g.m + BM - 1) / BM) * ((g.n + BN - 1) / BN) *
                          g.num_groups;
  if (tiles == 0) return (int)cudaSuccess;
  kern<<<static_cast<int>(tiles < sms ? tiles : sms), C::NT, C::smem, stream>>>(ma, mb, s);
  return (int)cudaGetLastError();
}

// C = A.B (G_NONE: `batch` products, BM by M; G_ROWS: BM = the caller's
// row tile, B = w[g] of g.num_groups).
template <int MODE>
int run(const GemmArgs& g, int batch, int bm, cudaStream_t stream) {
  const bool a_k = !(g.sam == 1 && g.sak != 1);
  const bool b_k = !(g.sbn == 1 && g.sbk != 1);
  Args s;
  s.a = operand(g.a, g.a_bf16, g.sam, g.sak, g.sab, g.m, g.k, a_k);
  s.b = operand(g.b, g.b_bf16, g.sbn, g.sbk, g.sbb, g.n, g.k, b_k);
  s.c = g.c;
  s.m = g.m; s.n = g.n; s.k = g.k;
  s.groups = g.groups;
  s.num_groups = g.num_groups;
  CUtensorMap ma{}, mb{};
  if (g.a_bf16) {
    const long long za = MODE == G_ROWS ? 1 : batch;
    s.a.tma = a_k ? encode(&ma, g.a, g.k, g.m, za, g.sam, g.sab, bm)
                  : encode(&ma, g.a, g.m, g.k, za, g.sak, g.sab, 64);
  }
  if (g.b_bf16) {
    const long long zb = MODE == G_ROWS ? g.num_groups : batch;
    s.b.tma = b_k ? encode(&mb, g.b, g.k, g.n, zb, g.sbn, g.sbb, BN)
                  : encode(&mb, g.b, g.n, g.k, zb, g.sbk, g.sbb, 64);
  }
  const int grid_z = MODE == G_ROWS ? 1 : batch;
  return bm == 64 ? launch_layout<64, MODE>(s, ma, mb, a_k, b_k, grid_z, stream)
                  : launch_layout<128, MODE>(s, ma, mb, a_k, b_k, grid_z, stream);
}

}  // namespace sm90
}  // namespace rt
