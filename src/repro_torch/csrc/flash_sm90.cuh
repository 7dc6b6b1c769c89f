// The flash-attention forward at the bf16 rung on Hopper's wgmma: a
// producer warpgroup (TMA, or converting loads) feeding one consumer
// warpgroup that keeps S, P and O in registers.  Included by
// attention_fused.cu; every other rung, decode, the paged decode and the
// backward keep flash_common.cuh's WMMA kernel.
//
// Replaces kernels/attention_fused.py:_fwd_kernel (pallas_call at :224) at
// the bf16 rung.  Same layouts and results as flash_kernel<P_BF16, 64>: q
// (B, Sq, Kv, G, hd) pre-scaled, k/v (B, Skv, Kv, hd), all f32 or all bf16;
// out (B, Sq, Kv*G, hd) f32 and lse = m + log l (B, Kv*G, Sq) f32.
//
// What bounds it on the H100: operations at the serve and train shapes (a
// few GFLOP against a few MB); the WMMA kernel stayed far from that because
// it kept O in shared memory (reloaded into fragments at every 32-column
// step), sent S through shared memory and issued warp-level 16x16x16 MMAs.
// Here:
//   - One CTA per (64 query rows, head, batch); warpgroup 0 produces,
//     warpgroup 1 computes.  Q is staged once (64 rows x hd); K and V go
//     through a 2-stage ring of 64-row tiles.  Each tile is stored as
//     ceil(hd / 64) blocks of 64 rows x 128 bytes in the 128-byte swizzle
//     that wgmma reads (gemm_sm90.cuh's layout and descriptors): K-major
//     for Q and K (the S product's A and B), and the same bytes read
//     MN-major for V (the P.V product's B, transpose bit set).  Columns past
//     hd and rows past Sq / Skv are zeros.
//   - bf16 inputs whose bases are 16-byte aligned go by TMA through 4-D
//     tensor maps (hd, heads, rows, batch): one 64 x 64 box per block, the
//     hardware's out-of-bounds fill giving the zeros.  f32 inputs (and
//     misaligned bf16) take the converting producer: 128 threads read
//     eight elements at a time, round them with __float2bfloat16_rn (the
//     WMMA kernel's and the twin's rounding) and store them swizzled.
//   - S = Q.K^T for the 64 x 64 tile by wgmma m64n64k16 (hd / 16 steps),
//     the f32 accumulator in registers.
//   - The online softmax runs in registers in the twin's 32-column steps
//     (kernels/attention_fused.py:_online_softmax): for each 32-column half
//     of the tile in order, softcap, mask, row max and row sum over the
//     quad's shuffles, m and l updated, O rescaled, P rounded to bf16 in
//     registers, then P.V for those 32 keys by wgmma m64n64k16 with P as
//     the register A operand (the accumulator layout of S is the A
//     fragment's), one wgmma per 64 columns of hd.  So kernel and twin
//     round P at the same points and the lse the backward rebuilds P from
//     does not move.
//   - O stays in registers (hd / 2 floats a thread) for the whole walk and
//     is written once, divided by l, with lse.
//   - Masks as the WMMA kernel's: the walk covers the 32-row KV tiles its
//     causal / sliding-window mask reaches (the TPU kernel's _block_live as
//     loop bounds), 64 rows a stage (a second half past the last live tile
//     is skipped); tail padding past Skv and Sq; softcap before masking;
//     masked scores are -1e30, as in the twin.
// No register rebalancing (setmaxnreg): the CTA has 256 threads, so a
// consumer may hold up to 255 registers (O's 128 floats at hd 256).
#pragma once

#include "flash_common.cuh"
#include "gemm_common.cuh"

namespace rt {
namespace fsm90 {

using sm90::ROW;                      // 128 bytes: one swizzled row of 64 bf16
constexpr int BLK = 64 * ROW;         // one 64-row x 64-column block, 8 KB
constexpr int BQ = 64, BN = 64, STAGES = 2, NT = 256;

template <int NB>  // NB = ceil(hd / 64) column blocks
struct Cfg {
  static constexpr int TILE = NB * BLK;       // Q, K or V: 64 rows x 64 NB columns
  static constexpr int STAGE = 2 * TILE;      // K then V
  static constexpr size_t smem = 1024 + TILE + STAGES * STAGE + (1 + 2 * STAGES) * 8;
};

// The three operands as the producer reads them: element (row, d) of q's
// head h (or k/v's kv head) at base + row * rs + d, rows < n_rows.
struct Rows {
  const char* base;
  long long rs;
  int n_rows;
};

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(sm90::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// One m64n64k16 bf16 wgmma, both operands from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One m64n64k16 bf16 wgmma, A from registers (four bf16 pairs a thread),
// B from shared memory MN-major (transpose bit set); d += a.b.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Path (b): the producer warpgroup's thread t fills a 64-row tile of NB
// blocks from rows [row0, row0 + 64) of r (zeros past r.n_rows and past hd),
// four 8-element chunks in flight at a time.
template <int NB>
__device__ __forceinline__ void convert_rows(unsigned char* tile, const Rows& r, int in_bf16,
                                             int row0, int hd, int t) {
  constexpr int PER = 64 * NB * 8 / 128;  // chunks a thread
#pragma unroll
  for (int i0 = 0; i0 < PER; i0 += 4) {
    uint4 v[4];
    int off[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = t + (i0 + j) * 128;
      const int blk = q / 512, row = (q / 8) % 64, c = q % 8, d = 64 * blk + 8 * c;
      off[j] = blk * BLK + row * ROW + ((c ^ (row & 7)) << 4);
      v[j] = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + row < r.n_rows && d < hd) {
        const long long e = static_cast<long long>(row0 + row) * r.rs + d;
        if (in_bf16) {
          v[j] = __ldg(reinterpret_cast<const uint4*>(r.base + e * 2));
        } else {
          const float4* f = reinterpret_cast<const float4*>(r.base + e * 4);
          const float4 a = __ldg(f), b = __ldg(f + 1);
          v[j] = make_uint4(sm90::pack2(a.x, a.y), sm90::pack2(a.z, a.w), sm90::pack2(b.x, b.y),
                            sm90::pack2(b.z, b.w));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) *reinterpret_cast<uint4*>(tile + off[j]) = v[j];
  }
}

template <int NB>
__global__ void __launch_bounds__(NT, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const AttnArgs a, int tma) {
  using C = Cfg<NB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sq = smem;
  unsigned char* stages = smem + C::TILE;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(stages + STAGES * C::STAGE);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  const int H = a.Kv * a.G, hd = a.hd;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, kvh = h / a.G;
  const int rows = min(BQ, a.Sq - q0);
  // the 32-row KV tiles this block's mask can reach, walked 64 rows a stage
  int j_lo = 0, j_hi = a.Skv;
  if (a.causal) {
    j_hi = min(a.Skv, q0 + rows);
    if (a.window > 0) j_lo = max(0, q0 - a.window + 1);
  }
  const int kv_begin = (j_lo / BKV) * BKV, kv_end = (j_hi + BKV - 1) / BKV * BKV;
  const int n_st = kv_end > kv_begin ? (kv_end - kv_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wg == 0) {
    // Producer.
    if (tma) {
      if (t != 0) return;
      sm90::mbar_arrive_tx(qbar, C::TILE);
#pragma unroll
      for (int blk = 0; blk < NB; ++blk)
        tma_load_4d(sq + blk * BLK, &map_q, qbar, 64 * blk, h, q0, b);
      int stage = 0, phase = 0;
      for (int st = 0; st < n_st; ++st) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* sk = stages + stage * C::STAGE;
        const int kv0 = kv_begin + st * BN;
        sm90::mbar_arrive_tx(&full[stage], C::STAGE);
#pragma unroll
        for (int blk = 0; blk < NB; ++blk) {
          tma_load_4d(sk + blk * BLK, &map_k, &full[stage], 64 * blk, kvh, kv0, b);
          tma_load_4d(sk + C::TILE + blk * BLK, &map_v, &full[stage], 64 * blk, kvh, kv0, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else {
      const int esz = a.in_bf16 ? 2 : 4;
      const Rows rq{static_cast<const char*>(a.q) + ((long long)b * a.Sq * H + h) * hd * esz,
                    (long long)H * hd, a.Sq};
      const Rows rk{static_cast<const char*>(a.k) + ((long long)b * a.Skv * a.Kv + kvh) * hd * esz,
                    (long long)a.Kv * hd, a.Skv};
      const Rows rv{static_cast<const char*>(a.v) + ((long long)b * a.Skv * a.Kv + kvh) * hd * esz,
                    (long long)a.Kv * hd, a.Skv};
      convert_rows<NB>(sq, rq, a.in_bf16, q0, hd, t);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, 128;" ::: "memory");
      if (t == 0) sm90::mbar_arrive(qbar);
      int stage = 0, phase = 0;
      for (int st = 0; st < n_st; ++st) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* sk = stages + stage * C::STAGE;
        const int kv0 = kv_begin + st * BN;
        convert_rows<NB>(sk, rk, a.in_bf16, kv0, hd, t);
        convert_rows<NB>(sk + C::TILE, rv, a.in_bf16, kv0, hd, t);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync 1, 128;" ::: "memory");
        if (t == 0) sm90::mbar_arrive(&full[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumer.  Accumulator i of thread t (S's 32, each 64-column block of
  // O's 32) is row 16 * warp + lane / 4 (+8 when i & 2), column
  // 8 * (i / 4) + 2 * (lane % 4) (+1 when i & 1) of its 64 x 64 tile.
  const int warp = t / 32, lane = t % 32;
  const int r_in = 16 * warp + lane / 4;  // the thread's first row (then r_in + 8)
  float o[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  const int n_kk = hd / 16;

  sm90::mbar_wait(qbar, 0);
  int stage = 0, phase = 0;
  for (int st = 0; st < n_st; ++st) {
    sm90::mbar_wait(&full[stage], phase);
    const unsigned char* sk = stages + stage * C::STAGE;
    const unsigned char* sv = sk + C::TILE;
    const int kv0 = kv_begin + st * BN;

    float s[32];
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    for (int kk = 0; kk < n_kk; ++kk) {
      const int off = (kk / 4) * BLK + (kk % 4) * 32;
      wgmma_ss(s, sm90::make_desc(sq + off, 16, 1024), sm90::make_desc(sk + off, 16, 1024),
               kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(s);

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c_half = kv0 + half * BKV;
      if (c_half >= kv_end) break;  // past the last live tile (uniform in the CTA)
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 16 * half; i < 16 * half + 16; ++i) {
        const int hr = (i >> 1) & 1;
        const int c = kv0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
        const int qr = q0 + r_in + 8 * hr;
        float x = s[i];
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        bool keep = c < a.Skv && qr < a.Sq;
        if (a.causal) {
          keep = keep && c <= qr;
          if (a.window > 0) keep = keep && c > qr - a.window;
        }
        s[i] = keep ? x : NEG_INF;
        mx[hr] = fmaxf(mx[hr], s[i]);
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        const float m_new = fmaxf(m_run[hr], mx[hr]);
        alpha[hr] = expf(m_run[hr] - m_new);
        m_run[hr] = m_new;
      }
#pragma unroll
      for (int i = 16 * half; i < 16 * half + 16; ++i) {
        const int hr = (i >> 1) & 1;
        s[i] = expf(s[i] - m_run[hr]);
        sum[hr] += s[i];
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
        sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
        l_run[hr] = l_run[hr] * alpha[hr] + sum[hr];
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[nb][i] *= alpha[(i >> 1) & 1];
      // P for keys [32 half, 32 half + 32) as two k16 A fragments
      uint32_t p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int base = 8 * (2 * half + j);
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = sm90::pack2(s[base + 2 * e], s[base + 2 * e + 1]);
      }
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          wgmma_rs(o[nb], p[j],
                   sm90::make_desc(sv + nb * BLK + (half * BKV + 16 * j) * ROW, BLK, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
    }
    if (lane == 0) sm90::mbar_arrive(&empty[stage]);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // Epilogue: out = O / l, lse = m + log l, rows < Sq, columns < hd.
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r_in + 8 * hr;
    if (row >= a.Sq) continue;
    const float l = fmaxf(l_run[hr], 1e-30f);
    float* dst = a.o + ((long long)b * a.Sq + row) * H * hd + (long long)h * hd;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * nb + 8 * j + 2 * (lane % 4);
        if (col < hd)
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(o[nb][4 * j + 2 * hr] / l, o[nb][4 * j + 2 * hr + 1] / l);
      }
    if (a.lse != nullptr && lane % 4 == 0)
      a.lse[((long long)b * H + h) * a.Sq + row] = m_run[hr] + logf(l);
  }
}

// ---------------------------------------------------------------- host side

// A bf16 (rows, heads, batch) operand as a 4-D map (hd, heads, rows,
// batch), 64 x 1 x 64 x 1 boxes, 128-byte swizzle; false where TMA cannot
// take it (the producer then converts).
inline bool encode_rows(CUtensorMap* map, const void* p, int hd, int heads, int rows, int batch) {
  sm90::EncodeTiled enc = sm90::encoder();
  if (enc == nullptr || reinterpret_cast<uintptr_t>(p) % 16 || (hd * 2) % 16 || rows <= 0)
    return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)rows * heads * hd * 2};
  if (strides[2] >= (1ull << 40)) return false;
  const cuuint32_t box[4] = {64u, 1u, 64u, 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB>
int launch(const AttnArgs& a, const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
           int tma, cudaStream_t stream) {
  using C = Cfg<NB>;
  auto kern = flash_sm90_kernel<NB>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.Kv * a.G, a.B);
  kern<<<grid, NT, C::smem, stream>>>(mq, mk, mv, a, tma);
  return (int)cudaGetLastError();
}

// The bf16 forward for head dims that are multiples of 16 up to 256.
inline int run(const AttnArgs& a, cudaStream_t stream) {
  if (a.hd <= 0 || a.hd % 16 || a.hd > 256) return (int)cudaErrorInvalidValue;
  CUtensorMap mq{}, mk{}, mv{};
  const int tma = a.in_bf16 && encode_rows(&mq, a.q, a.hd, a.Kv * a.G, a.Sq, a.B) &&
                  encode_rows(&mk, a.k, a.hd, a.Kv, a.Skv, a.B) &&
                  encode_rows(&mv, a.v, a.hd, a.Kv, a.Skv, a.B);
  switch ((a.hd + 63) / 64) {
    case 1: return launch<1>(a, mq, mk, mv, tma, stream);
    case 2: return launch<2>(a, mq, mk, mv, tma, stream);
    case 3: return launch<3>(a, mq, mk, mv, tma, stream);
    default: return launch<4>(a, mq, mk, mv, tma, stream);
  }
}

}  // namespace fsm90
}  // namespace rt
