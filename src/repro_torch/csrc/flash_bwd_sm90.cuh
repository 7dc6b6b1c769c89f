// The flash-attention backward at the bf16 rung on Hopper's wgmma: the dq
// kernel and the dk/dv kernel as one template, two consumer warpgroups that
// keep every score tile and accumulator in registers.  Included by
// attention_bwd.cu; every other rung keeps its WMMA kernels.
//
// Replaces kernels/attention_fused.py:_bwd_dq_kernel (pallas_call at :354)
// and :_bwd_dkv_kernel (pallas_call at :374) at the bf16 rung.  Same
// layouts and results as bwd_dq_kernel<P_BF16> / bwd_dkv_kernel<P_BF16>: q,
// dout (B, Sq, Kv, G, hd) and k, v (B, Skv, Kv, hd), here all bf16 (the
// wrapper rounds f32 inputs once, as the WMMA kernels' staging did); lse and
// di (B, Kv*G, Sq) f32; dq, dk and dv f32.
//
// What bounds it on the H100: operations at the train shapes (6 and 8
// flops per live (q, key) pair and head dim against a few MB).  The WMMA
// kernels stayed far from that: 32-row tiles, warp-level 16x16x16 MMAs, S,
// dP, P, dS and the f32 accumulators all in shared memory, synchronous
// staging by every thread.  Here one CTA owns 64 "fixed" rows and walks
// 64-row tiles of the other side:
//   dq:    fixed Q and dO of one query head; the walk is the KV tiles its
//          causal / sliding-window mask reaches (the TPU kernel's _block_live
//          as loop bounds); grid (ceil(Sq/64), Kv*G, B).
//   dk/dv: fixed K and V of one kv head; the walk is, for each query head
//          of the group in turn, the q tiles that reach those keys.
// The fixed pair is loaded once and the walked pair (K, V or Q, dO, each
// 64 x hd) goes through a 2-stage ring, all by TMA from bf16 through 4-D
// tensor maps (hd, heads, rows, batch) into flash_sm90.cuh's 128-byte
// swizzled 64 x 64 blocks (the hardware's out-of-bounds fill gives the
// zeros past hd, Sq and Skv).  No producer warpgroup: thread 0 of the
// second consumer issues the loads, so each of the 256 threads may hold
// 255 registers (no setmaxnreg).
//
// Both products of a step are shared-memory wgmma m64n64k16 with the fixed
// tile as A and the walked tile as B, both K-major (dq: S = Q.K^T and dP =
// dO.V^T; dk/dv: S^T = K.Q^T and dP^T = V.dO^T), so one code serves both
// kernels; only the mask's and lse's orientation differ (a column of S^T is
// a q row).  Warpgroup 1 computes S and rebuilds P in registers with the
// twin's arithmetic (softcap, masks, p = exp(s' - lse)); warpgroup 2
// computes dP.  P goes to warpgroup 2 through 16 KB of shared memory (f32,
// in accumulator order, so thread t of one warpgroup reads what thread t of
// the other wrote; with a softcap, times its chain term 1 - t^2, so ds =
// (p (1 - t^2)) (dp - di): the twin's product in another order), under a
// named barrier; warpgroup 2 forms dS there.  Each rounds its operand to
// bf16 once in registers.  (A first version formed both P and dS in
// warpgroup 1 from a dP handed over in shared memory: the loads of dP and
// the stores of dS interleaved, so its 32 elements ran one after another,
// and that phase took most of each step.)  The masks are one kept
// interval of the walked index per fixed row (two compares; expf(-inf)
// gives the masked zeros): as short-circuit tests they compiled to a
// branch around every element.
// lse and di go from device memory straight to the registers of the
// warpgroup that needs them (dk/dv: 16 q columns a thread, loaded at the
// top of each step, in flight over the barrier wait and the score product).
// The accumulations take P or dS as the register A operand (S's
// accumulator layout is the A fragment's, as in the forward's P.V) and the
// walked tile as an MN-major B (transpose bit), as the forward reads V:
//   dq:    dQ += dS.K, the hd columns split between the warpgroups (blocks
//          [0, ceil(NB/2)) in warpgroup 1, the rest in 2; dS goes back to
//          warpgroup 1 as bf16 pairs, 8 KB, a second named barrier);
//   dk/dv: warpgroup 1 dV += P^T.dO, warpgroup 2 dK += dS^T.Q (the second
//          barrier only says warpgroup 2 has read P).
// The accumulators stay in registers for the whole walk (at hd 256 and
// dk/dv, 128 floats a thread in each warpgroup) and are written once.
//
// The dk/dv grid: (ceil(Skv/64), Kv, B) with the group walked inside the
// CTA, unless that grid has fewer CTAs than the card has SMs and G > 1; then
// (ceil(Skv/64), Kv*G, B), one CTA per query head, each writing its head's
// dk and dv to slot g of a (G, B, Skv, Kv, hd) scratch that the wrapper
// sums over G (the JAX kernel's own per-query-head gradients).  The wrapper
// applies that rule (it queries the SM count) and passes the slot stride
// `part`; no atomics either way, so the result is the same on every run.
// Both train shapes split: gemma3's (B 2, Kv 1, S 1024) from 32 CTAs to
// 128, Mixtral's (B 1, Kv 8) from 128 to 512.
//
// Shared memory at hd 256: fixed 64 KB, ring 128 KB, exchange 24 KB: 217
// KB; at hd 128, 121 KB: one CTA per SM either way.
#pragma once

#include "flash_sm90.cuh"

namespace rt {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;  // f32 on the WMMA kernels, bf16 on the wgmma ones
  const float* lse;
  const float* di;
  float* dq;
  float* dk;
  float* dv;
  int in_bf16;
  int B, Sq, Skv, Kv, G, hd;
  int causal, window;  // window <= 0: none
  float softcap;       // <= 0: none
  long long part;      // wgmma dk/dv: elements between per-head slots; 0: group in the CTA
};

namespace bsm90 {

using fsm90::BLK;
using sm90::ROW;
constexpr int BR = 64, STAGES = 2, NT = 256;
constexpr int XCH = 64 * 64;  // elements of one exchanged 64 x 64 tile

template <int NB>  // NB = ceil(hd / 64) column blocks
struct Cfg {
  static constexpr int TILE = NB * BLK;  // one 64-row operand tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int X = 0, Y = TILE, RING = 2 * TILE;
  static constexpr int P = RING + STAGES * STAGE;  // P, f32
  static constexpr int DS = P + XCH * 4;           // dS, bf16 pairs (dq)
  static constexpr int BAR = DS + XCH * 2;
  static constexpr size_t smem = 1024 + BAR + (1 + 2 * STAGES) * 8;
};

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// acc (64 x 64 per block) = A.B^T over hd, A the fixed tile, B the walked
// one, both K-major.
__device__ __forceinline__ void score(float (&acc)[32], const unsigned char* a,
                                      const unsigned char* b, int hd) {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  for (int kk = 0; kk < hd / 16; ++kk) {
    const int off = (kk / 4) * BLK + (kk % 4) * 32;
    fsm90::wgmma_ss(acc, sm90::make_desc(a + off, 16, 1024), sm90::make_desc(b + off, 16, 1024),
                    kk > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fsm90::fence_regs(acc);
}

// acc[nb] += W.Y[:, blocks blk0 + nb], W the 64 x 64 register operand (four
// k16 fragments), Y a walked tile read MN-major.
template <int N>
__device__ __forceinline__ void accumulate(float (&acc)[N][32], const uint32_t (&w)[4][4],
                                           const unsigned char* y, int blk0) {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int nb = 0; nb < N; ++nb)
      fsm90::wgmma_rs(acc[nb], w[j], sm90::make_desc(y + (blk0 + nb) * BLK + 16 * j * ROW, BLK,
                                                     1024));
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
  for (int nb = 0; nb < N; ++nb) fsm90::fence_regs(acc[nb]);
}

// Rows [0, n_rows) of a 64-row output tile whose row r starts at base + r *
// rs: columns 64 * (blk0 + nb) + ... < hd from acc[nb].
template <int N>
__device__ __forceinline__ void store(const float (&acc)[N][32], float* base, long long rs,
                                      int n_rows, int blk0, int hd, int r_in, int lane) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r_in + 8 * hr;
    if (row >= n_rows) continue;
    float* dst = base + row * rs;
#pragma unroll
    for (int nb = 0; nb < N; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * (blk0 + nb) + 8 * j + 2 * (lane % 4);
        if (col < hd)
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(acc[nb][4 * j + 2 * hr], acc[nb][4 * j + 2 * hr + 1]);
      }
  }
}

// DKV: the dk/dv kernel, else dq.  Maps: q, k, v, dout.
template <int NB, bool DKV>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do, const BwdArgs a) {
  using C = Cfg<NB>;
  // accumulator blocks of each warpgroup
  constexpr int NA1 = DKV ? NB : (NB + 1) / 2, NA2 = DKV ? NB : NB / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem + C::RING;
  float* x_p = reinterpret_cast<float*>(smem + C::P);
  uint32_t* x_ds = reinterpret_cast<uint32_t*>(smem + C::DS);
  uint64_t* fixbar = reinterpret_cast<uint64_t*>(smem + C::BAR);
  uint64_t* full = fixbar + 1;
  uint64_t* empty = full + STAGES;

  const int H = a.Kv * a.G, hd = a.hd;
  const int r0 = blockIdx.x * BR, b = blockIdx.z;
  // dq: query head h.  dk/dv: kv head kvh, query heads g_lo .. g_hi-1 of its group.
  const int kvh = DKV ? (a.part ? blockIdx.y / a.G : blockIdx.y) : blockIdx.y / a.G;
  const int g_lo = DKV && a.part ? blockIdx.y % a.G : 0;
  const int n_g = DKV ? (a.part ? 1 : a.G) : 1;
  // The walked tiles the mask reaches.  dq: the keys of q rows r0..r0+63;
  // dk/dv: key c is seen by rows c .. c+window-1 (causal), so rows r0 ..
  // r0+62+window.
  int lo = 0, hi = DKV ? a.Sq : a.Skv;
  if (a.causal) {
    if (DKV) {
      lo = min(a.Sq, r0);
      if (a.window > 0) hi = min(a.Sq, r0 + BR - 1 + a.window);
    } else {
      hi = min(a.Skv, r0 + min(BR, a.Sq - r0));
      if (a.window > 0) lo = max(0, r0 - a.window + 1);
    }
  }
  const int t_lo = lo / BR, n_t = max(0, (hi + BR - 1) / BR - t_lo);
  const int n_st = n_t * n_g;

  if (threadIdx.x == 0) {
    sm90::mbar_init(fixbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // lane 0 of every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int r_in = 16 * warp + lane / 4;  // the thread's first row (then r_in + 8)

  // Walk step st: its query head and the first row of its walked tile.
  auto step_head = [&](int st) { return DKV ? kvh * a.G + g_lo + st / n_t : (int)blockIdx.y; };
  auto step_row = [&](int st) { return (t_lo + (DKV ? st % n_t : st)) * BR; };
  const CUtensorMap* fix0 = DKV ? &map_k : &map_q;  // fixed pair
  const CUtensorMap* fix1 = DKV ? &map_v : &map_do;
  const CUtensorMap* m0 = DKV ? &map_q : &map_k;    // walked pair
  const CUtensorMap* m1 = DKV ? &map_do : &map_v;
  auto issue = [&](int st) {  // one thread: the walked pair of step st into its stage
    const int stage = st % STAGES;
    unsigned char* dst = ring + stage * C::STAGE;
    const int head = DKV ? step_head(st) : kvh, row = step_row(st);
    sm90::mbar_arrive_tx(&full[stage], C::STAGE);
#pragma unroll
    for (int blk = 0; blk < NB; ++blk) {
      fsm90::tma_load_4d(dst + blk * BLK, m0, &full[stage], 64 * blk, head, row, b);
      fsm90::tma_load_4d(dst + C::TILE + blk * BLK, m1, &full[stage], 64 * blk, head, row, b);
    }
  };

  if (threadIdx.x == 128) {
    sm90::mbar_arrive_tx(fixbar, 2 * C::TILE);
    const int head = DKV ? kvh : (int)blockIdx.y;
#pragma unroll
    for (int blk = 0; blk < NB; ++blk) {
      fsm90::tma_load_4d(smem + C::X + blk * BLK, fix0, fixbar, 64 * blk, head, r0, b);
      fsm90::tma_load_4d(smem + C::Y + blk * BLK, fix1, fixbar, 64 * blk, head, r0, b);
    }
    for (int st = 0; st < min(STAGES, n_st); ++st) issue(st);
  }
  __syncwarp();
  sm90::mbar_wait(fixbar, 0);

  // Element i of a thread's 32 (any 64 x 64 accumulator) is row r_in (+8
  // when i & 2), column 8 (i / 4) + 2 (lane % 4) (+1 when i & 1).  dk/dv's
  // lse and di are per column (a q row): element i reads column slot
  // col_slot(i) of the 16 a thread sees.
  auto col_slot = [](int i) { return 2 * (i / 4) + (i & 1); };
  auto col_of = [&](int i) { return 8 * (i / 4) + 2 * (lane % 4) + (i & 1); };
  // The step's 16 column values of lse or di (rows past Sq read 0).
  auto load_cols = [&](float (&dst)[16], const float* src, int st) {
    const long long o = ((long long)b * H + step_head(st)) * a.Sq;
    const int q0 = step_row(st);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = q0 + 8 * j + 2 * (lane % 4) + u;
        dst[2 * j + u] = q < a.Sq ? src[o + q] : 0.f;
      }
  };
  // dq: lse (warpgroup 1) or di (warpgroup 2) of the thread's two q rows.
  auto load_rows = [&](float (&dst)[2], const float* src) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + r_in + 8 * hr;
      dst[hr] = row < a.Sq ? src[((long long)b * H + blockIdx.y) * a.Sq + row] : 0.f;
    }
  };

  if (wg == 0) {
    // Warpgroup 1: S, then P (handed over as f32, times the softcap's chain
    // term), then dV += P^T.dO (dk/dv) or dQ's first blocks += dS.K (dq).
    float lse_r[2];
    if (!DKV) load_rows(lse_r, a.lse);
    // The walked indices each of the thread's two fixed rows keeps, [lo,
    // hi] (causal, window and tails), so that a mask is two compares and
    // no branch.  dq: row f a q row, keys lo..hi; dk/dv: f a key, q rows.
    int keep_lo[2], keep_hi[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int f = r0 + r_in + 8 * hr;
      const bool win = a.causal && a.window > 0;
      if (DKV) {
        keep_lo[hr] = a.causal ? f : 0;
        keep_hi[hr] = f >= a.Skv ? -1 : win ? min(a.Sq - 1, f + a.window - 1) : a.Sq - 1;
      } else {
        keep_lo[hr] = win ? f - a.window + 1 : 0;
        keep_hi[hr] = f >= a.Sq ? -1 : a.causal ? min(f, a.Skv - 1) : a.Skv - 1;
      }
    }
    float acc[NA1][32];
#pragma unroll
    for (int nb = 0; nb < NA1; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;

    for (int st = 0; st < n_st; ++st) {
      const int stage = st % STAGES;
      float lse_c[16];
      if (DKV) load_cols(lse_c, a.lse, st);  // in flight over the wait and S
      sm90::mbar_wait(&full[stage], (st / STAGES) & 1);
      const unsigned char* w0 = ring + stage * C::STAGE;
      float s[32];
      score(s, smem + C::X, w0, hd);
      // P in place of S; the registers only, so the 32 elements interleave
      const int c0 = step_row(st);
      uint32_t pk[4][4];  // P as bf16 A fragments (dV's operand)
      float p_even = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hr = (i >> 1) & 1, w = c0 + col_of(i);
        float x = s[i], th = 0.f;
        if (a.softcap > 0.f) {
          th = tanhf(x / a.softcap);
          x = a.softcap * th;
        }
        const bool keep = (w >= keep_lo[hr]) & (w <= keep_hi[hr]);
        // exp(-inf) = 0: the masked elements without a branch around expf
        const float p =
            expf(keep ? x - (DKV ? lse_c[col_slot(i)] : lse_r[hr]) : -INFINITY);
        if (i & 1) pk[i / 8][(i % 8) / 2] = sm90::pack2(p_even, p);
        else p_even = p;
        s[i] = a.softcap > 0.f ? p * (1.f - th * th) : p;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) x_p[i * 128 + t] = s[i];
      bar_arrive(1);  // P in shared memory
      if (DKV) {
        accumulate(acc, pk, w0 + C::TILE, 0);  // dV += P^T.dO
        bar_sync(2);                           // warpgroup 2 has read P
      } else {
        bar_sync(2);  // dS in shared memory
        uint32_t dsf[4][4];
#pragma unroll
        for (int e = 0; e < 16; ++e) dsf[e / 4][e % 4] = x_ds[e * 128 + t];
        accumulate(acc, dsf, w0, 0);  // dQ += dS.K, first blocks
      }
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
    }
    if (DKV) {
      float* base = a.dv + (a.part ? g_lo * a.part : 0) +
                    (((long long)b * a.Skv + r0) * a.Kv + kvh) * hd;
      store(acc, base, (long long)a.Kv * hd, a.Skv - r0, 0, hd, r_in, lane);
    } else {
      float* base = a.dq + (((long long)b * a.Sq + r0) * H + blockIdx.y) * hd;
      store(acc, base, (long long)H * hd, a.Sq - r0, 0, hd, r_in, lane);
    }
  } else {
    // Warpgroup 2: dP, then dS = P (dP - di) (1 - t^2) with P from shared
    // memory, then dK += dS^T.Q (dk/dv) or, handing dS to warpgroup 1, dQ's
    // last blocks += dS.K (dq).  Its thread 0 refills each stage once
    // every warp has released it.
    float di_r[2];
    if (!DKV) load_rows(di_r, a.di);
    float acc[NA2 > 0 ? NA2 : 1][32];
#pragma unroll
    for (int nb = 0; nb < (NA2 > 0 ? NA2 : 1); ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;

    for (int st = 0; st < n_st; ++st) {
      const int stage = st % STAGES, phase = (st / STAGES) & 1;
      float di_c[16];
      if (DKV) load_cols(di_c, a.di, st);
      sm90::mbar_wait(&full[stage], phase);
      const unsigned char* w0 = ring + stage * C::STAGE;
      float dp[32];
      score(dp, smem + C::Y, w0 + C::TILE, hd);
      bar_sync(1);  // P in shared memory
      float p[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = x_p[i * 128 + t];
      if (DKV) bar_arrive(2);  // P read: warpgroup 1 may write the next
      uint32_t dsf[4][4];  // dS as bf16 A fragments
#pragma unroll
      for (int i = 1; i < 32; i += 2) {
        const float d0 = DKV ? di_c[col_slot(i - 1)] : di_r[(i >> 1) & 1];
        const float d1 = DKV ? di_c[col_slot(i)] : di_r[(i >> 1) & 1];
        dsf[i / 8][(i % 8) / 2] = sm90::pack2(p[i - 1] * (dp[i - 1] - d0), p[i] * (dp[i] - d1));
      }
      if (!DKV) {
#pragma unroll
        for (int e = 0; e < 16; ++e) x_ds[e * 128 + t] = dsf[e / 4][e % 4];
        bar_arrive(2);  // dS in shared memory
      }
      if constexpr (NA2 > 0) accumulate(acc, dsf, w0, DKV ? 0 : NA1);  // dK += dS^T.Q
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
      if (t == 0 && st + STAGES < n_st) {
        sm90::mbar_wait(&empty[stage], phase);
        issue(st + STAGES);
      }
      __syncwarp();
    }
    if constexpr (NA2 > 0) {
      if (DKV) {
        float* base = a.dk + (a.part ? g_lo * a.part : 0) +
                      (((long long)b * a.Skv + r0) * a.Kv + kvh) * hd;
        store(acc, base, (long long)a.Kv * hd, a.Skv - r0, 0, hd, r_in, lane);
      } else {
        float* base = a.dq + (((long long)b * a.Sq + r0) * H + blockIdx.y) * hd;
        store(acc, base, (long long)H * hd, a.Sq - r0, NA1, hd, r_in, lane);
      }
    }
  }
}

// ---------------------------------------------------------------- host side

template <int NB, bool DKV>
int launch(const BwdArgs& a, const CUtensorMap (&m)[4], dim3 grid, cudaStream_t stream) {
  auto kern = flash_bwd_sm90_kernel<NB, DKV>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Cfg<NB>::smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, NT, Cfg<NB>::smem, stream>>>(m[0], m[1], m[2], m[3], a);
  return (int)cudaGetLastError();
}

// The bf16 backward for head dims that are multiples of 16 up to 256, bf16
// q, k, v and dout whose bases TMA can take (the wrapper hands them so).
template <bool DKV>
int run(const BwdArgs& a, cudaStream_t stream) {
  if (a.hd <= 0 || a.hd % 16 || a.hd > 256 || !a.in_bf16) return (int)cudaErrorInvalidValue;
  const int H = a.Kv * a.G;
  CUtensorMap m[4];
  if (!fsm90::encode_rows(&m[0], a.q, a.hd, H, a.Sq, a.B) ||
      !fsm90::encode_rows(&m[1], a.k, a.hd, a.Kv, a.Skv, a.B) ||
      !fsm90::encode_rows(&m[2], a.v, a.hd, a.Kv, a.Skv, a.B) ||
      !fsm90::encode_rows(&m[3], a.dout, a.hd, H, a.Sq, a.B))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = DKV ? dim3((a.Skv + BR - 1) / BR, a.part ? H : a.Kv, a.B)
                        : dim3((a.Sq + BR - 1) / BR, H, a.B);
  switch ((a.hd + 63) / 64) {
    case 1: return launch<1, DKV>(a, m, grid, stream);
    case 2: return launch<2, DKV>(a, m, grid, stream);
    case 3: return launch<3, DKV>(a, m, grid, stream);
    default: return launch<4, DKV>(a, m, grid, stream);
  }
}

}  // namespace bsm90
}  // namespace rt
