// The flash-attention kernel shared by attention_fused.cu (prefill forward
// and dense-cache decode) and attention_paged.cu (paged-cache decode), the
// precision ladder fused into both contractions.
//
// Layouts are the model's: q (B, Sq, Kv, G, hd) pre-scaled, k/v
// (B, Skv, Kv, hd), out like q in f32.  q is f32 or bf16; k/v are f32 or
// bf16 (kv_type 0 / 1), or, for a paged pool, int8 with one f32 scale per
// (page row, kv head) (kv_type 2), dequantized on the way into shared
// memory.  The forward also writes lse = m + log l, (B, Kv*G, Sq) f32,
// which the backward kernels (attention_bwd.cu) rebuild the probabilities
// from.
//
// One block walks the KV sequence in BKV = 32 row tiles for BQ query rows,
// keeping the online-softmax state (running max m, running sum l, the
// unnormalised output O) in shared memory, so the score tile never reaches
// device memory:
//   S = Q.K^T            (WMMA, policy passes)      -> smem
//   m' = max(m, rowmax S); p = exp(S - m'); l = l e^{m-m'} + rowsum p
//   O = O e^{m-m'} + P.V (WMMA, policy passes; O reloaded as an accumulator)
// A warp owns one score row per step and a lane one column (BKV == 32),
// so row max and row sum are warp shuffles.  f32 runs the same walk on the
// CUDA cores (exact f32 dots).  The carried rungs (bf16x6 and the fp8/int8
// rungs, common.cuh) stage Q, K, V and P in f32 like f32 does and make
// their bf16 terms per fragment; their quantization scales are taken per
// staged tile: Q's BQ x hd block (decode: the group's G heads), each KV
// tile's 32 x hd rows of K and of V, and each BQ x 32 probability tile.
//
// Forward: grid (ceil(Sq/64), Kv*G, B); a q block visits only the KV tiles
// its causal / sliding-window mask can reach (the TPU kernel's
// _block_live skip, as loop bounds).  At hd 256 the block holds Q, K and V
// as bf16 hi+lo (or f32) plus O in f32: 217 KB of shared memory, one block
// per SM.
// Decode: grid (splits, Kv, B), one block per (KV split, row, kv head)
// whose 16 query rows are the G heads of that group, so K and V are read
// once per group.  Ring layers keep slot c when pos - ((pos - c) mod S) >= 0
// (a floor mod), linear layers c <= pos; both walk only the tiles up to
// pos, since until a ring wraps (pos < S) its slots past pos are masked
// too.  At one split (every rung but bf16) a block walks all of them.  At
// the bf16 rung the host splits the walk (kernels/attention_fused.py:
// decode_splits, from B, Kv, the cache's rows and the SM count: a grid of
// (B, Kv) blocks is 4 CTAs for gemma3 at B = 4) so that the card fills:
// split s takes live tiles [s * per, (s + 1) * per), per = ceil(live /
// splits), runs the same online softmax over them and writes its group's
// unnormalised O (G x hd), m and l to a workspace slot (a split with no
// live tile writes O = 0, l = 0, m = NEG_INF); the block that draws the
// group's last ticket (atomicAdd after a fence, as gemm_splitk.cuh's
// reduction) combines the splits in index order, O = sum_s O_s e^{m_s - M}
// and l = sum_s l_s e^{m_s - M} with M = max_s m_s, writes out = O / l and
// resets the ticket.  The order is fixed, so the result is deterministic;
// NEG_INF is finite, so an empty split weighs e^{NEG_INF - M} = 0.  A paged decode
// (PAGED) reads logical row c of slot b from physical row
// table[b, c / ps] * ps + c % ps of the pool, each row of the 32-row tile
// through its own table entry, so the tiles, masks and sums are those of
// the dense decode and a bf16 pool gives the dense kernel's result bit for
// bit.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int BKV = 32;
constexpr int ATT_WARPS = 8;
constexpr int ATT_NT = ATT_WARPS * 32;
constexpr float NEG_INF = -1e30f;

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  float* o;
  float* lse;      // forward: (B, Kv*G, Sq) log-sum-exp of each row, or null
  const int* pos;  // decode: (B,) positions
  int in_bf16;     // q (and, for the dense kernels, k and v) is bf16
  int B, Sq, Skv, Kv, G, hd;
  int causal, window;  // forward masks; window <= 0: none
  int ring;            // decode: ring-buffer mask, else linear
  float softcap;       // <= 0: none
  int kv_type;         // k/v payload: 0 f32, 1 bf16, 2 int8 (paged pools)
  const int* table;    // paged decode: (B, n_log) page table
  const float* k_scale;  // int8 pools: (P, ps, Kv) per-row scales
  const float* v_scale;
  int n_log, ps;       // paged decode: logical pages per slot, rows per page
};

// Decode splits per (row, kv head) at most (the combine's weights fit in
// the K tile's shared memory at any head dim).
constexpr int DECODE_MAX_SPLITS = 64;

// Whether a decode launch's split is one the kernel takes: 1 at any rung;
// more only at bf16, with a workspace slot per (row, kv head, split) and a
// ticket per (row, kv head).  The split travels beside AttnArgs, not in
// it: the bf16 forward of flash_sm90.cuh takes AttnArgs by value too, and
// ran markedly slower on the H100 while the split lived in the struct.
inline bool decode_split_ok(const AttnArgs& a, const SplitWs& w, int policy) {
  if (w.splits == 1) return true;
  const long long groups = (long long)a.B * a.Kv;
  return policy == P_BF16 && w.splits > 1 && w.splits <= DECODE_MAX_SPLITS &&
         w.ws != nullptr && w.tickets != nullptr && groups <= w.n_tickets &&
         groups * w.splits * 16 * (a.hd + 2) <= w.ws_floats;  // BQ = 16 rows
}

// Eight consecutive int8 values (8 bytes, 8-element aligned) as f32.
__device__ __forceinline__ void load8_i8(const void* p, long long i, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(static_cast<const signed char*>(p) + i);
  const unsigned w[2] = {u.x, u.y};
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = (float)(signed char)((w[j / 4] >> (8 * (j % 4))) & 0xffu);
}

// Byte offsets of the shared-memory sections for BQ rows at head dim hd.
struct AttnSmem {
  size_t q, k, v, s, p, o, m, l, red, scr, total;
  __host__ __device__ AttnSmem(int bq, int hd, bool carried) {
    size_t ldq = hd + 8;
    q = 0;
    k = q + align128(bq * ldq * 4);  // bf16 hi+lo, or f32
    v = k + align128(BKV * ldq * 4);
    s = v + align128(BKV * ldq * 4);
    p = s + align128(bq * (BKV + 4) * 4);
    o = p + align128(bq * (BKV + 8) * 4);
    m = o + align128(bq * (hd + 4) * 4);
    l = m + align128(bq * 4);
    red = l + align128(bq * 4);                  // carried rungs: block reductions
    scr = red + (carried ? align128(32 * 4) : 0);  // and a 1 KB term scratch per warp
    total = scr + (carried ? ATT_WARPS * 1024 : 0);
  }
};

template <int POL, int BQ, bool DECODE, bool PAGED>
__global__ void __launch_bounds__(ATT_NT) flash_kernel(AttnArgs a, SplitWs sw) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool CARRIED = Carried<POL>::value;
  constexpr bool F32TILE = POL == P_F32 || CARRIED;  // operand tiles staged in f32
  const AttnSmem sm(BQ, a.hd, CARRIED);
  const int hd = a.hd, ldq = hd + 8, ldo = hd + 4, lds = BKV + 4, ldp = BKV + 8;
  const int H = a.Kv * a.G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  int b, kvh, h, q0, rows, pos = 0, split = 0;
  if (DECODE) {
    split = blockIdx.x; kvh = blockIdx.y; b = blockIdx.z; h = kvh * a.G; q0 = 0; rows = a.G;
    pos = a.pos[b];
  } else {
    q0 = blockIdx.x * BQ; h = blockIdx.y; b = blockIdx.z; kvh = h / a.G;
    rows = min(BQ, a.Sq - q0);
  }

  bf16* q_hi = reinterpret_cast<bf16*>(smem + sm.q);
  bf16* q_lo = q_hi + BQ * ldq;
  float* q_f = reinterpret_cast<float*>(smem + sm.q);
  bf16* k_hi = reinterpret_cast<bf16*>(smem + sm.k);
  bf16* k_lo = k_hi + BKV * ldq;
  float* k_f = reinterpret_cast<float*>(smem + sm.k);
  bf16* v_hi = reinterpret_cast<bf16*>(smem + sm.v);
  bf16* v_lo = v_hi + BKV * ldq;
  float* v_f = reinterpret_cast<float*>(smem + sm.v);
  float* S = reinterpret_cast<float*>(smem + sm.s);
  bf16* p_hi = reinterpret_cast<bf16*>(smem + sm.p);
  bf16* p_lo = p_hi + BQ * ldp;
  float* p_f = reinterpret_cast<float*>(smem + sm.p);
  float* O = reinterpret_cast<float*>(smem + sm.o);
  float* M = reinterpret_cast<float*>(smem + sm.m);
  float* L = reinterpret_cast<float*>(smem + sm.l);
  float* red = reinterpret_cast<float*>(smem + sm.red);
  bf16* scr = reinterpret_cast<bf16*>(smem + sm.scr) + warp * 512;

  // Element (row r, dim d) of q and out: decode rows are the group's heads,
  // forward rows are positions of head h.
  auto q_index = [&](int r, int d) -> long long {
    if (DECODE) return ((long long)b * H + h + r) * hd + d;
    return (((long long)b * a.Sq + q0 + r) * H + h) * hd + d;
  };

  const int hd8 = hd / 8;
  for (int idx = tid; idx < BQ * hd8; idx += ATT_NT) {
    const int r = idx / hd8, d0 = (idx % hd8) * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < rows) load8(a.q, q_index(r, d0), a.in_bf16, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if constexpr (F32TILE) q_f[r * ldq + d0 + e] = x[e];
      else store_split<Splits<POL>::a_lo>(q_hi, q_lo, r * ldq + d0 + e, x[e]);
      O[r * ldo + d0 + e] = 0.f;
    }
  }
  for (int r = tid; r < BQ; r += ATT_NT) {
    M[r] = NEG_INF;
    L[r] = 0.f;
  }
  float2 sq = make_float2(1.f, 1.f), sk = sq, sv = sq, sp = sq;  // carried: tile scales
  if constexpr (Carried<POL>::quant) {
    __syncthreads();
    sq = tile_scales<POL>(q_f, BQ, hd, ldq, red);
  }

  // The KV tiles this block's mask can reach.
  int j_lo = 0, j_hi = a.Skv;
  if (DECODE) {
    j_hi = min(a.Skv, pos + 1);  // ring or linear: the slots past pos are masked
  } else if (a.causal) {
    j_hi = min(a.Skv, q0 + rows);
    if (a.window > 0) j_lo = max(0, q0 - a.window + 1);
  }
  int t_lo = j_lo / BKV, t_hi = (j_hi + BKV - 1) / BKV;
  // this split's share of the live tiles (only the bf16 rung splits)
  if (POL == P_BF16 && DECODE && sw.splits > 1) {
    const int per = (t_hi + sw.splits - 1) / sw.splits;
    t_lo = min(t_hi, split * per);
    t_hi = min(t_hi, t_lo + per);
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // previous step done with K, V, S and P
    for (int idx = tid; idx < BKV * hd8; idx += ATT_NT) {
      const int j = idx / hd8, d0 = (idx % hd8) * 8, gj = k0 + j;
      float kx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float vx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (gj < a.Skv) {
        // the row of the cache (dense) or of the page pool (paged)
        long long row = (long long)b * a.Skv + gj;
        if constexpr (PAGED) row = (long long)a.table[(long long)b * a.n_log + gj / a.ps] * a.ps + gj % a.ps;
        const long long gi = (row * a.Kv + kvh) * hd + d0;
        if (PAGED && a.kv_type == 2) {
          load8_i8(a.k, gi, kx);
          load8_i8(a.v, gi, vx);
          const float ks = a.k_scale[row * a.Kv + kvh], vs = a.v_scale[row * a.Kv + kvh];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            kx[e] = __fmul_rn(kx[e], ks);  // rounded before the split, as the plain twin
            vx[e] = __fmul_rn(vx[e], vs);
          }
        } else {
          load8(a.k, gi, a.kv_type, kx);
          load8(a.v, gi, a.kv_type, vx);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int o = j * ldq + d0 + e;
        if constexpr (F32TILE) {
          k_f[o] = kx[e];
          v_f[o] = vx[e];
        } else {
          store_split<Splits<POL>::b_lo>(k_hi, k_lo, o, kx[e]);
          store_split<Splits<POL>::b_lo>(v_hi, v_lo, o, vx[e]);
        }
      }
    }
    __syncthreads();
    if constexpr (Carried<POL>::quant) {
      sk = tile_scales<POL>(k_f, BKV, hd, ldq, red);
      sv = tile_scales<POL>(v_f, BKV, hd, ldq, red);
    }

    // S = Q K^T
    if constexpr (POL == P_F32) {
      for (int idx = tid; idx < BQ * BKV; idx += ATT_NT) {
        int r = idx / BKV, c = idx % BKV;
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc = fmaf(q_f[r * ldq + d], k_f[c * ldq + d], acc);
        S[r * lds + c] = acc;
      }
    } else {
      constexpr int FC = BKV / 16;
      for (int f = warp; f < (BQ / 16) * FC; f += ATT_WARPS) {
        int fr = f / FC, fc = f % FC;
        FragC small, main;
        wmma::fill_fragment(small, 0.f);
        wmma::fill_fragment(main, 0.f);
        for (int d = 0; d < hd; d += 16) {
          int qo = fr * 16 * ldq + d, ko = fc * 16 * ldq + d;
          if constexpr (CARRIED)
            fly_mma<POL, true, false>(small, main, FlyOp{q_f + qo, ldq, sq},
                                      FlyOp{k_f + ko, ldq, sk}, scr);
          else
            policy_mma<POL, wmma::col_major>(small, main, q_hi + qo, q_lo + qo, ldq,
                                             k_hi + ko, k_lo + ko, ldq);
        }
        for (int e = 0; e < main.num_elements; ++e) main.x[e] = small.x[e] + main.x[e];
        wmma::store_matrix_sync(S + fr * 16 * lds + fc * 16, main, lds, wmma::mem_row_major);
      }
    }
    __syncthreads();

    // Online softmax: warp per row, lane per column.
    for (int r = warp; r < BQ; r += ATT_WARPS) {
      const int c = k0 + lane;
      float s = S[r * lds + lane];
      if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
      bool keep = c < a.Skv;
      if (DECODE) {
        if (a.ring) {
          int mod = ((pos - c) % a.Skv + a.Skv) % a.Skv;
          keep = keep && pos - mod >= 0;
        } else {
          keep = keep && c <= pos;
        }
      } else {
        const int qr = q0 + r;
        keep = keep && qr < a.Sq;
        if (a.causal) {
          keep = keep && c <= qr;
          if (a.window > 0) keep = keep && c > qr - a.window;
        }
      }
      s = keep ? s : NEG_INF;
      float mx = s;
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = M[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      const float p = expf(s - m_new);
      float sum = p;
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if constexpr (F32TILE) p_f[r * ldp + lane] = p;
      else store_split<Splits<POL>::a_lo>(p_hi, p_lo, r * ldp + lane, p);
      for (int d = lane; d < hd; d += 32) O[r * ldo + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        M[r] = m_new;
        L[r] = L[r] * alpha + sum;
      }
    }
    __syncthreads();
    if constexpr (Carried<POL>::quant) sp = tile_scales<POL>(p_f, BQ, BKV, ldp, red);

    // O += P V
    if constexpr (POL == P_F32) {
      for (int idx = tid; idx < BQ * hd; idx += ATT_NT) {
        int r = idx / hd, d = idx % hd;
        float acc = 0.f;
        for (int j = 0; j < BKV; ++j) acc = fmaf(p_f[r * ldp + j], v_f[j * ldq + d], acc);
        O[r * ldo + d] += acc;
      }
    } else {
      const int fd_n = hd / 16;
      for (int f = warp; f < (BQ / 16) * fd_n; f += ATT_WARPS) {
        int fr = f / fd_n, fd = f % fd_n;
        FragC small, main, acc;
        wmma::fill_fragment(small, 0.f);
        wmma::fill_fragment(main, 0.f);
#pragma unroll
        for (int kk = 0; kk < BKV; kk += 16) {
          int po = fr * 16 * ldp + kk, vo = kk * ldq + fd * 16;
          if constexpr (CARRIED)
            fly_mma<POL, true, true>(small, main, FlyOp{p_f + po, ldp, sp},
                                     FlyOp{v_f + vo, ldq, sv}, scr);
          else
            policy_mma<POL, wmma::row_major>(small, main, p_hi + po, p_lo + po, ldp,
                                             v_hi + vo, v_lo + vo, ldq);
        }
        float* o_tile = O + fr * 16 * ldo + fd * 16;
        wmma::load_matrix_sync(acc, o_tile, ldo, wmma::mem_row_major);
        for (int e = 0; e < acc.num_elements; ++e) acc.x[e] = acc.x[e] + (small.x[e] + main.x[e]);
        wmma::store_matrix_sync(o_tile, acc, ldo, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();

  if constexpr (DECODE && POL == P_BF16) {
    if (sw.splits > 1) {
      // this split's O, m and l into its slot; the last of the group combines
      __shared__ int is_last;
      const int splits = sw.splits, part = BQ * (hd + 2);
      const long long grp = (long long)b * a.Kv + kvh;
      const float* slots = sw.ws + grp * splits * part;
      float* mine = sw.ws + (grp * splits + split) * part;
      for (int idx = tid; idx < rows * hd; idx += ATT_NT) mine[idx] = O[(idx / hd) * ldo + idx % hd];
      for (int r = tid; r < rows; r += ATT_NT) {
        mine[BQ * hd + r] = M[r];
        mine[BQ * hd + BQ + r] = L[r];
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) is_last = atomicAdd(sw.tickets + grp, 1) == splits - 1;
      __syncthreads();
      if (!is_last) return;
      __threadfence();
      // weights e^{m_s - M} by (split, row), then each row's max(l, 1e-30)
      // slot, in the K tile's shared memory (the walk is done with it)
      // (the loops over splits are unrolled so that their L2 reads overlap)
      float* wgt = reinterpret_cast<float*>(smem + sm.k);
      for (int r = tid; r < rows; r += ATT_NT) {
        float mx = NEG_INF;
#pragma unroll 8
        for (int s = 0; s < splits; ++s) mx = fmaxf(mx, __ldcg(slots + s * part + BQ * hd + r));
        float l = 0.f;
#pragma unroll 8
        for (int s = 0; s < splits; ++s) {
          const float w = expf(__ldcg(slots + s * part + BQ * hd + r) - mx);
          wgt[s * BQ + r] = w;
          l = l + __ldcg(slots + s * part + BQ * hd + BQ + r) * w;
        }
        wgt[splits * BQ + r] = fmaxf(l, 1e-30f);
      }
      __syncthreads();
      for (int idx = tid; idx < rows * hd; idx += ATT_NT) {
        const int r = idx / hd;
        float acc = 0.f;
#pragma unroll 8
        for (int s = 0; s < splits; ++s) acc = acc + __ldcg(slots + s * part + idx) * wgt[s * BQ + r];
        a.o[q_index(r, idx % hd)] = acc / wgt[splits * BQ + r];
      }
      if (tid == 0) sw.tickets[grp] = 0;
      return;
    }
  }

  for (int idx = tid; idx < rows * hd; idx += ATT_NT) {
    int r = idx / hd, d = idx % hd;
    a.o[q_index(r, d)] = O[r * ldo + d] / fmaxf(L[r], 1e-30f);
  }
  if (!DECODE && a.lse != nullptr) {
    for (int r = tid; r < rows; r += ATT_NT)
      a.lse[((long long)b * H + h) * a.Sq + q0 + r] = M[r] + logf(fmaxf(L[r], 1e-30f));
  }
}

constexpr SplitWs NO_SPLIT{1, nullptr, 0, nullptr, 0};

template <int POL, int BQ, bool DECODE, bool PAGED>
int run_attn(const AttnArgs& a, dim3 grid, cudaStream_t stream, const SplitWs& sw) {
  AttnSmem sm(BQ, a.hd, Carried<POL>::value);
  auto kern = flash_kernel<POL, BQ, DECODE, PAGED>;
  // the limit once, at the largest head dim the wrappers take (256)
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t err = smem_once(ready, kern, AttnSmem(BQ, 256, Carried<POL>::value).total);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, ATT_NT, sm.total, stream>>>(a, sw);
  return (int)cudaGetLastError();
}

// The forward's bf16 rung runs flash_sm90.cuh's kernel; decode's runs here.
template <int BQ, bool DECODE, bool PAGED = false>
int dispatch_attn(const AttnArgs& a, int policy, dim3 grid, cudaStream_t stream,
                  const SplitWs& sw = NO_SPLIT) {
  switch (policy) {
    case P_BF16:
      if constexpr (DECODE) return run_attn<P_BF16, BQ, DECODE, PAGED>(a, grid, stream, sw);
      return (int)cudaErrorInvalidValue;
    case P_REFINE_A: return run_attn<P_REFINE_A, BQ, DECODE, PAGED>(a, grid, stream, sw);
    case P_BF16X3: return run_attn<P_BF16X3, BQ, DECODE, PAGED>(a, grid, stream, sw);
    case P_REFINE_AB: return run_attn<P_REFINE_AB, BQ, DECODE, PAGED>(a, grid, stream, sw);
    case P_F32: return run_attn<P_F32, BQ, DECODE, PAGED>(a, grid, stream, sw);
    case P_BF16X6: return run_attn<P_BF16X6, BQ, DECODE, PAGED>(a, grid, stream, sw);
    case P_FP8: return run_attn<P_FP8, BQ, DECODE, PAGED>(a, grid, stream, sw);
    case P_INT8: return run_attn<P_INT8, BQ, DECODE, PAGED>(a, grid, stream, sw);
    case P_FP8X3: return run_attn<P_FP8X3, BQ, DECODE, PAGED>(a, grid, stream, sw);
    case P_INT8X3: return run_attn<P_INT8X3, BQ, DECODE, PAGED>(a, grid, stream, sw);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rt
