// Flash-attention backward on the tensor cores: two kernels, dq and dk/dv,
// the precision ladder fused into every contraction.
//
// Replaces the TPU kernels kernels/attention_fused.py:_bwd_dq_kernel
// (pallas_call at :354) and :_bwd_dkv_kernel (pallas_call at :374).
//
// Layouts are the model's: q, dout and dq (B, Sq, Kv, G, hd); k, v, dk and
// dv (B, Skv, Kv, hd); lse and di = rowsum(dout * out) (B, Kv*G, Sq).  q, k
// and v are all f32 or all bf16; dout, lse and di are f32; the gradients
// are written in f32.
//
// At the bf16 rung both launchers run the Hopper kernels of
// flash_bwd_sm90.cuh instead (wgmma, 64-row tiles, every score tile and
// accumulator in registers; q, k, v and dout bf16, which the wrapper
// hands); every other rung runs the WMMA kernels below.  Each launcher
// reports the kernel that ran through `loop` (rt::Mainloop).
//
// Both kernels rebuild the probability tile from the saved log-sum-exp
// instead of storing it in the forward:
//   S  = Q.K^T                     (policy passes)
//   s' = cap tanh(S / cap)         (softcap, when set)
//   P  = keep ? exp(s' - lse) : 0  (causal, sliding-window and tail masks)
//   dP = dO.V^T                    (policy passes)
//   dS = P (dP - di) (1 - tanh^2)  (the softcap chain term, when set)
// dq:   grid (ceil(Sq/32), Kv*G, B).  A block owns 32 query rows of one head
//       and walks the KV tiles its mask reaches (loop bounds, as in the
//       forward), accumulating dQ += dS.K.
// dk/dv: grid (ceil(Skv/32), Kv, B).  A block owns 32 KV rows of one kv head
//       and walks, for each of the group's G query heads in turn, the q
//       tiles that reach those rows, accumulating dV += P^T.dO and
//       dK += dS^T.Q.  Folding the group in the block writes (B, Skv, Kv,
//       hd) directly; no per-query-head copy and no atomics, so every output
//       tile has one owner and the result does not depend on scheduling.
// The transposed operands P^T and dS^T are read in place as col-major WMMA
// A fragments.  Each contraction keeps the operand order of the TPU kernel
// (Q.K^T, dO.V^T, dS.K, P^T.dO, dS^T.Q), so refine_a splits the same side.
// At hd 256 the dk/dv block holds K, V, Q and dO as bf16 hi+lo (or f32),
// dK and dV as f32, and the 32x32 score tiles: 221 KB of shared memory; the
// dq block 183 KB.  f32 runs the same walk with CUDA-core dots.  The carried
// rungs (bf16x6, fp8/int8, common.cuh) stage every tile in f32 and make the
// terms per fragment through a 1 KB scratch per warp (dk/dv: 230 KB at hd
// 256); their quantization scales are taken per staged tile: 32 x hd rows
// of Q, dO, K and V, and each 32 x 32 P and dS tile.
#include <type_traits>

#include "flash_bwd_sm90.cuh"  // BwdArgs, and the bf16 rung's Hopper kernels

namespace rt {

constexpr int BT = 32;  // rows of every q and kv tile; a warp's lane is one column
constexpr int BW_WARPS = 8;
constexpr int BW_NT = BW_WARPS * 32;

// Shared-memory sections: four staged hd-wide operand tiles (bf16 hi+lo or
// f32, same bytes), `acc` f32 accumulators of BT x hd, the S and dP score
// tiles (f32), the P and dS tiles (bf16 hi+lo or f32), lse and di.
struct BwdSmem {
  size_t x0, x1, x2, x3, acc, s, dp, p, ds, lse, di, red, scr, total;
  __host__ __device__ BwdSmem(int hd, int n_acc, bool carried) {
    const size_t ldq = hd + 8, tile = align128(BT * ldq * 4);
    x0 = 0;
    x1 = x0 + tile;
    x2 = x1 + tile;
    x3 = x2 + tile;
    acc = x3 + tile;
    s = acc + n_acc * align128(BT * (hd + 4) * 4);
    dp = s + align128(BT * (BT + 4) * 4);
    p = dp + align128(BT * (BT + 4) * 4);
    ds = p + align128(BT * (BT + 8) * 4);
    lse = ds + align128(BT * (BT + 8) * 4);
    di = lse + align128(BT * 4);
    red = di + align128(BT * 4);                   // carried rungs: block reductions
    scr = red + (carried ? align128(32 * 4) : 0);  // and a 1 KB term scratch per warp
    total = scr + (carried ? BW_WARPS * 1024 : 0);
  }
};

// A staged operand tile: bf16 hi (and lo) halves, or f32.
struct Tile {
  bf16* hi;
  bf16* lo;
  float* f;
  __device__ Tile(unsigned char* base, int ld) {
    hi = reinterpret_cast<bf16*>(base);
    lo = hi + BT * ld;
    f = reinterpret_cast<float*>(base);
  }
};

// Stage `rows` valid rows (zeros past them) of an hd-wide row-major block
// whose row r starts at element row_index(r), splitting into hi+lo when
// WITH_LO.
template <int POL, bool WITH_LO, class RowIndex>
__device__ __forceinline__ void stage_rows(Tile t, const void* src, int is_bf16, int rows, int hd,
                                           int ld, RowIndex row_index) {
  const int hd8 = hd / 8;
  for (int idx = threadIdx.x; idx < BT * hd8; idx += BW_NT) {
    const int r = idx / hd8, d0 = (idx % hd8) * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < rows) load8(src, row_index(r) + d0, is_bf16, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if constexpr (POL == P_F32 || Carried<POL>::value) t.f[r * ld + d0 + e] = x[e];
      else store_split<WITH_LO>(t.hi, t.lo, r * ld + d0 + e, x[e]);
    }
  }
}

// out (BT x BT, ld BT+4) = X.Y^T over hd, X and Y staged BT x hd tiles.
template <int POL>
__device__ __forceinline__ void scores(float* out, Tile x, Tile y, int hd, int ld, int warp,
                                       int n_warps, int warp0, float2 sx, float2 sy,
                                       bf16* scr) {
  const int lds = BT + 4;
  if constexpr (POL == P_F32) {
    for (int idx = threadIdx.x - warp0 * 32; idx < BT * BT; idx += n_warps * 32) {
      const int r = idx / BT, c = idx % BT;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc = fmaf(x.f[r * ld + d], y.f[c * ld + d], acc);
      out[r * lds + c] = acc;
    }
  } else {
    constexpr int FC = BT / 16;
    for (int f = warp; f < (BT / 16) * FC; f += n_warps) {
      const int fr = f / FC, fc = f % FC;
      FragC small, main;
      wmma::fill_fragment(small, 0.f);
      wmma::fill_fragment(main, 0.f);
      for (int d = 0; d < hd; d += 16) {
        const int xo = fr * 16 * ld + d, yo = fc * 16 * ld + d;
        if constexpr (Carried<POL>::value)
          fly_mma<POL, true, false>(small, main, FlyOp{x.f + xo, ld, sx}, FlyOp{y.f + yo, ld, sy},
                                    scr);
        else
          policy_mma<POL, wmma::col_major>(small, main, x.hi + xo, x.lo + xo, ld, y.hi + yo,
                                           y.lo + yo, ld);
      }
      for (int e = 0; e < main.num_elements; ++e) main.x[e] = small.x[e] + main.x[e];
      wmma::store_matrix_sync(out + fr * 16 * lds + fc * 16, main, lds, wmma::mem_row_major);
    }
  }
}

// acc (BT x hd, ld hd+4) += op(W).Y, W a BT x BT tile (ld BT+8) read as is
// (TRANS = false: acc row r sums W[r][j] Y[j]) or transposed (TRANS = true:
// acc row j sums W[r][j] Y[r]), Y a staged BT x hd tile.
template <int POL, bool TRANS>
__device__ __forceinline__ void accumulate(float* acc, const bf16* w_hi, const bf16* w_lo,
                                           const float* w_f, Tile y, int hd, int ld, int warp,
                                           float2 sw, float2 sy, bf16* scr) {
  const int ldo = hd + 4, ldp = BT + 8;
  if constexpr (POL == P_F32) {
    for (int idx = threadIdx.x; idx < BT * hd; idx += BW_NT) {
      const int r = idx / hd, d = idx % hd;
      float s = 0.f;
      for (int j = 0; j < BT; ++j) {
        const float w = TRANS ? w_f[j * ldp + r] : w_f[r * ldp + j];
        s = fmaf(w, y.f[j * ld + d], s);
      }
      acc[r * ldo + d] += s;
    }
  } else {
    using LayoutA = typename std::conditional<TRANS, wmma::col_major, wmma::row_major>::type;
    const int fd_n = hd / 16;
    for (int f = warp; f < (BT / 16) * fd_n; f += BW_WARPS) {
      const int fr = f / fd_n, fd = f % fd_n;
      FragC small, main, c;
      wmma::fill_fragment(small, 0.f);
      wmma::fill_fragment(main, 0.f);
#pragma unroll
      for (int kk = 0; kk < BT; kk += 16) {
        // A tile (fr, kk): row-major at W[fr*16][kk]; transposed, element
        // (i, k) = W[kk + k][fr*16 + i], a col-major tile at W[kk][fr*16].
        const int wo = TRANS ? kk * ldp + fr * 16 : fr * 16 * ldp + kk;
        const int yo = kk * ld + fd * 16;
        if constexpr (Carried<POL>::value)
          fly_mma<POL, !TRANS, true>(small, main, FlyOp{w_f + wo, ldp, sw},
                                     FlyOp{y.f + yo, ld, sy}, scr);
        else
          policy_mma<POL, wmma::row_major, LayoutA>(small, main, w_hi + wo, w_lo + wo, ldp,
                                                    y.hi + yo, y.lo + yo, ld);
      }
      float* tile = acc + fr * 16 * ldo + fd * 16;
      wmma::load_matrix_sync(c, tile, ldo, wmma::mem_row_major);
      for (int e = 0; e < c.num_elements; ++e) c.x[e] = c.x[e] + (small.x[e] + main.x[e]);
      wmma::store_matrix_sync(tile, c, ldo, wmma::mem_row_major);
    }
  }
}

// The elementwise step of one (q tile, kv tile) pair: rebuild P from S and
// lse under the masks, form dS, and stage P (when WITH_P) and dS for the
// tensor cores.  Warp per row, lane per column.
template <int POL, bool WITH_P>
__device__ __forceinline__ void probs(const BwdArgs& a, const float* S, const float* dP,
                                      const float* lse, const float* di, bf16* p_hi, bf16* p_lo,
                                      float* p_f, bf16* ds_hi, bf16* ds_lo, float* ds_f, int q0,
                                      int k0, int warp, int lane) {
  const int lds = BT + 4, ldp = BT + 8;
  for (int r = warp; r < BT; r += BW_WARPS) {
    const int c = k0 + lane, qr = q0 + r;
    float s = S[r * lds + lane], t = 0.f;
    if (a.softcap > 0.f) {
      t = tanhf(s / a.softcap);
      s = a.softcap * t;
    }
    bool keep = c < a.Skv && qr < a.Sq;
    if (a.causal) {
      keep = keep && c <= qr;
      if (a.window > 0) keep = keep && c > qr - a.window;
    }
    const float p = keep ? expf(s - lse[r]) : 0.f;
    float ds = p * (dP[r * lds + lane] - di[r]);
    if (a.softcap > 0.f) ds = ds * (1.f - t * t);
    const int o = r * ldp + lane;
    if constexpr (POL == P_F32 || Carried<POL>::value) {
      if constexpr (WITH_P) p_f[o] = p;
      ds_f[o] = ds;
    } else {
      if constexpr (WITH_P) store_split<Splits<POL>::a_lo>(p_hi, p_lo, o, p);
      store_split<Splits<POL>::a_lo>(ds_hi, ds_lo, o, ds);
    }
  }
}

template <int POL>
__global__ void __launch_bounds__(BW_NT) bwd_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem sm(a.hd, 1, Carried<POL>::value);
  const int hd = a.hd, ld = hd + 8, ldo = hd + 4;
  const int H = a.Kv * a.G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z, kvh = h / a.G;
  const int rows = min(BT, a.Sq - q0);
  constexpr bool Q_LO = Splits<POL>::a_lo, K_LO = Splits<POL>::b_lo;

  Tile tq(smem + sm.x0, ld), tdo(smem + sm.x1, ld), tk(smem + sm.x2, ld), tv(smem + sm.x3, ld);
  float* acc = reinterpret_cast<float*>(smem + sm.acc);
  float* S = reinterpret_cast<float*>(smem + sm.s);
  float* dP = reinterpret_cast<float*>(smem + sm.dp);
  bf16* ds_hi = reinterpret_cast<bf16*>(smem + sm.ds);
  bf16* ds_lo = ds_hi + BT * (BT + 8);
  float* ds_f = reinterpret_cast<float*>(smem + sm.ds);
  float* lse = reinterpret_cast<float*>(smem + sm.lse);
  float* di = reinterpret_cast<float*>(smem + sm.di);
  float* red = reinterpret_cast<float*>(smem + sm.red);
  bf16* scr = reinterpret_cast<bf16*>(smem + sm.scr) + warp * 512;
  const int ldp = BT + 8;

  auto q_row = [&](int r) -> long long { return (((long long)b * a.Sq + q0 + r) * H + h) * hd; };
  stage_rows<POL, Q_LO>(tq, a.q, a.in_bf16, rows, hd, ld, q_row);
  stage_rows<POL, Q_LO>(tdo, a.dout, 0, rows, hd, ld, q_row);
  float2 sq = make_float2(1.f, 1.f), sdo = sq, sk = sq, sv = sq, sds = sq;  // carried scales
  if constexpr (Carried<POL>::quant) {
    __syncthreads();
    sq = tile_scales<POL>(tq.f, BT, hd, ld, red);
    sdo = tile_scales<POL>(tdo.f, BT, hd, ld, red);
  }
  for (int idx = threadIdx.x; idx < BT * hd; idx += BW_NT) acc[(idx / hd) * ldo + idx % hd] = 0.f;
  for (int r = threadIdx.x; r < BT; r += BW_NT) {
    const long long o = ((long long)b * H + h) * a.Sq + q0 + r;
    lse[r] = r < rows ? a.lse[o] : 0.f;
    di[r] = r < rows ? a.di[o] : 0.f;
  }

  // The KV tiles this q block's mask reaches.
  int j_lo = 0, j_hi = a.Skv;
  if (a.causal) {
    j_hi = min(a.Skv, q0 + rows);
    if (a.window > 0) j_lo = max(0, q0 - a.window + 1);
  }
  for (int t = j_lo / BT; t < (j_hi + BT - 1) / BT; ++t) {
    const int k0 = t * BT;
    __syncthreads();  // previous step done with K, V, S, dP and dS
    auto kv_row = [&](int j) -> long long { return (((long long)b * a.Skv + k0 + j) * a.Kv + kvh) * hd; };
    stage_rows<POL, K_LO>(tk, a.k, a.in_bf16, min(BT, a.Skv - k0), hd, ld, kv_row);
    stage_rows<POL, K_LO>(tv, a.v, a.in_bf16, min(BT, a.Skv - k0), hd, ld, kv_row);
    __syncthreads();
    if constexpr (Carried<POL>::quant) {
      sk = tile_scales<POL>(tk.f, BT, hd, ld, red);
      sv = tile_scales<POL>(tv.f, BT, hd, ld, red);
    }
    // warps 0-3: S = Q.K^T; warps 4-7: dP = dO.V^T
    if (warp < BW_WARPS / 2) scores<POL>(S, tq, tk, hd, ld, warp, BW_WARPS / 2, 0, sq, sk, scr);
    else scores<POL>(dP, tdo, tv, hd, ld, warp - BW_WARPS / 2, BW_WARPS / 2, BW_WARPS / 2, sdo,
                     sv, scr);
    __syncthreads();
    probs<POL, false>(a, S, dP, lse, di, nullptr, nullptr, nullptr, ds_hi, ds_lo, ds_f, q0, k0,
                      warp, lane);
    __syncthreads();
    if constexpr (Carried<POL>::quant) sds = tile_scales<POL>(ds_f, BT, BT, ldp, red);
    accumulate<POL, false>(acc, ds_hi, ds_lo, ds_f, tk, hd, ld, warp, sds, sk, scr);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * hd; idx += BW_NT) {
    const int r = idx / hd, d = idx % hd;
    a.dq[q_row(r) + d] = acc[r * ldo + d];
  }
}

template <int POL>
__global__ void __launch_bounds__(BW_NT) bwd_dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem sm(a.hd, 2, Carried<POL>::value);
  const int hd = a.hd, ld = hd + 8, ldo = hd + 4, ldp = BT + 8;
  const int H = a.Kv * a.G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * BT, kvh = blockIdx.y, b = blockIdx.z;
  const int kv_rows = min(BT, a.Skv - k0);
  // Q and dO are the A side of S and dP and the B side of dK and dV.
  constexpr bool X_LO = Splits<POL>::a_lo || Splits<POL>::b_lo, K_LO = Splits<POL>::b_lo;

  Tile tk(smem + sm.x0, ld), tv(smem + sm.x1, ld), tq(smem + sm.x2, ld), tdo(smem + sm.x3, ld);
  float* dK = reinterpret_cast<float*>(smem + sm.acc);
  float* dV = dK + BT * ldo;
  float* S = reinterpret_cast<float*>(smem + sm.s);
  float* dP = reinterpret_cast<float*>(smem + sm.dp);
  bf16* p_hi = reinterpret_cast<bf16*>(smem + sm.p);
  bf16* p_lo = p_hi + BT * ldp;
  float* p_f = reinterpret_cast<float*>(smem + sm.p);
  bf16* ds_hi = reinterpret_cast<bf16*>(smem + sm.ds);
  bf16* ds_lo = ds_hi + BT * ldp;
  float* ds_f = reinterpret_cast<float*>(smem + sm.ds);
  float* lse = reinterpret_cast<float*>(smem + sm.lse);
  float* di = reinterpret_cast<float*>(smem + sm.di);
  float* red = reinterpret_cast<float*>(smem + sm.red);
  bf16* scr = reinterpret_cast<bf16*>(smem + sm.scr) + warp * 512;

  auto kv_row = [&](int j) -> long long { return (((long long)b * a.Skv + k0 + j) * a.Kv + kvh) * hd; };
  stage_rows<POL, K_LO>(tk, a.k, a.in_bf16, kv_rows, hd, ld, kv_row);
  stage_rows<POL, K_LO>(tv, a.v, a.in_bf16, kv_rows, hd, ld, kv_row);
  float2 sk = make_float2(1.f, 1.f), sv = sk, sq = sk, sdo = sk, sp = sk, sds = sk;
  if constexpr (Carried<POL>::quant) {
    __syncthreads();
    sk = tile_scales<POL>(tk.f, BT, hd, ld, red);
    sv = tile_scales<POL>(tv.f, BT, hd, ld, red);
  }
  for (int idx = threadIdx.x; idx < BT * hd; idx += BW_NT) {
    dK[(idx / hd) * ldo + idx % hd] = 0.f;
    dV[(idx / hd) * ldo + idx % hd] = 0.f;
  }

  // The q rows whose mask reaches KV rows k0 .. k0+BT-1: key c is seen by
  // rows c .. c+window-1 (causal), so rows k0 .. k0+BT-2+window.
  int r_lo = 0, r_hi = a.Sq;
  if (a.causal) {
    r_lo = min(a.Sq, k0);
    if (a.window > 0) r_hi = min(a.Sq, k0 + BT - 1 + a.window);
  }
  const int i_lo = r_lo / BT, i_hi = (r_hi + BT - 1) / BT;
  for (int g = 0; g < a.G; ++g) {
    const int h = kvh * a.G + g;
    for (int i = i_lo; i < i_hi; ++i) {
      const int q0 = i * BT, rows = min(BT, a.Sq - q0);
      __syncthreads();  // previous step done with Q, dO, P and dS
      auto q_row = [&](int r) -> long long { return (((long long)b * a.Sq + q0 + r) * H + h) * hd; };
      stage_rows<POL, X_LO>(tq, a.q, a.in_bf16, rows, hd, ld, q_row);
      stage_rows<POL, X_LO>(tdo, a.dout, 0, rows, hd, ld, q_row);
      for (int r = threadIdx.x; r < BT; r += BW_NT) {
        const long long o = ((long long)b * H + h) * a.Sq + q0 + r;
        lse[r] = r < rows ? a.lse[o] : 0.f;
        di[r] = r < rows ? a.di[o] : 0.f;
      }
      __syncthreads();
      if constexpr (Carried<POL>::quant) {
        sq = tile_scales<POL>(tq.f, BT, hd, ld, red);
        sdo = tile_scales<POL>(tdo.f, BT, hd, ld, red);
      }
      if (warp < BW_WARPS / 2)
        scores<POL>(S, tq, tk, hd, ld, warp, BW_WARPS / 2, 0, sq, sk, scr);
      else
        scores<POL>(dP, tdo, tv, hd, ld, warp - BW_WARPS / 2, BW_WARPS / 2, BW_WARPS / 2, sdo,
                    sv, scr);
      __syncthreads();
      probs<POL, true>(a, S, dP, lse, di, p_hi, p_lo, p_f, ds_hi, ds_lo, ds_f, q0, k0, warp,
                       lane);
      __syncthreads();
      if constexpr (Carried<POL>::quant) {
        sp = tile_scales<POL>(p_f, BT, BT, ldp, red);
        sds = tile_scales<POL>(ds_f, BT, BT, ldp, red);
      }
      accumulate<POL, true>(dV, p_hi, p_lo, p_f, tdo, hd, ld, warp, sp, sdo, scr);
      accumulate<POL, true>(dK, ds_hi, ds_lo, ds_f, tq, hd, ld, warp, sds, sq, scr);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kv_rows * hd; idx += BW_NT) {
    const int j = idx / hd, d = idx % hd;
    a.dk[kv_row(j) + d] = dK[j * ldo + d];
    a.dv[kv_row(j) + d] = dV[j * ldo + d];
  }
}

template <int POL, bool DKV>
int run_bwd(const BwdArgs& a, dim3 grid, cudaStream_t stream) {
  const BwdSmem sm(a.hd, DKV ? 2 : 1, Carried<POL>::value);
  auto kern = DKV ? bwd_dkv_kernel<POL> : bwd_dq_kernel<POL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sm.total);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, BW_NT, sm.total, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool DKV>
int dispatch_bwd(const BwdArgs& a, int policy, dim3 grid, cudaStream_t stream) {
  switch (policy) {
    case P_REFINE_A: return run_bwd<P_REFINE_A, DKV>(a, grid, stream);
    case P_BF16X3: return run_bwd<P_BF16X3, DKV>(a, grid, stream);
    case P_REFINE_AB: return run_bwd<P_REFINE_AB, DKV>(a, grid, stream);
    case P_F32: return run_bwd<P_F32, DKV>(a, grid, stream);
    case P_BF16X6: return run_bwd<P_BF16X6, DKV>(a, grid, stream);
    case P_FP8: return run_bwd<P_FP8, DKV>(a, grid, stream);
    case P_INT8: return run_bwd<P_INT8, DKV>(a, grid, stream);
    case P_FP8X3: return run_bwd<P_FP8X3, DKV>(a, grid, stream);
    case P_INT8X3: return run_bwd<P_INT8X3, DKV>(a, grid, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rt

// `loop` reports the kernel that ran (rt::Mainloop).
extern "C" int attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* di,
                                       float* dq, int in_bf16, int B, int Sq, int Skv, int Kv,
                                       int G, int hd, int causal, int window, float softcap,
                                       int policy, int* loop, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  rt::BwdArgs a{q, k, v, dout, lse, di, dq, nullptr, nullptr, in_bf16, B, Sq, Skv, Kv, G, hd,
                causal, window, softcap, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (policy == rt::P_BF16) {
    *loop = rt::LOOP_SM90;
    return rt::bsm90::run<false>(a, s);
  }
  *loop = rt::LOOP_WMMA;
  dim3 grid((Sq + rt::BT - 1) / rt::BT, Kv * G, B);
  return rt::dispatch_bwd<false>(a, policy, grid, s);
}

// `part`: on the wgmma kernel, the elements between the per-query-head
// slots of dk and dv (each then (G, B, Skv, Kv, hd)), or 0 to walk the group
// inside each CTA; the WMMA kernels always walk it inside.
extern "C" int attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, const float* di,
                                        float* dk, float* dv, int in_bf16, int B, int Sq, int Skv,
                                        int Kv, int G, int hd, int causal, int window,
                                        float softcap, int policy, long long part, int* loop,
                                        void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  rt::BwdArgs a{q, k, v, dout, lse, di, nullptr, dk, dv, in_bf16, B, Sq, Skv, Kv, G, hd,
                causal, window, softcap, part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (policy == rt::P_BF16) {
    *loop = rt::LOOP_SM90;
    return rt::bsm90::run<true>(a, s);
  }
  if (part != 0) return (int)cudaErrorInvalidValue;
  *loop = rt::LOOP_WMMA;
  dim3 grid((Skv + rt::BT - 1) / rt::BT, Kv, B);
  return rt::dispatch_bwd<true>(a, policy, grid, s);
}
