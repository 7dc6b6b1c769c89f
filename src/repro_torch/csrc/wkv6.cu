// Chunked RWKV-6 WKV forward as a chunk-parallel scan, its products on the
// tensor cores at 3xTF32.  Replaces the TPU kernel
// kernels/wkv6.py:_wkv6_kernel (pallas_call at wkv6.py:109).
//
// Per head, with la / lae the inclusive / exclusive cumulative log decay
// of a chunk of C steps (t, s index steps of the chunk; i, j channels):
//   out[t,j]  = sum_i r[t,i] e^{lae[t,i]} S_c[i,j]                   (inter)
//             + sum_{s<t} score[t,s] v[s,j]                           (intra)
//             + (sum_i r[t,i] u[i] k[t,i]) v[t,j]                     (bonus)
//   score[t,s] = sum_i r[t,i] e^{lae[t,i] - la[s,i]} k[s,i]
//   S_{c+1}   = diag(e^{la[C-1]}) S_c + (k e^{la[C-1] - la})^T v
//
// The TPU grid walks (B*H, S/C) with the chunk axis sequential and the
// state in VMEM scratch.  On the H100 one CTA walking a stream's chunks
// and computing its outputs as it went left most SMs idle at B = 1 (64
// CTAs at rwkv6-7b's H = 64), spent its time on an exponential inside
// every score's K-sum, and ran every product as f32 FMAs on the CUDA cores.
// Two launches in stream order, no host sync:
//   A+B  wkv6_state_kernel, a CTA of 8 warps per (b, h), walks the chunks
//        in order and does only the state's work: the chunk's decay and its
//        increment U_c = (k e^{la[C-1] - la})^T v, accumulated on the tensor
//        cores straight into the state it carries in registers (U_c never
//        reaches device memory), each chunk's incoming state S_c written to
//        a workspace; the next chunk's inputs load while one is computed.
//   C    wkv6_out_kernel, a CTA per (b, h, c), every chunk at once (704
//        CTAs at rwkv6-7b's layer 0): the chunk's output from S_c.
// The workspace holds B*H*(S/C) states of K^2 floats, written once and
// read once: B*H*(S/C)*K^2*4 bytes each way.
//
// The exponential leaves the O(C^2 K) sum.  C splits a chunk into 16-step
// sub-blocks; for sub-block T at t0, a step t in it and s in an earlier
// sub-block T' ending at e',
//   e^{lae_t - la_s} = e^{lae_t - lae_t0} e^{lae_t0 - la_e'} e^{la_e' - la_s},
// every exponent <= 0 (clamped at 0 as well), so nothing overflows and a
// factor underflows only where the exact term is below f32's range too.
// So T's off-diagonal scores are one product per T',
// (r~ e^{lae_t0 - la_e'}) k^_T'^T with r~ = r e^{lae - lae_t0} (in
// registers) and k^ = k e^{la_e' - la} (shared memory), and the inter read
// is (r~ e^{lae_t0}) S_c.  The diagonal 16 x 16 blocks keep the
// exp-in-the-sum form on the CUDA cores (f32, 136 x K exponentials a block,
// ~35k a 64-step chunk where the sum had 129k), the bonus on their
// diagonal; a lane takes two rows (rp, 15 - rp: 17 entries) over a quarter
// of the channels, so every lane's every step is a useful term.  A chunk
// that 16 does not divide ends in a zero-padded sub-block whose rows past C
// are not stored.  The cumulative decay is kept in log2 units (log2(e) logw
// summed in segments of steps, then the segments' totals added) so that
// each factor is one ex2.
//
// The products (inter, the off-diagonal scores, scores x v, U) run on
// mma.sync m16n8k8 .tf32 with f32 accumulators at 3xTF32: x = big + small,
// big = TF32(x), small = TF32(x - big), both rounded to nearest even
// (cvt.rn.tf32.f32, one F2FP; kernels/wkv6.py tf32_round emulates it on the
// bit pattern); small.big and big.small go to one accumulator, big.big to
// another, and the two are added at the end: the smallest terms first.  One
// TF32 pass misses the 1e-4 bound against the exact recurrence by ~50x
// (kernels/wkv6.py wkv6_scan_plain, passes=1).
//
// What bounds it on the H100: bytes (r, k, v, logw read, out written; the
// design adds the chunk states and reads k, v, logw twice).  At 3xTF32 the
// products take ~0.04 ms of tensor-core time at B = 4, S = 1024, H = 64,
// K = 64 against ~0.1 ms of the function's bytes; what the card spends
// beyond that is in PERF.md (tools/probe_wkv6.py times the parts).
// Shared-memory rows are padded (K + 4 for r, la, k, k^; K + 8 for v and the
// state) so the fragment reads fall on distinct banks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUB = 16;                 // steps of a sub-block
constexpr int WARPS = 4, THREADS = 32 * WARPS;          // the output kernel
constexpr int STATE_WARPS = 8, STATE_THREADS = 32 * STATE_WARPS;  // the state kernel
constexpr int LP = 20;                  // row stride of a warp's 16 x 16 score block
constexpr size_t SMEM_LIMIT = 232448;   // bytes of shared memory a block may use

template <int K>
struct Lay {
  static constexpr int LR = K + 4;      // r, la, k, k^ rows (A fragments, k^ as B^T)
  static constexpr int LV = K + 8;      // v and state rows (B fragments)
};

__host__ __device__ constexpr int padded(int c) { return (c + SUB - 1) / SUB * SUB; }

// One buffer of the state kernel's ring: a chunk's k and v (rows of LV)
// and logw (LR); the kernel keeps two where they fit, one otherwise.
template <int K>
__host__ __device__ constexpr size_t state_buffer(int c) {
  return 4 * (size_t)padded(c) * (2 * Lay<K>::LV + Lay<K>::LR);
}

template <int K>
__host__ __device__ constexpr size_t out_smem(int c) {
  return 4 * ((size_t)padded(c) * (4 * Lay<K>::LR + Lay<K>::LV) + K * Lay<K>::LV + K +
              WARPS * (K + SUB * LP) + THREADS);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows 0..c-1 (K floats each, `rs` apart from src) into rows of `ld` floats
// by 16-byte async copies; rows c..cp-1 zeros (identity steps).
template <int K>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, long long rs,
                                          int c, int cp) {
  constexpr int Q = K / 4;
  for (int e = threadIdx.x; e < cp * Q; e += blockDim.x) {
    const int t = e / Q, q = e % Q;
    float* d = dst + t * ld + 4 * q;
    if (t < c) cp16(d, src + t * rs + 4 * q);
    else *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// 2^x for x <= 0 (a difference of log2-unit decays), x clamped at 0.
__device__ __forceinline__ float ex(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fminf(x, 0.f)));
  return y;
}

// In place over rows 0..cp-1 of `la` (row stride LD): logw -> its inclusive
// cumulative sum in log2 units (log2(e) logw summed), so that every factor
// is one ex2.  Thread (g, i) of the CTA's G = NT / K segments of each
// channel i sums its segment's steps in order, eight loads in flight, then
// adds the totals of the segments before it (`seg`: G x K floats).
template <int LD, int K, int NT>
__device__ __forceinline__ void scan_decay(float* la, int cp, float* seg) {
  constexpr int G = NT / K;
  constexpr float LOG2E = 1.4426950408889634f;
  const int i = threadIdx.x % K, g = threadIdx.x / K;
  const int len = (cp + G - 1) / G, t0 = g * len, t1 = min(cp, t0 + len);
  float acc = 0.f;
  for (int t = t0; t < t1; t += 8) {
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = t + j < t1 ? la[(t + j) * LD + i] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc = fmaf(x[j], LOG2E, acc);
      if (t + j < t1) la[(t + j) * LD + i] = acc;
    }
  }
  seg[g * K + i] = acc;
  __syncthreads();
  float off = 0.f;
  for (int h = 0; h < g; ++h) off += seg[h * K + i];
  for (int t = t0; t < t1; t += 8) {
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = t + j < t1 ? la[(t + j) * LD + i] + off : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (t + j < t1) la[(t + j) * LD + i] = x[j];
  }
}

// dst[t, i] = src[t, i] 2^{min(la[end(t), i] - la[t, i], 0)} over rows 0..cp-1
// (dst may be src), four rows' loads in flight before any store.
template <int K, int NT, typename End>
__device__ __forceinline__ void decay_rows(float* dst, int ld_dst, const float* src, int ld_src,
                                           const float* la, int ld_la, int cp, End end) {
  for (int e0 = threadIdx.x; e0 < cp * K; e0 += 4 * NT) {
    float x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + q * NT, t = e / K, i = e % K;
      x[q] = e < cp * K ? src[t * ld_src + i] * ex(la[end(t) * ld_la + i] - la[t * ld_la + i])
                        : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + q * NT;
      if (e < cp * K) dst[e / K * ld_dst + e % K] = x[q];
    }
  }
}

// TF32 (10 explicit significand bits), nearest even: one F2FP on sm_90.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ FragA split_a(float x0, float x1, float x2, float x3) {
  FragA f;
  const float x[4] = {x0, x1, x2, x3};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f.big[q] = tf32(x[q]);
    f.small[q] = tf32(x[q] - __uint_as_float(f.big[q]));
  }
  return f;
}

__device__ __forceinline__ FragB split_b(float x0, float x1) {
  FragB f;
  f.big[0] = tf32(x0);
  f.big[1] = tf32(x1);
  f.small[0] = tf32(x0 - __uint_as_float(f.big[0]));
  f.small[1] = tf32(x1 - __uint_as_float(f.big[1]));
  return f;
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 3xTF32 step: small.big and big.small into `small`, then big.big into `main`.
__device__ __forceinline__ void mma3(float* small, float* main, const FragA& a, const FragB& b) {
  mma_tf32(small, a.small, b.big);
  mma_tf32(small, a.big, b.small);
  mma_tf32(main, a.big, b.big);
}

// --------------------------------------------------------------- A + B

// The chunk states of one (b, h): a CTA walks its chunks in order, chunk
// c + 1's k, v and logw loading (cp.async, when two buffers fit) while
// chunk c is computed.  For chunk c: the cumulative decay (scan_decay),
// k^ = k e^{la[C-1] - la} in place and d = e^{la[C-1]}; warp w < K/16 holds
// rows 16w..16w+15, columns 0..K/2-1 of the state in its accumulators
// (small and main, 3xTF32),
// stores S_c = small + main, scales both by d and adds k^_rows^T v (warp w
// + K/16 takes the same rows' other K/2 columns): U_c never reaches device
// memory.  ws: (B*H, NC, K, K), every chunk's
// incoming state; state: (B*H, K, K), the final one.
template <int K>
__global__ void __launch_bounds__(STATE_THREADS) wkv6_state_kernel(
    const float* __restrict__ k, const float* __restrict__ v, const float* __restrict__ w,
    float* __restrict__ ws, float* __restrict__ state, int S, int H, int C, int nbuf) {
  constexpr int LR = Lay<K>::LR, LV = Lay<K>::LV;
  const int cp = padded(C), h = blockIdx.x, b = blockIdx.y, nc = S / C;
  const int buf_floats = cp * (2 * LV + LR);  // k (LV), v (LV), logw (LR)
  extern __shared__ __align__(16) float sm[];
  float* seg = sm + nbuf * buf_floats;        // (STATE_THREADS) the scan's segment sums
  float* sd = seg + STATE_THREADS;            // (K) the chunk's decay
  const long long rs = (long long)H * K, bh = (long long)b * H + h;
  auto load = [&](int c, float* buf) {
    const long long base = ((long long)b * S + (long long)c * C) * rs + (long long)h * K;
    load_rows<K>(buf, LV, k + base, rs, C, cp);
    load_rows<K>(buf + cp * LV, LV, v + base, rs, C, cp);
    load_rows<K>(buf + 2 * cp * LV, LR, w + base, rs, C, cp);
    cp_commit();
  };
  constexpr int NH = K / 16;                  // n-tiles of 8 in half a state row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane >> 2, tig = lane & 3;
  const bool owns = warp < 2 * (K / 16);      // K / 16 row tiles x 2 column halves
  const int i0 = 16 * (warp % (K / 16)) + gid, n0 = (warp / (K / 16)) * NH;  // rows i0, i0 + 8
  float small[NH][4] = {}, main[NH][4] = {};
  if (nc) load(0, sm);
  for (int c = 0; c < nc; ++c) {
    float* sk = sm + (c % nbuf) * buf_floats;
    const float* sv = sk + cp * LV;
    float* sla = sk + 2 * cp * LV;
    if (nbuf == 2 && c + 1 < nc) {
      load(c + 1, sm + ((c + 1) % 2) * buf_floats);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    scan_decay<LR, K, STATE_THREADS>(sla, cp, seg);
    __syncthreads();
    const float* la_end = sla + (C - 1) * LR;
    decay_rows<K, STATE_THREADS>(sk, LV, sk, LV, sla, LR, cp, [C](int) { return C - 1; });
    for (int i = threadIdx.x; i < K; i += STATE_THREADS) sd[i] = ex(la_end[i]);
    __syncthreads();
    if (owns) {
      float* o = ws + ((bh * nc + c) * K + i0) * K;
      const float d0 = sd[i0], d8 = sd[i0 + 8];
#pragma unroll
      for (int nt = 0; nt < NH; ++nt) {
        const int j = 8 * (n0 + nt) + 2 * tig;
        *reinterpret_cast<float2*>(o + j) =
            make_float2(small[nt][0] + main[nt][0], small[nt][1] + main[nt][1]);
        *reinterpret_cast<float2*>(o + 8 * K + j) =
            make_float2(small[nt][2] + main[nt][2], small[nt][3] + main[nt][3]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          small[nt][q] *= q < 2 ? d0 : d8;
          main[nt][q] *= q < 2 ? d0 : d8;
        }
      }
      // + k^^T v over the chunk's steps: A = k^^T (rows i0, i0 + 8), B = v
      for (int s0 = 0; s0 < cp; s0 += 8) {
        const float* k0 = sk + (s0 + tig) * LV;
        const float* k4 = k0 + 4 * LV;
        const FragA a = split_a(k0[i0], k0[i0 + 8], k4[i0], k4[i0 + 8]);
        const float* v0 = sv + (s0 + tig) * LV + 8 * n0 + gid;
        const float* v4 = v0 + 4 * LV;
#pragma unroll
        for (int nt = 0; nt < NH; ++nt)
          mma3(small[nt], main[nt], a, split_b(v0[8 * nt], v4[8 * nt]));
      }
    }
    __syncthreads();
    if (nbuf == 1 && c + 1 < nc) load(c + 1, sm);
  }
  if (owns) {
    float* o = state + (bh * K + i0) * K;
#pragma unroll
    for (int nt = 0; nt < NH; ++nt) {
      const int j = 8 * (n0 + nt) + 2 * tig;
      *reinterpret_cast<float2*>(o + j) =
          make_float2(small[nt][0] + main[nt][0], small[nt][1] + main[nt][1]);
      *reinterpret_cast<float2*>(o + 8 * K + j) =
          make_float2(small[nt][2] + main[nt][2], small[nt][3] + main[nt][3]);
    }
  }
}

// ------------------------------------------------------------------- C

// acc += P (16 x 16 in sp, row stride LP) . v (16 rows from vb), 3xTF32.
template <int K>
__device__ __forceinline__ void scores_v(float (&small)[K / 8][4], float (&main)[K / 8][4],
                                         const float* sp, const float* vb, int gid, int tig) {
  using L = Lay<K>;
#pragma unroll
  for (int ks = 0; ks < SUB; ks += 8) {
    const FragA a = split_a(sp[gid * LP + ks + tig], sp[(gid + 8) * LP + ks + tig],
                            sp[gid * LP + ks + tig + 4], sp[(gid + 8) * LP + ks + tig + 4]);
    const float* v0 = vb + (ks + tig) * L::LV;
    const float* v4 = v0 + 4 * L::LV;
#pragma unroll
    for (int nt = 0; nt < K / 8; ++nt)
      mma3(small[nt], main[nt], a, split_b(v0[8 * nt + gid], v4[8 * nt + gid]));
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS) wkv6_out_kernel(
    const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ ws,
    float* __restrict__ out, int S, int H, int C) {
  using L = Lay<K>;
  constexpr int LR = L::LR, LV = L::LV;
  const int cp = padded(C), c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  extern __shared__ __align__(16) float sm[];
  float* sr = sm;                        // (cp, LR) r
  float* sla = sr + cp * LR;             // (cp, LR) logw, then its cumulative sum
  float* sk = sla + cp * LR;             // (cp, LR) k
  float* skh = sk + cp * LR;             // (cp, LR) k^ = k e^{la[end of its sub-block] - la}
  float* sv = skh + cp * LR;             // (cp, LV) v
  float* ss = sv + cp * LV;              // (K, LV) the incoming state S_c
  float* su = ss + K * LV;               // (K) u
  float* seg = su + K;                   // (THREADS) the scan's segment sums
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane >> 2, tig = lane & 3;
  float* sd = seg + THREADS + warp * (K + SUB * LP);  // this warp's decay row (K)
  float* sp = sd + K;                          // and its 16 x 16 score block
  const long long rs = (long long)H * K;
  const long long base = ((long long)b * S + (long long)c * C) * rs + (long long)h * K;
  const long long bhc = ((long long)b * H + h) * gridDim.x + c;
  // v, read last, loads while the decays are summed
  load_rows<K>(sr, LR, r + base, rs, C, cp);
  load_rows<K>(sla, LR, w + base, rs, C, cp);
  load_rows<K>(sk, LR, k + base, rs, C, cp);
  load_rows<K>(ss, LV, ws + bhc * K * K, K, K, K);
  for (int q = threadIdx.x; q < K / 4; q += THREADS) cp16(su + 4 * q, u + (long long)h * K + 4 * q);
  cp_commit();
  load_rows<K>(sv, LV, v + base, rs, C, cp);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  scan_decay<LR, K, THREADS>(sla, cp, seg);
  __syncthreads();
  decay_rows<K, THREADS>(skh, LR, sk, LR, sla, LR, cp,
                         [](int t) { return t / SUB * SUB + SUB - 1; });
  cp_wait<0>();
  __syncthreads();

  for (int T = warp; T < cp / SUB; T += WARPS) {
    const int t0 = T * SUB, ra = t0 + gid, rb = ra + 8;
    const float* bnd = t0 ? sla + (t0 - 1) * LR : nullptr;    // lae[t0]; 0 at t0 = 0
    // r~ = r e^{lae - lae[t0]} of this thread's A fragment elements
    float rt[K / 8][4];
#pragma unroll
    for (int ks = 0; ks < K / 8; ++ks) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = (q & 1) ? rb : ra, i = 8 * ks + tig + ((q & 2) ? 4 : 0);
        const float lae = t ? sla[(t - 1) * LR + i] : 0.f;
        rt[ks][q] = sr[t * LR + i] * ex(lae - (bnd ? bnd[i] : 0.f));
      }
    }
    float small[K / 8][4] = {}, main[K / 8][4] = {};
    // inter: (r~ e^{lae[t0]}) S_c
    __syncwarp();
    for (int i = lane; i < K; i += 32) sd[i] = ex(bnd ? bnd[i] : 0.f);
    __syncwarp();
#pragma unroll
    for (int ks = 0; ks < K / 8; ++ks) {
      const float d0 = sd[8 * ks + tig], d4 = sd[8 * ks + tig + 4];
      const FragA a = split_a(rt[ks][0] * d0, rt[ks][1] * d0, rt[ks][2] * d4, rt[ks][3] * d4);
      const float* s0 = ss + (8 * ks + tig) * LV;
      const float* s4 = s0 + 4 * LV;
#pragma unroll
      for (int nt = 0; nt < K / 8; ++nt)
        mma3(small[nt], main[nt], a, split_b(s0[8 * nt + gid], s4[8 * nt + gid]));
    }
    // each earlier sub-block T2: its scores ((r~ e^{lae[t0] - la[e2]}) k^_T2^T), then . v_T2
    for (int T2 = 0; T2 < T; ++T2) {
      const int s0 = T2 * SUB, e2 = s0 + SUB - 1;
      __syncwarp();
      for (int i = lane; i < K; i += 32) sd[i] = ex(bnd[i] - sla[e2 * LR + i]);
      __syncwarp();
      float ps[2][4] = {}, pm[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < K / 8; ++ks) {
        const float d0 = sd[8 * ks + tig], d4 = sd[8 * ks + tig + 4];
        const FragA a = split_a(rt[ks][0] * d0, rt[ks][1] * d0, rt[ks][2] * d4, rt[ks][3] * d4);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* kr = skh + (s0 + 8 * j + gid) * LR + 8 * ks + tig;
          mma3(ps[j], pm[j], a, split_b(kr[0], kr[4]));
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * j + 2 * tig;
        *reinterpret_cast<float2*>(sp + gid * LP + col) =
            make_float2(ps[j][0] + pm[j][0], ps[j][1] + pm[j][1]);
        *reinterpret_cast<float2*>(sp + (gid + 8) * LP + col) =
            make_float2(ps[j][2] + pm[j][2], ps[j][3] + pm[j][3]);
      }
      __syncwarp();
      scores_v<K>(small, main, sp, sv + s0 * LV, gid, tig);
    }
    // the diagonal block in f32: scores[t, s] for t0 <= s < t, the bonus at
    // s = t.  Lane (q, rp) takes rows rp and 15 - rp, 17 entries between
    // them, over channels q, q + 4, ...: slot j < 8 is row rp at s = j while
    // j <= rp, else row 15 - rp at s = 8 + j - rp (its last column is its
    // bonus); slots 8..16 are row 15 - rp at s = 0..8.  Every slot is one
    // term a channel, a row's r and decay load once a channel; the quarters'
    // sums meet by shuffles.
    __syncwarp();
    for (int e = lane; e < SUB * SUB; e += 32) sp[e / SUB * LP + e % SUB] = 0.f;
    {
      const int q = lane >> 3, rp = lane & 7, ta = t0 + rp, tb = t0 + SUB - 1 - rp;
      float acc[SUB + 1];
#pragma unroll
      for (int j = 0; j <= SUB; ++j) acc[j] = 0.f;
      for (int i = q; i < K; i += 4) {
        const float ra = sr[ta * LR + i], rb = sr[tb * LR + i], ui = su[i];
        const float ea = ta ? sla[(ta - 1) * LR + i] : 0.f, eb = sla[(tb - 1) * LR + i];
#pragma unroll
        for (int j = 0; j <= SUB; ++j) {
          const bool on_a = j < 8 && j <= rp;
          const int sl = j < 8 ? (on_a ? j : 8 + j - rp) : j - 8;
          const bool bonus = on_a ? sl == rp : sl == SUB - 1 - rp;
          const int ts = (t0 + sl) * LR + i;
          const float f = bonus ? ui : ex((on_a ? ea : eb) - sla[ts]);
          acc[j] = fmaf((on_a ? ra : rb) * f, sk[ts], acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j <= SUB; ++j) {
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 8);
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 16);
      }
      __syncwarp();
      if (q == 0) {
#pragma unroll
        for (int j = 0; j <= SUB; ++j) {
          const bool on_a = j < 8 && j <= rp;
          const int sl = j < 8 ? (on_a ? j : 8 + j - rp) : j - 8, tl = on_a ? rp : SUB - 1 - rp;
          sp[tl * LP + sl] = t0 + tl < C ? acc[j] : 0.f;
        }
      }
    }
    __syncwarp();
    scores_v<K>(small, main, sp, sv + t0 * LV, gid, tig);
    // out, rows past C not stored
#pragma unroll
    for (int nt = 0; nt < K / 8; ++nt) {
      const int j = 8 * nt + 2 * tig;
      if (ra < C)
        *reinterpret_cast<float2*>(out + base + ra * rs + j) =
            make_float2(small[nt][0] + main[nt][0], small[nt][1] + main[nt][1]);
      if (rb < C)
        *reinterpret_cast<float2*>(out + base + rb * rs + j) =
            make_float2(small[nt][2] + main[nt][2], small[nt][3] + main[nt][3]);
    }
  }
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           float* out, float* state, float* ws, int B, int S, int H, int C, size_t smem,
           cudaStream_t s) {
  const int nc = S / C;
  const size_t buf = state_buffer<K>(C), extra = 4 * (STATE_THREADS + K), sc = out_smem<K>(C);
  const int nbuf = 2 * buf + extra <= SMEM_LIMIT ? 2 : 1;
  const size_t sa = nbuf * buf + extra;
  if (sc != smem) return (int)cudaErrorInvalidValue;  // the wrapper's wkv6_smem_bytes
  cudaError_t err = cudaFuncSetAttribute(wkv6_state_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (err != cudaSuccess) return (int)err;
  wkv6_state_kernel<K><<<dim3(H, B), STATE_THREADS, sa, s>>>(k, v, w, ws, state, S, H, C,
                                                               nbuf);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (nc) {
    err = cudaFuncSetAttribute(wkv6_out_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sc);
    if (err != cudaSuccess) return (int)err;
    wkv6_out_kernel<K><<<dim3(nc, H, B), THREADS, sc, s>>>(r, k, v, w, u, ws, out, S, H, C);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w (log decay): (B, S, H, K) f32 contiguous, 16-byte aligned; u:
// (H, K); out: (B, S, H, K); state: (B, H, K, K); ws: (B, H, S/C, K, K) f32
// scratch (the chunk states).  K in {16, 32, 64}, S a multiple of C, `smem`
// the output kernel's shared memory (the wrapper's wkv6_smem_bytes, checked
// against it here).  Two launches on `stream`; returns a cudaError_t.
extern "C" int wkv6_launch(const float* r, const float* k, const float* v, const float* w,
                           const float* u, float* out, float* state, float* ws, int B, int S,
                           int H, int K, int C, long long smem, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16: return launch<16>(r, k, v, w, u, out, state, ws, B, S, H, C, (size_t)smem, s);
    case 32: return launch<32>(r, k, v, w, u, out, state, ws, B, S, H, C, (size_t)smem, s);
    case 64: return launch<64>(r, k, v, w, u, out, state, ws, B, S, H, C, (size_t)smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
