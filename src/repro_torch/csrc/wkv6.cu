// Chunked RWKV-6 WKV forward with the (K, K) state carried on chip.
// Replaces the TPU kernel kernels/wkv6.py:_wkv6_kernel (pallas_call at
// wkv6.py:109).
//
// Per head, with la / lae the inclusive / exclusive cumulative log decay
// of a chunk of C steps (t, s index steps of the chunk; i, j channels):
//   out[t,j]  = sum_i r[t,i] e^{lae[t,i]} S[i,j]                     (inter)
//             + sum_{s<t} score[t,s] v[s,j]                           (intra)
//             + (sum_i r[t,i] u[i] k[t,i]) v[t,j]                     (bonus)
//   score[t,s] = sum_i r[t,i] e^{min(lae[t,i] - la[s,i], 0)} k[s,i]
//   S'[i,j]   = S[i,j] e^{la[C-1,i]} + sum_s k[s,i] e^{la[C-1,i] - la[s,i]} v[s,j]
//
// The TPU grid walks (B*H, S/C) with the chunk axis sequential and the
// state in VMEM scratch.  Here one block of 256 threads owns one (b, h)
// stream and walks its chunks in order in a loop, the state in shared
// memory the whole time; blocks run in parallel over (b, h).  A chunk's
// r, k, v, la and lae sit in shared memory (rows padded to K + 1 floats,
// so threads that walk s read distinct banks).  The (C, C, K) decay
// tensor that the TPU kernel materializes in VMEM is never formed: each
// score sums its K terms with the exponential computed on the fly, in
// row blocks of at most 64 rows (the last one ragged where 64 does not
// divide C) so that a 128-step chunk fits.  Once a
// row block's scores are done its lae rows become r e^{lae} (the inter
// operand), and once all scores are done k becomes k e^{la[C-1] - la}
// (the state update's operand), both in place.
//
// Arithmetic is f32 on the CUDA cores, as the TPU kernel's dots take f32
// operands: the bound against the exact recurrence is 1e-4, which bf16
// tensor-core passes would not meet.  Every exponent is <= 0, so nothing
// overflows.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <int K>
__global__ void __launch_bounds__(THREADS) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, float* __restrict__ out,
    float* __restrict__ state_out, int S, int H, int C) {
  constexpr int KP = K + 1;
  const int TR = C < 64 ? C : 64;
  extern __shared__ float sm[];
  float* sr = sm;                 // (C, KP) r
  float* sk = sr + C * KP;        // k; then k decayed to the chunk's end
  float* sv = sk + C * KP;        // v
  float* sla = sv + C * KP;       // inclusive cumulative log decay
  float* slae = sla + C * KP;     // log decay first, then exclusive, then r e^{lae}
  float* ssc = slae + C * KP;     // (TR, C) scores of one row block
  float* sS = ssc + TR * C;       // (K, K) state
  float* sbonus = sS + K * K;     // (C,) current-token bonus
  const int bh = blockIdx.x, b = bh / H, h = bh % H, tid = threadIdx.x;
  const float* uh = u + (long long)h * K;
  const long long rs = (long long)H * K;                       // between steps
  const long long base = (long long)b * S * rs + (long long)h * K;
  for (int e = tid; e < K * K; e += THREADS) sS[e] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += C) {
    for (int e = tid; e < C * K; e += THREADS) {
      const int t = e / K, i = e % K;
      const long long g = base + (long long)(c0 + t) * rs + i;
      sr[t * KP + i] = r[g];
      sk[t * KP + i] = k[g];
      sv[t * KP + i] = v[g];
      slae[t * KP + i] = w[g];
    }
    __syncthreads();
    if (tid < K) {
      float acc = 0.0f;
      for (int t = 0; t < C; ++t) {
        const float lw = slae[t * KP + tid];
        acc += lw;
        sla[t * KP + tid] = acc;
        slae[t * KP + tid] = acc - lw;
      }
    }
    for (int t = tid; t < C; t += THREADS) {
      float acc = 0.0f;
#pragma unroll 8
      for (int i = 0; i < K; ++i) acc += sr[t * KP + i] * uh[i] * sk[t * KP + i];
      sbonus[t] = acc;
    }
    __syncthreads();

    for (int t0 = 0; t0 < C; t0 += TR) {
      const int rows = C - t0 < TR ? C - t0 : TR;   // a ragged last block when TR does not divide C
      for (int p = tid; p < rows * C; p += THREADS) {
        const int t = t0 + p / C, s = p % C;
        float acc = 0.0f;
        if (s < t) {
          const float* rt = sr + t * KP;
          const float* et = slae + t * KP;
          const float* ks = sk + s * KP;
          const float* ls = sla + s * KP;
#pragma unroll 8
          for (int i = 0; i < K; ++i) acc += rt[i] * expf(fminf(et[i] - ls[i], 0.0f)) * ks[i];
        }
        ssc[p] = acc;
      }
      __syncthreads();
      for (int e = tid; e < rows * K; e += THREADS) {
        const int t = t0 + e / K, i = e % K;
        slae[t * KP + i] = sr[t * KP + i] * expf(slae[t * KP + i]);
      }
      __syncthreads();
      for (int e = tid; e < rows * K; e += THREADS) {
        const int tl = e / K, j = e % K, t = t0 + tl;
        float inter = 0.0f, intra = 0.0f;
#pragma unroll 8
        for (int i = 0; i < K; ++i) inter += slae[t * KP + i] * sS[i * K + j];
        for (int s = 0; s < t; ++s) intra += ssc[tl * C + s] * sv[s * KP + j];
        out[base + (long long)(c0 + t) * rs + j] = inter + intra + sbonus[t] * sv[t * KP + j];
      }
      __syncthreads();
    }

    for (int e = tid; e < C * K; e += THREADS) {
      const int s = e / K, i = e % K;
      sk[s * KP + i] *= expf(sla[(C - 1) * KP + i] - sla[s * KP + i]);
    }
    __syncthreads();
    for (int e = tid; e < K * K; e += THREADS) {
      const int i = e / K, j = e % K;
      float acc = 0.0f;
      for (int s = 0; s < C; ++s) acc += sk[s * KP + i] * sv[s * KP + j];
      sS[e] = sS[e] * expf(sla[(C - 1) * KP + i]) + acc;
    }
    __syncthreads();
  }
  for (int e = tid; e < K * K; e += THREADS) state_out[(long long)bh * K * K + e] = sS[e];
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           float* out, float* state, int B, int S, int H, int C, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(wkv6_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_kernel<K><<<B * H, THREADS, smem, s>>>(r, k, v, w, u, out, state, S, H, C);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w (log decay): (B, S, H, K) f32 contiguous; u: (H, K); out:
// (B, S, H, K); state: (B, H, K, K).  K in {16, 32, 64}, S a multiple of
// C, `smem` bytes of shared memory (the wrapper sizes and checks it).
extern "C" int wkv6_launch(const float* r, const float* k, const float* v, const float* w,
                           const float* u, float* out, float* state, int B, int S, int H, int K,
                           int C, long long smem, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16: return launch<16>(r, k, v, w, u, out, state, B, S, H, C, (size_t)smem, s);
    case 32: return launch<32>(r, k, v, w, u, out, state, B, S, H, C, (size_t)smem, s);
    case 64: return launch<64>(r, k, v, w, u, out, state, B, S, H, C, (size_t)smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
