// Batched small GEMMs (G, n, n) x (G, n, n) -> (G, n, n): bf16 operands,
// f32 accumulators and output.  The paper's Fig. 7 workload.
//
// batched_packed_kernel replaces kernels/batched_gemm.py:_packed_kernel
// (pallas_call at batched_gemm.py:84).  The TPU kernel packs pack =
// tile / n matrices block-diagonally into one (tile x tile) operand pair
// so that one MXU pass computes all of them.  Here one CTA takes the same
// group of `pack` matrices, stages the group's operands once in shared
// memory (rounded to bf16 on the way in) and runs tensor-core MMAs on the
// diagonal blocks only: the same function, without multiplying the zero
// blocks.  For n < 16 two (n = 8) matrices share one 16 x 16 fragment
// block-diagonally, which is exact because the off-diagonal blocks are
// zero.  Four warps share the group's output fragments.
//
// batched_naive_kernel replaces kernels/batched_gemm.py:_naive_kernel
// (pallas_call at batched_gemm.py:120): one warp per matrix, the paper's
// Fig. 7 mapping.  It reads its operands straight from global memory into
// mma.sync m16n8k16 fragments, element by element with the ragged edge
// zero-filled, so it takes any n; no shared memory.
#include "common.cuh"

namespace {

using namespace nvcuda;
using rt::bf16;

// Two f32 values as one register of two bf16 (the first in the low half).
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

template <int N>
__global__ void __launch_bounds__(128) batched_packed_kernel(const void* a, int a_bf16,
                                                             const void* b, int b_bf16,
                                                             float* c, int pack) {
  constexpr int NF = N < 16 ? 16 : N;             // the side of a fragment-tiled block
  constexpr int PER_FRAG = N < 16 ? 16 / N : 1;   // matrices sharing one fragment
  extern __shared__ __align__(128) unsigned char smem[];
  const int blocks = pack / PER_FRAG;             // block-diagonal (NF x NF) blocks
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = sa + blocks * NF * NF;
  float* stage = reinterpret_cast<float*>(sb + blocks * NF * NF);  // n < 16: 4 x 256 f32
  const int elems = pack * N * N;
  const long long base = (long long)blockIdx.x * elems;
  if (N < 16) {
    for (int e = threadIdx.x; e < blocks * NF * NF; e += blockDim.x)
      sa[e] = sb[e] = __float2bfloat16_rn(0.0f);
    __syncthreads();
  }
  // the group's operands, 8 consecutive elements (one row when n = 8) a step
  for (int e = threadIdx.x * 8; e < elems; e += blockDim.x * 8) {
    float xa[8], xb[8];
    rt::load8(a, base + e, a_bf16, xa);
    rt::load8(b, base + e, b_bf16, xb);
    int dst = e;
    if (N < 16) {
      const int mat = e / (N * N), r = (e % (N * N)) / N, col = e % N;
      const int blk = mat / PER_FRAG, off = (mat % PER_FRAG) * N;
      dst = blk * NF * NF + (r + off) * NF + col + off;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sa[dst + j] = __float2bfloat16_rn(xa[j]);
      sb[dst + j] = __float2bfloat16_rn(xb[j]);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int T = NF / 16;                     // fragments along a block's side
  const int tiles = blocks * T * T;
  for (int t = warp; t < tiles; t += blockDim.x / 32) {
    const int blk = t / (T * T), ti = (t % (T * T)) / T, tj = t % T;
    const bf16* ba = sa + blk * NF * NF;
    const bf16* bb = sb + blk * NF * NF;
    rt::FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < T; ++kk) {
      rt::FragA<> fa;
      rt::FragB<wmma::row_major> fb;
      wmma::load_matrix_sync(fa, ba + ti * 16 * NF + kk * 16, NF);
      wmma::load_matrix_sync(fb, bb + kk * 16 * NF + tj * 16, NF);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    if (N >= 16) {
      wmma::store_matrix_sync(c + base + (long long)blk * N * N + ti * 16 * N + tj * 16, acc, N,
                              wmma::mem_row_major);
    } else {
      // keep the diagonal (N x N) blocks of the 16 x 16 product
      float* st = stage + warp * 256;
      wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < PER_FRAG * N * N; e += 32) {
        const int m = e / (N * N), r = (e % (N * N)) / N, col = e % N;
        c[base + (long long)(blk * PER_FRAG + m) * N * N + r * N + col] =
            st[(r + m * N) * 16 + col + m * N];
      }
      __syncwarp();
    }
  }
}

__device__ __forceinline__ float at(const void* p, long long base, int r, int col, int n,
                                    int is_bf16) {
  return (r < n && col < n) ? rt::load_elem(p, base + (long long)r * n + col, is_bf16) : 0.0f;
}

__global__ void __launch_bounds__(128) batched_naive_kernel(const void* a, int a_bf16,
                                                            const void* b, int b_bf16, float* c,
                                                            int g, int n) {
  const int mat = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (mat >= g) return;
  const int lane = threadIdx.x % 32, gid = lane >> 2, tig = lane & 3;
  const long long base = (long long)mat * n * n;
  for (int i0 = 0; i0 < n; i0 += 16) {
    for (int j0 = 0; j0 < n; j0 += 8) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k0 = 0; k0 < n; k0 += 16) {
        const int ka = k0 + tig * 2, ra = i0 + gid, cb = j0 + gid;
        const unsigned a0 = pack_bf16x2(at(a, base, ra, ka, n, a_bf16), at(a, base, ra, ka + 1, n, a_bf16));
        const unsigned a1 = pack_bf16x2(at(a, base, ra + 8, ka, n, a_bf16), at(a, base, ra + 8, ka + 1, n, a_bf16));
        const unsigned a2 = pack_bf16x2(at(a, base, ra, ka + 8, n, a_bf16), at(a, base, ra, ka + 9, n, a_bf16));
        const unsigned a3 = pack_bf16x2(at(a, base, ra + 8, ka + 8, n, a_bf16), at(a, base, ra + 8, ka + 9, n, a_bf16));
        const unsigned b0 = pack_bf16x2(at(b, base, ka, cb, n, b_bf16), at(b, base, ka + 1, cb, n, b_bf16));
        const unsigned b1 = pack_bf16x2(at(b, base, ka + 8, cb, n, b_bf16), at(b, base, ka + 9, cb, n, b_bf16));
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
      const int r = i0 + gid, col = j0 + tig * 2;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = r + (q >= 2 ? 8 : 0), cc = col + (q & 1);
        if (rr < n && cc < n) c[base + (long long)rr * n + cc] = d[q];
      }
    }
  }
}

template <int N>
int launch_packed(const void* a, int a_bf16, const void* b, int b_bf16, float* c, int g,
                  int pack, cudaStream_t s) {
  constexpr int NF = N < 16 ? 16 : N;
  const int blocks = N < 16 ? pack / (16 / N) : pack;
  const size_t smem = 2 * (size_t)blocks * NF * NF * sizeof(bf16) + (N < 16 ? 4 * 256 * 4 : 0);
  cudaError_t err = cudaFuncSetAttribute(batched_packed_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  batched_packed_kernel<N><<<g / pack, 128, smem, s>>>(a, a_bf16, b, b_bf16, c, pack);
  return (int)cudaGetLastError();
}

}  // namespace

// n in {8, 16, 32, 64}, pack * n the packing tile, g a multiple of pack
// (the wrapper checks); returns a cudaError_t.
extern "C" int batched_gemm_launch(const void* a, int a_bf16, const void* b, int b_bf16,
                                   float* c, int g, int n, int pack, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8: return launch_packed<8>(a, a_bf16, b, b_bf16, c, g, pack, s);
    case 16: return launch_packed<16>(a, a_bf16, b, b_bf16, c, g, pack, s);
    case 32: return launch_packed<32>(a, a_bf16, b, b_bf16, c, g, pack, s);
    case 64: return launch_packed<64>(a, a_bf16, b, b_bf16, c, g, pack, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int batched_gemm_naive_launch(const void* a, int a_bf16, const void* b, int b_bf16,
                                         float* c, int g, int n, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  batched_naive_kernel<<<(g + 3) / 4, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      a, a_bf16, b, b_bf16, c, g, n);
  return (int)cudaGetLastError();
}
