// Batched small GEMMs (G, n, n) x (G, n, n) -> (G, n, n): bf16 operands,
// f32 accumulators and output.  The paper's Fig. 7 workload.
//
// batched_stream_kernel replaces kernels/batched_gemm.py:_packed_kernel
// (pallas_call at batched_gemm.py:84).  The TPU kernel packs pack =
// tile / n matrices block-diagonally into one (tile x tile) operand pair
// so that one MXU pass computes all of them.  Each product does n/4 FLOP a
// byte (16 at n = 64) against the ~295 the H100's tensor cores need, so
// what bounds it here is the byte stream: each operand read once, the f32
// output written once.  The design is a stream:
//   - Persistent CTAs (the host's schedule, kernels/batched_gemm.py
//     packed_schedule: two an SM for bf16 operands, one otherwise) walk
//     chunks of CHUNK = 8192 consecutive elements of A and of B (16 KB an
//     operand in bf16, 32 KB in f32; whole matrices, 8192 / n^2 of them,
//     since n^2 divides 8192) with a grid stride.
//   - One producer thread fills a ring of 2-4 stages by TMA and completes
//     them on mbarriers (the helpers of gemm_sm90.cuh).  A group's
//     operands are contiguous, so each operand is a 2-D map of 128-byte
//     lines with a 128B swizzle (16-byte chunk c of line L at c ^ (L % 8)):
//     the fragment reads of every n and element size then fall on distinct
//     banks (ldmatrix at bf16; two-float and scalar reads at f32, where B's
//     scalar column reads can still meet two ways).  The last chunk's box
//     runs past the operand and TMA fills it with zeros.
//   - Eight consumer warps run mma.sync m16n8k16 bf16 with f32
//     accumulators on the diagonal blocks only: a warp takes 16-row tiles
//     of the chunk's matrices (n >= 16) or pairs of matrices (n = 8: two
//     8 x 8 matrices share one 16 x 16 fragment block-diagonally, which is
//     exact because the off-diagonal blocks are zero).  f32 operands are
//     rounded to bf16 (RNE, torch's .to(torch.bfloat16)) in the fragment
//     load.
//   - The f32 output goes to a swizzled 32 KB buffer in shared memory and
//     leaves by one TMA store (clipped at the output's end) while the next
//     stage's loads are in flight; the buffer is rewritten only once that
//     store has read it (cp.async.bulk.wait_group.read).
//
// batched_naive_kernel replaces kernels/batched_gemm.py:_naive_kernel
// (pallas_call at batched_gemm.py:120): one warp per matrix, the paper's
// Fig. 7 mapping.  It reads its operands straight from global memory into
// mma.sync m16n8k16 fragments, element by element with the ragged edge
// zero-filled, so it takes any n; no shared memory.
#include "gemm_common.cuh"

namespace {

namespace sm = rt::sm90;

// Two f32 values as one register of two bf16 (the first in the low half).
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// The stream's sizes (kernels/batched_gemm.py mirrors CHUNK and the ring).
constexpr int CHUNK = 8192;                 // elements of A (and of B) a stage holds
constexpr int LINE = 128;                   // bytes of one swizzled line
constexpr int OUT_BYTES = CHUNK * 4;        // a chunk's f32 output
constexpr int CONSUMERS = 8;                // consumer warps
constexpr int STREAM_NT = 32 * (CONSUMERS + 1);
constexpr int MAX_STAGES = 4;

// Byte offset o of a chunk buffer (1024-byte aligned) in TMA's 128B swizzle.
__device__ __forceinline__ uint32_t swz(uint32_t o) { return o ^ (((o >> 7) & 7) << 4); }

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* d, unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Element (row, col) of matrix m of an n x n chunk buffer: its byte offset
// before the swizzle.
template <int N, int E>
__device__ __forceinline__ uint32_t at_off(int m, int row, int col) {
  return static_cast<uint32_t>(((m * N + row) * N + col) * E);
}

// Two consecutive f32 of a swizzled buffer (col even) as one bf16 pair.
template <int N>
__device__ __forceinline__ unsigned f32_pair(const unsigned char* t, int m, int row, int col) {
  const float2 x = *reinterpret_cast<const float2*>(t + swz(at_off<N, 4>(m, row, col)));
  return pack_bf16x2(x.x, x.y);
}

// (k, k + 1) of one column of an f32 buffer as one bf16 pair.
template <int N>
__device__ __forceinline__ unsigned f32_col_pair(const unsigned char* t, int m, int k, int col) {
  const float lo = *reinterpret_cast<const float*>(t + swz(at_off<N, 4>(m, k, col)));
  const float hi = *reinterpret_cast<const float*>(t + swz(at_off<N, 4>(m, k + 1, col)));
  return pack_bf16x2(lo, hi);
}

// The A fragment (rows r0..r0+15, k0..k0+15) of matrix m, n >= 16.
template <int N, bool A16>
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const unsigned char* t, int m, int r0,
                                       int k0, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  if constexpr (A16) {
    ldsm_x4(a, sm::smem_u32(t) + swz(at_off<N, 2>(m, r0 + (lane & 15), k0 + (lane >> 4) * 8)));
  } else {
    a[0] = f32_pair<N>(t, m, r0 + gid, k0 + 2 * tig);
    a[1] = f32_pair<N>(t, m, r0 + gid + 8, k0 + 2 * tig);
    a[2] = f32_pair<N>(t, m, r0 + gid, k0 + 8 + 2 * tig);
    a[3] = f32_pair<N>(t, m, r0 + gid + 8, k0 + 8 + 2 * tig);
  }
}

// The B fragments (k0..k0+15) of the two 8-column tiles at n0 and n0 + 8 of
// matrix m, n >= 16: b[0], b[1] the first tile's, b[2], b[3] the second's.
template <int N, bool B16>
__device__ __forceinline__ void frag_b(unsigned (&b)[4], const unsigned char* t, int m, int k0,
                                       int n0, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  if constexpr (B16) {
    const int k = k0 + (lane & 7) + ((lane >> 3) & 1) * 8, col = n0 + (lane >> 4) * 8;
    ldsm_x4_t(b, sm::smem_u32(t) + swz(at_off<N, 2>(m, k, col)));
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      b[2 * j] = f32_col_pair<N>(t, m, k0 + 2 * tig, n0 + 8 * j + gid);
      b[2 * j + 1] = f32_col_pair<N>(t, m, k0 + 8 + 2 * tig, n0 + 8 * j + gid);
    }
  }
}

// A consumer warp's share of one chunk into acc (32 floats a thread: the
// chunk's 8192 outputs over 256 threads).  n >= 16: 16-row tiles u = cw,
// cw + 8, ... of the chunk's matrices; n = 8: pairs of matrices.
template <int N, bool A16, bool B16>
__device__ __forceinline__ void chunk_mma(float (&acc)[32], const unsigned char* sa,
                                          const unsigned char* sb, int cw, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  if constexpr (N >= 16) {
    constexpr int RT = N / 16, UPW = CHUNK / (N * N) * RT / CONSUMERS;  // units a warp
#pragma unroll
    for (int j = 0; j < UPW; ++j) {
      const int u = cw + CONSUMERS * j, m = u / RT, r0 = (u % RT) * 16;
      float* d = acc + j * (N / 2);  // N / 8 tiles of 8 columns, 4 floats each
#pragma unroll
      for (int e = 0; e < N / 2; ++e) d[e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 16) {
        unsigned a[4];
        frag_a<N, A16>(a, sa, m, r0, k0, lane);
#pragma unroll
        for (int n0 = 0; n0 < N; n0 += 16) {
          unsigned b[4];
          frag_b<N, B16>(b, sb, m, k0, n0, lane);
          mma_bf16(d + n0 / 2, a[0], a[1], a[2], a[3], b[0], b[1]);
          mma_bf16(d + n0 / 2 + 4, a[0], a[1], a[2], a[3], b[2], b[3]);
        }
      }
    }
  } else {
    // two 8 x 8 matrices 2p, 2p + 1 as the diagonal blocks of one 16 x 16
    // fragment: a = (A_2p, 0; 0, A_2p+1); tile 0 of B = (B_2p; 0) gives
    // rows 0-7 = A_2p B_2p, tile 1 = (0; B_2p+1) rows 8-15 = A_2p+1 B_2p+1
#pragma unroll
    for (int j = 0; j < CHUNK / 64 / 2 / CONSUMERS; ++j) {
      const int p = cw + CONSUMERS * j;
      unsigned a[2], b[2];
      if constexpr (A16) {
        ldsm_x2(a, sm::smem_u32(sa) + swz(at_off<8, 2>(2 * p + ((lane >> 3) & 1), lane & 7, 0)));
      } else {
        a[0] = f32_pair<8>(sa, 2 * p, gid, 2 * tig);
        a[1] = f32_pair<8>(sa, 2 * p + 1, gid, 2 * tig);
      }
      if constexpr (B16) {
        ldsm_x2_t(b, sm::smem_u32(sb) + swz(at_off<8, 2>(2 * p + ((lane >> 3) & 1), lane & 7, 0)));
      } else {
        b[0] = f32_col_pair<8>(sb, 2 * p, 2 * tig, gid);
        b[1] = f32_col_pair<8>(sb, 2 * p + 1, 2 * tig, gid);
      }
      float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(d0, a[0], 0u, 0u, a[1], b[0], 0u);
      mma_bf16(d1, a[0], 0u, 0u, a[1], 0u, b[1]);
      acc[4 * j] = d0[0];
      acc[4 * j + 1] = d0[1];
      acc[4 * j + 2] = d1[2];
      acc[4 * j + 3] = d1[3];
    }
  }
}

// acc (as chunk_mma left it) into the swizzled f32 output buffer.
template <int N>
__device__ __forceinline__ void chunk_store(const float (&acc)[32], unsigned char* out, int cw,
                                            int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  if constexpr (N >= 16) {
    constexpr int RT = N / 16, UPW = CHUNK / (N * N) * RT / CONSUMERS;
#pragma unroll
    for (int j = 0; j < UPW; ++j) {
      const int u = cw + CONSUMERS * j, m = u / RT, r0 = (u % RT) * 16;
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        const float* d = acc + j * (N / 2) + nt * 4;
        const int col = nt * 8 + 2 * tig;
        *reinterpret_cast<float2*>(out + swz(at_off<N, 4>(m, r0 + gid, col))) =
            make_float2(d[0], d[1]);
        *reinterpret_cast<float2*>(out + swz(at_off<N, 4>(m, r0 + gid + 8, col))) =
            make_float2(d[2], d[3]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < CHUNK / 64 / 2 / CONSUMERS; ++j) {
      const int p = cw + CONSUMERS * j;
      *reinterpret_cast<float2*>(out + swz(at_off<8, 4>(2 * p, gid, 2 * tig))) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(out + swz(at_off<8, 4>(2 * p + 1, gid, 2 * tig))) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int line) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(sm::smem_u32(src)), "r"(0), "r"(line), "r"(0)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Persistent: CTA x takes chunks x, x + gridDim.x, ...; warp 0's lane 0 is
// the producer, warps 1-8 the consumers.
template <int N, bool A16, bool B16>
__global__ void __launch_bounds__(STREAM_NT, 2) batched_stream_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_c, int chunks, int stages) {
  constexpr int A_BYTES = CHUNK * (A16 ? 2 : 4), B_BYTES = CHUNK * (B16 ? 2 : 4);
  constexpr int STAGE = A_BYTES + B_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* out = smem + stages * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(out + OUT_BYTES);
  uint64_t* empty = full + stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm::mbar_init(&full[s], 1);
      sm::mbar_init(&empty[s], CONSUMERS);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int s = 0, phase = 0;
  if (warp == 0) {
    // the producer alone waits on `empty`: it gates those phases
    if (lane == 0) {
      prefetch_map(&map_a);
      prefetch_map(&map_b);
      for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
        sm::mbar_wait(&empty[s], phase ^ 1);
        sm::mbar_arrive_tx(&full[s], STAGE);
        unsigned char* st = smem + s * STAGE;
        sm::tma_load(st, &map_a, &full[s], 0, ch * (A_BYTES / LINE), 0);
        sm::tma_load(st + A_BYTES, &map_b, &full[s], 0, ch * (B_BYTES / LINE), 0);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  const int cw = warp - 1;
  if (threadIdx.x == 32) prefetch_map(&map_c);
  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    sm::mbar_wait(&full[s], phase);
    const unsigned char* sa = smem + s * STAGE;
    float acc[32];
    chunk_mma<N, A16, B16>(acc, sa, sa + A_BYTES, cw, lane);
    __syncwarp();
    if (lane == 0) sm::mbar_arrive(&empty[s]);
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
    // the previous chunk's store has read the output buffer
    if (threadIdx.x == 32) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(32 * CONSUMERS) : "memory");
    chunk_store<N>(acc, out, cw, lane);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(32 * CONSUMERS) : "memory");
    if (threadIdx.x == 32) tma_store(&map_c, out, ch * (OUT_BYTES / LINE));
  }
  // the last store must have read the buffer before the CTA's shared memory goes
  if (threadIdx.x == 32) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
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

// A contiguous operand of `bytes` bytes as a 2-D map of 128-byte lines,
// boxes of `box_lines` lines, 128B swizzle; the box past the end reads zeros
// (loads) or is clipped (stores).
bool encode_lines(CUtensorMap* map, const void* p, long long bytes, int box_lines) {
  sm::EncodeTiled enc = sm::encoder();
  if (enc == nullptr || bytes % LINE || reinterpret_cast<uintptr_t>(p) % 16) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)LINE, (cuuint64_t)(bytes / LINE), 1};
  const cuuint64_t strides[2] = {(cuuint64_t)LINE, (cuuint64_t)bytes};
  const cuuint32_t box[3] = {(cuuint32_t)LINE, (cuuint32_t)box_lines, 1u};
  const cuuint32_t unit[3] = {1u, 1u, 1u};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(p), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N, bool A16, bool B16>
int launch_stream(const void* a, const void* b, float* c, long long g, int grid, int stages,
                  cudaStream_t s) {
  constexpr int A_BYTES = CHUNK * (A16 ? 2 : 4), B_BYTES = CHUNK * (B16 ? 2 : 4);
  const long long elems = g * N * N;
  const int chunks = static_cast<int>((elems + CHUNK - 1) / CHUNK);
  if (stages < 1 || stages > MAX_STAGES || grid < 1 || grid > chunks)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma{}, mb{}, mc{};
  if (!encode_lines(&ma, a, elems * (A16 ? 2 : 4), A_BYTES / LINE) ||
      !encode_lines(&mb, b, elems * (B16 ? 2 : 4), B_BYTES / LINE) ||
      !encode_lines(&mc, c, elems * 4, OUT_BYTES / LINE))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 1024 + (size_t)stages * (A_BYTES + B_BYTES) + OUT_BYTES + 16 * stages;
  auto kern = batched_stream_kernel<N, A16, B16>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, STREAM_NT, smem, s>>>(ma, mb, mc, chunks, stages);
  return (int)cudaGetLastError();
}

template <int N>
int launch_n(const void* a, int a16, const void* b, int b16, float* c, long long g, int grid,
             int stages, cudaStream_t s) {
  if (a16 && b16) return launch_stream<N, true, true>(a, b, c, g, grid, stages, s);
  if (a16) return launch_stream<N, true, false>(a, b, c, g, grid, stages, s);
  if (b16) return launch_stream<N, false, true>(a, b, c, g, grid, stages, s);
  return launch_stream<N, false, false>(a, b, c, g, grid, stages, s);
}

}  // namespace

// n in {8, 16, 32, 64}, g > 0 matrices, a and b contiguous and 16-byte
// aligned; `grid` persistent CTAs over ceil(g n^2 / 8192) chunks and a ring
// of `stages` (1-4): batched_gemm.py's packed_schedule.  Returns a
// cudaError_t.
extern "C" int batched_gemm_launch(const void* a, int a_bf16, const void* b, int b_bf16,
                                   float* c, long long g, int n, int grid, int stages,
                                   void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8: return launch_n<8>(a, a_bf16, b, b_bf16, c, g, grid, stages, s);
    case 16: return launch_n<16>(a, a_bf16, b, b_bf16, c, g, grid, stages, s);
    case 32: return launch_n<32>(a, a_bf16, b, b_bf16, c, g, grid, stages, s);
    case 64: return launch_n<64>(a, a_bf16, b, b_bf16, c, g, grid, stages, s);
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
