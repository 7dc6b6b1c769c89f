// The grouped dW at every rung (gemm_grouped.cuh; the int8 rungs on the
// fp8 instantiations, GemmArgs::q_int8 set), and the quantize pass of its
// quantized rungs.
//
// Quantize pass.  The fp8 / int8 rungs quantize x^T and dy per tile under
// pow2 scales: 64 x 32 tiles of x^T (64 columns of x by 32 rows of the run)
// and 32 x 128 tiles of dy, the WMMA kernel's A and B tiles and the plain
// twin's (kernels/gemm_grouped.py: grouped_gemm_dw_plain takes tile_terms
// over each run at ((64, 32), (32, 128))).  Tiles start at each run's first
// row and never cross its end: a run of n rows has ceil(n / 32) K tiles, the
// last one holding the n % 32 rows that 32 leaves (if any), whose missing
// rows count as zeros, exactly as the twin pads that tile and as the WMMA
// kernel's masked fetch reads it.  One block per (K tile slot, column tile)
// reduces the tile's amax, takes hi's scale, then (x3) the residual
// x - q(x)'s amax and its scale, with the helpers the WMMA kernel runs per
// staged tile (so scales and terms are bit-equal); it writes the (hi, lo)
// scale pair into a small buffer (gemm_common.cuh: DW_SCALE_K and the slot
// layout) and, for the dW, the tile's terms into bf16 planes shaped like x
// and dy: hi = q(x), and lo = q(x - hi) for x3.  The dW kernel then stages
// those planes as they are: every tile is quantized once, not once for each
// of the 112 (x^T) or 64 (dy) blocks that read it, and no block reduces.
#include "gemm_grouped.cuh"

using namespace rt;

namespace {

constexpr int SCALE_NT = 256;

// planes: (hi, lo) of x then (hi, lo) of dy, or null (scales only)
struct Planes {
  bf16* p[4];
};

template <bool X3>
__global__ void __launch_bounds__(SCALE_NT)
dw_quant_kernel(const void* x, int x_bf16, const void* dy, int dy_bf16, const int* offsets,
                int num_groups, int d, int f, int fp8, float* scales, Planes planes) {
  __shared__ float red[SCALE_NT / 32];
  const int slot = blockIdx.x, ct = blockIdx.y;
  const int nd = (d + DW_SCALE_D - 1) / DW_SCALE_D;
  // the group whose K tiles hold this slot (none: a slot nothing reads)
  int g = -1, t = 0;
  for (int e = 0; e < num_groups; ++e) {
    const int o0 = offsets[e], n = offsets[e + 1] - o0;
    const int first = o0 / DW_SCALE_K + e;
    if (slot >= first && slot < first + (n + DW_SCALE_K - 1) / DW_SCALE_K) {
      g = e;
      t = slot - first;
    }
  }
  if (g < 0) return;
  const int r0 = offsets[g] + t * DW_SCALE_K;
  const int r1 = min(r0 + DW_SCALE_K, offsets[g + 1]);
  const bool is_x = ct < nd;
  const void* p = is_x ? x : dy;
  const int bf = is_x ? x_bf16 : dy_bf16, width = is_x ? d : f;
  const int cw = is_x ? DW_SCALE_D : DW_SCALE_F;
  const int c0 = is_x ? ct * DW_SCALE_D : (ct - nd) * DW_SCALE_F;
  constexpr int PER = DW_SCALE_K * DW_SCALE_F / SCALE_NT;
  float v[PER];
  float m = 0.f;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int i = threadIdx.x + e * SCALE_NT, r = i / cw, c = i % cw;
    const bool in = i < DW_SCALE_K * cw && r0 + r < r1 && c0 + c < width;
    v[e] = in ? load_elem(p, static_cast<long long>(r0 + r) * width + c0 + c, bf) : 0.f;
    m = fmaxf(m, fabsf(v[e]));
  }
  const float qmax = fp8 ? 224.f : 127.f;
  const float s_hi = pow2_scale(block_amax(m, red), qmax);
  float s_lo = 1.f;
  if constexpr (X3) {
    m = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e)
      m = fmaxf(m, fabsf(v[e] - __bfloat162float(qdq_fmt(v[e], s_hi, fp8))));
    s_lo = pow2_scale(block_amax(m, red), qmax);
  }
  if (threadIdx.x == 0) {
    float* out = scales + (static_cast<long long>(slot) * gridDim.y + ct) * 2;
    out[0] = s_hi;
    out[1] = s_lo;
  }
  bf16* hi = planes.p[is_x ? 0 : 2];
  bf16* lo = planes.p[is_x ? 1 : 3];
  if (hi == nullptr) return;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int i = threadIdx.x + e * SCALE_NT, r = i / cw, c = i % cw;
    if (i < DW_SCALE_K * cw && r0 + r < r1 && c0 + c < width) {
      const long long at = static_cast<long long>(r0 + r) * width + c0 + c;
      const bf16 h = qdq_fmt(v[e], s_hi, fp8);
      hi[at] = h;
      if constexpr (X3) lo[at] = qdq_fmt(v[e] - __bfloat162float(h), s_lo, fp8);
    }
  }
}

}  // namespace

// scales: (n_slots, ceil(d / 64) + ceil(f / 128), 2) f32, n_slots =
// rows / 32 + num_groups + 1 (gemm_common.cuh's slot layout); x_hi, x_lo,
// dy_hi, dy_lo: bf16 planes shaped like x and dy (the rows of the runs
// written), or null for the scales alone (lo: x3 rungs only).
extern "C" int grouped_dw_scales_launch(const void* x, int x_bf16, const void* dy, int dy_bf16,
                                        const int* offsets, int num_groups, int d, int f,
                                        int n_slots, int policy, float* scales, void* x_hi,
                                        void* x_lo, void* dy_hi, void* dy_lo, void* stream,
                                        int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool x3 = policy == P_FP8X3 || policy == P_INT8X3;
  const int fp8 = policy == P_FP8 || policy == P_FP8X3;
  if (policy < P_FP8 || policy > P_INT8X3) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_slots, (d + DW_SCALE_D - 1) / DW_SCALE_D + (f + DW_SCALE_F - 1) / DW_SCALE_F);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Planes planes{{static_cast<bf16*>(x_hi), static_cast<bf16*>(x_lo),
                       static_cast<bf16*>(dy_hi), static_cast<bf16*>(dy_lo)}};
  if (x3)
    dw_quant_kernel<true><<<grid, SCALE_NT, 0, s>>>(x, x_bf16, dy, dy_bf16, offsets, num_groups,
                                                    d, f, fp8, scales, planes);
  else
    dw_quant_kernel<false><<<grid, SCALE_NT, 0, s>>>(x, x_bf16, dy, dy_bf16, offsets,
                                                     num_groups, d, f, fp8, scales, planes);
  return (int)cudaGetLastError();
}

// The quantized rungs: x and dy are the quantize pass's hi planes (bf16),
// `x_lo` and `dy_lo` its lo planes (x3; null for one pass).
// `loop` reports the mainloop that ran (rt::Mainloop).
extern "C" int grouped_gemm_dw_launch(const void* x, int x_bf16, const void* dy, int dy_bf16,
                                      const void* x_lo, const void* dy_lo,
                                      const int* offsets, int num_groups, float* dw, int rows,
                                      int d, int f, int policy, int* loop, void* stream,
                                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // A = x^T (d x rows: m-stride 1, k-stride d); B = dy (rows x f); each
  // block's K is its group's run, set from the offsets (K = rows bounds the
  // tensor maps).
  GemmArgs g = make_args(x, x_bf16, 0, 1, d, dy, dy_bf16, 0, f, 1, dw, d, f, rows);
  g.a_vec = vec4_ok(x, x_bf16, 1, d, 0, d);  // x^T read four columns at a time along M
  g.groups = offsets;
  g.num_groups = num_groups;
  g.q_int8 = policy == P_INT8 || policy == P_INT8X3;
  g.a_lo = x_lo;
  g.b_lo = dy_lo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (policy) {
    case P_BF16: return grouped_k<P_BF16>(g, num_groups, s, loop);
    case P_REFINE_A: return grouped_k<P_REFINE_A>(g, num_groups, s, loop);
    case P_BF16X3: return grouped_k<P_BF16X3>(g, num_groups, s, loop);
    case P_REFINE_AB: return grouped_k<P_REFINE_AB>(g, num_groups, s, loop);
    case P_F32: return grouped_k<P_F32>(g, num_groups, s, loop);
    case P_BF16X6: return grouped_k<P_BF16X6>(g, num_groups, s, loop);
    case P_FP8: case P_INT8: return grouped_k<P_FP8>(g, num_groups, s, loop);
    case P_FP8X3: case P_INT8X3: return grouped_k<P_FP8X3>(g, num_groups, s, loop);
    default: return (int)cudaErrorInvalidValue;
  }
}
