// Flash attention on the tensor cores: prefill forward and single-token
// decode against the dense cache, the precision ladder fused into both
// contractions.
//
// Replaces the TPU kernels kernels/attention_fused.py:_fwd_kernel
// (pallas_call at :224) and :_decode_kernel (pallas_call at :579).  The
// forward at the bf16 rung runs the Hopper kernel of flash_sm90.cuh
// (wgmma, S / P / O in registers); every other rung of the forward, and
// decode, run the WMMA kernel of flash_common.cuh (shared with the paged
// decode, attention_paged.cu), decode at bf16 with its KV walk split
// `splits` ways over CTAs and combined in the same launch.
#include "flash_sm90.cuh"

// `loop` reports the kernel that ran (rt::Mainloop).
extern "C" int attention_fwd_launch(const void* q, const void* k, const void* v, float* o,
                                    float* lse, int in_bf16, int B, int Sq, int Skv, int Kv, int G, int hd,
                                    int causal, int window, float softcap, int policy, int* loop,
                                    void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  rt::AttnArgs a{q, k, v, o, lse, nullptr, in_bf16, B, Sq, Skv, Kv, G, hd, causal, window, 0, softcap,
                 in_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (policy == rt::P_BF16) {
    *loop = rt::LOOP_SM90;
    return rt::fsm90::run(a, s);
  }
  *loop = rt::LOOP_WMMA;
  dim3 grid((Sq + 63) / 64, Kv * G, B);
  return rt::dispatch_attn<64, false>(a, policy, grid, s);
}

extern "C" int attention_decode_launch(const void* q, const void* k, const void* v, float* o,
                                       const int* pos, int in_bf16, int B, int S, int Kv, int G,
                                       int hd, int ring, float softcap, int policy, int splits,
                                       float* ws, long long ws_floats, int* tickets,
                                       int n_tickets, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  rt::AttnArgs a{q, k, v, o, nullptr, pos, in_bf16, B, 1, S, Kv, G, hd, 0, 0, ring, softcap,
                 in_bf16};
  const rt::SplitWs sw{splits, ws, ws_floats, tickets, n_tickets};
  if (!rt::decode_split_ok(a, sw, policy)) return (int)cudaErrorInvalidValue;
  dim3 grid(splits, Kv, B);
  return rt::dispatch_attn<16, true>(a, policy, grid, static_cast<cudaStream_t>(stream), sw);
}
