// RWKV-4 ("x040") WKV recurrence on Hopper: the sequence forward K17
// (wkv4_fwd). It replaces no TPU kernel: the JAX package computes this
// recurrence with a lax.scan of elementwise ops (visualrwkv_tpu/ops/wkv4.py
// ::wkv4), which XLA fuses into one loop; run eagerly on the card, the same
// scan costs about 12 launches a token and layer. Plain C interface, loaded
// with ctypes by visualrwkv_torch/ops/wkv4_cuda.py.
//
// The recurrence is per channel, with a log-domain state (aa, bb, pp):
//   ww = u + k_t; p = max(pp, ww)
//   y_t = (e^{pp-p} aa + e^{ww-p} v_t) / (e^{pp-p} bb + e^{ww-p})
//   ww = w + pp; p = max(ww, k_t)
//   aa = e^{ww-p} aa + e^{k_t-p} v_t; bb = e^{ww-p} bb + e^{k_t-p}; pp = p
// with w = -exp(time_decay) <= 0. Every exponent is <= 0, so nothing
// overflows fp32 whatever k is (the max tracking).
//
// Design: one thread a (b, c), walking T with (aa, bb, pp) in registers; no
// shared memory and no cross-thread sum. Consecutive threads own consecutive
// channels, so a step's loads of k and v and its store of y are coalesced.
// The walk is a chain of dependent exp / max / divide / fma, so the kernel is
// bound by that chain's latency, not by memory (it moves ~4 % of the
// card's memory rate at B=1): the next step's k and v are loaded before the
// current step's arithmetic, so that the chain does not also wait on
// memory. Only pp -> w + pp -> max -> exp -> fma is carried from step to
// step; y's exps and divide hang off it.
//
// Arithmetic is fp32 and follows the plain version sum for sum (expf, IEEE
// divide; nvcc may contract a product and a sum into one fma).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

// steps of k and v loaded ahead of the walk: 1, the next step's. A deeper
// ring (4, 8, 16, 32 steps) measured 7-26 % slower at the x040 prefill's
// shapes on an H100 80GB HBM3 at 700 W (chip_variants.py --wkv4): the walk
// waits on its own chain of dependent operations, not on memory
constexpr int PREFETCH = 1;
constexpr float PP_INIT = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// the k, v element type of a dtype code: 0 float, 1 bf16
template <int DT>
using KV = std::conditional_t<DT == 1, __nv_bfloat16, float>;

// k, v [B, T, C] in KV<DT>; w, u fp32 [C]; s0 (may be null) and s_out fp32
// [B, C, 3] (aa, bb, pp); y fp32 [B, T, C]
template <int DT>
__global__ void wkv4_fwd_kernel(int B, int T, int C, const float* __restrict__ w,
                                const float* __restrict__ u, const KV<DT>* __restrict__ k,
                                const KV<DT>* __restrict__ v, const float* __restrict__ s0,
                                float* __restrict__ y, float* __restrict__ s_out) {
  using X = KV<DT>;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)B * C) return;
  const int b = (int)(idx / C), c = (int)(idx % C);
  const float wc = w[c], uc = u[c];
  float aa = 0.f, bb = 0.f, pp = PP_INIT;
  if (s0 != nullptr) {
    aa = s0[idx * 3];
    bb = s0[idx * 3 + 1];
    pp = s0[idx * 3 + 2];
  }
  const long base = (long)b * T * C + c;
  const X* kp = k + base;
  const X* vp = v + base;
  float* yp = y + base;

  float kb[PREFETCH], vb[PREFETCH];
#pragma unroll
  for (int j = 0; j < PREFETCH; ++j) {
    if (j < T) {
      kb[j] = to_f(kp[(long)j * C]);
      vb[j] = to_f(vp[(long)j * C]);
    }
  }
  for (int t0 = 0; t0 < T; t0 += PREFETCH) {
#pragma unroll
    for (int j = 0; j < PREFETCH; ++j) {
      const int t = t0 + j;
      if (t < T) {
        const float kt = kb[j], vt = vb[j];
        const int tn = t + PREFETCH;
        if (tn < T) {
          kb[j] = to_f(kp[(long)tn * C]);
          vb[j] = to_f(vp[(long)tn * C]);
        }
        // output first: the bonus u applies to the current token only
        float ww = uc + kt;
        float p = fmaxf(pp, ww);
        float e1 = expf(pp - p);
        float e2 = expf(ww - p);
        yp[(long)t * C] = (e1 * aa + e2 * vt) / (e1 * bb + e2);
        // then decay and accumulate
        ww = wc + pp;
        p = fmaxf(ww, kt);
        e1 = expf(ww - p);
        e2 = expf(kt - p);
        aa = e1 * aa + e2 * vt;
        bb = e1 * bb + e2;
        pp = p;
      }
    }
  }
  s_out[idx * 3] = aa;
  s_out[idx * 3 + 1] = bb;
  s_out[idx * 3 + 2] = pp;
}

}  // namespace

extern "C" {

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K17: k, v [B, T, C] fp32 (dtype 0) or bf16 (1); w, u fp32 [C]; s0 (may be
// null: aa = bb = 0, pp = -1e30) and s_out fp32 [B, C, 3]; y fp32 [B, T, C];
// threads = threads a block (a multiple of 32, at most 1024), one a (b, c).
int wkv4_fwd(int dtype, int threads, int B, int T, int C, const float* w, const float* u,
             const void* k, const void* v, const float* s0, float* y, float* s_out,
             void* stream) {
  if (B <= 0 || T < 0 || C <= 0 || threads <= 0 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  const long n = (long)B * C;
  const int blocks = (int)((n + threads - 1) / threads);
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    wkv4_fwd_kernel<0><<<blocks, threads, 0, st>>>(B, T, C, w, u, (const float*)k, (const float*)v,
                                                   s0, y, s_out);
  } else if (dtype == 1) {
    wkv4_fwd_kernel<1><<<blocks, threads, 0, st>>>(B, T, C, w, u, (const __nv_bfloat16*)k,
                                                   (const __nv_bfloat16*)v, s0, y, s_out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
