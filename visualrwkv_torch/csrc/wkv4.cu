// RWKV-4 ("x040") WKV recurrence on Hopper: the sequence forward K17
// (wkv4_fwd) and its VJP K18 (wkv4_bwd). Neither replaces a TPU kernel: the
// JAX package computes this recurrence with a lax.scan of elementwise ops
// (visualrwkv_tpu/ops/wkv4.py::wkv4), which XLA fuses into one loop, and
// differentiates the scan with autodiff; run eagerly on the card, the same
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
//
// K18 is the reverse-mode derivative of that walk, where JAX differentiates
// its scan with autodiff. It needs the state entering every step, in reverse
// order. K18 recomputes those states rather than have K17 save them: its first
// walk runs K17's state update forward over T and writes the state entering
// each step to a workspace [B, T, 3, C] (fp32, channel fastest, so that a
// step's stores are coalesced) that lives for the call only; the second walk
// goes back over T, reading it. Saving a trail from the forward would keep
// one such tensor a layer alive from the forward to the backward (24 layers
// x 104 MB at B=4, T=1056, C=2048); the recomputation costs one more walk of
// K17's state chain, and the workspace is written and read back while it is
// hot in L2 at the adapter's shapes.
//
// The reverse walk differentiates every operation of the step as autograd
// does the plain loop: the gradient of max goes to the larger argument (half
// to each on a tie, as torch.maximum's), and the running max pp, a stabiliser
// whose derivative cancels in exact arithmetic, is differentiated like any
// other value, so that a cotangent of the final state's pp is honoured.
// dw and du are sums over B and T: each thread writes its (b, c) partial sum
// over T and the wrapper sums the partials over B, so the result does not
// depend on the order blocks run in.

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

// K18: the VJP of wkv4_fwd_kernel. k, v [B, T, C] in KV<DT>; w, u fp32 [C];
// s0 (may be null) fp32 [B, C, 3]; dy fp32 [B, T, C]; ds (may be null: a zero
// cotangent) fp32 [B, C, 3], the final state's cotangent; ws fp32 workspace
// [B, T, 3, C]. Writes dk, dv fp32 [B, T, C], the per-row partial sums dw_part,
// du_part fp32 [B, C], and, when ds0 is not null, ds0 fp32 [B, C, 3].
template <int DT>
__global__ void wkv4_bwd_kernel(int B, int T, int C, const float* __restrict__ w,
                                const float* __restrict__ u, const KV<DT>* __restrict__ k,
                                const KV<DT>* __restrict__ v, const float* __restrict__ s0,
                                const float* __restrict__ dy, const float* __restrict__ ds,
                                float* __restrict__ ws, float* __restrict__ dk,
                                float* __restrict__ dv, float* __restrict__ dw_part,
                                float* __restrict__ du_part, float* __restrict__ ds0) {
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
  const long cs = C;  // stride of one step in k, v, dy, dk, dv
  float* wsp = ws + (long)b * T * 3 * C + c;

  // walk 1: the state entering each step, K17's update without y
  for (int t = 0; t < T; ++t) {
    const float kt = to_f(k[base + t * cs]), vt = to_f(v[base + t * cs]);
    wsp[(3L * t) * C] = aa;
    wsp[(3L * t + 1) * C] = bb;
    wsp[(3L * t + 2) * C] = pp;
    const float ww = wc + pp;
    const float p = fmaxf(ww, kt);
    const float e1 = expf(ww - p);
    const float e2 = expf(kt - p);
    aa = e1 * aa + e2 * vt;
    bb = e1 * bb + e2;
    pp = p;
  }

  // walk 2: back over T with the state's cotangent (gaa, gbb, gpp)
  float gaa = 0.f, gbb = 0.f, gpp = 0.f;
  if (ds != nullptr) {
    gaa = ds[idx * 3];
    gbb = ds[idx * 3 + 1];
    gpp = ds[idx * 3 + 2];
  }
  float gw = 0.f, gu = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const float kt = to_f(k[base + t * cs]), vt = to_f(v[base + t * cs]);
    const float gy = dy[base + t * cs];
    aa = wsp[(3L * t) * C];
    bb = wsp[(3L * t + 1) * C];
    pp = wsp[(3L * t + 2) * C];
    // the step's forward values
    const float ww = uc + kt;
    const float p = fmaxf(pp, ww);
    const float e1 = expf(pp - p);
    const float e2 = expf(ww - p);
    const float num = e1 * aa + e2 * vt;
    const float den = e1 * bb + e2;
    const float y = num / den;
    const float ww2 = wc + pp;
    const float p2 = fmaxf(ww2, kt);
    const float f1 = expf(ww2 - p2);
    const float f2 = expf(kt - p2);
    // the update aa' = f1 aa + f2 v, bb' = f1 bb + f2, pp' = p2
    const float gf1 = gaa * aa + gbb * bb;
    const float gf2 = gaa * vt + gbb;
    float naa = gaa * f1, nbb = gbb * f1, gv = gaa * f2;
    const float a1 = gf1 * f1, a2 = gf2 * f2;
    float gww2 = a1, gk = a2;
    const float gp2 = gpp - a1 - a2;
    if (ww2 > kt) {
      gww2 += gp2;
    } else if (kt > ww2) {
      gk += gp2;
    } else {
      gww2 += 0.5f * gp2;
      gk += 0.5f * gp2;
    }
    gw += gww2;
    float npp = gww2;
    // the output y = num / den
    const float gnum = gy / den;
    const float gden = -gy * y / den;
    const float ge1 = gnum * aa + gden * bb;
    const float ge2 = gnum * vt + gden;
    naa += gnum * e1;
    nbb += gden * e1;
    gv += gnum * e2;
    const float b1 = ge1 * e1, b2 = ge2 * e2;
    npp += b1;
    float gww = b2;
    const float gp = -b1 - b2;
    if (pp > ww) {
      npp += gp;
    } else if (ww > pp) {
      gww += gp;
    } else {
      npp += 0.5f * gp;
      gww += 0.5f * gp;
    }
    gu += gww;
    gk += gww;
    dk[base + t * cs] = gk;
    dv[base + t * cs] = gv;
    gaa = naa;
    gbb = nbb;
    gpp = npp;
  }
  dw_part[idx] = gw;
  du_part[idx] = gu;
  if (ds0 != nullptr) {
    ds0[idx * 3] = gaa;
    ds0[idx * 3 + 1] = gbb;
    ds0[idx * 3 + 2] = gpp;
  }
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

// K18: k, v [B, T, C] fp32 (dtype 0) or bf16 (1); w, u fp32 [C]; s0 and ds
// (each may be null) fp32 [B, C, 3]; dy fp32 [B, T, C]; ws fp32 [B, T, 3, C]
// (scratch); dk, dv fp32 [B, T, C]; dw_part, du_part fp32 [B, C]; ds0 (may be
// null) fp32 [B, C, 3]; threads as wkv4_fwd.
int wkv4_bwd(int dtype, int threads, int B, int T, int C, const float* w, const float* u,
             const void* k, const void* v, const float* s0, const float* dy, const float* ds,
             float* ws, float* dk, float* dv, float* dw_part, float* du_part, float* ds0,
             void* stream) {
  if (B <= 0 || T < 0 || C <= 0 || threads <= 0 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  const long n = (long)B * C;
  const int blocks = (int)((n + threads - 1) / threads);
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    wkv4_bwd_kernel<0><<<blocks, threads, 0, st>>>(B, T, C, w, u, (const float*)k, (const float*)v,
                                                   s0, dy, ds, ws, dk, dv, dw_part, du_part, ds0);
  } else if (dtype == 1) {
    wkv4_bwd_kernel<1><<<blocks, threads, 0, st>>>(B, T, C, w, u, (const __nv_bfloat16*)k,
                                                   (const __nv_bfloat16*)v, s0, dy, ds, ws, dk, dv,
                                                   dw_part, du_part, ds0);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
