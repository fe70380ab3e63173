// RWKV-7 ("x070") WKV recurrence on Hopper: sequence forward (K1) and the
// one-token decode step (K2). Plain C interface, loaded with ctypes by
// visualrwkv_torch/ops/wkv7_cuda.py.
//
// Recurrence per (batch, head), fp32 state S of shape [Nv, Nk] = [64, 64]:
//   sa_i = sum_j S_ij a_j
//   S_ij = S_ij * exp(-exp(w_raw_j)) + sa_i * b_j + v_i * k_j
//   y_i  = sum_j S_ij r_j
//
// K1 wkv7_fwd replaces visualrwkv_tpu/ops/wkv7_pallas.py::wkv7_pallas (the
// chunked forward, kernel _wkv7_kernel). The Pallas kernel solves a chunk of
// up to 16 steps with matmuls, because the TPU has a matrix unit and a
// sequential grid. Here the design is the sequential recurrence: one block of
// 64 threads per (b, h), thread i owns value row i of the state in 64
// registers, and each step's r, w, k, a, b are staged in shared memory
// (double-buffered, so one barrier per step). There is no chunk solve, so the
// stability envelope of docs/wkv_chunk_stability.md does not apply.
// Bound on the H100: the T steps are sequential and there are only B*H
// blocks (32 at B=1), so the kernel is latency-bound, far from both the
// byte bound (about 31 MB at B=1, T=1056, H=32, bf16) and the fp32 operation
// bound (about 1.25 GFLOP). The next step's inputs are loaded into registers
// while the current step computes, to hide the global-memory latency.
//
// K2 wkv7_step replaces visualrwkv_tpu/ops/wkv7_pallas.py::wkv7_step_pallas
// (_wkv7_step_kernel). Bound: state bytes, B*H*64*64 read once and written
// once (fp32 or bf16 state; math fp32). One block of 8 warps per (b, h);
// a warp walks rows, each lane owns two adjacent columns, so every row is
// read and written as one coalesced 128- or 256-byte transaction, and the two
// row sums are warp shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void load2(const float* p, float& x, float& y) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  x = q.x;
  y = q.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& x, float& y) {
  const __nv_bfloat162 q = *reinterpret_cast<const __nv_bfloat162*>(p);
  x = __low2float(q);
  y = __high2float(q);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// K1: sequence forward. Streams [B, T, H, N]; state [B, H, Nv, Nk] fp32.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(N) wkv7_fwd_kernel(
    int Tlen, int H, const T* __restrict__ r, const T* __restrict__ w,
    const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ a,
    const T* __restrict__ b, const float* __restrict__ s0, T* __restrict__ y,
    float* __restrict__ s_out) {
  const int bh = blockIdx.x;
  const int bb = bh / H, hh = bh % H;
  const int i = threadIdx.x;
  __shared__ float sr[2][N], sw[2][N], sk[2][N], sa[2][N], sb[2][N];

  float S[N];
  if (s0 != nullptr) {
    const float4* row = reinterpret_cast<const float4*>(s0 + ((size_t)bh * N + i) * N);
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 q = row[j];
      S[4 * j] = q.x;
      S[4 * j + 1] = q.y;
      S[4 * j + 2] = q.z;
      S[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) S[j] = 0.f;
  }

  const size_t stride = (size_t)H * N;  // one time step
  size_t off = ((size_t)bb * Tlen * H + hh) * N + i;
  float nr = 0.f, nw = 0.f, nk = 0.f, nv = 0.f, na = 0.f, nb = 0.f;
  if (Tlen > 0) {
    nr = to_f(r[off]); nw = to_f(w[off]); nk = to_f(k[off]);
    nv = to_f(v[off]); na = to_f(a[off]); nb = to_f(b[off]);
  }
  for (int t = 0; t < Tlen; ++t) {
    const int p = t & 1;
    sr[p][i] = nr;
    sw[p][i] = expf(-expf(nw));
    sk[p][i] = nk;
    sa[p][i] = na;
    sb[p][i] = nb;
    const float vi = nv;
    const size_t cur = off;
    __syncthreads();
    if (t + 1 < Tlen) {  // prefetch step t+1 while step t computes
      off += stride;
      nr = to_f(r[off]); nw = to_f(w[off]); nk = to_f(k[off]);
      nv = to_f(v[off]); na = to_f(a[off]); nb = to_f(b[off]);
    }
    float sai = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) sai = fmaf(S[j], sa[p][j], sai);
    float yi = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      S[j] = fmaf(S[j], sw[p][j], fmaf(sai, sb[p][j], vi * sk[p][j]));
      yi = fmaf(S[j], sr[p][j], yi);
    }
    y[cur] = from_f<T>(yi);
  }

  float4* out = reinterpret_cast<float4*>(s_out + ((size_t)bh * N + i) * N);
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    out[j] = make_float4(S[4 * j], S[4 * j + 1], S[4 * j + 2], S[4 * j + 3]);
}

// ---------------------------------------------------------------------------
// K2: one decode step. State [B, H, Nv, Nk] in TS; vectors [B, H, N] fp32.
// ---------------------------------------------------------------------------
constexpr int STEP_WARPS = 8;

template <typename TS>
__global__ void __launch_bounds__(STEP_WARPS * 32) wkv7_step_kernel(
    const TS* __restrict__ s_in, const float* __restrict__ r, const float* __restrict__ w,
    const float* __restrict__ k, const float* __restrict__ v, const float* __restrict__ a,
    const float* __restrict__ b, TS* __restrict__ s_out, float* __restrict__ y) {
  const int bh = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = 2 * lane;
  const size_t vo = (size_t)bh * N;
  float r0, r1, w0, w1, k0, k1, a0, a1, b0, b1;
  load2(r + vo + j0, r0, r1);
  load2(w + vo + j0, w0, w1);
  load2(k + vo + j0, k0, k1);
  load2(a + vo + j0, a0, a1);
  load2(b + vo + j0, b0, b1);
  w0 = expf(-expf(w0));
  w1 = expf(-expf(w1));

  constexpr int ROWS = N / STEP_WARPS;
#pragma unroll
  for (int ii = 0; ii < ROWS; ++ii) {
    const int i = warp * ROWS + ii;
    const size_t so = (vo + i) * N + j0;
    float s0, s1;
    load2(s_in + so, s0, s1);
    const float sai = warp_sum(s0 * a0 + s1 * a1);
    const float vi = v[vo + i];
    s0 = fmaf(s0, w0, fmaf(sai, b0, vi * k0));
    s1 = fmaf(s1, w1, fmaf(sai, b1, vi * k1));
    store2(s_out + so, s0, s1);
    const float yi = warp_sum(s0 * r0 + s1 * r1);
    if (lane == 0) y[vo + i] = yi;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int wkv7_fwd(int dtype, int B, int T, int H, int n, const void* r, const void* w,
             const void* k, const void* v, const void* a, const void* b,
             const void* s0, void* y, void* s_out, void* stream) {
  if (n != N || B <= 0 || H <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B * H), block(N);
  const float* s0f = (const float*)s0;
  float* soutf = (float*)s_out;
  if (dtype == 0) {
    wkv7_fwd_kernel<float><<<grid, block, 0, st>>>(
        T, H, (const float*)r, (const float*)w, (const float*)k, (const float*)v,
        (const float*)a, (const float*)b, s0f, (float*)y, soutf);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    wkv7_fwd_kernel<bf><<<grid, block, 0, st>>>(
        T, H, (const bf*)r, (const bf*)w, (const bf*)k, (const bf*)v, (const bf*)a,
        (const bf*)b, s0f, (bf*)y, soutf);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int wkv7_step(int state_dtype, int B, int H, int n, const void* s_in, const float* r,
              const float* w, const float* k, const float* v, const float* a,
              const float* b, void* s_out, float* y, void* stream) {
  if (n != N || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B * H), block(STEP_WARPS * 32);
  if (state_dtype == 0) {
    wkv7_step_kernel<float><<<grid, block, 0, st>>>((const float*)s_in, r, w, k, v, a, b,
                                                    (float*)s_out, y);
  } else if (state_dtype == 1) {
    using bf = __nv_bfloat16;
    wkv7_step_kernel<bf><<<grid, block, 0, st>>>((const bf*)s_in, r, w, k, v, a, b,
                                                 (bf*)s_out, y);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
