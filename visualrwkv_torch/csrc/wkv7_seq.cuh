// The sequential RWKV-7 ("x070") recurrence on Hopper, shared by the kernels
// of wkv7.cu (K1) and wkv7_packed.cu (K11), and the constants and stream
// conversions of the chunked kernels: the training forwards K5 and K12
// (wkv7_chunk.cuh) and the backwards K6 and K13 (wkv7_chunk_bwd.cuh). Device
// code and launch helpers only; each .cu file defines its own plain C entry
// points.
//
// Recurrence per (batch, head), fp32 state S of shape [Nv, Nk] = [64, 64]:
//   sa_i = sum_j S_ij a_j
//   S_ij = S_ij * exp(-exp(w_raw_j)) + sa_i * b_j + v_i * k_j
//   y_i  = sum_j S_ij r_j
//
// wkv7_fwd_kernel<T, HEADS> is the sequence forward. One block of
// HEADS * 64 threads per (b, group of HEADS adjacent heads); thread
// h2 * 64 + i owns value row i of head h0 + h2 in 64 registers, and each
// step's r, w, k, a, b rows of the group are staged in shared memory
// (double-buffered, so one barrier per step). The group's HEADS * 64
// elements of each stream are contiguous in a [B, T, H, 64] row, so every
// thread loads one element and the block's load is one coalesced access.
// HEADS = 1 is K1, HEADS = 2 (a head pair, 256 bytes a bf16 stream row) is
// K11; the per-thread arithmetic is the same, so both give bit-equal
// outputs. There is no chunk solve, so the stability envelope of
// docs/wkv_chunk_stability.md does not apply.
//
// Bound on the H100: the T steps are dependent and there are only B*H (or
// B*H/2) blocks, so these kernels are latency-bound, far from both the byte
// bound (the streams and the states) and the fp32 operation bound.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 64;
constexpr int CHUNK = 16;  // K5 / K12 save, K6 / K13 read, the state entering every CHUNK steps

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// Sequence forward. Streams [B, T, H, N]; state [B, H, Nv, Nk] fp32.
// ---------------------------------------------------------------------------
template <typename T, int HEADS>
__global__ void __launch_bounds__(HEADS * N) wkv7_fwd_kernel(
    int Tlen, int H, const T* __restrict__ r, const T* __restrict__ w,
    const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ a,
    const T* __restrict__ b, const float* __restrict__ s0, T* __restrict__ y,
    float* __restrict__ s_out) {
  constexpr int W = HEADS * N;  // threads; the group's elements of one stream row
  const int g = blockIdx.x;     // (b, head group)
  const int groups = H / HEADS;
  const int bb = g / groups, h0 = (g % groups) * HEADS;
  const int tid = threadIdx.x;          // h2 * N + i
  const int hoff = tid - (tid % N);     // h2 * N: this thread's head in the staged rows
  __shared__ float sr[2][W], sw[2][W], sk[2][W], sa[2][W], sb[2][W];

  // the group's heads are adjacent in [B, H, N, N]: row tid of the group's rows
  const size_t srow = ((size_t)bb * H + h0) * N + tid;
  float S[N];
  if (s0 != nullptr) {
    const float4* row = reinterpret_cast<const float4*>(s0 + srow * N);
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
  size_t off = ((size_t)bb * Tlen * H + h0) * N + tid;
  float nr = 0.f, nw = 0.f, nk = 0.f, nv = 0.f, na = 0.f, nb = 0.f;
  if (Tlen > 0) {
    nr = to_f(r[off]); nw = to_f(w[off]); nk = to_f(k[off]);
    nv = to_f(v[off]); na = to_f(a[off]); nb = to_f(b[off]);
  }
  for (int t = 0; t < Tlen; ++t) {
    const int p = t & 1;
    sr[p][tid] = nr;
    sw[p][tid] = expf(-expf(nw));
    sk[p][tid] = nk;
    sa[p][tid] = na;
    sb[p][tid] = nb;
    const float vi = nv;
    const size_t cur = off;
    __syncthreads();
    if (t + 1 < Tlen) {  // prefetch step t+1 while step t computes
      off += stride;
      nr = to_f(r[off]); nw = to_f(w[off]); nk = to_f(k[off]);
      nv = to_f(v[off]); na = to_f(a[off]); nb = to_f(b[off]);
    }
    const float* pr = sr[p] + hoff;
    const float* pw = sw[p] + hoff;
    const float* pk = sk[p] + hoff;
    const float* pa = sa[p] + hoff;
    const float* pb = sb[p] + hoff;
    float sai = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) sai = fmaf(S[j], pa[j], sai);
    float yi = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      S[j] = fmaf(S[j], pw[j], fmaf(sai, pb[j], vi * pk[j]));
      yi = fmaf(S[j], pr[j], yi);
    }
    y[cur] = from_f<T>(yi);
  }

  float4* out = reinterpret_cast<float4*>(s_out + srow * N);
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    out[j] = make_float4(S[4 * j], S[4 * j + 1], S[4 * j + 2], S[4 * j + 3]);
}

// dtype codes: 0 = float32, 1 = bfloat16.
template <int HEADS>
int launch_fwd(int dtype, int B, int T, int H, int n, const void* r, const void* w,
               const void* k, const void* v, const void* a, const void* b,
               const void* s0, void* y, void* s_out, void* stream) {
  if (n != N || B <= 0 || H <= 0 || H % HEADS != 0 || T < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B * H / HEADS), block(HEADS * N);
  const float* s0f = (const float*)s0;
  float* soutf = (float*)s_out;
  if (dtype == 0) {
    wkv7_fwd_kernel<float, HEADS><<<grid, block, 0, st>>>(
        T, H, (const float*)r, (const float*)w, (const float*)k, (const float*)v,
        (const float*)a, (const float*)b, s0f, (float*)y, soutf);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    wkv7_fwd_kernel<bf, HEADS><<<grid, block, 0, st>>>(
        T, H, (const bf*)r, (const bf*)w, (const bf*)k, (const bf*)v, (const bf*)a,
        (const bf*)b, s0f, (bf*)y, soutf);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace
