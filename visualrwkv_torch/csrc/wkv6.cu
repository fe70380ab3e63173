// RWKV-6 ("x060") WKV recurrence on Hopper: sequence forward (K7), the
// training forward that also saves the chunk states (K8) and the one-token
// decode step (K10). Plain C interface, loaded with ctypes by
// visualrwkv_torch/ops/wkv6_cuda.py. The backward (K9) is in wkv6_train.cu.
//
// Recurrence per (batch, head), fp32 state S of shape [Nv, Nk] = [64, 64],
// bonus u per channel of the head:
//   bonus = sum_j u_j k_j r_j
//   y_i   = sum_j S_ij r_j + bonus * v_i          (the state BEFORE the step)
//   S_ij  = S_ij * w_j + v_i * k_j
// with w = exp(max(-exp(w_raw), floor)). The sequence kernels (K7, K8) take
// the floor -80/L of the JAX package's chunked forms (L = the model's
// chunk_len), which the wrapper passes in; the decode step (K10) has none.
//
// K7 wkv6_fwd replaces visualrwkv_tpu/ops/wkv6_pallas.py::wkv6_pallas (the
// chunked forward, kernel _wkv6_kernel). The Pallas kernel works a chunk at a
// time with cumulative-decay matmuls for the TPU's matrix unit. Here the
// design is the sequential recurrence, as K1's for WKV7 but simpler: there is
// no a.b^T term, so each state row evolves on its own. One block of 64
// threads per (b, h), thread i owns value row i of the state in 64 registers;
// each step's r, decay, k and u.k.r products are staged in shared memory
// (double-buffered, one barrier a step), and the next step's inputs are
// loaded into registers while the current step computes.
// Bound on the H100: the T steps are dependent and there are only B*H
// blocks (64 at B=1, H=64), so the kernel is bound by the latency of the
// step chain, far from both its byte bound (5 streams of B*T*H*64 elements
// plus the states) and its fp32 operation bound (about 6 B*T*H*64*64).
//
// K8 wkv6_fwd_res replaces wkv6_pallas_fwd_res: K7's recurrence behind a
// template flag that also writes the state entering every 16-step chunk,
// zin[bh, c] = transpose of S before step 16c (fp32), the layout the Pallas
// kernel saves. With one thread a state row, column j of all rows is 64
// adjacent floats of Z[j], so the stores are coalesced, and the backward's
// row threads read them the same way. Bound: as K7; the extra bytes are
// B*H*(T/16)*16 KiB.
//
// K10 wkv6_step replaces wkv6_step_pallas (_wkv6_step_kernel): K2's body
// without a, b and the S.a term. Bound: state bytes, B*H*64*64 read once and
// written once (fp32 or bf16 state; math fp32). One block of 8 warps per
// (b, h); a warp walks rows, each lane owns two adjacent columns, so every row
// is read and written as one coalesced 128- or 256-byte transaction, and the
// row sum and the bonus are warp shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 64;
constexpr int CHUNK = 16;  // K8 saves the state entering every CHUNK steps

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
// K7 / K8: sequence forward. Streams [B, T, H, N]; u [H, N] fp32; state
// [B, H, Nv, Nk] fp32.
// ---------------------------------------------------------------------------
template <typename T, bool SAVE>
__global__ void __launch_bounds__(N) wkv6_fwd_kernel(
    int Tlen, int H, float wfloor, const T* __restrict__ r, const T* __restrict__ w,
    const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ u,
    const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_out,
    float* __restrict__ zin) {
  const int bh = blockIdx.x;
  const int bb = bh / H, hh = bh % H;
  const int i = threadIdx.x;
  __shared__ float sr[2][N], sw[2][N], sk[2][N], sb[2][N];  // sb: u_j k_j r_j
  const float ui = u[hh * N + i];

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
  float nr = 0.f, nw = 0.f, nk = 0.f, nv = 0.f;
  if (Tlen > 0) {
    nr = to_f(r[off]); nw = to_f(w[off]); nk = to_f(k[off]); nv = to_f(v[off]);
  }
  for (int t = 0; t < Tlen; ++t) {
    if (SAVE && t % CHUNK == 0) {  // zin[bh, t / CHUNK, j, i] = S[i][j]
      float* z = zin + ((size_t)bh * (Tlen / CHUNK) + t / CHUNK) * N * N + i;
#pragma unroll
      for (int j = 0; j < N; ++j) z[(size_t)j * N] = S[j];
    }
    const int p = t & 1;
    sr[p][i] = nr;
    sw[p][i] = expf(fmaxf(-expf(nw), wfloor));
    sk[p][i] = nk;
    sb[p][i] = ui * nk * nr;
    const float vi = nv;
    const size_t cur = off;
    __syncthreads();
    if (t + 1 < Tlen) {  // prefetch step t+1 while step t computes
      off += stride;
      nr = to_f(r[off]); nw = to_f(w[off]); nk = to_f(k[off]); nv = to_f(v[off]);
    }
    float bonus = 0.f, yi = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      bonus += sb[p][j];
      yi = fmaf(S[j], sr[p][j], yi);
      S[j] = fmaf(S[j], sw[p][j], vi * sk[p][j]);
    }
    y[cur] = from_f<T>(fmaf(bonus, vi, yi));
  }

  float4* out = reinterpret_cast<float4*>(s_out + ((size_t)bh * N + i) * N);
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    out[j] = make_float4(S[4 * j], S[4 * j + 1], S[4 * j + 2], S[4 * j + 3]);
}

// ---------------------------------------------------------------------------
// K10: one decode step. Vectors [B, H, N] fp32, u [H, N] fp32; state in TS,
// [B, H, Nv, Nk].
// ---------------------------------------------------------------------------
constexpr int STEP_WARPS = 8;

template <typename TS>
__global__ void __launch_bounds__(STEP_WARPS * 32) wkv6_step_kernel(
    int H, const TS* __restrict__ s_in, const float* __restrict__ r, const float* __restrict__ w,
    const float* __restrict__ k, const float* __restrict__ v, const float* __restrict__ u,
    TS* __restrict__ s_out, float* __restrict__ y) {
  const int bh = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = 2 * lane;
  const size_t vo = (size_t)bh * N;
  const size_t base = vo * N;
  float r0, r1, w0, w1, k0, k1, u0, u1;
  load2(r + vo + j0, r0, r1);
  load2(w + vo + j0, w0, w1);
  load2(k + vo + j0, k0, k1);
  load2(u + (size_t)(bh % H) * N + j0, u0, u1);
  w0 = expf(-expf(w0));
  w1 = expf(-expf(w1));
  const float bonus = warp_sum(u0 * k0 * r0 + u1 * k1 * r1);

  constexpr int ROWS = N / STEP_WARPS;
#pragma unroll
  for (int ii = 0; ii < ROWS; ++ii) {
    const int i = warp * ROWS + ii;
    const size_t so = base + (size_t)i * N + j0;
    float s0, s1;
    load2(s_in + so, s0, s1);
    const float vi = v[vo + i];
    const float yi = warp_sum(s0 * r0 + s1 * r1);
    s0 = fmaf(s0, w0, vi * k0);
    s1 = fmaf(s1, w1, vi * k1);
    store2(s_out + so, s0, s1);
    if (lane == 0) y[vo + i] = fmaf(bonus, vi, yi);
  }
}

template <bool SAVE>
int launch_fwd(int dtype, int B, int T, int H, int n, float wfloor, const void* r,
               const void* w, const void* k, const void* v, const void* u, const void* s0,
               void* y, void* s_out, void* zin, void* stream) {
  if (n != N || B <= 0 || H <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (SAVE && (T % CHUNK != 0 || zin == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B * H), block(N);
  const float* uf = (const float*)u;
  const float* s0f = (const float*)s0;
  float* soutf = (float*)s_out;
  if (dtype == 0) {
    wkv6_fwd_kernel<float, SAVE><<<grid, block, 0, st>>>(
        T, H, wfloor, (const float*)r, (const float*)w, (const float*)k, (const float*)v, uf,
        s0f, (float*)y, soutf, (float*)zin);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    wkv6_fwd_kernel<bf, SAVE><<<grid, block, 0, st>>>(
        T, H, wfloor, (const bf*)r, (const bf*)w, (const bf*)k, (const bf*)v, uf, s0f, (bf*)y,
        soutf, (float*)zin);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K7: streams [B, T, H, 64] in one dtype; u fp32 [H, 64]; s0 (may be null)
// and s_out fp32 [B, H, 64, 64]; wfloor = -80 / chunk_len.
int wkv6_fwd(int dtype, int B, int T, int H, int n, float wfloor, const void* r, const void* w,
             const void* k, const void* v, const void* u, const void* s0, void* y, void* s_out,
             void* stream) {
  return launch_fwd<false>(dtype, B, T, H, n, wfloor, r, w, k, v, u, s0, y, s_out, nullptr,
                           stream);
}

// K8: T must be a multiple of 16; zin is fp32 [B*H, T/16, 64, 64].
int wkv6_fwd_res(int dtype, int B, int T, int H, int n, float wfloor, const void* r,
                 const void* w, const void* k, const void* v, const void* u, const void* s0,
                 void* y, void* s_out, void* zin, void* stream) {
  return launch_fwd<true>(dtype, B, T, H, n, wfloor, r, w, k, v, u, s0, y, s_out, zin, stream);
}

// K10: state [B, H, 64, 64] fp32 (0) or bf16 (1); vectors fp32 [B, H, 64].
int wkv6_step(int state_dtype, int B, int H, int n, const void* s_in, const float* r,
              const float* w, const float* k, const float* v, const float* u, void* s_out,
              float* y, void* stream) {
  if (n != N || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B * H), block(STEP_WARPS * 32);
  if (state_dtype == 0) {
    wkv6_step_kernel<float><<<grid, block, 0, st>>>(H, (const float*)s_in, r, w, k, v, u,
                                                    (float*)s_out, y);
  } else if (state_dtype == 1) {
    using bf = __nv_bfloat16;
    wkv6_step_kernel<bf><<<grid, block, 0, st>>>(H, (const bf*)s_in, r, w, k, v, u, (bf*)s_out,
                                                 y);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
