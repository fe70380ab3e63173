// RWKV-6 ("x060") WKV backward on Hopper (K9). Plain C interface, loaded with
// ctypes by visualrwkv_torch/ops/wkv6_cuda.py.
//
// K9 wkv6_bwd replaces visualrwkv_tpu/ops/wkv6_pallas.py::wkv6_pallas_bwd
// (_wkv6_bwd_kernel): the vector-Jacobian product of
//   bonus = sum_j u_j k_j r_j
//   y_i   = sum_j S_ij r_j + bonus v_i                 (S: the state before the step)
//   S'_ij = S_ij w_j + v_i k_j,   w = exp(max(-exp(w_raw), floor))
// over a sequence, from the states saved by K8 at every 16-step chunk.
//
// The Pallas kernel differentiates the chunk's matrix form, with exp(+-g)
// factors of the cumulative log decay. Here the design is the per-step
// adjoint, which has no such factors and never divides by w (which can be
// e^-5 or less). With dS' the cotangent of the state after step t:
//   dv_i  = sum_j dS'_ij k_j + bonus dy_i                      (row sum)
//   dr_j  = sum_i S_ij dy_i + u_j k_j (dy . v)                 (column sums)
//   dk_j  = sum_i dS'_ij v_i + u_j r_j (dy . v)
//   dw_raw_j = w_j (sum_i dS'_ij S_ij) (-exp(w_raw_j)), or 0 where the floor binds
//   du_j += k_j r_j (dy . v)
//   dS_ij = dS'_ij w_j + dy_i r_j
// Rows and columns of dS evolve on their own (the update is elementwise plus
// an outer product), so the block keeps dS twice, in two thread roles: 64
// "row" threads (thread i holds row i; they produce dv) and 64 "column"
// threads (thread j holds column j; they produce dr, dk, dw_raw and du). Every
// sum is local to a thread and a step needs no exchange at all; the two
// scalars a step shares (bonus and dy . v) are reduced by warp shuffles when
// the chunk's streams are staged. The column threads need the state before
// each step: the row threads recompute it from the chunk's saved state (read
// coalesced from Z = S^T, one state row a thread) and park it in shared
// memory in a [j][i] layout padded to 65 floats a row, so that the row
// threads' stores and the column threads' loads are both free of bank
// conflicts. Sixteen fp32 states (256 KiB) do not fit, so a chunk is done in
// two halves of eight steps (130 KiB); the first half's recompute runs
// through the second half's steps again (22 forward steps per 16). du is
// summed per (b, h) in a register and added over the batch by the wrapper;
// no atomics. All arithmetic is fp32; outputs are cast to the stream type at
// the store. Dynamic shared memory: 158,080 bytes.
//
// Bound on the H100: like K7 the T steps are dependent and there are only
// B*H blocks, so the kernel is bound by latency, far above both its byte
// bound (10 streams + the saved states) and its fp32 operation bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 64;
constexpr int CHUNK = 16;        // steps between saved states
constexpr int HALF = 8;          // steps whose states are parked at once
constexpr int SP = N + 1;        // padded row of a parked state
constexpr int THREADS = 2 * N;   // 64 row threads + 64 column threads
constexpr int ST_FLOATS = HALF * N * SP;
constexpr int VEC = CHUNK * N;   // one stream over a chunk
constexpr int N_VEC = 6;         // r, w, d log w / d w_raw, k, v, dy
constexpr int SMEM_FLOATS = ST_FLOATS + N_VEC * VEC + 2 * CHUNK + N;
constexpr size_t SMEM_BYTES = (size_t)SMEM_FLOATS * sizeof(float);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) wkv6_bwd_kernel(
    int Tlen, int H, float wfloor, const T* __restrict__ r, const T* __restrict__ w,
    const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ u,
    const float* __restrict__ zin, const T* __restrict__ dy, const float* __restrict__ dsf,
    T* __restrict__ dr, T* __restrict__ dw, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ du, float* __restrict__ ds0) {
  extern __shared__ __align__(16) float smem[];
  float* st = smem;               // [HALF][N (j)][SP (i)]: state before a step
  float* vr = st + ST_FLOATS;     // [CHUNK][N] each
  float* vw = vr + VEC;           // decay exp(max(-exp(w_raw), floor))
  float* vsc = vw + VEC;          // d log w / d w_raw: -exp(w_raw), 0 where the floor binds
  float* vk = vsc + VEC;
  float* vv = vk + VEC;
  float* vdy = vv + VEC;
  float* vbonus = vdy + VEC;      // [CHUNK]: sum_j u_j k_j r_j
  float* vdyv = vbonus + CHUNK;   // [CHUNK]: dy . v
  float* su = vdyv + CHUNK;       // [N]: this head's u

  const int bh = blockIdx.x;
  const int bb = bh / H, hh = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool row = tid < N;
  const int x = tid & (N - 1);    // row i (row threads) or column j (column threads)
  const int nc = Tlen / CHUNK;
  if (row) su[x] = u[(size_t)hh * N + x];

  float dS[N];  // row thread: dS[x][.]; column thread: dS[.][x]
  float S[N];   // row threads only: the state row during the recompute
  if (row) {
    const float4* p = reinterpret_cast<const float4*>(dsf + ((size_t)bh * N + x) * N);
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 q = p[j];
      dS[4 * j] = q.x;
      dS[4 * j + 1] = q.y;
      dS[4 * j + 2] = q.z;
      dS[4 * j + 3] = q.w;
    }
  } else {
    const float* p = dsf + (size_t)bh * N * N + x;
#pragma unroll
    for (int i = 0; i < N; ++i) dS[i] = p[(size_t)i * N];
  }
#pragma unroll
  for (int j = 0; j < N; ++j) S[j] = 0.f;
  float du_acc = 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    // the chunk's streams into shared memory (the previous chunk ended on a barrier)
    const size_t chunk_off = (((size_t)bb * Tlen + (size_t)c * CHUNK) * H + hh) * N;
    for (int idx = tid; idx < VEC; idx += THREADS) {
      const size_t off = chunk_off + (size_t)(idx >> 6) * H * N + (idx & (N - 1));
      const float lw = -expf(to_f(w[off]));
      vr[idx] = to_f(r[off]);
      vw[idx] = expf(fmaxf(lw, wfloor));
      vsc[idx] = lw > wfloor ? lw : 0.f;
      vk[idx] = to_f(k[off]);
      vv[idx] = to_f(v[off]);
      vdy[idx] = to_f(dy[off]);
    }
    __syncthreads();
    // the two scalars of each step, one warp a step at a time
    for (int t = warp; t < CHUNK; t += THREADS / 32) {
      const int a = t * N + lane, b = a + 32;
      const float bo = warp_sum(su[lane] * vk[a] * vr[a] + su[lane + 32] * vk[b] * vr[b]);
      const float q = warp_sum(vdy[a] * vv[a] + vdy[b] * vv[b]);
      if (lane == 0) {
        vbonus[t] = bo;
        vdyv[t] = q;
      }
    }

    for (int half = CHUNK / HALF - 1; half >= 0; --half) {
      const int t0 = half * HALF;
      if (row) {
        // recompute the states before steps t0 .. t0 + HALF - 1 from the saved one
        const float* z = zin + ((size_t)bh * nc + c) * N * N + x;  // Z[j][x] = S[x][j]
#pragma unroll
        for (int j = 0; j < N; ++j) S[j] = z[(size_t)j * N];
        for (int t = 0; t < t0 + HALF; ++t) {
          if (t >= t0) {
            float* dst = st + (t - t0) * N * SP + x;
#pragma unroll
            for (int j = 0; j < N; ++j) dst[j * SP] = S[j];
          }
          if (t + 1 < t0 + HALF) {
            const float* pw = vw + t * N;
            const float* pk = vk + t * N;
            const float vi = vv[t * N + x];
#pragma unroll
            for (int j = 0; j < N; ++j) S[j] = fmaf(S[j], pw[j], vi * pk[j]);
          }
        }
      }
      __syncthreads();  // parked states, bonus and dy . v are complete

      for (int t = t0 + HALF - 1; t >= t0; --t) {
        const float* pr = vr + t * N;
        const float* pw = vw + t * N;
        const float* pk = vk + t * N;
        const float* pv = vv + t * N;
        const float* pdy = vdy + t * N;
        const size_t off = chunk_off + (size_t)t * H * N + x;
        if (row) {
          const float dyi = pdy[x];
          float dvi = 0.f;
#pragma unroll
          for (int j = 0; j < N; ++j) {
            dvi = fmaf(dS[j], pk[j], dvi);
            dS[j] = fmaf(dS[j], pw[j], dyi * pr[j]);
          }
          dv[off] = from_f<T>(fmaf(vbonus[t], dyi, dvi));
        } else {
          const float* sp = st + (t - t0) * N * SP + x * SP;  // column x of the state before step t
          const float rj = pr[x], wj = pw[x], kj = pk[x], uj = su[x];
          float a_dr = 0.f, a_dk = 0.f, a_dw = 0.f;
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float si = sp[i], d = dS[i], dyi = pdy[i];
            a_dr = fmaf(si, dyi, a_dr);
            a_dk = fmaf(d, pv[i], a_dk);
            a_dw = fmaf(d, si, a_dw);
            dS[i] = fmaf(d, wj, dyi * rj);
          }
          const float q = vdyv[t];
          dr[off] = from_f<T>(fmaf(uj * kj, q, a_dr));
          dk[off] = from_f<T>(fmaf(uj * rj, q, a_dk));
          dw[off] = from_f<T>(a_dw * wj * vsc[t * N + x]);
          du_acc = fmaf(kj * rj, q, du_acc);
        }
      }
      __syncthreads();  // the parked states and the streams may be overwritten now
    }
  }

  if (row) {
    float4* out = reinterpret_cast<float4*>(ds0 + ((size_t)bh * N + x) * N);
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      out[j] = make_float4(dS[4 * j], dS[4 * j + 1], dS[4 * j + 2], dS[4 * j + 3]);
  } else {
    du[(size_t)bh * N + x] = du_acc;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Streams and dy [B, T, H, 64] in one dtype, T a multiple of 16; u fp32
// [H, 64]; zin fp32 [B*H, T/16, 64, 64] as K8 wrote it; dsf (cotangent of
// the final state) and ds0 (of the initial state) fp32 [B, H, 64, 64]; du
// fp32 [B*H, 64] (per (b, h), summed over B by the caller); wfloor =
// -80 / chunk_len.
int wkv6_bwd(int dtype, int B, int T, int H, int n, float wfloor, const void* r, const void* w,
             const void* k, const void* v, const void* u, const void* zin, const void* dy,
             const void* dsf, void* dr, void* dw, void* dk, void* dv, void* du, void* ds0,
             void* stream) {
  if (n != N || B <= 0 || H <= 0 || T <= 0 || T % CHUNK != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B * H), block(THREADS);
  const float* uf = (const float*)u;
  cudaError_t err;
  if (dtype == 0) {
    auto kern = wkv6_bwd_kernel<float>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, block, SMEM_BYTES, st>>>(
        T, H, wfloor, (const float*)r, (const float*)w, (const float*)k, (const float*)v, uf,
        (const float*)zin, (const float*)dy, (const float*)dsf, (float*)dr, (float*)dw,
        (float*)dk, (float*)dv, (float*)du, (float*)ds0);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    auto kern = wkv6_bwd_kernel<bf>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, block, SMEM_BYTES, st>>>(
        T, H, wfloor, (const bf*)r, (const bf*)w, (const bf*)k, (const bf*)v, uf,
        (const float*)zin, (const bf*)dy, (const float*)dsf, (bf*)dr, (bf*)dw, (bf*)dk, (bf*)dv,
        (float*)du, (float*)ds0);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
