// RWKV-7 ("x070") WKV backward on Hopper (K6). Plain C interface, loaded with
// ctypes by visualrwkv_torch/ops/wkv7_cuda.py.
//
// K6 wkv7_bwd replaces visualrwkv_tpu/ops/wkv7_pallas.py::wkv7_pallas_bwd
// (_wkv7_bwd_kernel / _wkv7_bwd_math): the vector-Jacobian product of
//   sa_i = sum_j S_ij a_j
//   S'_ij = S_ij w_j + sa_i b_j + v_i k_j        (w = exp(-exp(w_raw)))
//   y_i  = sum_j S'_ij r_j
// over a sequence, from the states saved by K5 at every 16-step chunk.
//
// The Pallas kernel differentiates the chunk's matrix form (two triangular
// solves and about twenty small matmuls a chunk), which suits a matrix unit
// and whose exp(-g) factors need the 16-step stability envelope. Here the
// design is the per-step adjoint, which has no such factors:
//   dS'  += dy r^T
//   dr_j  = sum_i S'_ij dy_i = w_j sum_i S_ij dy_i + b_j (sa . dy) + k_j (v . dy)
//   dw_j  = sum_i dS'_ij S_ij      db_j = sum_i dS'_ij sa_i    dk_j = sum_i dS'_ij v_i
//   dv_i  = sum_j dS'_ij k_j       dsa_i = sum_j dS'_ij b_j
//   da_j  = sum_i S_ij dsa_i
//   dS_ij = dS'_ij w_j + dsa_i a_j
//   dw_raw_j = dw_j * w_j * (-exp(w_raw_j))
// so each step needs only the state S before it, never the one after.
//
// One block of 128 threads per (b, h), walking the chunks in reverse with the
// state cotangent carried in registers. The step needs sums along rows (dv,
// dsa) and along columns (dr, dw, db, dk, da) of 64x64 matrices, so the block
// keeps dS twice: warps 0-1 ("row" threads, thread i holds row i) and warps
// 2-3 ("column" threads, thread j holds column j). Every sum is then local
// to a thread; the only exchange a step is the 64-vector dsa, through shared
// memory, with one barrier. The states before each step are recomputed by the
// row threads from the chunk's saved state (read coalesced from Z = S^T) and
// parked in shared memory for the column threads, in a [j][i] layout padded to
// 65 floats a row so that the row threads' stores and the column threads'
// loads are both free of bank conflicts. Sixteen fp32 states are 260 KiB, more
// than a block may hold, so a chunk is done in two halves of eight steps
// (130 KiB); the first half's recompute runs through the second half's steps
// again (24 forward steps per 16). All arithmetic is fp32; outputs are cast to
// the stream type at the store. Dynamic shared memory: 170,496 bytes.
//
// Bound on the H100: like K1 the T steps are dependent and there are only B*H
// blocks, so the kernel is bound by latency, far above both the byte bound
// (14 streams + the saved states) and the fp32 operation bound.

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
constexpr int N_VEC = 9;         // r, w, exp(w_raw), k, v, a, b, dy, sa
constexpr int SMEM_FLOATS = ST_FLOATS + N_VEC * VEC + 2 * N;
constexpr size_t SMEM_BYTES = (size_t)SMEM_FLOATS * sizeof(float);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) wkv7_bwd_kernel(
    int Tlen, int H, const T* __restrict__ r, const T* __restrict__ w,
    const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ a,
    const T* __restrict__ b, const float* __restrict__ zin, const T* __restrict__ dy,
    const float* __restrict__ dsf, T* __restrict__ dr, T* __restrict__ dw,
    T* __restrict__ dk, T* __restrict__ dv, T* __restrict__ da, T* __restrict__ db,
    float* __restrict__ ds0) {
  extern __shared__ __align__(16) float smem[];
  float* st = smem;               // [HALF][N (j)][SP (i)]: state before a step
  float* vr = st + ST_FLOATS;     // [CHUNK][N] each
  float* vw = vr + VEC;           // decay exp(-exp(w_raw))
  float* vew = vw + VEC;          // exp(w_raw)
  float* vk = vew + VEC;
  float* vv = vk + VEC;
  float* va = vv + VEC;
  float* vb = va + VEC;
  float* vdy = vb + VEC;
  float* vsa = vdy + VEC;         // sa of each step (from the recompute)
  float* vdsa = vsa + VEC;        // [2][N], by step parity

  const int bh = blockIdx.x;
  const int bb = bh / H, hh = bh % H;
  const int tid = threadIdx.x;
  const bool row = tid < N;
  const int x = tid & (N - 1);    // row i (row threads) or column j (column threads)
  const int nc = Tlen / CHUNK;

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

  for (int c = nc - 1; c >= 0; --c) {
    // the chunk's streams into shared memory (the previous chunk ended on a barrier)
    const size_t chunk_off = (((size_t)bb * Tlen + (size_t)c * CHUNK) * H + hh) * N;
    for (int idx = tid; idx < VEC; idx += THREADS) {
      const size_t off = chunk_off + (size_t)(idx >> 6) * H * N + (idx & (N - 1));
      const float ew = expf(to_f(w[off]));
      vr[idx] = to_f(r[off]);
      vew[idx] = ew;
      vw[idx] = expf(-ew);
      vk[idx] = to_f(k[off]);
      vv[idx] = to_f(v[off]);
      va[idx] = to_f(a[off]);
      vb[idx] = to_f(b[off]);
      vdy[idx] = to_f(dy[off]);
    }
    __syncthreads();

    for (int half = CHUNK / HALF - 1; half >= 0; --half) {
      const int t0 = half * HALF;
      if (row) {
        // recompute the states before steps t0 .. t0 + HALF - 1 from the saved one
        const float* z = zin + ((size_t)bh * nc + c) * N * N + x;  // Z[j][x] = S[x][j]
#pragma unroll
        for (int j = 0; j < N; ++j) S[j] = z[(size_t)j * N];
        for (int t = 0; t < t0 + HALF; ++t) {
          const float* pa = va + t * N;
          if (t >= t0) {
            float* dst = st + (t - t0) * N * SP + x;
#pragma unroll
            for (int j = 0; j < N; ++j) dst[j * SP] = S[j];
          }
          float sai = 0.f;
#pragma unroll
          for (int j = 0; j < N; ++j) sai = fmaf(S[j], pa[j], sai);
          if (t >= t0) vsa[t * N + x] = sai;
          if (t + 1 < t0 + HALF) {
            const float* pw = vw + t * N;
            const float* pb = vb + t * N;
            const float* pk = vk + t * N;
            const float vi = vv[t * N + x];
#pragma unroll
            for (int j = 0; j < N; ++j) S[j] = fmaf(S[j], pw[j], fmaf(sai, pb[j], vi * pk[j]));
          }
        }
      }
      __syncthreads();

      for (int t = t0 + HALF - 1; t >= t0; --t) {
        const float* pr = vr + t * N;
        const float* pw = vw + t * N;
        const float* pk = vk + t * N;
        const float* pv = vv + t * N;
        const float* pa = va + t * N;
        const float* pb = vb + t * N;
        const float* pdy = vdy + t * N;
        const float* psa = vsa + t * N;
        const float* sp = st + (t - t0) * N * SP + x * SP;  // column x of the state before step t
        float* dsa = vdsa + (t & 1) * N;
        const size_t off = chunk_off + (size_t)t * H * N + x;
        float o_dr = 0.f, o_dw = 0.f, o_dk = 0.f, o_db = 0.f;
        if (row) {
          const float dyi = pdy[x];
          float dvi = 0.f, dsai = 0.f;
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const float d = fmaf(dyi, pr[j], dS[j]);
            dvi = fmaf(d, pk[j], dvi);
            dsai = fmaf(d, pb[j], dsai);
            dS[j] = d;
          }
          dsa[x] = dsai;
#pragma unroll
          for (int j = 0; j < N; ++j) dS[j] = fmaf(dS[j], pw[j], dsai * pa[j]);
          dv[off] = from_f<T>(dvi);
        } else {
          const float rj = pr[x];
          float dwj = 0.f, dbj = 0.f, dkj = 0.f, pj = 0.f, q1 = 0.f, q2 = 0.f;
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float dyi = pdy[i], si = sp[i], sai = psa[i], vi = pv[i];
            const float d = fmaf(dyi, rj, dS[i]);
            dS[i] = d;
            dwj = fmaf(d, si, dwj);
            dbj = fmaf(d, sai, dbj);
            dkj = fmaf(d, vi, dkj);
            pj = fmaf(si, dyi, pj);
            q1 = fmaf(sai, dyi, q1);
            q2 = fmaf(vi, dyi, q2);
          }
          o_dr = fmaf(pw[x], pj, fmaf(pb[x], q1, pk[x] * q2));
          o_dw = -dwj * pw[x] * vew[t * N + x];
          o_dk = dkj;
          o_db = dbj;
        }
        __syncthreads();  // dsa of this step is complete
        if (!row) {
          const float wj = pw[x], aj = pa[x];
          float daj = 0.f;
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float dsai = dsa[i];
            daj = fmaf(sp[i], dsai, daj);
            dS[i] = fmaf(dS[i], wj, dsai * aj);
          }
          dr[off] = from_f<T>(o_dr);
          dw[off] = from_f<T>(o_dw);
          dk[off] = from_f<T>(o_dk);
          db[off] = from_f<T>(o_db);
          da[off] = from_f<T>(daj);
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
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Streams and dy [B, T, H, 64] in one dtype, T a multiple of 16; zin fp32
// [B*H, T/16, 64, 64] as K5 wrote it; dsf (cotangent of the final state) and
// ds0 (of the initial state) fp32 [B, H, 64, 64].
int wkv7_bwd(int dtype, int B, int T, int H, int n, const void* r, const void* w,
             const void* k, const void* v, const void* a, const void* b, const void* zin,
             const void* dy, const void* dsf, void* dr, void* dw, void* dk, void* dv,
             void* da, void* db, void* ds0, void* stream) {
  if (n != N || B <= 0 || H <= 0 || T <= 0 || T % CHUNK != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B * H), block(THREADS);
  cudaError_t err;
  if (dtype == 0) {
    auto kern = wkv7_bwd_kernel<float>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, block, SMEM_BYTES, st>>>(
        T, H, (const float*)r, (const float*)w, (const float*)k, (const float*)v,
        (const float*)a, (const float*)b, (const float*)zin, (const float*)dy,
        (const float*)dsf, (float*)dr, (float*)dw, (float*)dk, (float*)dv, (float*)da,
        (float*)db, (float*)ds0);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    auto kern = wkv7_bwd_kernel<bf>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, block, SMEM_BYTES, st>>>(
        T, H, (const bf*)r, (const bf*)w, (const bf*)k, (const bf*)v, (const bf*)a,
        (const bf*)b, (const float*)zin, (const bf*)dy,
        (const float*)dsf, (bf*)dr, (bf*)dw, (bf*)dk, (bf*)dv, (bf*)da, (bf*)db, (float*)ds0);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
