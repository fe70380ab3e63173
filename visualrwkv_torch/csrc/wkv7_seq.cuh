// The sequential RWKV-7 ("x070") recurrence on Hopper, shared by the kernels
// of wkv7.cu (K1), wkv7_train.cu (K6) and wkv7_packed.cu (K11, K13). The
// training forwards K5 and K12, which save the chunk states, are the chunked
// form of wkv7_chunk.cuh. Device code and launch helpers only; each .cu file
// defines its own plain C entry points.
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
// wkv7_bwd_kernel<T, ZHEADS> is the vector-Jacobian product (K6; K13 reads
// the packed zin with ZHEADS = 2):
//   dS'  += dy r^T
//   dr_j  = w_j sum_i S_ij dy_i + b_j (sa . dy) + k_j (v . dy)
//   dw_j  = sum_i dS'_ij S_ij      db_j = sum_i dS'_ij sa_i    dk_j = sum_i dS'_ij v_i
//   dv_i  = sum_j dS'_ij k_j       dsa_i = sum_j dS'_ij b_j
//   da_j  = sum_i S_ij dsa_i
//   dS_ij = dS'_ij w_j + dsa_i a_j
//   dw_raw_j = dw_j * w_j * (-exp(w_raw_j))
// so each step needs only the state S before it, never the one after (zin
// holds it at every 16th step: zin[bh / ZHEADS, c, j, (bh % ZHEADS) 64 + i]
// = S[i, j], as K5 / K12 write it). One
// block of 128 threads per (b, h), walking the chunks in reverse with the
// state cotangent carried in registers. The step needs sums along rows (dv,
// dsa) and along columns (dr, dw, db, dk, da) of 64x64 matrices, so the block
// keeps dS twice: warps 0-1 ("row" threads, thread i holds row i) and warps
// 2-3 ("column" threads, thread j holds column j). Every sum is then local
// to a thread; the only exchange a step is the 64-vector dsa, through shared
// memory, with one barrier. The states before each step are recomputed by the
// row threads from the chunk's saved state (read coalesced from zin) and
// parked in shared memory for the column threads, in a [j][i] layout padded to
// 65 floats a row so that the row threads' stores and the column threads'
// loads are both free of bank conflicts. Sixteen fp32 states are 260 KiB, more
// than a block may hold, so a chunk is done in two halves of eight steps
// (130 KiB); the first half's recompute runs through the second half's steps
// again (24 forward steps per 16). All arithmetic is fp32; outputs are cast to
// the stream type at the store. Dynamic shared memory: 170,496 bytes.
//
// Bound on the H100: the T steps are dependent and there are only B*H (or
// B*H/2) blocks, so these kernels are latency-bound, far from both the byte
// bound (the streams and the saved states) and the fp32 operation bound.

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

// ---------------------------------------------------------------------------
// Backward. zin as wkv7_fwd_res_kernel<DT, ROWS, ZHEADS> (wkv7_chunk.cuh) wrote it.
// ---------------------------------------------------------------------------
constexpr int HALF = 8;          // steps whose states are parked at once
constexpr int SP = N + 1;        // padded row of a parked state
constexpr int BWD_THREADS = 2 * N;  // 64 row threads + 64 column threads
constexpr int ST_FLOATS = HALF * N * SP;
constexpr int VEC = CHUNK * N;   // one stream over a chunk
constexpr int N_VEC = 9;         // r, w, exp(w_raw), k, v, a, b, dy, sa
constexpr int SMEM_FLOATS = ST_FLOATS + N_VEC * VEC + 2 * N;
constexpr size_t SMEM_BYTES = (size_t)SMEM_FLOATS * sizeof(float);

template <typename T, int ZHEADS>
__global__ void __launch_bounds__(BWD_THREADS) wkv7_bwd_kernel(
    int Tlen, int H, const T* __restrict__ r, const T* __restrict__ w,
    const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ a,
    const T* __restrict__ b, const float* __restrict__ zin, const T* __restrict__ dy,
    const float* __restrict__ dsf, T* __restrict__ dr, T* __restrict__ dw,
    T* __restrict__ dk, T* __restrict__ dv, T* __restrict__ da, T* __restrict__ db,
    float* __restrict__ ds0, int zrow) {
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
  // this head's saved states: zin[bh / ZHEADS, c, j, (bh % ZHEADS) * N + i].
  // The row stride zrow (= ZHEADS * N) comes in at run time: with it a
  // compile-time constant, ptxas gave this kernel 254 registers and a 96-byte
  // spill with ZHEADS = 2 (168 and a 16-byte spill with 1), and K13 ran 5.1 ms
  // where K6 ran 3.8 (B=2 T=2048 H=32, H100 80GB HBM3 at 700 W, chip_smoke.py).
  const float* zhead = zin + (size_t)(bh / ZHEADS) * nc * N * zrow + (bh % ZHEADS) * N + x;

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
    for (int idx = tid; idx < VEC; idx += BWD_THREADS) {
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
        const float* z = zhead + (size_t)c * N * zrow;  // z[j * zrow] = S[x][j]
#pragma unroll
        for (int j = 0; j < N; ++j) S[j] = z[(size_t)j * zrow];
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

template <int ZHEADS>
int launch_bwd(int dtype, int B, int T, int H, int n, const void* r, const void* w,
               const void* k, const void* v, const void* a, const void* b, const void* zin,
               const void* dy, const void* dsf, void* dr, void* dw, void* dk, void* dv,
               void* da, void* db, void* ds0, void* stream) {
  if (n != N || B <= 0 || H <= 0 || H % ZHEADS != 0 || T <= 0 || T % CHUNK != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B * H), block(BWD_THREADS);
  cudaError_t err;
  if (dtype == 0) {
    auto kern = wkv7_bwd_kernel<float, ZHEADS>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, block, SMEM_BYTES, st>>>(
        T, H, (const float*)r, (const float*)w, (const float*)k, (const float*)v,
        (const float*)a, (const float*)b, (const float*)zin, (const float*)dy,
        (const float*)dsf, (float*)dr, (float*)dw, (float*)dk, (float*)dv, (float*)da,
        (float*)db, (float*)ds0, ZHEADS * N);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    auto kern = wkv7_bwd_kernel<bf, ZHEADS>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, block, SMEM_BYTES, st>>>(
        T, H, (const bf*)r, (const bf*)w, (const bf*)k, (const bf*)v, (const bf*)a,
        (const bf*)b, (const float*)zin, (const bf*)dy,
        (const float*)dsf, (bf*)dr, (bf*)dw, (bf*)dk, (bf*)dv, (bf*)da, (bf*)db, (float*)ds0,
        ZHEADS * N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace
