// One token of the WKV recurrence on Hopper, one body for three kernels: the
// RWKV-7 ("x070") decode steps K2 wkv7_step (head layout) and K4
// wkv7_step_flat (flat layout), included by wkv7.cu, and the RWKV-6
// ("x060") decode step K10 wkv6_step, included by wkv6.cu. Device code and
// launchers only; each .cu file defines its own entry points.
//
// Per (batch, head), state S [Nv, Nk] = [64, 64] fp32 or bf16, vectors fp32
// [64], all math fp32 and the new state rounded once to the state's dtype:
//   FAM 7 (K2 / K4): S' = S diag(w) + (S a) b^T + v k^T,  y = S' r
//   FAM 6 (K10):     y = S r + (sum_j u_j k_j r_j) v,  S' = S diag(w) + v k^T
// with w = exp(-exp(w_raw)) and no decay floor; u is the RWKV-6 bonus, fp32
// [H, 64]. K10 reads y from the OLD state, K2 from the new one: the two
// families differ only there and in the (S a) b^T term.
//
// Bound. Bytes: the state read once and written once (16 KiB a head fp32,
// 8 KiB bf16) against 5-9 fp32 operations an element: 0.00033 ms at B=1
// H=32 fp32 (K2), 0.00066 ms at B=1 H=64 (K10). At the serving batch B=1
// the kernel cannot get near that: it is one launch (the floor of an empty
// kernel on the same grid, csrc/launch_floor.cu) and one trip to device
// memory, for in decode the other layers' weights have flushed a layer's
// state out of L2 before it is read again. The design aims at those two.
//
// Design.
// - Grid (b, h, slice of ROWS value rows). Every value row evolves on its
//   own (the transition acts on S from the right), so the row sums stay
//   inside a block and nothing is reduced across blocks. The wrapper
//   (ops/wkv7_cuda.py::step_plan, ops/wkv6_cuda.py::step_plan) picks the
//   most rows that still give about a block for each of the 132
//   multiprocessors, at most 256 threads a block: 16 rows (128 blocks) for
//   K2 at B=1 H=32, 32 rows (128 blocks) for K10 at B=1 H=64; with more
//   heads, 32 rows for an fp32 state and whole heads for bf16; K4 with an
//   fp32 state 8 rows at every batch, which read fastest with rows H*256
//   bytes apart. (A block a head would leave 100 of the 132 multiprocessors
//   idle at K2's B=1, 68 at K10's.)
// - 16-byte accesses. A lane holds CPL = 4 (fp32) or 8 (bf16) adjacent
//   columns of a row, so a row is LPR = 16 or 8 lanes, a warp covers 2 or 4
//   rows an instruction, and each row sum is 4 or 3 shuffle levels over the
//   row's lanes. A thread owns PARTS adjacent rows, one, or two once the
//   block would have more than 256 threads: its v is one vector load, and
//   the first lane of a row group stores the group's y as one vector.
// - One trip to memory. Each thread issues all its state loads, then the
//   vector loads, before any sum, so the block's whole slice is in flight at
//   once. w is formed once for the thread's columns, for all its rows.
// - K10's bonus sum_j u_j k_j r_j is a partial sum over the thread's
//   columns, reduced by the same shuffles as its rows' y (one more value a
//   level), and y comes from the old state, so the row sum and the update
//   read the same registers.
// Measured against this on the H100 (chip_variants.py --wkv7step): a bulk
// asynchronous copy of the slice into shared memory (cp.async.bulk on an
// mbarrier) wins nowhere for K2 and loses up to 60 % for K4 (a copy a
// row); 8-byte accesses win nowhere consistently; whole fp32 heads were
// slower at B=32 (four rows a thread 19 %, 512 threads 3 %). At B=1 the
// step takes about 0.6 us over the launch floor of an empty kernel on its
// grid.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_tiles.cuh"

namespace {
namespace step {

constexpr int N = 64;              // head size
constexpr int STEP_VEC = 16;       // bytes of state a lane loads or stores at once
constexpr int STEP_THREADS = 256;  // threads a block, past which a thread takes two rows

template <int DT>
using StepState = std::conditional_t<DT == 1, __nv_bfloat16, float>;

template <int DT>
struct StepShape {
  static constexpr int W = STEP_VEC / 4;                    // 32-bit words of a lane's access
  static constexpr int CPL = STEP_VEC / (DT == 1 ? 2 : 4);  // columns a lane
  static constexpr int LPR = N / CPL;                       // lanes a row
};

// rows a thread (one, or two once the block's rows take more than
// STEP_THREADS lanes) and threads a block
template <int DT, int ROWS>
__host__ __device__ constexpr int step_parts() {
  return ROWS * StepShape<DT>::LPR > STEP_THREADS ? 2 : 1;
}
template <int DT, int ROWS>
__host__ __device__ constexpr int step_threads() {
  return ROWS * StepShape<DT>::LPR / step_parts<DT, ROWS>();
}

template <int W>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&u)[W]) {
  static_assert(W == 4 || W == 2, "a lane's access is 16 or 8 bytes");
  if constexpr (W == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    u[0] = q.x, u[1] = q.y, u[2] = q.z, u[3] = q.w;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    u[0] = q.x, u[1] = q.y;
  }
}

template <int W>
__device__ __forceinline__ void store_words(void* p, const uint32_t (&u)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
  }
}

// M fp32 values at p (16-byte aligned for M a multiple of 4, else 4 M bytes)
template <int M>
__device__ __forceinline__ void load_f(const float* p, float (&x)[M]) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int q = 0; q < M / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      x[4 * q] = t.x, x[4 * q + 1] = t.y, x[4 * q + 2] = t.z, x[4 * q + 3] = t.w;
    }
  } else if constexpr (M == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
    static_assert(M == 1, "1, 2 or a multiple of 4 values");
    x[0] = *p;
  }
}

template <int M>
__device__ __forceinline__ void store_f(float* p, const float (&x)[M]) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int q = 0; q < M / 4; ++q)
      reinterpret_cast<float4*>(p)[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  } else if constexpr (M == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// the state's words as fp32 columns, and back (bf16: the lower column in the low half)
template <int DT, int W>
__device__ __forceinline__ void unpack(const uint32_t (&u)[W], float (&s)[StepShape<DT>::CPL]) {
#pragma unroll
  for (int e = 0; e < W; ++e) {
    if constexpr (DT == 1) {
      s[2 * e] = hopper::bf16_lo(u[e]);
      s[2 * e + 1] = hopper::bf16_hi(u[e]);
    } else {
      s[e] = __uint_as_float(u[e]);
    }
  }
}

template <int DT, int W>
__device__ __forceinline__ void pack(const float (&s)[StepShape<DT>::CPL], uint32_t (&u)[W]) {
#pragma unroll
  for (int e = 0; e < W; ++e) {
    if constexpr (DT == 1) {
      u[e] = hopper::pack_bf16(s[2 * e], s[2 * e + 1]);
    } else {
      u[e] = __float_as_uint(s[e]);
    }
  }
}

// sum over the LPR adjacent lanes of a row (xor shuffles stay inside the row's lanes)
template <int LPR, int M>
__device__ __forceinline__ void row_sums(float (&x)[M]) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int p = 0; p < M; ++p) x[p] += __shfl_xor_sync(0xffffffffu, x[p], o);
  }
}

// Block (bh, slice): value rows row0 .. row0 + ROWS of head bh. Thread t
// holds columns CPL (t % LPR) .. + CPL of rows row0 + PARTS (t / LPR) .. +
// PARTS. FAM 7 reads a and b (u unused), FAM 6 reads u (a and b unused).
template <int FAM, int DT, int FLAT, int ROWS>
__global__ void __launch_bounds__(step_threads<DT, ROWS>()) wkv_step_kernel(
    int H, const StepState<DT>* __restrict__ s_in, const float* __restrict__ r,
    const float* __restrict__ w, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ a, const float* __restrict__ b, const float* __restrict__ u6,
    StepState<DT>* __restrict__ s_out, float* __restrict__ y) {
  using Shape = StepShape<DT>;
  constexpr int W = Shape::W, CPL = Shape::CPL, LPR = Shape::LPR;
  constexpr int PARTS = step_parts<DT, ROWS>();
  static_assert(FAM == 6 || FAM == 7, "RWKV-6 or RWKV-7");
  static_assert(N % ROWS == 0 && step_threads<DT, ROWS>() % 32 == 0 && step_threads<DT, ROWS>() <= 1024,
                "rows a block");
  constexpr int SLICES = N / ROWS;
  const int bh = blockIdx.x / SLICES;
  const int c = threadIdx.x % LPR, i0 = (blockIdx.x % SLICES) * ROWS + (threadIdx.x / LPR) * PARTS;
  const int j0 = c * CPL;
  const size_t vo = (size_t)bh * N;
  // row i of this head's state starts at base + i * row_stride
  const size_t base = FLAT ? ((size_t)(bh / H) * N * H + bh % H) * N : vo * N;
  const size_t row_stride = FLAT ? (size_t)H * N : N;

  uint32_t u[PARTS][W];
#pragma unroll
  for (int p = 0; p < PARTS; ++p) load_words<W>(s_in + base + (i0 + p) * row_stride + j0, u[p]);
  float rr[CPL], ww[CPL], kk[CPL], vv[PARTS];
  load_f<CPL>(r + vo + j0, rr);
  load_f<CPL>(w + vo + j0, ww);
  load_f<CPL>(k + vo + j0, kk);
  float s[PARTS][CPL];
  if constexpr (FAM == 7) {
    float aa[CPL], bb[CPL];
    load_f<CPL>(a + vo + j0, aa);
    load_f<CPL>(b + vo + j0, bb);
    load_f<PARTS>(v + vo + i0, vv);
#pragma unroll
    for (int j = 0; j < CPL; ++j) ww[j] = expf(-expf(ww[j]));

    float sa[PARTS], yy[PARTS];
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      unpack<DT, W>(u[p], s[p]);
      sa[p] = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) sa[p] = fmaf(s[p][j], aa[j], sa[p]);
    }
    row_sums<LPR, PARTS>(sa);
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      yy[p] = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        s[p][j] = fmaf(s[p][j], ww[j], fmaf(sa[p], bb[j], vv[p] * kk[j]));
        yy[p] = fmaf(s[p][j], rr[j], yy[p]);
      }
      pack<DT, W>(s[p], u[p]);
      store_words<W>(s_out + base + (i0 + p) * row_stride + j0, u[p]);
    }
    row_sums<LPR, PARTS>(yy);
    if (c == 0) store_f<PARTS>(y + vo + i0, yy);
  } else {
    float uu[CPL];
    load_f<CPL>(u6 + (size_t)(bh % H) * N + j0, uu);
    load_f<PARTS>(v + vo + i0, vv);
#pragma unroll
    for (int j = 0; j < CPL; ++j) ww[j] = expf(-expf(ww[j]));

    // yy[p]: row p's partial S r from the old state; yy[PARTS]: the bonus's
    float yy[PARTS + 1];
    yy[PARTS] = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) yy[PARTS] = fmaf(uu[j] * kk[j], rr[j], yy[PARTS]);
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      unpack<DT, W>(u[p], s[p]);
      yy[p] = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        yy[p] = fmaf(s[p][j], rr[j], yy[p]);
        s[p][j] = fmaf(s[p][j], ww[j], vv[p] * kk[j]);
      }
      pack<DT, W>(s[p], u[p]);
      store_words<W>(s_out + base + (i0 + p) * row_stride + j0, u[p]);
    }
    row_sums<LPR, PARTS + 1>(yy);
    float out[PARTS];
#pragma unroll
    for (int p = 0; p < PARTS; ++p) out[p] = fmaf(yy[PARTS], vv[p], yy[p]);
    if (c == 0) store_f<PARTS>(y + vo + i0, out);
  }
}

template <int FAM, int DT, int FLAT, int ROWS>
int launch_step_rows(int B, int H, const void* s_in, const float* r, const float* w, const float* k,
                     const float* v, const float* a, const float* b, const float* u, void* s_out,
                     float* y, cudaStream_t st) {
  using TS = StepState<DT>;
  wkv_step_kernel<FAM, DT, FLAT, ROWS><<<B * H * (N / ROWS), step_threads<DT, ROWS>(), 0, st>>>(
      H, (const TS*)s_in, r, w, k, v, a, b, u, (TS*)s_out, y);
  return (int)cudaGetLastError();
}

template <int FAM, int DT, int FLAT>
int launch_step_dt(int rows, int B, int H, const void* s_in, const float* r, const float* w,
                   const float* k, const float* v, const float* a, const float* b, const float* u,
                   void* s_out, float* y, cudaStream_t st) {
  switch (rows) {
    case 8: return launch_step_rows<FAM, DT, FLAT, 8>(B, H, s_in, r, w, k, v, a, b, u, s_out, y, st);
    case 16: return launch_step_rows<FAM, DT, FLAT, 16>(B, H, s_in, r, w, k, v, a, b, u, s_out, y, st);
    case 32: return launch_step_rows<FAM, DT, FLAT, 32>(B, H, s_in, r, w, k, v, a, b, u, s_out, y, st);
    case 64: return launch_step_rows<FAM, DT, FLAT, 64>(B, H, s_in, r, w, k, v, a, b, u, s_out, y, st);
  }
  return (int)cudaErrorInvalidValue;
}

// state dtype codes: 0 = float32, 1 = bfloat16; rows = the value rows a block
// owns (8, 16, 32 or 64); every pointer 16-byte aligned
template <int FAM, int FLAT>
int launch_step(int state_dtype, int rows, int B, int H, int n, const void* s_in, const float* r,
                const float* w, const float* k, const float* v, const float* a, const float* b,
                const float* u, void* s_out, float* y, void* stream) {
  if (n != N || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (state_dtype == 0) return launch_step_dt<FAM, 0, FLAT>(rows, B, H, s_in, r, w, k, v, a, b, u, s_out, y, st);
  if (state_dtype == 1) return launch_step_dt<FAM, 1, FLAT>(rows, B, H, s_in, r, w, k, v, a, b, u, s_out, y, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace step
}  // namespace
