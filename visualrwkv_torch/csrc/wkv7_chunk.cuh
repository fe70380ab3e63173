// The chunked RWKV-7 ("x070") forward on Hopper, one kernel
// wkv7_fwd_res_kernel<DT, ROWS, ZHEADS, SAVE> behind four entry points: the
// prefill forward K1 wkv7_fwd (wkv7.cu) and its head-pair twin K11
// wkv7_fwd_packed (wkv7_packed.cu) with SAVE 0, the training forward K5
// wkv7_fwd_res (wkv7.cu) and its head-pair twin K12 wkv7_fwd_res_packed
// (wkv7_packed.cu) with SAVE 1. Also the constants and stream conversions of
// the backwards K6 and K13 (wkv7_chunk_bwd.cuh). Device code and the launch
// helper only; each .cu file defines its own plain C entry points.
//
// Recurrence per (batch, head), fp32 state S of shape [Nv, Nk] = [64, 64]:
//   sa_i = sum_j S_ij a_j
//   S_ij = S_ij * exp(-exp(w_raw_j)) + sa_i * b_j + v_i * k_j
//   y_i  = sum_j S_ij r_j
//
// It replaces visualrwkv_tpu/ops/wkv7_pallas.py::wkv7_pallas (K1),
// wkv7_pallas_packed (K11), wkv7_pallas_fwd_res (K5) and
// wkv7_pallas_fwd_res_packed (K12), and computes what they compute: y and
// the final state, and with SAVE the state entering every 16-step chunk,
//   ZHEADS = 1 (K5):  zin[bh, c, j, i]             = S_bh[i, j]
//   ZHEADS = 2 (K12): zin[bh / 2, c, j, (bh % 2) * 64 + i] = S_bh[i, j]
// before step 16c, fp32 (Z = S^T; K6 / K13 read it). ZHEADS changes only
// that address, so K11's outputs are bit-equal to K1's and K12's to K5's;
// it stays in K1 / K11's instantiations so that each is a kernel of its own
// in a profile. On the H100 a head pair needs no packing of the streams (the
// TPU kernels pack them for 128-lane rows): a pair's rows are adjacent in
// the [B, T, H, 64] streams already.
//
// Any T >= 0 without SAVE (the models give K1 / K11 a multiple of their
// chunk_len, which may be 8, 4 or 1): the steps t >= T of the last chunk are
// identity steps inside the kernel. Their rows load as zeros, their log
// decay is exactly 0 (not -exp(0)) and their y is not stored, so they add
// nothing to u, y or the state. T = 0 returns s0, or zeros without one. With
// SAVE, T is a positive multiple of 16 (the wrappers pad it with identity
// steps) and the tail mask is compiled out.
//
// The math is the Pallas kernel's chunk form (_wkv7_chunk_math, the "u
// form") at chunk 16. Inside a chunk, with g the inclusive running sum of
// the log decay -exp(w_raw) (in log2 units here), g_p = g - log w (the sum
// before the step), g_l = g at step 15, and z_i column i of Z (value row i
// of S):
//   rhs_i = Nm v_i + (a e^{g_p}) z_i
//   u_i   = (I - M)^{-1} rhs_i                     (forward substitution)
//   y_i   = (r e^{g}) z_i + sb u_i + sk v_i
//   z_i  <- e^{g_l} (.) z_i + (b e^{g_l - g})^T u_i + (k e^{g_l - g})^T v_i
// with the head's 16 x 16 matrices M = strict(a~ b^T), Nm = strict(a~ k^T),
// sb = incl(r~ b^T), sk = incl(r~ k^T), where a~_t b_s = sum_j a_tj
// e^{g_p,tj - g_sj} b_sj and so on. u_i[t] is S_{t-1} a_t, row i. Every
// value row evolves on its own (the transition diag(w) + a b^T acts on S
// from the right), so a block owns a slice of ROWS value rows of one (b, h):
// B*H*64/ROWS blocks, ROWS chosen by the wrapper (ops/wkv7_cuda.py::
// fwd_res_plan) so that the grid fills the card (32 rows, 128 blocks at
// B*H = 64; 16 rows at the B=1 prefill's B*H = 32, where 32 rows on half
// the card were slower). What does not depend on v or S (the factors and
// the four matrices) is the same in every slice of a head, and each slice
// computes it: the slices of a head as a thread-block cluster splitting the
// matrices through distributed shared memory were slower (0.568 against
// 0.536 ms at B=2 T=2048 H=32, bf16, H100), their barrier costing more than
// the half of the matrices it saved.
//
// Range. The matrices' factors take their reference at step m = 7:
// a~ = a e^{g_p - g_m}, r~ = r e^{g - g_m}, and b, k e^{g_m - g}; each factor
// is one exp2 of a difference that spans at most 8 steps, so it is a normal
// float while the decay stays above e^{-11} a step (w_raw <= 2.4, where 8
// steps reach e^{-88}), and it is formed before the small a, b, k or r
// multiplies it. The factors against Z (e^{g_p}, e^{g}, e^{g_l - g}, e^{g_l})
// are at most 1 and may underflow harmlessly. Past w_raw ~ 2.4 on a whole
// chunk the result is NaN, as the Pallas kernel's is (from ~1.7 there, its
// factors referenced at the chunk's start); the models keep
// w_raw <= -0.5. The solve runs over 16 steps in fp32, inside the envelope
// of docs/wkv_chunk_stability.md (its 2.9e-3 comes from bf16 intermediates;
// every product on the state path here is fp32 FMA).
//
// Bound on the H100: with SAVE, bytes, 7 streams of B*T*H*64 elements, two
// states and zin (B*H*(T/16)*16 KiB, the largest part); the fp32 operations
// (about 9 B*T*H*64*64) take about as long. Without SAVE, the operations:
// 1.25 GFLOP (0.0186 ms) against 30 MB of bf16 streams (0.009 ms) at the
// B=1 T=1056 H=32 prefill. The sequential form these kernels had before
// (one block a (b, h) or head pair, a state row a thread, one barrier a
// step) was bound by the latency of T dependent steps over B*H blocks.
//
// Design. Thread (si, sg), si = tid % ROWS, sg = tid / ROWS, owns value row
// i0 + si and the state's columns CPT sg .. CPT sg + CPT of it, in registers
// (TPR = 8 threads a row, 4 at 64 rows); the slice is also parked in shared
// memory for the dot products along j. The block walks the T/16 chunks in
// order, a pipeline of two phases a chunk with one barrier each:
//   phase 1: the factors of chunk c+1 (a thread per (column, part): prefix
//            sums by shuffles, six exp2 an element), and for chunk c the
//            products along j: (a e^{g_p}) z_i and (r e^{g}) z_i at the
//            thread's 16 / TPR steps, plus Nm v_i and sk v_i there; rhs goes
//            to shared memory;
//   phase 2: the four matrices of chunk c+1 (4 x 4 tiles on and below the
//            diagonal, eight lanes a tile over 8 columns each, summed by
//            shuffles), and for chunk c the solve (every thread of a row
//            walks its row's 16-step chain, so u stays in registers with no
//            further barrier), y at the thread's steps, zin (before the
//            update: each warp stores runs of up to 32 adjacent floats) and
//            the update of the thread's part of the state.
// r, w, k, a, b and the slice's v columns of chunk c+2 come in by cp.async
// into a ring of three stages while chunks c and c+1 compute. All arithmetic
// is fp32 FMA.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_tiles.cuh"

namespace {

constexpr int N = 64;
constexpr int CHUNK = 16;  // the solve's length; K5 / K12 save, K6 / K13 read, the state every CHUNK steps

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int C_LDP = N + 4;   // row stride of the fp32 tiles in shared memory
constexpr int C_MID = 7;       // the reference step of the matrices' factors
constexpr int C_STAGES = 3;    // raw input stages: chunks c, c+1 and c+2 in flight
constexpr float C_LOG2E = 1.4426950408889634f;

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::dot4;
using hopper::reduce_scatter;

template <int DT>
using ChunkStream = std::conditional_t<DT == 1, __nv_bfloat16, float>;

// Threads a value row: 8 (8 columns of S and 2 steps each), or 4 at 64 rows
// a block (16 columns and 4 steps), so that a block has at most 256 threads.
template <int ROWS>
__host__ __device__ constexpr int chunk_threads_a_row() { return ROWS == 64 ? 4 : 8; }

// Byte offsets of a block's shared memory.
template <int DT, int ROWS>
struct ChunkSmem {
  static constexpr int TILE = CHUNK * N;                 // elements of an r, w, k, a or b tile
  static constexpr int STAGE = 5 * TILE + CHUNK * ROWS;  // the five tiles and the slice's v columns
  static constexpr int FTILE = CHUNK * C_LDP * 4;        // bytes of an fp32 factor tile
  static constexpr int MATS = 4 * CHUNK * CHUNK;         // floats of M^T, Nm, sb, sk
  static constexpr size_t raw = 0;                                          // [STAGES][STAGE]
  static constexpr size_t az = raw + C_STAGES * STAGE * sizeof(ChunkStream<DT>);  // [2] a e^{g_p}
  static constexpr size_t rz = az + 2 * FTILE;           // [2] r e^{g}
  static constexpr size_t bl = rz + 2 * FTILE;           // [2] b e^{g_l - g}
  static constexpr size_t kl = bl + 2 * FTILE;           // [2] k e^{g_l - g}
  static constexpr size_t am = kl + 2 * FTILE;           // a e^{g_p - g_m}
  static constexpr size_t rm = am + FTILE;               // r e^{g - g_m}
  static constexpr size_t bm = rm + FTILE;               // b e^{g_m - g}
  static constexpr size_t km = bm + FTILE;               // k e^{g_m - g}
  static constexpr size_t dec = km + FTILE;              // [2][N] e^{g_l}
  static constexpr size_t mats = dec + 2 * N * 4;        // [2][MATS]
  static constexpr size_t st = mats + 2 * MATS * 4;      // [ROWS][C_LDP] the slice of S
  static constexpr size_t rhs = st + ROWS * C_LDP * 4;   // [CHUNK][ROWS]
  static constexpr size_t bytes = rhs + CHUNK * ROWS * 4;
};

// A chunk's r, w, k, a, b rows (CHUNK x N tiles, TILE apart) and the columns
// i0 .. i0 + ROWS of a sixth stream x6 (v in K1 / K5, dy in the backward's
// pass 1; CHUNK x ROWS after them) into dst by cp.async, one commit group;
// c0 is the offset of the chunk's first (b, t, h, 0) element. With TAIL the
// rows t >= nv (past T) are zero-filled and read nothing.
template <typename T, int ROWS, int NT, bool TAIL = false>
__device__ __forceinline__ void chunk_load(T* dst, int tid, size_t c0, size_t tstride, int i0, const T* r,
                                           const T* w, const T* k, const T* a, const T* b, const T* x6,
                                           int nv = CHUNK) {
  constexpr int TILE = CHUNK * N, VEC = 16 / sizeof(T);
  constexpr int ROW_SEGS = N / VEC, TILE_SEGS = CHUNK * ROW_SEGS, V_SEGS = ROWS / VEC;
  for (int idx = tid; idx < 5 * TILE_SEGS + CHUNK * V_SEGS; idx += NT) {
    int t, col, dcol, tile;
    if (idx < 5 * TILE_SEGS) {
      tile = idx / TILE_SEGS;
      t = idx % TILE_SEGS / ROW_SEGS;
      col = dcol = idx % ROW_SEGS * VEC;
    } else {
      tile = 5;
      t = (idx - 5 * TILE_SEGS) / V_SEGS;
      dcol = (idx - 5 * TILE_SEGS) % V_SEGS * VEC;
      col = i0 + dcol;
    }
    const T* src = tile == 0 ? r : tile == 1 ? w : tile == 2 ? k : tile == 3 ? a : tile == 4 ? b : x6;
    const bool ok = !TAIL || t < nv;
    cp_async16(dst + tile * TILE + t * (tile == 5 ? ROWS : N) + dcol,
               src + c0 + (ok ? (size_t)t * tstride + col : 0), ok);
  }
  cp_async_commit();
}

// A chunk's factor tiles from its raw r, w, k, a, b tiles x (CHUNK x N, TILE
// apart), a thread per (column fj, part fp of P): prefix sums by shuffles,
// six exp2 an element. Writes az = a e^{g_p}, rz = r e^{g}, bl, kl = b, k
// e^{g_l - g}, the step-7-referenced am, rm, bm, km, dec[fj] = e^{g_l} and,
// with G, the running sum g itself (log2 units) into gt. With TAIL the steps
// t >= nv are identity steps: log decay 0 (their zero-filled rows make every
// other factor of theirs 0). The forwards and both passes of the backward
// (wkv7_chunk_bwd.cuh) share it.
template <typename T, int P, bool G = false, bool TAIL = false>
__device__ __forceinline__ void chunk_factors(const T* x, int fj, int fp, float* az, float* rz, float* bl,
                                              float* kl, float* am, float* rm, float* bm, float* km,
                                              float* dec, float* gt = nullptr, int nv = CHUNK) {
  constexpr int TP = CHUNK / P;  // steps a thread
  constexpr int TILE = CHUNK * N;
  constexpr unsigned FULL = 0xffffffffu;
  float lw[TP], g[TP], run = 0.f;
#pragma unroll
  for (int q = 0; q < TP; ++q) {
    const int t = fp * TP + q;
    lw[q] = !TAIL || t < nv ? -expf(to_f(x[TILE + t * N + fj])) * C_LOG2E : 0.f;
    run += lw[q];
    g[q] = run;
  }
  float incl = run;  // inclusive sum over the parts of this column
#pragma unroll
  for (int d = 1; d < P; d <<= 1) {
    const float o = __shfl_up_sync(FULL, incl, d, P);
    if (fp >= d) incl += o;
  }
  const float excl = incl - run;
  const float gm = __shfl_sync(FULL, excl + g[C_MID % TP], C_MID / TP, P);
  const float gl = __shfl_sync(FULL, incl, P - 1, P);
#pragma unroll
  for (int q = 0; q < TP; ++q) {
    const int t = fp * TP + q, o = t * C_LDP + fj, e = t * N + fj;
    const float g_t = excl + g[q], gp = g_t - lw[q];
    const float rr = to_f(x[e]), kk = to_f(x[2 * TILE + e]);
    const float aa = to_f(x[3 * TILE + e]), bb = to_f(x[4 * TILE + e]);
    const float el = exp2f(gl - g_t), em = exp2f(gm - g_t);
    az[o] = aa * exp2f(gp);
    rz[o] = rr * exp2f(g_t);
    bl[o] = bb * el;
    kl[o] = kk * el;
    am[o] = aa * exp2f(gp - gm);
    rm[o] = rr * exp2f(g_t - gm);
    bm[o] = bb * em;
    km[o] = kk * em;
    if (G) gt[o] = g_t;
  }
  if (fp == P - 1) dec[fj] = exp2f(gl);
}

// A chunk's four 16 x 16 matrices M = strict(am bm^T), Nm = strict(am km^T),
// sb = incl(rm bm^T), sk = incl(rm km^T) into out (entries above the
// triangles are left as they are): out = [M^T | Nm | sb | sk], [s][t] for M^T
// and [t][s] for the others (K5's forward substitution walks M's columns),
// or with TRANS [M | Nm^T | sb^T | sk^T] (the backward's transposed solve
// walks M's rows). 40 tasks (4 matrices x the ten 4 x 4 tiles on and below
// the diagonal), eight lanes a task, each over 8 columns j (4 jc .. 4 jc + 4
// and 32 more), summed by shuffles; lane jc keeps entries 2 jc, 2 jc + 1.
template <int NT, bool TRANS>
__device__ __forceinline__ void chunk_matrices(int tid, const float* am, const float* rm, const float* bm,
                                               const float* km, float* out) {
  for (int task = tid; task < 4 * 10 * 8; task += NT) {  // a warp-uniform bound
    const int mat = task / 80, tile = task % 80 / 8, jc = task % 8;
    int bt = 0;
    while ((bt + 1) * (bt + 2) / 2 <= tile) ++bt;
    const int bs = tile - bt * (bt + 1) / 2;
    const float* lhs = mat < 2 ? am : rm;
    const float* rhs = mat % 2 == 0 ? bm : km;
    float acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float4 la[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        la[q] = *reinterpret_cast<const float4*>(lhs + (4 * bt + q) * C_LDP + 4 * jc + 32 * hh);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float4 rb = *reinterpret_cast<const float4*>(rhs + (4 * bs + s) * C_LDP + 4 * jc + 32 * hh);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[4 * q + s] = dot4(la[q], rb, acc[4 * q + s]);
      }
    }
    reduce_scatter<4, 8>(acc, jc & 4);
    reduce_scatter<2, 4>(acc, jc & 2);
    reduce_scatter<1, 2>(acc, jc & 1);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int t = 4 * bt + (2 * jc + m) / 4, s = 4 * bs + (2 * jc + m) % 4;
      if (mat < 2 ? s < t : s <= t)
        out[mat * CHUNK * CHUNK + ((mat == 0) != TRANS ? s * CHUNK + t : t * CHUNK + s)] = acc[m];
    }
  }
}

template <int DT, int ROWS, int ZHEADS, int SAVE>
__global__ void __launch_bounds__(ROWS * chunk_threads_a_row<ROWS>(), 1) wkv7_fwd_res_kernel(
    int Tlen, int H, const ChunkStream<DT>* __restrict__ r, const ChunkStream<DT>* __restrict__ w,
    const ChunkStream<DT>* __restrict__ k, const ChunkStream<DT>* __restrict__ v,
    const ChunkStream<DT>* __restrict__ a, const ChunkStream<DT>* __restrict__ b,
    const float* __restrict__ s0, ChunkStream<DT>* __restrict__ y, float* __restrict__ s_out,
    float* __restrict__ zin) {
  using T = ChunkStream<DT>;
  using L = ChunkSmem<DT, ROWS>;
  constexpr int TPR = chunk_threads_a_row<ROWS>();
  constexpr int NT = ROWS * TPR;    // threads
  constexpr int CPT = N / TPR;      // columns of S a thread
  constexpr int Q4 = CPT / 4;       // ... as float4
  constexpr int OPT = CHUNK / TPR;  // steps a thread in the products along j
  constexpr int P = NT / N;         // factor pass: threads a column
  constexpr int FT = CHUNK * C_LDP;  // floats of a factor tile
  constexpr int ZROW = ZHEADS * N;   // zin's row stride
  static_assert((ROWS == 16 || ROWS == 32 || ROWS == 64) && NT >= 128 && NT <= 256, "ROWS");

  constexpr bool TAIL = !SAVE;      // steps past T in the last chunk
  extern __shared__ __align__(16) unsigned char chunk_smem[];
  T* raw = reinterpret_cast<T*>(chunk_smem + L::raw);
  float* az = reinterpret_cast<float*>(chunk_smem + L::az);
  float* rz = reinterpret_cast<float*>(chunk_smem + L::rz);
  float* bl = reinterpret_cast<float*>(chunk_smem + L::bl);
  float* kl = reinterpret_cast<float*>(chunk_smem + L::kl);
  float* am = reinterpret_cast<float*>(chunk_smem + L::am);
  float* rm = reinterpret_cast<float*>(chunk_smem + L::rm);
  float* bm = reinterpret_cast<float*>(chunk_smem + L::bm);
  float* km = reinterpret_cast<float*>(chunk_smem + L::km);
  float* dec = reinterpret_cast<float*>(chunk_smem + L::dec);
  float* mats = reinterpret_cast<float*>(chunk_smem + L::mats);
  float* st = reinterpret_cast<float*>(chunk_smem + L::st);
  float* srhs = reinterpret_cast<float*>(chunk_smem + L::rhs);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / (N / ROWS), i0 = (blockIdx.x % (N / ROWS)) * ROWS;
  const int h = bh % H;
  const int nc = (Tlen + CHUNK - 1) / CHUNK;
  const size_t tstride = (size_t)H * N;                       // one time step
  const size_t base = ((size_t)(bh / H) * Tlen * H + h) * N;  // (b, 0, h, 0)
  // state: value row si of the slice, columns CPT sg .. CPT sg + CPT; the
  // steps 2 TPR p + sg and 2 TPR p + 2 TPR - 1 - sg for p < OPT / 2
  const int si = tid % ROWS, sg = tid / ROWS;
  // factor pass: column fj, steps fp * CHUNK / P .. (fp + 1) * CHUNK / P
  const int fj = tid / P, fp = tid % P;
  int ts[OPT];
#pragma unroll
  for (int o = 0; o < OPT; ++o) ts[o] = 2 * TPR * (o / 2) + (o % 2 ? 2 * TPR - 1 - sg : sg);

  float4 S[Q4];
  const size_t srow = ((size_t)bh * N + i0 + si) * N + CPT * sg;  // in s0 and s_out
#pragma unroll
  for (int q = 0; q < Q4; ++q)
    S[q] = s0 != nullptr ? reinterpret_cast<const float4*>(s0 + srow)[q]
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  auto put_state = [&]() {
#pragma unroll
    for (int q = 0; q < Q4; ++q) reinterpret_cast<float4*>(st + si * C_LDP + CPT * sg)[q] = S[q];
  };
  put_state();
  // the matrices' entries above their triangles stay 0
  for (int idx = tid; idx < 2 * L::MATS; idx += NT) mats[idx] = 0.f;
  // this slice's saved states: zin[(bh / ZHEADS, c, j), (bh % ZHEADS) N + i0 + si]
  float* zhead = SAVE ? zin + (size_t)(bh / ZHEADS) * nc * N * ZROW + (bh % ZHEADS) * N + i0 + si : nullptr;

  // chunk c's r, w, k, a, b rows and v columns i0 .. i0 + ROWS into stage c % 3
  auto load = [&](int c) {
    chunk_load<T, ROWS, NT, TAIL>(raw + (c % C_STAGES) * L::STAGE, tid, base + (size_t)c * CHUNK * tstride,
                                  tstride, i0, r, w, k, a, b, v, Tlen - c * CHUNK);
  };

  // phase 1 (a): chunk c's factor tiles and decay
  auto factors = [&](int c) {
    const int p = (c & 1) * FT;
    chunk_factors<T, P, false, TAIL>(raw + (c % C_STAGES) * L::STAGE, fj, fp, az + p, rz + p, bl + p, kl + p,
                                     am, rm, bm, km, dec + (c & 1) * N, nullptr, Tlen - c * CHUNK);
  };

  // phase 2 (a): chunk c's matrices, mats[c & 1] = M^T [s][t], Nm, sb, sk [t][s]
  auto matrices = [&](int c) { chunk_matrices<NT, false>(tid, am, rm, bm, km, mats + (c & 1) * L::MATS); };

  // phase 1 (b): for chunk c at the thread's steps, the products along j,
  // rhs (to shared memory) and y's part without u (returned in yp)
  auto products = [&](int c, float* yp) {
    const T* vx = raw + (c % C_STAGES) * L::STAGE + 5 * L::TILE + si;
    const float4* z4 = reinterpret_cast<const float4*>(st + si * C_LDP);
    const float4* aq[OPT];
    const float4* rq[OPT];
    float pa[OPT];
#pragma unroll
    for (int o = 0; o < OPT; ++o) {
      aq[o] = reinterpret_cast<const float4*>(az + (c & 1) * FT + ts[o] * C_LDP);
      rq[o] = reinterpret_cast<const float4*>(rz + (c & 1) * FT + ts[o] * C_LDP);
      pa[o] = 0.f;
      yp[o] = 0.f;
    }
#pragma unroll 4
    for (int jj = 0; jj < N / 4; ++jj) {
      const float4 zv = z4[jj];
#pragma unroll
      for (int o = 0; o < OPT; ++o) {
        pa[o] = dot4(aq[o][jj], zv, pa[o]);
        yp[o] = dot4(rq[o][jj], zv, yp[o]);
      }
    }
    float vs[CHUNK];
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) vs[s] = to_f(vx[s * ROWS]);
    const float* mt = mats + (c & 1) * L::MATS;
#pragma unroll
    for (int o = 0; o < OPT; ++o) {
      const float4* nq = reinterpret_cast<const float4*>(mt + CHUNK * CHUNK + ts[o] * CHUNK);
      const float4* kq = reinterpret_cast<const float4*>(mt + 3 * CHUNK * CHUNK + ts[o] * CHUNK);
#pragma unroll
      for (int s4 = 0; s4 < CHUNK / 4; ++s4) {
        const float4 vq = make_float4(vs[4 * s4], vs[4 * s4 + 1], vs[4 * s4 + 2], vs[4 * s4 + 3]);
        pa[o] = dot4(nq[s4], vq, pa[o]);
        yp[o] = dot4(kq[s4], vq, yp[o]);
      }
      srhs[ts[o] * ROWS + si] = pa[o];
    }
  };

  // phase 2 (b): u of chunk c (M's solve), y at the thread's steps, zin of
  // chunk c (the state before it), then the thread's part of S through chunk c
  auto finish = [&](int c, const float* yp) {
    const float* mt = mats + (c & 1) * L::MATS;
    float u[CHUNK];
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) u[t] = srhs[t * ROWS + si];
#pragma unroll
    for (int s = 0; s < CHUNK - 1; ++s) {  // column s of M: u[t] += M[t][s] u[s], t > s
#pragma unroll
      for (int t4 = (s + 1) / 4; t4 < CHUNK / 4; ++t4) {
        const float4 m = reinterpret_cast<const float4*>(mt + s * CHUNK)[t4];
        const float mm[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * t4 + e > s) u[4 * t4 + e] = fmaf(mm[e], u[s], u[4 * t4 + e]);
      }
    }
#pragma unroll
    for (int o = 0; o < OPT; ++o) {
      const float4* bq = reinterpret_cast<const float4*>(mt + 2 * CHUNK * CHUNK + ts[o] * CHUNK);
      float yo = yp[o];
#pragma unroll
      for (int s4 = 0; s4 < CHUNK / 4; ++s4)
        yo = dot4(bq[s4], make_float4(u[4 * s4], u[4 * s4 + 1], u[4 * s4 + 2], u[4 * s4 + 3]), yo);
      if (!TAIL || c * CHUNK + ts[o] < Tlen)  // no y for an identity step past T
        y[base + (size_t)(c * CHUNK + ts[o]) * tstride + i0 + si] = from_f<T>(yo);
    }
    if constexpr (SAVE) {
      float* z = zhead + ((size_t)c * N + CPT * sg) * ZROW;  // zin[.., c, j, ..] = S[i][j]
#pragma unroll
      for (int q = 0; q < Q4; ++q) {
        z[(size_t)(4 * q) * ZROW] = S[q].x;
        z[(size_t)(4 * q + 1) * ZROW] = S[q].y;
        z[(size_t)(4 * q + 2) * ZROW] = S[q].z;
        z[(size_t)(4 * q + 3) * ZROW] = S[q].w;
      }
    }
    const T* vx = raw + (c % C_STAGES) * L::STAGE + 5 * L::TILE + si;
    const float4* bq = reinterpret_cast<const float4*>(bl + (c & 1) * FT + CPT * sg);
    const float4* kq = reinterpret_cast<const float4*>(kl + (c & 1) * FT + CPT * sg);
    const float4* dq = reinterpret_cast<const float4*>(dec + (c & 1) * N + CPT * sg);
#pragma unroll
    for (int q = 0; q < Q4; ++q) {
      const float4 d = dq[q];
      S[q] = make_float4(S[q].x * d.x, S[q].y * d.y, S[q].z * d.z, S[q].w * d.w);
    }
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) {
      const float us = u[s], vs = to_f(vx[s * ROWS]);
#pragma unroll
      for (int q = 0; q < Q4; ++q) {
        const float4 bb = bq[s * (C_LDP / 4) + q], kk = kq[s * (C_LDP / 4) + q];
        S[q] = make_float4(fmaf(us, bb.x, fmaf(vs, kk.x, S[q].x)), fmaf(us, bb.y, fmaf(vs, kk.y, S[q].y)),
                           fmaf(us, bb.z, fmaf(vs, kk.z, S[q].z)), fmaf(us, bb.w, fmaf(vs, kk.w, S[q].w)));
      }
    }
    put_state();
  };

  if (nc > 0) {
    load(0);
    if (nc > 1) {
      load(1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    factors(0);
    __syncthreads();
    matrices(0);
  }
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<0>();  // chunk c + 1's inputs
    __syncthreads();
    if (c + 2 < nc) load(c + 2);
    if (c + 1 < nc) factors(c + 1);
    float yp[OPT];
    products(c, yp);
    __syncthreads();
    if (c + 1 < nc) matrices(c + 1);
    finish(c, yp);
  }

#pragma unroll
  for (int q = 0; q < Q4; ++q) reinterpret_cast<float4*>(s_out + srow)[q] = S[q];
}

template <int DT, int ROWS, int ZHEADS, int SAVE>
int launch_fwd_res_rows(int B, int T, int H, const void* r, const void* w, const void* k,
                        const void* v, const void* a, const void* b, const void* s0, void* y,
                        void* s_out, void* zin, cudaStream_t st) {
  using X = ChunkStream<DT>;
  const auto kernel = wkv7_fwd_res_kernel<DT, ROWS, ZHEADS, SAVE>;
  constexpr size_t smem = ChunkSmem<DT, ROWS>::bytes;
  static hopper_host::SmemOptIn opt_in;
  const int e = opt_in(kernel, smem);
  if (e != 0) return e;
  kernel<<<B * H * (N / ROWS), ROWS * chunk_threads_a_row<ROWS>(), smem, st>>>(
      T, H, (const X*)r, (const X*)w, (const X*)k, (const X*)v, (const X*)a, (const X*)b,
      (const float*)s0, (X*)y, (float*)s_out, (float*)zin);
  return (int)cudaGetLastError();
}

template <int DT, int ZHEADS, int SAVE>
int launch_fwd_res_dt(int rows, int B, int T, int H, const void* r, const void* w, const void* k,
                      const void* v, const void* a, const void* b, const void* s0, void* y,
                      void* s_out, void* zin, cudaStream_t st) {
  switch (rows) {
    case 16: return launch_fwd_res_rows<DT, 16, ZHEADS, SAVE>(B, T, H, r, w, k, v, a, b, s0, y, s_out, zin, st);
    case 32: return launch_fwd_res_rows<DT, 32, ZHEADS, SAVE>(B, T, H, r, w, k, v, a, b, s0, y, s_out, zin, st);
    case 64: return launch_fwd_res_rows<DT, 64, ZHEADS, SAVE>(B, T, H, r, w, k, v, a, b, s0, y, s_out, zin, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype codes: 0 = float32, 1 = bfloat16; rows = the value rows a block owns
// (16, 32 or 64); H even for ZHEADS = 2. SAVE 1 (K5 / K12): T a positive
// multiple of 16 and zin given. SAVE 0 (K1 / K11): any T >= 0, zin unused.
template <int ZHEADS, int SAVE>
int launch_fwd_res(int dtype, int rows, int B, int T, int H, int n, const void* r, const void* w,
                   const void* k, const void* v, const void* a, const void* b, const void* s0,
                   void* y, void* s_out, void* zin, void* stream) {
  if (n != N || B <= 0 || H <= 0 || H % ZHEADS != 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (SAVE && (T == 0 || T % CHUNK != 0 || zin == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_fwd_res_dt<0, ZHEADS, SAVE>(rows, B, T, H, r, w, k, v, a, b, s0, y, s_out, zin, st);
  if (dtype == 1)
    return launch_fwd_res_dt<1, ZHEADS, SAVE>(rows, B, T, H, r, w, k, v, a, b, s0, y, s_out, zin, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a K1 / K5 / K11 / K12 block, bytes (-1: no such
// instantiation).
inline int fwd_res_smem_bytes(int dtype, int rows) {
  if (dtype != 0 && dtype != 1) return -1;
  switch (rows) {
    case 16: return dtype ? (int)ChunkSmem<1, 16>::bytes : (int)ChunkSmem<0, 16>::bytes;
    case 32: return dtype ? (int)ChunkSmem<1, 32>::bytes : (int)ChunkSmem<0, 32>::bytes;
    case 64: return dtype ? (int)ChunkSmem<1, 64>::bytes : (int)ChunkSmem<0, 64>::bytes;
  }
  return -1;
}

}  // namespace
