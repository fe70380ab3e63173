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
// chunked forward, kernel _wkv6_kernel) and K8 wkv6_fwd_res replaces
// wkv6_pallas_fwd_res, which also saves the state entering every 16-step
// chunk, zin[bh, c] = transpose of S before step 16c (fp32), the layout K9
// reads. Both are one kernel, wkv6_fwd_kernel<DT, SAVE, ROWS, DIFF>: the chunked
// form of ops/wkv6.py::wkv6_chunked at chunk 16, with g the running sum of
// the floored log decay inside a chunk, in log2 units:
//   y_t  = (r_t e^{g_{t-1}}) S^T + sum_{s<t} A_ts v_s + bonus_t v_t
//   A_ts = sum_j r_tj e^{g_{t-1,j} - g_m,j} k_sj e^{g_m,j - g_s,j}
//   S   <- e^{g_15} (.) S + sum_s v_s (k_s e^{g_15 - g_s})
// Bound on the H100: bytes, 5 streams of B*T*H*64 elements, two states and
// for K8 zin (B*H*(T/16)*16 KiB, most of it); the fp32 operations (about
// 5 B*T*H*64*64) take less. The sequential form (one block a (b, h), one
// step at a time) was bound by the latency of a chain of T dependent steps
// over B*H blocks instead.
//
// Design. Each value row of the state evolves on its own (the decay is
// diagonal in the key index and there is no a.b^T term), so a block owns a
// slice of ROWS value rows of one (b, h): B*H*64/ROWS blocks, ROWS chosen by
// the wrapper (ops/wkv6_cuda.py::fwd_plan) so that the grid fills the card
// (32 rows, 128 blocks, at B*H = 64). The block walks the T/16 chunks in
// order, its slice of S in registers (TPR = 8 threads a row, 4 at 64 rows;
// thread (i, g) holds S[i][CPT g .. CPT g + CPT)) and in shared memory for
// the outputs. Everything but the state is independent of the state, so the
// chunk loop is a pipeline of two phases a chunk, one barrier each:
//   phase 1: the factor tiles of chunk c+1 (a thread per (column, part):
//            prefix sums of the log decay by shuffles across the parts, one
//            exp and two exp2 an element), and y of chunk c (a thread per
//            value row and 16 / TPR steps: 64 + 16 FMAs an output);
//   phase 2: A of chunk c+1 (the ten 4 x 4 tiles on and below the diagonal
//            by 80 threads, 8 columns each, summed by shuffles; the bonus on
//            the diagonal by one warp), zin of chunk c (K8, before the
//            update: each warp stores runs of 64 or 128 bytes of rows of Z)
//            and the update of S.
// r, w, k and the slice's v columns of chunk c+2 come in by cp.async into a
// ring of three stages while chunks c and c+1 compute. All arithmetic is
// fp32 FMA (no tensor cores: an fp32 stream, the state and zin are held to
// 1e-3). The factorisation of A takes its reference at step m = 7, so that
// each of its factors e^{g_{t-1} - g_m} and e^{g_m - g_s} spans at most 8
// steps: within 2^{+-58} under the floor of -5 a step (chunk_len 16) and
// 2^{+-116} under -10 (chunk_len 8, the lowest the launcher takes), a
// normal float either way, formed before r or k multiplies it, so the terms
// do not underflow even where |r| is small and the decay is at the floor.
// Under -5 a factor is formed as e^{g_{t-1}} e^{-g_m}, reusing the exp2 of
// the tiles against S; under a lower floor those alone leave fp32's range
// over 16 steps, so each factor is one exp2 of its difference (two more an
// element: at chunk_len 16 that form read 0.3996 against 0.3381 ms, K8 at
// B=2 T=2048 H=32 bf16 on an H100, chip_variants.py --wkv6 exp2_each). Every
// slice of a head recomputes the factor tiles and A, which is cheaper than
// exchanging them. T needs not be a multiple of 16 for K7: the
// last chunk's missing steps load as zeros and take a log decay of 0, and
// their y is not stored.
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

#include <type_traits>

#include "hopper_tiles.cuh"

namespace {

constexpr int N = 64;
constexpr int CHUNK = 16;  // K8 saves the state entering every CHUNK steps
constexpr int MIN_CHUNK_LEN = 8;  // K7 / K8 take the decay floor -80 / chunk_len down to here

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
// K7 / K8: sequence forward. Streams [B, T, H, N] of DT (0 fp32, 1 bf16); u
// [H, N] fp32; states [B, H, Nv, Nk] fp32; zin [B*H, T/16, N, N] fp32.
// ---------------------------------------------------------------------------
constexpr int LDP = N + 4;  // row stride of the fp32 tiles in shared memory
constexpr int MID = 7;      // the reference step of A's factorisation
constexpr int STAGES = 3;   // raw input stages: chunks c, c+1 and c+2 in flight
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <int DT>
using Stream = std::conditional_t<DT == 1, __nv_bfloat16, float>;

// Byte offsets of a block's shared memory.
template <int DT, int ROWS>
struct FwdSmem {
  static constexpr int TILE = CHUNK * N;              // elements of an r, w or k tile
  static constexpr int STAGE = 3 * TILE + CHUNK * ROWS;  // r, w, k and the slice's v columns
  static constexpr int FTILE = CHUNK * LDP * 4;       // bytes of an fp32 factor tile
  static constexpr size_t raw = 0;                                     // [STAGES][STAGE]
  static constexpr size_t rq = raw + STAGES * STAGE * sizeof(Stream<DT>);  // [2] r e^{g_{t-1}}
  static constexpr size_t kb = rq + 2 * FTILE;                         // [2] k e^{g_15 - g}
  static constexpr size_t rm = kb + 2 * FTILE;                         // r e^{g_{t-1} - g_m}
  static constexpr size_t km = rm + FTILE;                             // k e^{g_m - g}
  static constexpr size_t st = km + FTILE;                             // [2][ROWS][LDP] S
  static constexpr size_t dec = st + 2 * ROWS * LDP * 4;               // [2][N] e^{g_15}
  static constexpr size_t amat = dec + 2 * N * 4;                      // [CHUNK][CHUNK]
  static constexpr size_t u = amat + CHUNK * CHUNK * 4;                // [N]
  static constexpr size_t bytes = u + N * 4;
};

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::dot4;
using hopper::reduce_scatter;

// Threads a value row: 8 (8 columns of S and 2 output steps each), or 4 at 64
// rows a block (16 columns and 4 steps), so that two blocks of 256 threads
// fit on a multiprocessor without spilling.
template <int ROWS>
__host__ __device__ constexpr int threads_a_row() { return ROWS == 64 ? 4 : 8; }

// DIFF: A's referenced factors each as one exp2 of its difference (the
// launcher's choice for a floor below -5 a step; see the factor pass)
template <int DT, int SAVE, int ROWS, int DIFF>
__global__ void __launch_bounds__(ROWS * threads_a_row<ROWS>(), 2) wkv6_fwd_kernel(
    int Tlen, int H, float wfloor, const Stream<DT>* __restrict__ r,
    const Stream<DT>* __restrict__ w, const Stream<DT>* __restrict__ k,
    const Stream<DT>* __restrict__ v, const float* __restrict__ u, const float* __restrict__ s0,
    Stream<DT>* __restrict__ y, float* __restrict__ s_out, float* __restrict__ zin) {
  using T = Stream<DT>;
  using L = FwdSmem<DT, ROWS>;
  constexpr int TPR = threads_a_row<ROWS>();
  constexpr int NT = ROWS * TPR;    // threads
  constexpr int CPT = N / TPR;      // columns of S a thread
  constexpr int Q4 = CPT / 4;       // ... as float4
  constexpr int OPT = CHUNK / TPR;  // output steps a thread
  constexpr int P = NT / N;         // factor pass: threads a column
  constexpr int TP = CHUNK / P;     // factor pass: steps a thread
  constexpr int VEC = 16 / sizeof(T);
  constexpr int FT = CHUNK * LDP;   // floats of a factor tile
  // the outputs' and the bonus's dot-product loops unrolled 4 deep (in full
  // ran slower: chip_variants.py --wkv6 unroll16); not at 64 rows, where 4
  // deep spilled when a row had 8 threads
  constexpr int UNROLL = ROWS == 64 ? 1 : 4;
  static_assert((ROWS == 16 || ROWS == 32 || ROWS == 64) && NT >= 128, "ROWS");

  extern __shared__ __align__(16) unsigned char smem[];
  T* raw = reinterpret_cast<T*>(smem + L::raw);
  float* rq = reinterpret_cast<float*>(smem + L::rq);
  float* kb = reinterpret_cast<float*>(smem + L::kb);
  float* rm = reinterpret_cast<float*>(smem + L::rm);
  float* km = reinterpret_cast<float*>(smem + L::km);
  float* st = reinterpret_cast<float*>(smem + L::st);
  float* dec = reinterpret_cast<float*>(smem + L::dec);
  float* am = reinterpret_cast<float*>(smem + L::amat);
  float* su = reinterpret_cast<float*>(smem + L::u);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / (N / ROWS), i0 = (blockIdx.x % (N / ROWS)) * ROWS;
  const int h = bh % H;
  const int nc = (Tlen + CHUNK - 1) / CHUNK;
  const size_t tstride = (size_t)H * N;                            // one time step
  const size_t base = ((size_t)(bh / H) * Tlen * H + h) * N;       // (b, 0, h, 0)
  // state and outputs: value row si of the slice; columns CPT sg .. CPT sg +
  // CPT, and the output steps 2 TPR p + sg and 2 TPR p + 2 TPR - 1 - sg for
  // p < OPT / 2
  const int si = tid % ROWS, sg = tid / ROWS;
  // factor pass: column fj, steps fp * TP .. fp * TP + TP
  const int fj = tid / P, fp = tid % P;

  float4 S[Q4];
  const size_t srow = ((size_t)bh * N + i0 + si) * N + CPT * sg;  // in s0 and s_out
#pragma unroll
  for (int q = 0; q < Q4; ++q)
    S[q] = s0 != nullptr ? reinterpret_cast<const float4*>(s0 + srow)[q]
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  auto put_state = [&](float* dst) {
#pragma unroll
    for (int q = 0; q < Q4; ++q) reinterpret_cast<float4*>(dst + si * LDP + CPT * sg)[q] = S[q];
  };
  put_state(st);
  if (tid < N) su[tid] = u[h * N + tid];

  // chunk c's r, w, k rows and v columns i0 .. i0 + ROWS into stage c % 3;
  // steps past T read as zeros
  auto load = [&](int c) {
    T* dst = raw + (c % STAGES) * L::STAGE;
    constexpr int ROW_SEGS = N / VEC, TILE_SEGS = CHUNK * ROW_SEGS, V_SEGS = ROWS / VEC;
    for (int idx = tid; idx < 3 * TILE_SEGS + CHUNK * V_SEGS; idx += NT) {
      int t, col, dcol, tile;
      if (idx < 3 * TILE_SEGS) {
        tile = idx / TILE_SEGS;
        t = idx % TILE_SEGS / ROW_SEGS;
        col = dcol = idx % ROW_SEGS * VEC;
      } else {
        tile = 3;
        t = (idx - 3 * TILE_SEGS) / V_SEGS;
        dcol = (idx - 3 * TILE_SEGS) % V_SEGS * VEC;
        col = i0 + dcol;
      }
      const T* src = tile == 0 ? r : tile == 1 ? w : tile == 2 ? k : v;
      const bool ok = c * CHUNK + t < Tlen;
      cp_async16(dst + tile * L::TILE + t * (tile == 3 ? ROWS : N) + dcol,
                 src + base + (ok ? (size_t)(c * CHUNK + t) * tstride + col : 0), ok);
    }
    cp_async_commit();
  };

  // phase 1 (a): chunk c's factor tiles and decay
  auto factors = [&](int c) {
    const T* x = raw + (c % STAGES) * L::STAGE;
    const int nv = min(CHUNK, Tlen - c * CHUNK);
    float lw[TP], g[TP], run = 0.f;
#pragma unroll
    for (int q = 0; q < TP; ++q) {
      const int t = fp * TP + q;
      lw[q] = t < nv ? fmaxf(-expf(to_f(x[L::TILE + t * N + fj])), wfloor) * LOG2E : 0.f;
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
    const float gm = __shfl_sync(FULL, excl + g[MID % TP], MID / TP, P);
    const float gl = __shfl_sync(FULL, incl, P - 1, P);
    float* q_rq = rq + (c & 1) * FT;
    float* q_kb = kb + (c & 1) * FT;
    if constexpr (!DIFF) {
      // e^{g_{t-1} - g_m} = e^{g_{t-1}} e^{-g_m} and e^{g_m - g_t} = e^{g_15 -
      // g_t} e^{g_m - g_15}, from the two exp2 an element that rq and kb need:
      // under a floor of -5 a step each factor and product is a normal float
      const float to_m = exp2f(-gm), from_m = exp2f(gm - gl);
#pragma unroll
      for (int q = 0; q < TP; ++q) {
        const int t = fp * TP + q, o = t * LDP + fj;
        const float gt = excl + g[q], ep = exp2f(gt - lw[q]), el = exp2f(gl - gt);
        const float rr = to_f(x[t * N + fj]), kk = to_f(x[2 * L::TILE + t * N + fj]);
        q_rq[o] = rr * ep;
        rm[o] = rr * (ep * to_m);
        km[o] = kk * (el * from_m);
        q_kb[o] = kk * el;
      }
    } else {
      // under a lower floor (chunk_len 8 .. 15) e^{g_{t-1}} and e^{g_15 - g_t}
      // alone may leave fp32's range: each factor is one exp2 of a difference
      // that spans at most 8 steps, a normal float down to -10 a step
#pragma unroll
      for (int q = 0; q < TP; ++q) {
        const int t = fp * TP + q, o = t * LDP + fj;
        const float gt = excl + g[q], gp = gt - lw[q];
        const float rr = to_f(x[t * N + fj]), kk = to_f(x[2 * L::TILE + t * N + fj]);
        q_rq[o] = rr * exp2f(gp);
        rm[o] = rr * exp2f(gp - gm);
        km[o] = kk * exp2f(gm - gt);
        q_kb[o] = kk * exp2f(gl - gt);
      }
    }
    if (fp == P - 1) dec[(c & 1) * N + fj] = exp2f(gl);
  };

  // phase 2 (a): chunk c's A. Warps 0-2: the ten 4 x 4 tiles of A on and
  // below the diagonal, eight lanes a tile, each over 8 columns j (4 jc ..
  // 4 jc + 4 and 32 more), summed by shuffles (lane jc keeps the tile's
  // entries 2 jc and 2 jc + 1); lanes 80-95 redo tile 9 and store nothing.
  // Warp 3: the bonus on the diagonal, two lanes a step.
  auto amatrix = [&](int c) {
    if (tid < 96) {
      const int tile = min(tid / 8, 9), jc = tid % 8;
      int bt = 0;
      while ((bt + 1) * (bt + 2) / 2 <= tile) ++bt;
      const int bs = tile - bt * (bt + 1) / 2;
      float acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float4 ra[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          ra[a] = *reinterpret_cast<const float4*>(rm + (4 * bt + a) * LDP + 4 * jc + 32 * hh);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float4 kk =
              *reinterpret_cast<const float4*>(km + (4 * bs + b) * LDP + 4 * jc + 32 * hh);
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[4 * a + b] = dot4(ra[a], kk, acc[4 * a + b]);
        }
      }
      reduce_scatter<4, 8>(acc, jc & 4);
      reduce_scatter<2, 4>(acc, jc & 2);
      reduce_scatter<1, 2>(acc, jc & 1);
      if (tid < 80) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int t = 4 * bt + (2 * jc + m) / 4, s = 4 * bs + (2 * jc + m) % 4;
          if (s < t) am[t * CHUNK + s] = acc[m];
        }
      }
    } else if (tid < 128) {
      const T* x = raw + (c % STAGES) * L::STAGE;
      const int t = (tid - 96) / 2, j0 = (tid & 1) * (N / 2);
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll UNROLL
      for (int j = j0; j < j0 + N / 2; j += 2) {
        float r0, r1, k0, k1;
        load2(x + t * N + j, r0, r1);
        load2(x + 2 * L::TILE + t * N + j, k0, k1);
        acc0 = fmaf(su[j] * r0, k0, acc0);
        acc1 = fmaf(su[j + 1] * r1, k1, acc1);
      }
      float sum = acc0 + acc1;
      sum += __shfl_xor_sync(FULL, sum, 1);
      if ((tid & 1) == 0) am[t * CHUNK + t] = sum;
    }
  };

  // phase 1 (b): y of chunk c at the thread's OPT steps, value row i0 + si
  auto outputs = [&](int c) {
    const T* vx = raw + (c % STAGES) * L::STAGE + 3 * L::TILE + si;
    const float4* srow4 = reinterpret_cast<const float4*>(st + (c & 1) * ROWS * LDP + si * LDP);
    int ts[OPT];
    const float4* qs[OPT];
    float ys[OPT];
#pragma unroll
    for (int o = 0; o < OPT; ++o) {
      ts[o] = 2 * TPR * (o / 2) + (o % 2 ? 2 * TPR - 1 - sg : sg);
      qs[o] = reinterpret_cast<const float4*>(rq + (c & 1) * FT + ts[o] * LDP);
      ys[o] = 0.f;
    }
#pragma unroll UNROLL
    for (int jj = 0; jj < N / 4; ++jj) {
      const float4 sv = srow4[jj];
#pragma unroll
      for (int o = 0; o < OPT; ++o) ys[o] = dot4(qs[o][jj], sv, ys[o]);
    }
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) {
      const float vs = to_f(vx[s * ROWS]);
#pragma unroll
      for (int o = 0; o < OPT; ++o)
        if (s <= ts[o]) ys[o] = fmaf(am[ts[o] * CHUNK + s], vs, ys[o]);
    }
#pragma unroll
    for (int o = 0; o < OPT; ++o)
      if (c * CHUNK + ts[o] < Tlen)
        y[base + (size_t)(c * CHUNK + ts[o]) * tstride + i0 + si] = from_f<T>(ys[o]);
  };

  // phase 2 (b): zin of chunk c (the state before it), then S through chunk c
  auto update = [&](int c) {
    if (SAVE) {  // zin[bh, c, j, i0 + si] = S[i0 + si][j]
      float* z = zin + (((size_t)bh * nc + c) * N + CPT * sg) * N + i0 + si;
#pragma unroll
      for (int q = 0; q < Q4; ++q) {
        z[(size_t)(4 * q) * N] = S[q].x;
        z[(size_t)(4 * q + 1) * N] = S[q].y;
        z[(size_t)(4 * q + 2) * N] = S[q].z;
        z[(size_t)(4 * q + 3) * N] = S[q].w;
      }
    }
    const T* vx = raw + (c % STAGES) * L::STAGE + 3 * L::TILE + si;
    const float4* kq = reinterpret_cast<const float4*>(kb + (c & 1) * FT + CPT * sg);
    const float4* dq = reinterpret_cast<const float4*>(dec + (c & 1) * N + CPT * sg);
#pragma unroll
    for (int q = 0; q < Q4; ++q) {
      const float4 d = dq[q];
      S[q] = make_float4(S[q].x * d.x, S[q].y * d.y, S[q].z * d.z, S[q].w * d.w);
    }
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) {
      const float vs = to_f(vx[s * ROWS]);
#pragma unroll
      for (int q = 0; q < Q4; ++q) {
        const float4 kk = kq[s * (LDP / 4) + q];
        S[q] = make_float4(fmaf(vs, kk.x, S[q].x), fmaf(vs, kk.y, S[q].y), fmaf(vs, kk.z, S[q].z),
                           fmaf(vs, kk.w, S[q].w));
      }
    }
    put_state(st + ((c + 1) & 1) * ROWS * LDP);
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
    amatrix(0);
  }
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<0>();  // chunk c + 1's inputs
    __syncthreads();
    if (c + 2 < nc) load(c + 2);
    if (c + 1 < nc) factors(c + 1);
    outputs(c);
    __syncthreads();
    if (c + 1 < nc) amatrix(c + 1);
    update(c);
  }

#pragma unroll
  for (int q = 0; q < Q4; ++q) reinterpret_cast<float4*>(s_out + srow)[q] = S[q];
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

template <int DT, int SAVE, int ROWS, int DIFF>
int launch_form(int B, int T, int H, float wfloor, const void* r, const void* w, const void* k,
                const void* v, const void* u, const void* s0, void* y, void* s_out, void* zin,
                cudaStream_t st) {
  using X = Stream<DT>;
  const auto kernel = wkv6_fwd_kernel<DT, SAVE, ROWS, DIFF>;
  constexpr size_t smem = FwdSmem<DT, ROWS>::bytes;
  static hopper_host::SmemOptIn opt_in;
  const int e = opt_in(kernel, smem);
  if (e != 0) return e;
  kernel<<<B * H * (N / ROWS), ROWS * threads_a_row<ROWS>(), smem, st>>>(
      T, H, wfloor, (const X*)r, (const X*)w, (const X*)k, (const X*)v, (const float*)u,
      (const float*)s0, (X*)y, (float*)s_out, (float*)zin);
  return (int)cudaGetLastError();
}

// the factor form by the floor: a run-time branch between the two inside
// the kernel made K8 13 % slower at chunk_len 16 (0.3411 -> 0.3861 ms, B=2
// T=2048 H=32 bf16, H100), so each form is its own instantiation
template <int DT, int SAVE, int ROWS>
int launch_rows(int B, int T, int H, float wfloor, const void* r, const void* w, const void* k,
                const void* v, const void* u, const void* s0, void* y, void* s_out, void* zin,
                cudaStream_t st) {
  return wfloor >= -80.f / CHUNK
             ? launch_form<DT, SAVE, ROWS, 0>(B, T, H, wfloor, r, w, k, v, u, s0, y, s_out, zin, st)
             : launch_form<DT, SAVE, ROWS, 1>(B, T, H, wfloor, r, w, k, v, u, s0, y, s_out, zin, st);
}

template <int DT, int SAVE>
int launch_dt(int rows, int B, int T, int H, float wfloor, const void* r, const void* w,
              const void* k, const void* v, const void* u, const void* s0, void* y, void* s_out,
              void* zin, cudaStream_t st) {
  switch (rows) {
    case 16: return launch_rows<DT, SAVE, 16>(B, T, H, wfloor, r, w, k, v, u, s0, y, s_out, zin, st);
    case 32: return launch_rows<DT, SAVE, 32>(B, T, H, wfloor, r, w, k, v, u, s0, y, s_out, zin, st);
    case 64: return launch_rows<DT, SAVE, 64>(B, T, H, wfloor, r, w, k, v, u, s0, y, s_out, zin, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int SAVE>
int launch_fwd(int dtype, int rows, int B, int T, int H, int n, float wfloor, const void* r,
               const void* w, const void* k, const void* v, const void* u, const void* s0,
               void* y, void* s_out, void* zin, void* stream) {
  if (n != N || B <= 0 || H <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (SAVE && (T % CHUNK != 0 || zin == nullptr)) return (int)cudaErrorInvalidValue;
  // the factorisation needs the floor of chunk_len >= 8: at most -10 a step
  if (!(wfloor >= -80.f / MIN_CHUNK_LEN && wfloor < 0.f)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dt<0, SAVE>(rows, B, T, H, wfloor, r, w, k, v, u, s0, y, s_out, zin, st);
  if (dtype == 1)
    return launch_dt<1, SAVE>(rows, B, T, H, wfloor, r, w, k, v, u, s0, y, s_out, zin, st);
  return (int)cudaErrorInvalidValue;
}

template <int DT>
int smem_bytes(int rows) {
  switch (rows) {
    case 16: return (int)FwdSmem<DT, 16>::bytes;
    case 32: return (int)FwdSmem<DT, 32>::bytes;
    case 64: return (int)FwdSmem<DT, 64>::bytes;
  }
  return -1;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K7: streams [B, T, H, 64] in one dtype; u fp32 [H, 64]; s0 (may be null)
// and s_out fp32 [B, H, 64, 64]; wfloor = -80 / chunk_len, chunk_len >= 8;
// rows = the value rows a block owns (16, 32 or 64; 8 threads a row, 4 at 64).
int wkv6_fwd(int dtype, int rows, int B, int T, int H, int n, float wfloor, const void* r,
             const void* w, const void* k, const void* v, const void* u, const void* s0, void* y,
             void* s_out, void* stream) {
  return launch_fwd<0>(dtype, rows, B, T, H, n, wfloor, r, w, k, v, u, s0, y, s_out, nullptr,
                       stream);
}

// K8: K7 with T a multiple of 16; zin is fp32 [B*H, T/16, 64, 64].
int wkv6_fwd_res(int dtype, int rows, int B, int T, int H, int n, float wfloor, const void* r,
                 const void* w, const void* k, const void* v, const void* u, const void* s0,
                 void* y, void* s_out, void* zin, void* stream) {
  return launch_fwd<1>(dtype, rows, B, T, H, n, wfloor, r, w, k, v, u, s0, y, s_out, zin,
                       stream);
}

// Dynamic shared memory of a K7 / K8 block, bytes (-1: no such instantiation).
int wkv6_fwd_smem_bytes(int dtype, int rows) {
  return dtype == 0 ? smem_bytes<0>(rows) : dtype == 1 ? smem_bytes<1>(rows) : -1;
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
