// The chunked RWKV-6 ("x060") recurrence on Hopper, one loop for three
// kernels: the sequence forward K7 wkv6_fwd and the training forward K8
// wkv6_fwd_res (wkv6.cu: wkv6_fwd_kernel<DT, SAVE, ROWS, FORM>) and the
// first pass of the backward K9 (wkv6_chunk_bwd.cuh, included by
// wkv6_train.cu: wkv6_bwd_state_kernel<DT, ROWS, FORM>), which is K8's
// layout walked in reverse. Device code only; each .cu file defines its own
// entry points.
//
// Recurrence per (batch, head), fp32 state S of shape [Nv, Nk] = [64, 64],
// bonus u per channel of the head:
//   bonus = sum_j u_j k_j r_j
//   y_i   = sum_j S_ij r_j + bonus * v_i          (the state BEFORE the step)
//   S_ij  = S_ij * w_j + v_i * k_j
// with w = exp(max(-exp(w_raw), floor)), the floor -80/L of the JAX
// package's chunked forms (L = the model's chunk_len, any L >= 1), which
// the wrapper passes in.
//
// K7 replaces visualrwkv_tpu/ops/wkv6_pallas.py::wkv6_pallas (the chunked
// forward, kernel _wkv6_kernel) and K8 wkv6_pallas_fwd_res, which also saves
// the state entering every 16-step chunk, zin[bh, c] = transpose of S before
// step 16c (fp32), the layout K9 reads. The chunked form of
// ops/wkv6.py::wkv6_chunked at chunk 16, with g the running sum of the
// floored log decay inside a chunk, in log2 units, g_p = g - lw the sum
// before the step and g_l = g at step 15:
//   y_t  = (r_t e^{g_p,t}) S^T + sum_{s<t} A_ts v_s + bonus_t v_t
//   A_ts = sum_j r_tj k_sj e^{g_p,tj - g_sj}
//   S   <- e^{g_l} (.) S + sum_s v_s (k_s e^{g_l - g_s})
// K9's first pass (MODE 2) is the same loop on the cotangent dS of the
// state, walked from the last chunk, with dy in v's place:
//   dv_s = (k_s e^{g_l - g_s}) dS^T + sum_{t>=s} A_ts dy_t   (A's diagonal: bonus)
//   dS  <- e^{g_l} (.) dS + sum_t dy_t (r_t e^{g_p,t})
// storing dS leaving every chunk (dZ1, zin's layout) for the second pass.
// Bound on the H100: bytes, 5 streams of B*T*H*64 elements, two states and
// for K8 (and the first pass) zin (B*H*(T/16)*16 KiB, most of it); the fp32
// operations (about 5 B*T*H*64*64) take less. The sequential form (one
// block a (b, h), one step at a time) was bound by the latency of a chain
// of T dependent steps over B*H blocks instead.
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
// 1e-3).
//
// Range: the tiles against the state, r e^{g_p}, k e^{g_l - g} and e^{g_l},
// are decays (at most 1), so they may underflow to 0 at any floor, which is
// then the right value. A's pair factors e^{g_p,t - g_s} are decays too, but
// formed as products of per-step factors they would leave fp32's range. Three
// forms (FORM), each its own instantiation chosen by the launcher from the
// floor (a run-time branch between them inside the kernel made K8 13 %
// slower at chunk_len 16: 0.3411 -> 0.3861 ms, B=2 T=2048 H=32 bf16, H100):
//   FORM 0, floor >= -5 a step (chunk_len >= 16): referenced at step m = 7,
//     A_ts = sum_j (r e^{g_p - g_m})_tj (k e^{g_m - g})_sj, each factor
//     spanning at most 8 steps (within 2^{+-58}), formed as e^{g_p} e^{-g_m}
//     from the exp2 the tiles against S need;
//   FORM 1, floor >= -10 (chunk_len 8 .. 15): the same two factors, each as
//     one exp2 of its difference (within 2^{+-116}; two more exp2 an element:
//     at chunk_len 16 it read 0.3996 against 0.3381 ms, chip_variants.py
//     --wkv6 exp2_each);
//   FORM 2, any floor (chunk_len 1 .. 7: down to -80 a step): every pair
//     factor is one exp2 of its own difference g_p,t - g_s <= 0, a decay that
//     underflows to 0 only where its true value is below fp32's range. The
//     factor pass keeps g_p and g in place of the referenced tiles and A's
//     lanes read r and k from the raw stage: 16 exp2 a lane and column
//     against 2 (7,680 pairs' worth a chunk and slice, the diagonal tiles'
//     upper halves clamped to 0 and dropped).
// In the referenced forms each factor is formed before r or k multiplies it,
// so the terms do not underflow even where |r| is small and the decay is at
// the floor. Every slice of a head recomputes the factor tiles and A, which
// is cheaper than exchanging them. T needs not be a multiple of 16 for K7:
// the last chunk's missing steps load as zeros and take a log decay of 0,
// and their y is not stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_tiles.cuh"

namespace {

constexpr int N = 64;
constexpr int CHUNK = 16;  // K8 saves, and K9 reads, the state entering every CHUNK steps

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
// four consecutive elements (16-byte aligned fp32, 8-byte aligned bf16)
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  float4 q;
  load2(p, q.x, q.y);
  load2(p + 2, q.z, q.w);
  return q;
}

// ---------------------------------------------------------------------------
// Streams [B, T, H, N] of DT (0 fp32, 1 bf16); u [H, N] fp32; states
// [B, H, Nv, Nk] fp32; zin [B*H, T/16, N, N] fp32.
// ---------------------------------------------------------------------------
constexpr int LDP = N + 4;  // row stride of the fp32 tiles in shared memory
constexpr int MID = 7;      // the reference step of A's factorisation (FORM 0, 1)
constexpr int STAGES = 3;   // raw input stages: chunks c, c+1 and c+2 in flight
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <int DT>
using Stream = std::conditional_t<DT == 1, __nv_bfloat16, float>;

// The factor form of A for a floor of `wfloor` a step (see the header).
inline int factor_form(float wfloor) { return wfloor >= -80.f / CHUNK ? 0 : wfloor >= -10.f ? 1 : 2; }

// Byte offsets of a block's shared memory.
template <int DT, int ROWS>
struct FwdSmem {
  static constexpr int TILE = CHUNK * N;              // elements of an r, w or k tile
  static constexpr int STAGE = 3 * TILE + CHUNK * ROWS;  // r, w, k and the slice's v (dy) columns
  static constexpr int FTILE = CHUNK * LDP * 4;       // bytes of an fp32 factor tile
  static constexpr size_t raw = 0;                                     // [STAGES][STAGE]
  static constexpr size_t rq = raw + STAGES * STAGE * sizeof(Stream<DT>);  // [2] r e^{g_{t-1}}
  static constexpr size_t kb = rq + 2 * FTILE;                         // [2] k e^{g_15 - g}
  static constexpr size_t rm = kb + 2 * FTILE;                         // r e^{g_{t-1} - g_m}; FORM 2: g_p
  static constexpr size_t km = rm + FTILE;                             // k e^{g_m - g}; FORM 2: g
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

// Blocks a multiprocessor the register budget is set for: two, but one for
// the per-pair form (FORM 2), whose A tiles spilled 4-52 bytes under the 128
// registers of two (the main shapes' 128 blocks take one a multiprocessor
// anyway)
template <int FORM>
__host__ __device__ constexpr int min_blocks() { return FORM == 2 ? 1 : 2; }

// The chunk walk of a block. MODE 0: K7 (y and the final state); 1: K8 (and
// zin, the state entering every chunk); 2: K9's first pass, walked from the
// last chunk: x is dy, s0 the cotangent of the final state, y receives dv,
// s_out the cotangent of the initial state and zin dZ1 (the cotangent of the
// state leaving every chunk).
template <int DT, int MODE, int ROWS, int FORM>
__device__ __forceinline__ void chunk_walk(
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
  static_assert(MODE >= 0 && MODE <= 2 && FORM >= 0 && FORM <= 2, "MODE, FORM");

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
  // position c of the walk is chunk c, or chunk nc - 1 - c walking back
  auto chunk = [&](int c) { return MODE == 2 ? nc - 1 - c : c; };

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

  // position c's r, w, k rows and v columns i0 .. i0 + ROWS into stage c % 3;
  // steps past T read as zeros
  auto load = [&](int c) {
    T* dst = raw + (c % STAGES) * L::STAGE;
    const int c0 = chunk(c) * CHUNK;
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
      const bool ok = c0 + t < Tlen;
      cp_async16(dst + tile * L::TILE + t * (tile == 3 ? ROWS : N) + dcol,
                 src + base + (ok ? (size_t)(c0 + t) * tstride + col : 0), ok);
    }
    cp_async_commit();
  };

  // phase 1 (a): position c's factor tiles and decay
  auto factors = [&](int c) {
    const T* x = raw + (c % STAGES) * L::STAGE;
    const int nv = min(CHUNK, Tlen - chunk(c) * CHUNK);
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
    if constexpr (FORM == 0) {
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
    } else if constexpr (FORM == 1) {
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
    } else {
      // any floor: A's pair factors come from g_p and g themselves (amatrix).
      // g_p of a step is the previous step's g bit for bit, and g_l step 15's
      // (each |g| up to 1850 a chunk here, whose ulp would put 1e-4 on the
      // factors of two adjacent steps, e^0, if formed as g - lw)
      const float prev = __shfl_up_sync(FULL, excl + g[TP - 1], 1, P);
      const float gl2 = __shfl_sync(FULL, excl + g[TP - 1], P - 1, P);
#pragma unroll
      for (int q = 0; q < TP; ++q) {
        const int t = fp * TP + q, o = t * LDP + fj;
        const float gt = excl + g[q], gp = q ? excl + g[q - 1] : fp ? prev : 0.f;
        const float rr = to_f(x[t * N + fj]), kk = to_f(x[2 * L::TILE + t * N + fj]);
        q_rq[o] = rr * exp2f(gp);
        rm[o] = gp;
        km[o] = gt;
        q_kb[o] = kk * exp2f(gl2 - gt);
      }
      if (fp == P - 1) dec[(c & 1) * N + fj] = exp2f(gl2);
    }
    if (FORM < 2 && fp == P - 1) dec[(c & 1) * N + fj] = exp2f(gl);
  };

  // phase 2 (a): position c's A. Warps 0-2: the ten 4 x 4 tiles of A on and
  // below the diagonal, eight lanes a tile, each over 8 columns j (4 jc ..
  // 4 jc + 4 and 32 more), summed by shuffles (lane jc keeps the tile's
  // entries 2 jc and 2 jc + 1); lanes 80-95 redo tile 9 and store nothing.
  // Warp 3: the bonus on the diagonal, two lanes a step.
  auto amatrix = [&](int c) {
    const T* x = raw + (c % STAGES) * L::STAGE;
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
        const int col = 4 * jc + 32 * hh;
        if constexpr (FORM < 2) {
          float4 ra[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) ra[a] = *reinterpret_cast<const float4*>(rm + (4 * bt + a) * LDP + col);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const float4 kk = *reinterpret_cast<const float4*>(km + (4 * bs + b) * LDP + col);
#pragma unroll
            for (int a = 0; a < 4; ++a) acc[4 * a + b] = dot4(ra[a], kk, acc[4 * a + b]);
          }
        } else {
          // r_t k_s e^{g_p,t - g_s}, the exponent clamped to 0 for the pairs
          // s >= t of the diagonal tiles, which are not stored
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float4 ra = load4(x + (4 * bt + a) * N + col);
            const float4 ga = *reinterpret_cast<const float4*>(rm + (4 * bt + a) * LDP + col);
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const float4 kk = load4(x + 2 * L::TILE + (4 * bs + b) * N + col);
              const float4 gs = *reinterpret_cast<const float4*>(km + (4 * bs + b) * LDP + col);
              float s = acc[4 * a + b];
              s = fmaf(ra.x * kk.x, exp2f(fminf(ga.x - gs.x, 0.f)), s);
              s = fmaf(ra.y * kk.y, exp2f(fminf(ga.y - gs.y, 0.f)), s);
              s = fmaf(ra.z * kk.z, exp2f(fminf(ga.z - gs.z, 0.f)), s);
              s = fmaf(ra.w * kk.w, exp2f(fminf(ga.w - gs.w, 0.f)), s);
              acc[4 * a + b] = s;
            }
          }
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

  // phase 1 (b): y of position c at the thread's OPT steps, value row i0 +
  // si; walking back, dv there: the tile against the state is kb, and A's
  // sum runs over its column
  auto outputs = [&](int c) {
    const T* vx = raw + (c % STAGES) * L::STAGE + 3 * L::TILE + si;
    const float4* srow4 = reinterpret_cast<const float4*>(st + (c & 1) * ROWS * LDP + si * LDP);
    int ts[OPT];
    const float4* qs[OPT];
    float ys[OPT];
#pragma unroll
    for (int o = 0; o < OPT; ++o) {
      ts[o] = 2 * TPR * (o / 2) + (o % 2 ? 2 * TPR - 1 - sg : sg);
      qs[o] = reinterpret_cast<const float4*>((MODE == 2 ? kb : rq) + (c & 1) * FT + ts[o] * LDP);
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
      for (int o = 0; o < OPT; ++o) {
        if constexpr (MODE == 2) {
          if (s >= ts[o]) ys[o] = fmaf(am[s * CHUNK + ts[o]], vs, ys[o]);
        } else {
          if (s <= ts[o]) ys[o] = fmaf(am[ts[o] * CHUNK + s], vs, ys[o]);
        }
      }
    }
    const int c0 = chunk(c) * CHUNK;
#pragma unroll
    for (int o = 0; o < OPT; ++o)
      if (c0 + ts[o] < Tlen) y[base + (size_t)(c0 + ts[o]) * tstride + i0 + si] = from_f<T>(ys[o]);
  };

  // phase 2 (b): zin of position c (the state before it; walking back, dZ1),
  // then S through it
  auto update = [&](int c) {
    if (MODE > 0) {  // zin[bh, chunk, j, i0 + si] = S[i0 + si][j]
      float* z = zin + (((size_t)bh * nc + chunk(c)) * N + CPT * sg) * N + i0 + si;
#pragma unroll
      for (int q = 0; q < Q4; ++q) {
        z[(size_t)(4 * q) * N] = S[q].x;
        z[(size_t)(4 * q + 1) * N] = S[q].y;
        z[(size_t)(4 * q + 2) * N] = S[q].z;
        z[(size_t)(4 * q + 3) * N] = S[q].w;
      }
    }
    const T* vx = raw + (c % STAGES) * L::STAGE + 3 * L::TILE + si;
    const float4* kq = reinterpret_cast<const float4*>((MODE == 2 ? rq : kb) + (c & 1) * FT + CPT * sg);
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
    cp_async_wait<0>();  // position c + 1's inputs
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

}  // namespace
