// Flash-style attention backward for the vision towers: K14 (dq and the
// rel-pos tables' gradients) and K15 (dk, dv). Plain C interface, loaded
// with ctypes by visualrwkv_torch/vision/flash.py.
//
// Replaces two TPU kernels:
//   * visualrwkv_tpu/vision/flash.py::_sam_flash_bwd_impl (the backward of
//     sam_flash_attention; kernels _sam_flash_bwd_dq_kernel and
//     _sam_flash_bwd_dkv_kernel): SAM's global blocks with the decomposed
//     bias bias[q, key] = rel_h[q, key / Wk] + rel_w[q, key % Wk];
//   * the backward of JAX's stock TPU flash kernel behind
//     visualrwkv_tpu/vision/flash.py::flash_mha: the no-bias MHA of DINOv2 and
//     SigLIP (null bias pointers).
// Layouts are K3's (attention.cu): q/k/v [B, N, h, hd] read in place (token
// row stride h*hd; SAM's [G, N, hd] is h = 1). Head dims 64 and 72; 72 is
// padded to 80 by TMA's zero fill. Keys and queries past N (DINOv2's 1029
// tokens) are masked and not written.
//
// The FlashAttention-2 backward from the forward's output O and log-sum-exp:
// p = exp(S scale + bias - lse) is recomputed tile by tile from the unscaled
// q (K3's p), dP = dO V^T, dS = p (dP - delta) with delta = rowsum(dO O);
// dq = dS K scale, dk = dS^T Q scale, dv = p^T dO, d rel_h[q, kh] = sum of
// dS[q, key] over the keys of grid row kh, d rel_w[q, kw] over grid column
// kw. dS and p are rounded to bf16 before the products, as the reference
// kernels round them to the input dtype; the tables' gradients sum the
// rounded dS in fp32.
//
// Bound on the H100: operations, and the exponentials. At SAM's global
// shape (G=12, N=4096, hd 64) the function needs 5 products of G*N^2*hd
// multiply-adds (S, dP, dq, dk, dv), 129 GFLOP, against about 90 MB moved.
// K14 runs 3 of them (S, dP, dq: 77.3 GFLOP) and K15 4 (S, dP, dv, dk: 103.1
// GFLOP): recomputing S and dP in both is the price of keeping the N x N
// probabilities out of device memory. Each kernel also recomputes p, 12 *
// 4096^2 exponentials on the multi-function unit (16 a clock per
// multiprocessor: about 0.05 ms, a quarter of its products' time at the
// tensor peak), and with a bias adds it and sums the tables' gradients on
// the ALUs.
//
// Design (Hopper): a block is two consumer warpgroups and one producer
// warpgroup (384 threads; setmaxnreg gives the consumers 232 registers and
// the producer 40, or 224 and 56 where K15's producer threads copy tables).
// One producer thread keeps TMA loads of the streamed tiles in flight
// through a ring of stages, each guarded by a full and an empty mbarrier;
// the consumers run every product on wgmma with bf16 operands and fp32
// accumulators in registers. S and dP stay in registers: p and dS are
// rounded to bf16 pairs in place and feed the next product as wgmma's
// register A operand, so no fp32 tile goes through shared memory
// (hopper_tiles.cuh has the building blocks).
//   K14: one block per (g, 128 queries), a warpgroup owns 64 query rows; Q
//     and dO stay in shared memory, K and V tiles stream (3 stages). S = Q K^T
//     and dP = dO V^T (operands K-major), dq += dS K (K MN-major). With a
//     bias and a grid at most 64 wide ("rows"), a key tile is one grid row:
//     Wk keys, padded to a multiple of 16 (wgmma's reduction depth) and the
//     padding masked. A thread then owns the same grid columns in every
//     tile: it keeps (rel_w - lse) and its d rel_w sums in registers, and
//     d rel_h is one row sum a tile; rel_h of its rows is staged in shared
//     memory, and the sums run while the dq product does. Wider grids
//     ("general") take 64-key tiles and sum both tables' gradients in
//     shared memory with atomics (slow, and no tower at its published size
//     takes it).
//   K15: one block per (g, 128 keys), a warpgroup owns 64 keys; K and V are
//     loaded once, the ring (3 stages) streams 64-query tiles of Q and dO
//     with their lse and delta and, with a bias, the only table entries the
//     block needs: rel_h[q, kh] for the grid rows its keys span (at most
//     127 / Wk + 2 of them) and rel_w[q, 0:Wk], 19.5 KB a query tile at
//     SAM-B's 64 x 64 grid against the WMMA form's 32 KB for 64 keys. S^T =
//     K Q^T, dP^T = V dO^T, then dv += P^T dO and dk += dS^T Q from
//     registers; dk and dv stay in registers to the end. Its two
//     warpgroups take turns to issue their first products (below).
// Tried and dropped, each slower on an H100: issuing a tile's S and dP
// before the previous tile's last product has completed (ptxas then
// serialises the wgmma), the same turns in K14, and summing K14's tables'
// gradients on the tensor cores (dS times an identity and a ones matrix:
// its tensor cores are the busier unit).
// This replaces a WMMA form (16x16x16 fragments re-read from shared memory,
// fp32 tiles through shared memory, no overlap of loads and products) that
// took 1.2365 + 1.9342 ms at SAM's global shape on an H100 80GB HBM3 at
// 700 W (PERF.md row 5).

#include "hopper_tiles.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int NC = 2;                 // consumer warpgroups a block
constexpr int THREADS = (NC + 1) * 128;
constexpr int ROWS = 64 * NC;         // query rows (K14) or keys (K15) a block
constexpr int DQ_STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;

// K15's two consumer warpgroups take turns to issue a tile's first
// products (named barriers 3 and 4, over both): while one warpgroup's
// products run on the tensor cores, the other computes p and dS. Each issue
// waits for its turn (warpgroup 1 first waits for warpgroup 0's first
// issue) and then hands the turn over; warpgroup 0 takes one turn more
// after its last tile, so that every arrival is matched.
__device__ __forceinline__ void turn_wait(int wg) { named_sync(3 + wg, 256); }
__device__ __forceinline__ void turn_pass(int wg) { named_arrive(4 - wg, 256); }

// The plan of a call, shared by the launchers and attention_bwd_plan:
// K14's mode and key tile, K15's count of rel_h columns a block stages.
struct Plan {
  int mode, key_tile, hspan, tables;  // tables: K15's Tables (below)
};

Plan make_plan(int hd, bool bias, int Hk, int Wk) {
  if (!bias) return {NOBIAS, 64, 0, 0};
  const int hspan = (127 / Wk + 2) < Hk ? (127 / Wk + 2) : Hk;
  const int tables = Hk % 4 == 0 && Wk % 4 == 0 ? 1 : 2;
  if (hd == 64 && Wk <= 64) return {GRID_ROWS, grid_rows_tile(Wk), hspan, tables};
  return {GENERAL, 64, hspan, tables};
}

struct Maps {
  CUtensorMap q[2], dout[2], k[2], v[2];  // [0] columns 0..63, [1] 64..79 (hd 72)
  CUtensorMap rh, rw;                     // K15's table slices (TAB_TMA)
};

// ------------------------------------------------------------------ K14

template <int HD, int BKN>
struct DqLayout {
  using C = Cols<HD>;
  static constexpr int Q = 0;
  static constexpr int DO = Q + C::tile_bytes(ROWS);
  static constexpr int K = DO + C::tile_bytes(ROWS);
  static constexpr int V = K + DQ_STAGES * C::tile_bytes(BKN);
  static constexpr int QT = V + DQ_STAGES * C::tile_bytes(BKN);
  static constexpr int DOT = QT + C::tail_bytes(ROWS);
  static constexpr int KT = DOT + C::tail_bytes(ROWS);
  static constexpr int VT = KT + DQ_STAGES * C::tail_bytes(BKN);
  static constexpr int BARS = (VT + DQ_STAGES * C::tail_bytes(BKN) + 15) / 16 * 16;
  static constexpr int DELTA = BARS + (2 * DQ_STAGES + 1) * 8;
  // then, fp32: GENERAL both tables' gradients [ROWS][Hk + Wk], GRID_ROWS rel_h [ROWS][Hk + 1]
  static constexpr int TABLES = (DELTA + ROWS * 4 + 15) / 16 * 16;
  static constexpr int STAGE_TX = 2 * (C::tile_bytes(BKN) + C::tail_bytes(BKN));
  static constexpr int Q_TX = 2 * (C::tile_bytes(ROWS) + C::tail_bytes(ROWS));
};

template <int HD, int BKN, int MODE>
__global__ void __launch_bounds__(THREADS, 1) attention_bwd_dq_kernel(
    __grid_constant__ const Maps maps, int N, int heads, float scale,
    const float* __restrict__ rel_h, const float* __restrict__ rel_w, int Hk, int Wk,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, bf16* __restrict__ dq, float* __restrict__ drh,
    float* __restrict__ drw) {
  using L = DqLayout<HD, BKN>;
  using C = Cols<HD>;
  constexpr int NJ = BKN / 8;  // 8-column groups of a key tile
  extern __shared__ __align__(1024) unsigned char sm_raw[];
  unsigned char* sm = align_1024(sm_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + DQ_STAGES;
  uint64_t* qbar = empty + DQ_STAGES;
  const int g = blockIdx.y, b = g / heads, head = g % heads;
  const int qb0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int ntiles = MODE == GRID_ROWS ? Hk : (N + BKN - 1) / BKN;

  if (tid == 0) {
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 128);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NC * 128) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (tid == NC * 128) {
      mbar_arrive_expect_tx(qbar, L::Q_TX);
      load_rows<HD>(maps.q, sm + L::Q, sm + L::QT, qbar, head, qb0, b);
      load_rows<HD>(maps.dout, sm + L::DO, sm + L::DOT, qbar, head, qb0, b);
      Ring<DQ_STAGES> ring;
      for (int t = 0; t < ntiles; ++t) {
        const int s = ring.stage;
        mbar_wait(&empty[s], ring.phase ^ 1u);
        mbar_arrive_expect_tx(&full[s], L::STAGE_TX);
        const int key0 = MODE == GRID_ROWS ? t * Wk : t * BKN;
        load_rows<HD>(maps.k, sm + L::K + s * C::tile_bytes(BKN), sm + L::KT + s * C::tail_bytes(BKN),
                      &full[s], head, key0, b);
        load_rows<HD>(maps.v, sm + L::V + s * C::tile_bytes(BKN), sm + L::VT + s * C::tail_bytes(BKN),
                      &full[s], head, key0, b);
        ring.advance();
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = tid >> 7, t = tid & 127;
  const int r = 16 * (t >> 5) + ((t & 31) >> 2), c = t & 3;
  const int q0 = qb0 + wg * 64;  // this warpgroup's first query row
  const size_t row_stride = (size_t)heads * HD;
  const size_t base = ((size_t)b * N * heads + head) * HD;
  float* delta_s = reinterpret_cast<float*>(sm + L::DELTA) + wg * 64;
  float* tab = reinterpret_cast<float*>(sm + L::TABLES) +
               (size_t)wg * 64 * (MODE == GENERAL ? Hk + Wk : Hk + 1);

  // delta = rowsum(dO O) in fp32 of the bf16 values, two threads a row
  {
    const int row = t >> 1, half = t & 1, qrow = q0 + row;
    float dl = 0.f;
    if (qrow < N) {
      const bf16* orow = o + base + (size_t)qrow * row_stride + half * (HD / 2);
      const bf16* drow = dout + base + (size_t)qrow * row_stride + half * (HD / 2);
#pragma unroll
      for (int col = 0; col < HD / 2; col += 2) {
        const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(orow + col);
        const __nv_bfloat162 d = *reinterpret_cast<const __nv_bfloat162*>(drow + col);
        dl = fmaf(__low2float(a), __low2float(d), dl);
        dl = fmaf(__high2float(a), __high2float(d), dl);
      }
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    if (half == 0) {
      delta_s[row] = dl;
      if (qrow < N) delta[(size_t)g * N + qrow] = dl;
    }
  }
  if (MODE == GENERAL)  // both tables' gradients, [64][Hk + Wk]
    for (int i = t; i < 64 * (Hk + Wk); i += 128) tab[i] = 0.f;
  if (MODE == GRID_ROWS)  // rel_h of the warpgroup's rows times log2 e, [64][Hk + 1]
    for (int i = t; i < 64 * Hk; i += 128) {
      const int row = i / Hk, col = i - row * Hk;
      tab[row * (Hk + 1) + col] =
          q0 + row < N ? __ldg(rel_h + ((size_t)g * N + q0 + row) * Hk + col) * LOG2E : 0.f;
    }
  named_sync(1 + wg, 128);

  // per row h (rows r and r + 8 of the warpgroup's 64): lse, delta, tables
  int qr[2];
  bool qv[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qr[h] = q0 + r + 8 * h;
    qv[h] = qr[h] < N;
    lse2[h] = qv[h] ? lse[(size_t)g * N + qr[h]] * LOG2E : INFINITY;  // p = 0 past N
    dl[h] = delta_s[r + 8 * h];
  }
  const float sl2 = scale * LOG2E;
  // GRID_ROWS: (rel_w - lse) times log2 e of the thread's columns, -inf for
  // the padding past Wk (so p = 0 there), and their d rel_w sums
  float rw2[MODE == GRID_ROWS ? 2 : 1][MODE == GRID_ROWS ? 2 * NJ : 1];
  float drw_acc[MODE == GRID_ROWS ? 2 : 1][MODE == GRID_ROWS ? 2 * NJ : 1];
  // the tables' rows of the thread's two query rows (row 0 past N)
  const float* rh_row[2] = {nullptr, nullptr};
  const float* rw_row[2] = {nullptr, nullptr};
  if (MODE != NOBIAS) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t qrow = (size_t)g * N + (qv[h] ? qr[h] : 0);
      rh_row[h] = rel_h + qrow * Hk;
      rw_row[h] = rel_w + qrow * Wk;
    }
  }
  if (MODE == GRID_ROWS) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * c + e;
          rw2[h][2 * j + e] =
              col < Wk ? (qv[h] ? __ldg(rw_row[h] + col) * LOG2E : 0.f) - lse2[h] : -INFINITY;
          drw_acc[h][2 * j + e] = 0.f;
        }
  }

  float dqa[32], dqt[8];
#pragma unroll
  for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) dqt[i] = 0.f;

  mbar_wait(qbar, 0);
  const unsigned char* qm = sm + L::Q;
  const unsigned char* qt = sm + L::QT;
  const unsigned char* dom = sm + L::DO;
  const unsigned char* dot = sm + L::DOT;
  const int r0 = wg * 64;

  Ring<DQ_STAGES> ring;

  for (int kt = 0; kt < ntiles; ++kt) {
    const int s = ring.stage;
    const int key0 = MODE == GRID_ROWS ? kt * Wk : kt * BKN;
    float rh2[2] = {0.f, 0.f};
    if (MODE == GRID_ROWS)
#pragma unroll
      for (int h = 0; h < 2; ++h) rh2[h] = tab[(r + 8 * h) * (Hk + 1) + kt];
    const unsigned char* km = sm + L::K + s * C::tile_bytes(BKN);
    const unsigned char* ktl = sm + L::KT + s * C::tail_bytes(BKN);
    const unsigned char* vm = sm + L::V + s * C::tile_bytes(BKN);
    const unsigned char* vtl = sm + L::VT + s * C::tail_bytes(BKN);
    mbar_wait(&full[s], ring.phase);

    float sa[BKN / 2], pa[BKN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk)
      wgmma_ss<BKN>(sa, desc_k<HD>(qm, qt, r0, kk), desc_k<HD>(km, ktl, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk)
      wgmma_ss<BKN>(pa, desc_k<HD>(dom, dot, r0, kk), desc_k<HD>(vm, vtl, 0, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sa);

    // p from the forward's lse, in place of S; 0 for masked keys
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * c + e, idx = 4 * j + 2 * h + e;
          if (MODE == GRID_ROWS) {
            sa[idx] = ex2(fmaf(sa[idx], sl2, rh2[h] + rw2[h][2 * j + e]));
          } else {
            const bool valid = key0 + col < N;
            float bias2 = 0.f;
            if (MODE == GENERAL && valid && qv[h]) {
              const int key = key0 + col, kh = key / Wk;
              bias2 = (__ldg(rh_row[h] + kh) + __ldg(rw_row[h] + key - kh * Wk)) * LOG2E;
            }
            sa[idx] = valid ? ex2(fmaf(sa[idx], sl2, bias2 - lse2[h])) : 0.f;
          }
        }
    wgmma_wait<0>();
    fence_regs(pa);

    // dS = p (dP - delta) rounded to bf16, as the A operand of dq += dS K
    uint32_t da[BKN / 16][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = 4 * j + 2 * h;
        da[j >> 1][(j & 1) * 2 + h] =
            pack_bf16(sa[idx] * (pa[idx] - dl[h]), sa[idx + 1] * (pa[idx + 1] - dl[h]));
      }

    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < BKN / 16; ++kb) {
      wgmma_rs_n64(dqa, da[kb], desc_mn(km, kb));
      if (C::TAIL) wgmma_rs_n16(dqt, da[kb], desc_mn_tail(ktl, kb));
    }
    wgmma_commit();

    // the tables' gradients from the rounded dS, while the dq product runs
    float run[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (MODE != NOBIAS) {
          const uint32_t u = da[j >> 1][(j & 1) * 2 + h];
          const float d0 = bf16_lo(u), d1 = bf16_hi(u);
          if (MODE == GRID_ROWS) {
            run[h] += d0 + d1;
            drw_acc[h][2 * j] += d0;
            drw_acc[h][2 * j + 1] += d1;
          } else if (qv[h]) {
            float* trow = tab + (r + 8 * h) * (Hk + Wk);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = key0 + 8 * j + 2 * c + e;
              if (key < N) {
                const int kh = key / Wk;
                const float d = e ? d1 : d0;
                atomicAdd(trow + kh, d);
                atomicAdd(trow + Hk + key - kh * Wk, d);
              }
            }
          }
        }
      }
    if (MODE == GRID_ROWS) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        run[h] += __shfl_xor_sync(0xffffffffu, run[h], 1);
        run[h] += __shfl_xor_sync(0xffffffffu, run[h], 2);
        if (c == 0 && qv[h]) drh[((size_t)g * N + qr[h]) * Hk + kt] = run[h];
      }
    }
    wgmma_wait<0>();
    fence_regs(dqa);
    fence_regs(dqt);
    fence_regs(da);
    mbar_arrive(&empty[s]);
    ring.advance();
  }

  store_acc<HD>(dq + base, row_stride, N, q0, dqa, dqt, scale, scale);
  if (MODE == GRID_ROWS) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!qv[h]) continue;
      float* out = drw + ((size_t)g * N + qr[h]) * Wk;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + 2 * c + e < Wk) out[8 * j + 2 * c + e] = drw_acc[h][2 * j + e];
    }
  }
  if (MODE == GENERAL) {
    named_sync(1 + wg, 128);
    const int W = Hk + Wk;
    for (int i = t; i < 64 * W; i += 128) {
      const int row = i / W, col = i - row * W, qrow = q0 + row;
      if (qrow >= N) continue;
      if (col < Hk) drh[((size_t)g * N + qrow) * Hk + col] = tab[i];
      else drw[((size_t)g * N + qrow) * Wk + col - Hk] = tab[i];
    }
  }
}

// ------------------------------------------------------------------ K15

constexpr int DKV_STAGES = 3;

template <int HD>
struct DkvLayout {
  using C = Cols<HD>;
  static constexpr int K = 0;
  static constexpr int V = K + C::tile_bytes(ROWS);
  static constexpr int Q = V + C::tile_bytes(ROWS);
  static constexpr int DO = Q + DKV_STAGES * C::tile_bytes(64);
  static constexpr int KT = DO + DKV_STAGES * C::tile_bytes(64);
  static constexpr int VT = KT + C::tail_bytes(ROWS);
  static constexpr int QT = VT + C::tail_bytes(ROWS);
  static constexpr int DOT = QT + DKV_STAGES * C::tail_bytes(64);
  static constexpr int BARS = (DOT + DKV_STAGES * C::tail_bytes(64) + 15) / 16 * 16;
  static constexpr int VEC = BARS + (2 * DKV_STAGES + 1) * 8;  // lse, delta [stages][2][64]
  // the table slices, [stages][table_bytes], 1024-byte aligned
  static constexpr int TABLES = (VEC + DKV_STAGES * 2 * 64 * 4 + 1023) / 1024 * 1024;
  static constexpr int STAGE_TX = 2 * (C::tile_bytes(64) + C::tail_bytes(64));
  static constexpr int KV_TX = 2 * (C::tile_bytes(ROWS) + C::tail_bytes(ROWS));
};

// How K15 stages the table slices of a query tile.
//   TAB_TMA (Hk and Wk multiples of 4, TMA's 16-byte row strides): the
//     producer thread's TMA brings rel_w[q, 0:Wk] as boxes of 32 columns with
//     the 128-byte swizzle (conflict-free reads by the accumulator layout;
//     columns past Wk read as zeros) and rel_h[q, kh0 : kh0 + hspan] as one
//     box from the column kh0 rounded down to a multiple of 4 (TMA starts a
//     box on 16 bytes), rh_box(hspan) columns wide: hspan + 3 or more, and
//     4 mod 8, so that the 4 query rows a warp reads at once fall in
//     different banks.
//   TAB_LOADS: the producer warpgroup's threads copy both with plain loads
//     into rows padded for conflict-free reads.
enum Tables { TAB_NONE = 0, TAB_TMA = 1, TAB_LOADS = 2 };

__host__ __device__ constexpr int rh_box(int hspan) { return (hspan + 6) / 8 * 8 + 4; }
// TAB_LOADS row strides: odd, and 4 mod 16
__host__ __device__ constexpr int rh_stride(int hspan) { return hspan | 1; }
__host__ __device__ constexpr int rw_stride(int Wk) { return (Wk + 15) / 16 * 16 + 4; }
// bytes of one stage's table slices, a multiple of 1024
__host__ __device__ constexpr int table_bytes(int tab, int Wk, int hspan) {
  int n = 0;
  if (tab == TAB_TMA) n = (Wk + 31) / 32 * 64 * 128 + 64 * rh_box(hspan) * 4;
  if (tab == TAB_LOADS) n = 64 * (rh_stride(hspan) + rw_stride(Wk)) * 4;
  return (n + 1023) / 1024 * 1024;
}

template <int HD, int TAB>
__global__ void __launch_bounds__(THREADS, 1) attention_bwd_dkv_kernel(
    __grid_constant__ const Maps maps, int N, int heads, float scale,
    const float* __restrict__ rel_h, const float* __restrict__ rel_w, int Hk, int Wk, int hspan,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv) {
  using L = DkvLayout<HD>;
  using C = Cols<HD>;
  constexpr int S = DKV_STAGES;
  extern __shared__ __align__(1024) unsigned char sm_raw[];
  unsigned char* sm = align_1024(sm_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + S;
  uint64_t* kvbar = empty + S;
  float* vec = reinterpret_cast<float*>(sm + L::VEC);
  const int TB = table_bytes(TAB, Wk, hspan);
  const int RWB = (Wk + 31) / 32 * 64 * 128;  // TAB_TMA: bytes of the rel_w boxes
  const int RHS = TAB == TAB_TMA ? rh_box(hspan) : rh_stride(hspan), RWS = rw_stride(Wk);
  const int g = blockIdx.y, b = g / heads, head = g % heads;
  const int k0 = blockIdx.x * ROWS;
  // first grid row of the block's keys; TAB_TMA stages rel_h from kh0 & ~3
  const int kh0 = TAB == TAB_TMA ? k0 / Wk & ~3 : TAB == TAB_LOADS ? k0 / Wk : 0;
  const int tid = threadIdx.x;
  const int nq = (N + 63) / 64;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 128);  // every producer thread arrives
      mbar_init(&empty[s], NC * 128);
    }
    mbar_init(kvbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NC * 128) {  // producer warpgroup
    if (TAB == TAB_LOADS) setmaxnreg_dec<56>();
    else setmaxnreg_dec<40>();
    const int pt = tid - NC * 128;
    if (pt == 0) {
      mbar_arrive_expect_tx(kvbar, L::KV_TX);
      load_rows<HD>(maps.k, sm + L::K, sm + L::KT, kvbar, head, k0, b);
      load_rows<HD>(maps.v, sm + L::V, sm + L::VT, kvbar, head, k0, b);
    }
    Ring<S> ring;
    for (int qt = 0; qt < nq; ++qt) {
      const int s = ring.stage, qs = qt * 64;
      unsigned char* tabs = sm + L::TABLES + s * TB;
      mbar_wait(&empty[s], ring.phase ^ 1u);
      if (pt == 0) {
        mbar_expect_tx(&full[s], L::STAGE_TX + (TAB == TAB_TMA ? RWB + 64 * RHS * 4 : 0));
        load_rows<HD>(maps.q, sm + L::Q + s * C::tile_bytes(64), sm + L::QT + s * C::tail_bytes(64),
                      &full[s], head, qs, b);
        load_rows<HD>(maps.dout, sm + L::DO + s * C::tile_bytes(64),
                      sm + L::DOT + s * C::tail_bytes(64), &full[s], head, qs, b);
        if (TAB == TAB_TMA) {  // rows past N belong to the next group: p = 0 there
          for (int c0 = 0; c0 < Wk; c0 += 32)
            tma_load_2d(tabs + c0 / 32 * 64 * 128, &maps.rw, &full[s], c0, g * N + qs);
          tma_load_2d(tabs + RWB, &maps.rh, &full[s], kh0, g * N + qs);
        }
      }
      // lse (times log2 e; +inf past N, so p = 0) and delta of the 64 queries
      {
        const int qi = qs + (pt & 63);
        float x;
        if (pt < 64) x = qi < N ? lse[(size_t)g * N + qi] * LOG2E : INFINITY;
        else x = qi < N ? delta[(size_t)g * N + qi] : 0.f;
        vec[s * 128 + pt] = x;
      }
      if (TAB == TAB_LOADS) {  // rel_h[q, kh0 + j] for j < hspan, rel_w[q, 0:Wk]
        float* rh_s = reinterpret_cast<float*>(tabs);
        float* rw_s = rh_s + 64 * RHS;
        for (int i0 = pt; i0 < 64 * hspan; i0 += 128 * 4) {
          float x[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * 128, row = i / hspan, j = i - row * hspan;
            x[u] = (i < 64 * hspan && qs + row < N && kh0 + j < Hk)
                       ? __ldg(rel_h + ((size_t)g * N + qs + row) * Hk + kh0 + j)
                       : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * 128, row = i / hspan;
            if (i < 64 * hspan) rh_s[row * RHS + i - row * hspan] = x[u];
          }
        }
        const int rows = min(64, N - qs);
        const float* src = rel_w + ((size_t)g * N + qs) * Wk;  // the tile's rows are contiguous
        for (int i0 = pt; i0 < 64 * Wk; i0 += 128 * 8) {
          float x[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int i = i0 + u * 128;
            x[u] = i < rows * Wk ? __ldg(src + i) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int i = i0 + u * 128, row = i / Wk;
            if (i < 64 * Wk) rw_s[row * RWS + i - row * Wk] = x[u];
          }
        }
      }
      mbar_arrive(&full[s]);
      ring.advance();
    }
    return;
  }

  if (TAB == TAB_LOADS) setmaxnreg_inc<224>();
  else setmaxnreg_inc<232>();
  const int wg = tid >> 7, t = tid & 127;
  const int r = 16 * (t >> 5) + ((t & 31) >> 2), c = t & 3;
  const int kw0 = k0 + wg * 64;  // this warpgroup's first key
  // the thread's two keys (rows r, r + 8): grid row relative to kh0, and
  // where grid column kw lies in a table row (TAB_TMA: the 32-column box,
  // and the swizzled position for each parity e of the query column, whose
  // row q has q % 8 = 2c + e)
  int khrel[2] = {0, 0}, kwo[2][2] = {{0, 0}, {0, 0}};
  if (TAB != TAB_NONE) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = kw0 + r + 8 * h;
      if (key < N) {
        const int kh = key / Wk, kw = key - kh * Wk;
        khrel[h] = kh - kh0;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          kwo[h][e] = TAB == TAB_TMA
                          ? kw / 32 * 64 * 32 + ((((kw & 31) >> 2) ^ (2 * c + e)) << 2) + (kw & 3)
                          : kw;
      }
    }
  }
  const float sl2 = scale * LOG2E;
  float dka[32], dkt[8], dva[32], dvt[8];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) dkt[i] = dvt[i] = 0.f;

  mbar_wait(kvbar, 0);
  const unsigned char* km = sm + L::K;
  const unsigned char* ktl = sm + L::KT;
  const unsigned char* vm = sm + L::V;
  const unsigned char* vtl = sm + L::VT;
  const int r0 = wg * 64;

  Ring<S> ring;
  for (int qt = 0; qt < nq; ++qt) {
    const int s = ring.stage;
    const unsigned char* qm = sm + L::Q + s * C::tile_bytes(64);
    const unsigned char* qtl = sm + L::QT + s * C::tail_bytes(64);
    const unsigned char* dom = sm + L::DO + s * C::tile_bytes(64);
    const unsigned char* dotl = sm + L::DOT + s * C::tail_bytes(64);
    const float* lse_s = vec + s * 128;
    const float* delta_s = lse_s + 64;
    const float* tabs = reinterpret_cast<const float*>(sm + L::TABLES + s * TB);
    const float* rh_s = TAB == TAB_TMA ? tabs + RWB / 4 : tabs;
    const float* rw_s = TAB == TAB_TMA ? tabs : tabs + 64 * RHS;
    const int rws = TAB == TAB_TMA ? 32 : RWS;  // floats a row of rw_s
    mbar_wait(&full[s], ring.phase);

    float sa[32], pa[32];
    if (qt > 0 || wg == 1) turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk)
      wgmma_ss<64>(sa, desc_k<HD>(km, ktl, r0, kk), desc_k<HD>(qm, qtl, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk)
      wgmma_ss<64>(pa, desc_k<HD>(vm, vtl, r0, kk), desc_k<HD>(dom, dotl, 0, kk), kk);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<1>();
    fence_regs(sa);

    // P^T: rows are keys, columns queries
    uint32_t pb[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 8 * j + 2 * c + e, idx = 4 * j + 2 * h + e;
          float bias2 = 0.f;
          if (TAB != TAB_NONE) bias2 = (rh_s[q * RHS + khrel[h]] + rw_s[q * rws + kwo[h][e]]) * LOG2E;
          p[e] = ex2(fmaf(sa[idx], sl2, bias2 - lse_s[q]));
          sa[idx] = p[e];
        }
        pb[j >> 1][(j & 1) * 2 + h] = pack_bf16(p[0], p[1]);
      }
    wgmma_wait<0>();
    fence_regs(pa);

    uint32_t db[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = 4 * j + 2 * h, q = 8 * j + 2 * c;
        db[j >> 1][(j & 1) * 2 + h] = pack_bf16(sa[idx] * (pa[idx] - delta_s[q]),
                                               sa[idx + 1] * (pa[idx + 1] - delta_s[q + 1]));
      }

    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      wgmma_rs_n64(dva, pb[kb], desc_mn(dom, kb));
      if (C::TAIL) wgmma_rs_n16(dvt, pb[kb], desc_mn_tail(dotl, kb));
      wgmma_rs_n64(dka, db[kb], desc_mn(qm, kb));
      if (C::TAIL) wgmma_rs_n16(dkt, db[kb], desc_mn_tail(qtl, kb));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dvt);
    fence_regs(dka);
    fence_regs(dkt);
    fence_regs(pb);
    fence_regs(db);
    mbar_arrive(&empty[s]);
    ring.advance();
  }
  if (wg == 0) turn_wait(0);

  const size_t row_stride = (size_t)heads * HD;
  const size_t base = ((size_t)b * N * heads + head) * HD;
  store_acc<HD>(dk + base, row_stride, N, kw0, dka, dkt, scale, scale);
  store_acc<HD>(dv + base, row_stride, N, kw0, dva, dvt, 1.f, 1.f);
}

// ------------------------------------------------------------------ host

// Tensor maps of q, dout, k, v with boxes of `qrows` (q, dout) and `krows`
// (k, v) tokens.
int make_maps(Maps* m, int G, int N, int heads, int hd, const void* q, const void* dout,
              const void* k, const void* v, int qrows, int krows) {
  const int B = G / heads;
  int e = hopper_host::make_head_maps(m->q, q, B, N, heads, hd, qrows);
  if (!e) e = hopper_host::make_head_maps(m->dout, dout, B, N, heads, hd, qrows);
  if (!e) e = hopper_host::make_head_maps(m->k, k, B, N, heads, hd, krows);
  if (!e) e = hopper_host::make_head_maps(m->v, v, B, N, heads, hd, krows);
  return e;
}

// Dynamic shared memory of a K14 / K15 launch (the layouts' arithmetic at
// run time, held equal to them by the launchers' static_asserts).
constexpr int row_bytes(int hd) { return hd > 64 ? 160 : 128; }
constexpr int dq_tables(int hd, int bkn) {
  return ((2 * ROWS * row_bytes(hd) + 2 * DQ_STAGES * bkn * row_bytes(hd) + 15) / 16 * 16 +
          (2 * DQ_STAGES + 1) * 8 + ROWS * 4 + 15) / 16 * 16;
}
constexpr int dkv_tables(int hd) {
  return ((2 * ROWS * row_bytes(hd) + 2 * DKV_STAGES * 64 * row_bytes(hd) + 15) / 16 * 16 +
          (2 * DKV_STAGES + 1) * 8 + DKV_STAGES * 2 * 64 * 4 + 1023) / 1024 * 1024;
}
size_t dq_smem(int hd, int bkn, int mode, int Hk, int Wk) {
  const int cols = mode == GENERAL ? Hk + Wk : mode == GRID_ROWS ? Hk + 1 : 0;
  return SMEM_ALIGN + dq_tables(hd, bkn) + (size_t)ROWS * cols * 4;
}
size_t dkv_smem(int hd, int tab, int Wk, int hspan) {
  return SMEM_ALIGN + dkv_tables(hd) + (size_t)DKV_STAGES * table_bytes(tab, Wk, hspan);
}

template <int HD, int BKN, int MODE>
int launch_dq(const Maps& maps, int G, int N, int heads, float scale, const void* rel_h,
              const void* rel_w, int Hk, int Wk, const void* o, const void* dout, const void* lse,
              void* delta, void* dq, void* drh, void* drw, cudaStream_t st) {
  static_assert(DqLayout<HD, BKN>::TABLES == dq_tables(HD, BKN), "K14 layout");
  const size_t smem = dq_smem(HD, BKN, MODE, Hk, Wk);
  auto kernel = attention_bwd_dq_kernel<HD, BKN, MODE>;
  static hopper_host::SmemOptIn opt_in;
  const int e = opt_in(kernel, smem);
  if (e) return e;
  const dim3 grid((N + ROWS - 1) / ROWS, G);
  kernel<<<grid, THREADS, smem, st>>>(maps, N, heads, scale, (const float*)rel_h,
                                      (const float*)rel_w, Hk, Wk, (const bf16*)o,
                                      (const bf16*)dout, (const float*)lse, (float*)delta,
                                      (bf16*)dq, (float*)drh, (float*)drw);
  return (int)cudaGetLastError();
}

template <int HD, int TAB>
int launch_dkv(const Maps& maps, int G, int N, int heads, float scale, const void* rel_h,
               const void* rel_w, int Hk, int Wk, int hspan, const void* lse, const void* delta,
               void* dk, void* dv, cudaStream_t st) {
  static_assert(DkvLayout<HD>::TABLES == dkv_tables(HD), "K15 layout");
  const size_t smem = dkv_smem(HD, TAB, Wk, hspan);
  auto kernel = attention_bwd_dkv_kernel<HD, TAB>;
  static hopper_host::SmemOptIn opt_in;
  const int e = opt_in(kernel, smem);
  if (e) return e;
  const dim3 grid((N + ROWS - 1) / ROWS, G);
  kernel<<<grid, THREADS, smem, st>>>(maps, N, heads, scale, (const float*)rel_h,
                                      (const float*)rel_w, Hk, Wk, hspan, (const float*)lse,
                                      (const float*)delta, (bf16*)dk, (bf16*)dv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The plan of a call (flash.py::bwd_plan mirrors it): plan[0] K14's mode
// (0 no bias, 1 one grid row a key tile, 2 general), plan[1] its key tile,
// plan[2] the rel_h columns a K15 block stages (0 without a bias), plan[3]
// how K15 stages the tables (0 none, 1 TMA, 2 plain loads), plan[4] and
// plan[5] K14's and K15's dynamic shared memory in bytes.
int attention_bwd_plan(int hd, int has_bias, int Hk, int Wk, int* plan) {
  const Plan p = make_plan(hd, has_bias != 0, Hk, Wk);
  plan[0] = p.mode, plan[1] = p.key_tile, plan[2] = p.hspan, plan[3] = p.tables;
  plan[4] = (int)dq_smem(hd, p.key_tile, p.mode, Hk, Wk);
  plan[5] = (int)dkv_smem(hd, p.tables, Wk, p.hspan);
  return 0;
}

// K14. q, k, v, o, dout, dq: bf16 in K3's layouts (token row stride
// heads*hd, group g = (g / heads, g % heads)); hd 64 or 72. rel_h / rel_w
// [G, N, Hk] / [G, N, Wk] fp32 and drh / drw the same, or all four null.
// lse [G, N] fp32 from K3; writes delta [G, N] fp32 = rowsum(dout o) for K15.
int attention_bwd_dq(int G, int N, int heads, int hd, float scale, const void* q,
                     const void* k, const void* v, const void* rel_h, const void* rel_w,
                     int Hk, int Wk, const void* o, const void* dout, const void* lse,
                     void* delta, void* dq, void* drh, void* drw, void* stream) {
  const int bad = hopper_host::check_geometry(G, N, heads, hd, rel_h, rel_w, Hk, Wk);
  if (bad) return bad;
  if ((rel_h == nullptr) != (drh == nullptr) || (rel_w == nullptr) != (drw == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Plan p = make_plan(hd, rel_h != nullptr, Hk, Wk);
  Maps maps;
  const int e = make_maps(&maps, G, N, heads, hd, q, dout, k, v, ROWS, p.key_tile);
  if (e) return e;
#define VRWKV_DQ(HD, BKN, MODE)                                                                 \
  return launch_dq<HD, BKN, MODE>(maps, G, N, heads, scale, rel_h, rel_w, Hk, Wk, o, dout, lse, \
                                  delta, dq, drh, drw, st)
  if (hd == 64) {
    if (p.mode == NOBIAS) VRWKV_DQ(64, 64, NOBIAS);
    if (p.mode == GENERAL) VRWKV_DQ(64, 64, GENERAL);
    switch (p.key_tile) {
      case 16: VRWKV_DQ(64, 16, GRID_ROWS);
      case 32: VRWKV_DQ(64, 32, GRID_ROWS);
      case 48: VRWKV_DQ(64, 48, GRID_ROWS);
      default: VRWKV_DQ(64, 64, GRID_ROWS);
    }
  }
  // hd 72: the head dim of SigLIP, whose attention has no bias
  if (p.mode == NOBIAS) VRWKV_DQ(72, 64, NOBIAS);
  VRWKV_DQ(72, 64, GENERAL);
#undef VRWKV_DQ
}

// K15, after K14 on the same stream (it reads K14's delta). dk, dv bf16 in
// the layout of k and v.
int attention_bwd_dkv(int G, int N, int heads, int hd, float scale, const void* q,
                      const void* k, const void* v, const void* rel_h, const void* rel_w,
                      int Hk, int Wk, const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, void* stream) {
  const int bad = hopper_host::check_geometry(G, N, heads, hd, rel_h, rel_w, Hk, Wk);
  if (bad) return bad;
  const cudaStream_t st = (cudaStream_t)stream;
  const Plan p = make_plan(hd, rel_h != nullptr, Hk, Wk);
  Maps maps;
  int e = make_maps(&maps, G, N, heads, hd, q, dout, k, v, 64, ROWS);
  if (e) return e;
  if (p.tables == TAB_TMA) {
    e = hopper_host::make_f32_map(&maps.rw, rel_w, Wk, G * N, 32, 64, true);
    if (!e) e = hopper_host::make_f32_map(&maps.rh, rel_h, Hk, G * N, rh_box(p.hspan), 64, false);
    if (e) return e;
  }
#define VRWKV_DKV(HD, TAB)                                                                      \
  return launch_dkv<HD, TAB>(maps, G, N, heads, scale, rel_h, rel_w, Hk, Wk, p.hspan, lse,     \
                             delta, dk, dv, st)
  if (hd == 64) {
    if (p.tables == TAB_TMA) VRWKV_DKV(64, TAB_TMA);
    if (p.tables == TAB_LOADS) VRWKV_DKV(64, TAB_LOADS);
    VRWKV_DKV(64, TAB_NONE);
  }
  if (p.tables == TAB_TMA) VRWKV_DKV(72, TAB_TMA);
  if (p.tables == TAB_LOADS) VRWKV_DKV(72, TAB_LOADS);
  VRWKV_DKV(72, TAB_NONE);
#undef VRWKV_DKV
}

}  // extern "C"
