// The chunked RWKV-7 ("x070") backward on Hopper: K6 wkv7_bwd (wkv7_train.cu)
// and its head-pair twin K13 wkv7_bwd_packed (wkv7_packed.cu), two kernels
// launched one after the other, wkv7_bwd_state_kernel<DT, ROWS, ZHEADS> and
// wkv7_bwd_chunk_kernel<DT, ZHEADS>. Device code and the launch helper only;
// each .cu file defines its own plain C entry point.
//
// It replaces visualrwkv_tpu/ops/wkv7_pallas.py::wkv7_pallas_bwd and
// wkv7_pallas_bwd_packed (_wkv7_bwd_math): the vector-Jacobian product of
// the chunk form of wkv7_chunk.cuh at chunk 16, from the states K5 / K12
// saved, zin[.., c] = Z0 = S^T entering chunk c (ZHEADS = 1: head layout;
// 2: packed, row stride 128 at run time, as K5 / K12 write it). K6 and K13
// differ only in that address, so their results are bit-equal.
//
// With dY the chunk's output cotangent [t][i], dZ1 the cotangent of the
// state leaving it [j][i] and the u form's quantities (wkv7_chunk.cuh), the
// VJP splits in two:
//   (a) per value row i (column i of Z):
//       dU_i    = sb^T dy_i + bbar dz1_i
//       dWpre_i = (I - M)^{-T} dU_i                 (back substitution)
//       dv_i    = sk^T dy_i + kbar dz1_i + Nm^T dWpre_i
//       dz0_i   = rt^T dy_i + e^{g_l} (.) dz1_i + at^T dWpre_i
//   no sum over rows and no Z0: the cotangent recurrence, pass 1;
//   (b) the sums over rows, chunk-local once Z0 and dZ1 are known, pass 2:
//       dM = strict(dWpre u^T), dN = strict(dWpre V^T), dSB = incl(dY u^T),
//       dSK = incl(dY V^T), P_A = dWpre Z0^T, P_R = dY Z0^T,
//       dBbar = u dZ1^T, dKbar = V dZ1^T (each over the 64 rows i), then
//       da = P_A e^{g_p} + (dM bm + dN km) e^{g_p - g_m}
//       dr = P_R e^{g} + (dSB bm + dSK km) e^{g - g_m}
//       db = (dM^T am + dSB^T rm) e^{g_m - g} + dBbar e^{g_l - g}
//       dk = (dN^T am + dSK^T rm) e^{g_m - g} + dKbar e^{g_l - g}
//   with u recomputed by K5's forward substitution and dWpre by pass 1's.
// dw: every term of the chunk's outputs carries e to a sum of log decays
// over the steps it spans, so d log w_s is the sum of the terms that span
// step s: y's r e^{g} Z0 (s <= t), u's a e^{g_p} Z0 (s < t), the pairs
// (t, t1) of sb / sk (t1 < s <= t) and of M / Nm (t1 < s < t), Z1's
// bbar / kbar terms (s > t) and e^{g_l} Z0 (every s); dw_raw = d log w
// * (-e^{w_raw}). The Pallas kernel's form of the same sum (each step's
// dg = r dr - b db - k dk and a da, summed over t >= s) cancels terms of
// the whole chunk against each other: in fp32 it read 4.3e-4 relative error
// at w_raw = 2.0 where this form reads 3e-6 (tests/test_torch_wkv7_chunk_bwd.py).
//
// Range: as K5. Every e^{-g}-type factor is one of K5's step-7-referenced
// am, rm, bm, km (a difference spanning at most 8 steps, a normal float
// while w_raw <= 2.4) or a difference formed inside one exp2, never e^{-g}
// alone.
//
// Pass 1, wkv7_bwd_state_kernel: K5's layout in reverse. A block owns a
// slice of ROWS value rows of one (b, h) (ops/wkv7_cuda.py::fwd_res_plan) and
// walks the T/16 chunks from the last, from dsf, with the same two-phase
// pipeline, cp.async ring and factor / matrix code as K5 (the matrices
// stored [M | Nm^T | sb^T | sk^T] so that the transposed solve reads rows):
//   phase 1: the factors of the next chunk; for this chunk at the thread's
//            steps the products along j (bbar dz1_i, kbar dz1_i) and along
//            t (sb^T dy_i, sk^T dy_i); dU to shared memory;
//   phase 2: the matrices of the next chunk; the back substitution (every
//            thread of a row walks the row's 16 steps), dv at the thread's
//            steps, dZ1[c] (the row's cotangent before the chunk's update,
//            stored as zin is), and the update of the thread's columns.
// It reads r, w, k, a, b and dy, never v or zin, and writes dv, dZ1 (fp32,
// zin's layout and size: a workspace the wrapper allocates) and ds0.
//
// Pass 2, wkv7_bwd_chunk_kernel: one block of 256 threads for each (b, h,
// chunk), B*H*T/16 of them, each with the whole head; nothing waits on
// another chunk. It loads Z0, dZ1, r, w, k, a, b (cp.async) and v, dy
// (fp32), then, one barrier apart:
//   the factors (K5's code, also keeping g) and the matrices (K5's layout);
//   w_pre = Nm V + at Z0 (threads 0-127) and dU = sb^T dY + bbar dZ1
//   (128-255), a 2 x 4 register tile (steps x columns i) a thread;
//   u's forward substitution (64 threads) and dWpre's back substitution
//   (64 threads), a column a thread;
//   dM, dN, dSB, dSK (a thread an entry (t, s), stored with transposes),
//   P_A, P_R, dBbar, dKbar (4 x 4 register tiles, 16 of them a 16 x 64
//   pair, parked where Z0 was) and sum_i dZ1 Z0;
//   at column j and steps f, f + 4, f + 8, f + 12 (thread (j, f), so that
//   the rows a warp reads at once lie in four different bank groups): the
//   terms of d log w that reach Z0 or Z1, then, two steps at a time, the
//   (t, s) sums against am, rm, bm, km with the pair terms of d log w and
//   the gradients; d log w's sums over the thread's steps are reduced
//   across the four threads of a column by shuffles. (Four steps at a time
//   spill under the 128 registers that two blocks a multiprocessor allow:
//   chip_variants.py --wkv7bwd pairs4.)
// All arithmetic is fp32 FMA; everything reduces inside a block, with no
// atomics.
//
// Bound on the H100: fp32 operations, about 27 B*T*H*64*64 for the work
// itself (the same count as the sequential form's); the extra traffic of the
// two passes is the dZ1 workspace, written once and read once (B*H*(T/16)
// *16 KiB), and zin read again by pass 2. What holds it at about 5.6x the
// bound (B=2 T=2048 H=32 bf16, H100): pass 1 is K5's loop in reverse and
// costs what K5 does (latency: one block a multiprocessor, two barriers a
// chunk); pass 2's row and pair sums are fp32 FMA fed from shared memory,
// bound by its load bandwidth (3xTF32 mma.sync is the next step).
#pragma once

#include "wkv7_chunk.cuh"

namespace {

constexpr int CB_THREADS = 256;       // pass 2: threads a block
constexpr int CB_P = CB_THREADS / N;  // pass 2: threads a column j
constexpr int CB_MLD = CHUNK + 4;     // row stride of the 16 x 16 cotangent matrices

// Byte offsets of a pass-2 block's shared memory. cot (dM, dN, dSB, dSK and
// their transposes) takes the place of az, bl and mats once the solves have
// read them; rz and kl, which pass 2 does not use, land in u and dw before
// those are written.
template <int DT>
struct ChunkBwdSmem {
  static constexpr int FTILE = CHUNK * C_LDP * 4;  // bytes of an fp32 [t][j] tile
  static constexpr int ZTILE = N * C_LDP * 4;      // bytes of an fp32 [j][i] state
  static constexpr int MATS = 4 * CHUNK * CHUNK;   // floats of M^T, Nm, sb, sk
  static constexpr int COT = 8 * CHUNK * CB_MLD;   // floats of the cotangent matrices
  static constexpr size_t raw = 0;                                              // r, w, k, a, b
  static constexpr size_t vt = raw + 5 * CHUNK * N * sizeof(ChunkStream<DT>);   // v [t][i]
  static constexpr size_t dyt = vt + FTILE;                                     // dy [t][i]
  static constexpr size_t az = dyt + FTILE;
  static constexpr size_t bl = az + FTILE;
  static constexpr size_t mats = bl + FTILE;
  static constexpr size_t cot = az;
  static constexpr size_t am = (mats + MATS * 4 > cot + COT * 4 ? mats + MATS * 4 : cot + COT * 4);
  static constexpr size_t rm = am + FTILE;
  static constexpr size_t bm = rm + FTILE;
  static constexpr size_t km = bm + FTILE;
  static constexpr size_t gt = km + FTILE;  // the running log decay g (log2 units)
  static constexpr size_t u = gt + FTILE;   // w_pre, then u [t][i]
  static constexpr size_t dw = u + FTILE;   // dU, then dWpre [t][i]
  static constexpr size_t dec = dw + FTILE;
  static constexpr size_t z0 = dec + N * 4;  // [j][i]
  static constexpr size_t dz1 = z0 + ZTILE;
  static constexpr size_t bytes = dz1 + ZTILE;
};

// ---------------------------------------------------------------------------
// Pass 1: the cotangent recurrence over a slice of value rows.
// ---------------------------------------------------------------------------
template <int DT, int ROWS, int ZHEADS>
__global__ void __launch_bounds__(ROWS * chunk_threads_a_row<ROWS>(), 1) wkv7_bwd_state_kernel(
    int Tlen, int H, const ChunkStream<DT>* __restrict__ r, const ChunkStream<DT>* __restrict__ w,
    const ChunkStream<DT>* __restrict__ k, const ChunkStream<DT>* __restrict__ a,
    const ChunkStream<DT>* __restrict__ b, const ChunkStream<DT>* __restrict__ dy,
    const float* __restrict__ dsf, ChunkStream<DT>* __restrict__ dv, float* __restrict__ ds0,
    float* __restrict__ dz1, int zrow) {
  using T = ChunkStream<DT>;
  using L = ChunkSmem<DT, ROWS>;
  constexpr int TPR = chunk_threads_a_row<ROWS>();
  constexpr int NT = ROWS * TPR;    // threads
  constexpr int CPT = N / TPR;      // columns of dZ a thread
  constexpr int Q4 = CPT / 4;       // ... as float4
  constexpr int OPT = CHUNK / TPR;  // steps a thread in the products
  constexpr int P = NT / N;         // factor pass: threads a column
  constexpr int FT = CHUNK * C_LDP;  // floats of a factor tile
  constexpr int CC = CHUNK * CHUNK;
  static_assert((ROWS == 16 || ROWS == 32 || ROWS == 64) && NT >= 128 && NT <= 256, "ROWS");

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
  float* sdu = reinterpret_cast<float*>(chunk_smem + L::rhs);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / (N / ROWS), i0 = (blockIdx.x % (N / ROWS)) * ROWS;
  const int h = bh % H;
  const int nc = Tlen / CHUNK;
  const size_t tstride = (size_t)H * N;
  const size_t base = ((size_t)(bh / H) * Tlen * H + h) * N;
  const int si = tid % ROWS, sg = tid / ROWS;
  const int fj = tid / P, fp = tid % P;
  int ts[OPT];
#pragma unroll
  for (int o = 0; o < OPT; ++o) ts[o] = 2 * TPR * (o / 2) + (o % 2 ? 2 * TPR - 1 - sg : sg);

  // dZ's column i0 + si (dS's row), entries CPT sg .. CPT sg + CPT
  float4 D[Q4];
  const size_t srow = ((size_t)bh * N + i0 + si) * N + CPT * sg;  // in dsf and ds0
#pragma unroll
  for (int q = 0; q < Q4; ++q) D[q] = reinterpret_cast<const float4*>(dsf + srow)[q];
  auto put_state = [&]() {
#pragma unroll
    for (int q = 0; q < Q4; ++q) reinterpret_cast<float4*>(st + si * C_LDP + CPT * sg)[q] = D[q];
  };
  put_state();
  for (int idx = tid; idx < 2 * L::MATS; idx += NT) mats[idx] = 0.f;
  float* zhead = dz1 + (size_t)(bh / ZHEADS) * nc * N * zrow + (bh % ZHEADS) * N + i0 + si;

  // position p of the walk is chunk nc - 1 - p
  auto load = [&](int p) {
    chunk_load<T, ROWS, NT>(raw + (p % C_STAGES) * L::STAGE, tid,
                            base + (size_t)(nc - 1 - p) * CHUNK * tstride, tstride, i0, r, w, k, a, b, dy);
  };
  auto factors = [&](int p) {
    const int o = (p & 1) * FT;
    chunk_factors<T, P>(raw + (p % C_STAGES) * L::STAGE, fj, fp, az + o, rz + o, bl + o, kl + o, am, rm,
                        bm, km, dec + (p & 1) * N);
  };
  auto matrices = [&](int p) { chunk_matrices<NT, true>(tid, am, rm, bm, km, mats + (p & 1) * L::MATS); };

  // phase 1 (b): dU at the thread's steps (to shared memory) and dv's part
  // without dWpre (returned in pv)
  auto products = [&](int p, float* pv) {
    const T* dyx = raw + (p % C_STAGES) * L::STAGE + 5 * L::TILE + si;
    const float4* z4 = reinterpret_cast<const float4*>(st + si * C_LDP);
    const float4* bq[OPT];
    const float4* kq[OPT];
    float pu[OPT];
#pragma unroll
    for (int o = 0; o < OPT; ++o) {
      bq[o] = reinterpret_cast<const float4*>(bl + (p & 1) * FT + ts[o] * C_LDP);
      kq[o] = reinterpret_cast<const float4*>(kl + (p & 1) * FT + ts[o] * C_LDP);
      pu[o] = 0.f;
      pv[o] = 0.f;
    }
#pragma unroll 4
    for (int jj = 0; jj < N / 4; ++jj) {
      const float4 zv = z4[jj];
#pragma unroll
      for (int o = 0; o < OPT; ++o) {
        pu[o] = dot4(bq[o][jj], zv, pu[o]);
        pv[o] = dot4(kq[o][jj], zv, pv[o]);
      }
    }
    float ds[CHUNK];
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) ds[s] = to_f(dyx[s * ROWS]);
    const float* mt = mats + (p & 1) * L::MATS;
#pragma unroll
    for (int o = 0; o < OPT; ++o) {
      const float4* sbq = reinterpret_cast<const float4*>(mt + 2 * CC + ts[o] * CHUNK);
      const float4* skq = reinterpret_cast<const float4*>(mt + 3 * CC + ts[o] * CHUNK);
#pragma unroll
      for (int s4 = 0; s4 < CHUNK / 4; ++s4) {
        const float4 dq = make_float4(ds[4 * s4], ds[4 * s4 + 1], ds[4 * s4 + 2], ds[4 * s4 + 3]);
        pu[o] = dot4(sbq[s4], dq, pu[o]);
        pv[o] = dot4(skq[s4], dq, pv[o]);
      }
      sdu[ts[o] * ROWS + si] = pu[o];
    }
  };

  // phase 2 (b): dWpre (M^T's solve), dv at the thread's steps, dZ1 of the
  // chunk (the cotangent before its update), then the thread's part of dZ
  // through the chunk
  auto finish = [&](int p, const float* pv) {
    const int c = nc - 1 - p;
    const float* mt = mats + (p & 1) * L::MATS;
    float x[CHUNK];
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) x[t] = sdu[t * ROWS + si];
#pragma unroll
    for (int tp = CHUNK - 1; tp > 0; --tp) {  // row tp of M: x[t] += M[tp][t] x[tp], t < tp
#pragma unroll
      for (int t4 = 0; t4 <= (tp - 1) / 4; ++t4) {
        const float4 m = reinterpret_cast<const float4*>(mt + tp * CHUNK)[t4];
        const float mm[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * t4 + e < tp) x[4 * t4 + e] = fmaf(mm[e], x[tp], x[4 * t4 + e]);
      }
    }
#pragma unroll
    for (int o = 0; o < OPT; ++o) {
      const float4* nq = reinterpret_cast<const float4*>(mt + CC + ts[o] * CHUNK);
      float d = pv[o];
#pragma unroll
      for (int s4 = 0; s4 < CHUNK / 4; ++s4)
        d = dot4(nq[s4], make_float4(x[4 * s4], x[4 * s4 + 1], x[4 * s4 + 2], x[4 * s4 + 3]), d);
      dv[base + (size_t)(c * CHUNK + ts[o]) * tstride + i0 + si] = from_f<T>(d);
    }
    float* z = zhead + ((size_t)c * N + CPT * sg) * zrow;  // dZ1[.., c, j, ..]
#pragma unroll
    for (int q = 0; q < Q4; ++q) {
      z[(size_t)(4 * q) * zrow] = D[q].x;
      z[(size_t)(4 * q + 1) * zrow] = D[q].y;
      z[(size_t)(4 * q + 2) * zrow] = D[q].z;
      z[(size_t)(4 * q + 3) * zrow] = D[q].w;
    }
    const T* dyx = raw + (p % C_STAGES) * L::STAGE + 5 * L::TILE + si;
    const float4* rq = reinterpret_cast<const float4*>(rz + (p & 1) * FT + CPT * sg);
    const float4* aq = reinterpret_cast<const float4*>(az + (p & 1) * FT + CPT * sg);
    const float4* dq = reinterpret_cast<const float4*>(dec + (p & 1) * N + CPT * sg);
#pragma unroll
    for (int q = 0; q < Q4; ++q) {
      const float4 e = dq[q];
      D[q] = make_float4(D[q].x * e.x, D[q].y * e.y, D[q].z * e.z, D[q].w * e.w);
    }
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) {
      const float ys = to_f(dyx[s * ROWS]), xs = x[s];
#pragma unroll
      for (int q = 0; q < Q4; ++q) {
        const float4 rr = rq[s * (C_LDP / 4) + q], aa = aq[s * (C_LDP / 4) + q];
        D[q] = make_float4(fmaf(xs, aa.x, fmaf(ys, rr.x, D[q].x)), fmaf(xs, aa.y, fmaf(ys, rr.y, D[q].y)),
                           fmaf(xs, aa.z, fmaf(ys, rr.z, D[q].z)), fmaf(xs, aa.w, fmaf(ys, rr.w, D[q].w)));
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
  for (int p = 0; p < nc; ++p) {
    cp_async_wait<0>();  // position p + 1's inputs
    __syncthreads();
    if (p + 2 < nc) load(p + 2);
    if (p + 1 < nc) factors(p + 1);
    float pv[OPT];
    products(p, pv);
    __syncthreads();
    if (p + 1 < nc) matrices(p + 1);
    finish(p, pv);
  }

#pragma unroll
  for (int q = 0; q < Q4; ++q) reinterpret_cast<float4*>(ds0 + srow)[q] = D[q];
}

// ---------------------------------------------------------------------------
// Pass 2: the chunk-local sums over value rows, a block a (b, h, chunk).
// ---------------------------------------------------------------------------
template <int DT, int ZHEADS>
__global__ void __launch_bounds__(CB_THREADS, 2) wkv7_bwd_chunk_kernel(
    int Tlen, int H, const ChunkStream<DT>* __restrict__ r, const ChunkStream<DT>* __restrict__ w,
    const ChunkStream<DT>* __restrict__ k, const ChunkStream<DT>* __restrict__ v,
    const ChunkStream<DT>* __restrict__ a, const ChunkStream<DT>* __restrict__ b,
    const ChunkStream<DT>* __restrict__ dy, const float* __restrict__ zin,
    const float* __restrict__ dz1, ChunkStream<DT>* __restrict__ dr, ChunkStream<DT>* __restrict__ dw,
    ChunkStream<DT>* __restrict__ dk, ChunkStream<DT>* __restrict__ da,
    ChunkStream<DT>* __restrict__ db, int zrow) {
  using T = ChunkStream<DT>;
  using L = ChunkBwdSmem<DT>;
  constexpr int NT = CB_THREADS;
  constexpr int TILE = CHUNK * N, VEC = 16 / sizeof(T);
  constexpr int CC = CHUNK * CHUNK, MC = CHUNK * CB_MLD;
  constexpr unsigned FULL = 0xffffffffu;

  extern __shared__ __align__(16) unsigned char chunk_smem[];
  T* raw = reinterpret_cast<T*>(chunk_smem + L::raw);
  float* vt = reinterpret_cast<float*>(chunk_smem + L::vt);
  float* dyt = reinterpret_cast<float*>(chunk_smem + L::dyt);
  float* az = reinterpret_cast<float*>(chunk_smem + L::az);
  float* bl = reinterpret_cast<float*>(chunk_smem + L::bl);
  float* mats = reinterpret_cast<float*>(chunk_smem + L::mats);
  float* cot = reinterpret_cast<float*>(chunk_smem + L::cot);
  float* am = reinterpret_cast<float*>(chunk_smem + L::am);
  float* rm = reinterpret_cast<float*>(chunk_smem + L::rm);
  float* bm = reinterpret_cast<float*>(chunk_smem + L::bm);
  float* km = reinterpret_cast<float*>(chunk_smem + L::km);
  float* gt = reinterpret_cast<float*>(chunk_smem + L::gt);
  float* su = reinterpret_cast<float*>(chunk_smem + L::u);
  float* sw = reinterpret_cast<float*>(chunk_smem + L::dw);
  float* dec = reinterpret_cast<float*>(chunk_smem + L::dec);
  float* z0 = reinterpret_cast<float*>(chunk_smem + L::z0);
  float* zd = reinterpret_cast<float*>(chunk_smem + L::dz1);

  const int tid = threadIdx.x;
  const int nc = Tlen / CHUNK;
  const int bh = blockIdx.x / nc, c = blockIdx.x % nc;
  const int h = bh % H;
  const size_t tstride = (size_t)H * N;
  const size_t c0 = ((size_t)(bh / H) * Tlen * H + h) * N + (size_t)c * CHUNK * tstride;  // (b, 16c, h, 0)
  const size_t zoff = ((size_t)(bh / ZHEADS) * nc + c) * N * zrow + (bh % ZHEADS) * N;

  // the chunk's r, w, k, a, b (raw), Z0 and dZ1 by cp.async; v and dy as fp32
  {
    constexpr int ROW_SEGS = N / VEC, TILE_SEGS = CHUNK * ROW_SEGS;
    for (int idx = tid; idx < 5 * TILE_SEGS; idx += NT) {
      const int tile = idx / TILE_SEGS, t = idx % TILE_SEGS / ROW_SEGS, col = idx % ROW_SEGS * VEC;
      const T* src = tile == 0 ? r : tile == 1 ? w : tile == 2 ? k : tile == 3 ? a : b;
      cp_async16(raw + tile * TILE + t * N + col, src + c0 + (size_t)t * tstride + col, true);
    }
    for (int idx = tid; idx < 2 * N * (N / 4); idx += NT) {  // 16-byte segments of Z0 and dZ1
      const int which = idx / (N * N / 4), j = idx % (N * N / 4) / (N / 4), col = idx % (N / 4) * 4;
      cp_async16((which ? zd : z0) + j * C_LDP + col, (which ? dz1 : zin) + zoff + (size_t)j * zrow + col, true);
    }
    cp_async_commit();
    for (int idx = tid; idx < TILE; idx += NT) {
      const int t = idx / N, i = idx % N;
      vt[t * C_LDP + i] = to_f(v[c0 + (size_t)t * tstride + i]);
      dyt[t * C_LDP + i] = to_f(dy[c0 + (size_t)t * tstride + i]);
    }
    for (int idx = tid; idx < L::MATS; idx += NT) mats[idx] = 0.f;  // above the triangles
    cp_async_wait<0>();
    __syncthreads();
  }

  // the factors (rz and kl land in u and dw, unused) and the running sum g
  chunk_factors<T, CB_P, true>(raw, tid / CB_P, tid % CB_P, az, su, bl, sw, am, rm, bm, km, dec, gt);
  __syncthreads();
  chunk_matrices<NT, false>(tid, am, rm, bm, km, mats);  // M^T [s][t], Nm, sb, sk [t][s]
  __syncthreads();

  // w_pre = Nm V + at Z0 (threads 0-127) and dU = sb^T dY + bbar dZ1
  // (128-255): a 2 x 4 register tile a thread, steps tq and tq + 8 and
  // columns 4 iq .. 4 iq + 4
  {
    const bool upper = tid >= NT / 2;
    const int tq = tid % (NT / 2) / 16, i0 = 4 * (tid % 16);
    const float* lhs = upper ? bl : az;   // [t][j]
    const float* zs = upper ? zd : z0;    // [j][i]
    const float* xs = upper ? dyt : vt;   // [s][i]
    float4 acc[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
    auto fma4 = [](float a, float4 x, float4 y) {
      return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
    };
#pragma unroll 4
    for (int j4 = 0; j4 < N / 4; ++j4) {
      float4 zr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) zr[e] = *reinterpret_cast<const float4*>(zs + (4 * j4 + e) * C_LDP + i0);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 l = *reinterpret_cast<const float4*>(lhs + (tq + 8 * q) * C_LDP + 4 * j4);
        acc[q] = fma4(l.w, zr[3], fma4(l.z, zr[2], fma4(l.y, zr[1], fma4(l.x, zr[0], acc[q]))));
      }
    }
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(xs + s * C_LDP + i0);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int t = tq + 8 * q;  // Nm[t][s] or sb[s][t]
        acc[q] = fma4(upper ? mats[2 * CC + s * CHUNK + t] : mats[CC + t * CHUNK + s], x, acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
      *reinterpret_cast<float4*>((upper ? sw : su) + (tq + 8 * q) * C_LDP + i0) = acc[q];
  }
  __syncthreads();

  // u = (I - M)^{-1} w_pre (threads 0-63) and dWpre = (I - M)^{-T} dU
  // (64-127), a column a thread
  if (tid < 2 * N) {
    const int i = tid % N;
    const bool back = tid >= N;
    float* col = (back ? sw : su) + i;
    float x[CHUNK];
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) x[t] = col[t * C_LDP];
    if (!back) {
#pragma unroll
      for (int s = 0; s < CHUNK - 1; ++s) {  // column s of M: x[t] += M[t][s] x[s], t > s
#pragma unroll
        for (int t4 = (s + 1) / 4; t4 < CHUNK / 4; ++t4) {
          const float4 m = reinterpret_cast<const float4*>(mats + s * CHUNK)[t4];
          const float mm[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * t4 + e > s) x[4 * t4 + e] = fmaf(mm[e], x[s], x[4 * t4 + e]);
        }
      }
    } else {
#pragma unroll
      for (int t = CHUNK - 2; t >= 0; --t) {  // x[t] += sum_{t' > t} M[t'][t] x[t'] (row t of M^T)
#pragma unroll
        for (int t4 = (t + 1) / 4; t4 < CHUNK / 4; ++t4) {
          const float4 m = reinterpret_cast<const float4*>(mats + t * CHUNK)[t4];
          const float mm[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * t4 + e > t) x[t] = fmaf(mm[e], x[4 * t4 + e], x[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) col[t * C_LDP] = x[t];
  }
  __syncthreads();

  // the sums over rows i: dM, dN, dSB, dSK (thread (t, s), into cot with
  // their transposes: cot + m MC = [dM, dN, dSB, dSK], + (4 + m) MC the
  // transposes); P_A = dW Z0^T, P_R = dY Z0^T (threads 0-127) and dBbar =
  // u dZ1^T, dKbar = V dZ1^T (128-255) as 4 x 4 register tiles, rows rb,
  // rb + 8 of each of the pair and columns jb + 16 e (the 16 rows a quarter
  // warp reads lie in distinct bank groups); sum_i dZ1 Z0 at column j
  const int j = tid / CB_P, f = tid % CB_P;
  float zz = 0.f, acc[4][4];
  {
    const int t = tid / CHUNK, s = tid % CHUNK;
    float m4[4] = {0.f, 0.f, 0.f, 0.f};  // dW u, dW v, dy u, dy v
#pragma unroll 4
    for (int i4 = 0; i4 < N / 4; ++i4) {
      const float4 wt = *reinterpret_cast<const float4*>(sw + t * C_LDP + 4 * i4);
      const float4 yt = *reinterpret_cast<const float4*>(dyt + t * C_LDP + 4 * i4);
      const float4 us = *reinterpret_cast<const float4*>(su + s * C_LDP + 4 * i4);
      const float4 vs = *reinterpret_cast<const float4*>(vt + s * C_LDP + 4 * i4);
      m4[0] = dot4(wt, us, m4[0]);
      m4[1] = dot4(wt, vs, m4[1]);
      m4[2] = dot4(yt, us, m4[2]);
      m4[3] = dot4(yt, vs, m4[3]);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float e = (m < 2 ? s < t : s <= t) ? m4[m] : 0.f;
      cot[m * MC + t * CB_MLD + s] = e;
      cot[(4 + m) * MC + s * CB_MLD + t] = e;
    }
  }
  const int g = tid / (NT / 2), rb = tid % (NT / 2) / 16, jb = tid % 16;
  {
    const float* la = g ? su : sw;   // [t][i]: the pair's first
    const float* lb = g ? vt : dyt;  // and second
    const float* zs = g ? zd : z0;   // [j][i]
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2) acc[e][e2] = 0.f;
#pragma unroll 2
    for (int i4 = 0; i4 < N / 4; ++i4) {
      float4 x[4], z[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = *reinterpret_cast<const float4*>((e < 2 ? la : lb) + (rb + 8 * (e & 1)) * C_LDP + 4 * i4);
        z[e] = *reinterpret_cast<const float4*>(zs + (jb + 16 * e) * C_LDP + 4 * i4);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int e2 = 0; e2 < 4; ++e2) acc[e][e2] = dot4(x[e], z[e2], acc[e][e2]);
    }
#pragma unroll
    for (int i4 = f; i4 < N / 4; i4 += CB_P)
      zz = dot4(*reinterpret_cast<const float4*>(z0 + j * C_LDP + 4 * i4),
                *reinterpret_cast<const float4*>(zd + j * C_LDP + 4 * i4), zz);
  }
  zz += __shfl_xor_sync(FULL, zz, 1);
  zz += __shfl_xor_sync(FULL, zz, 2);
  __syncthreads();
  // the four [t][j] tiles P_A, P_R, dBbar, dKbar into Z0's place
  float* pt = z0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int e2 = 0; e2 < 4; ++e2)
      pt[(2 * g + e / 2) * CHUNK * C_LDP + (rb + 8 * (e & 1)) * C_LDP + jb + 16 * e2] = acc[e][e2];
  __syncthreads();
  // at column j, steps t = f + 4q (P values from their tiles, factors from g):
  // first the terms of d log w_s that reach Z0 or Z1, y's r e^{g} Z0 (s <= t),
  // u's a e^{g_p} Z0 (s < t) and Z1's (b, k) e^{g_l - g} (s > t), into cr[s]
  const float gm = gt[C_MID * C_LDP + j], gl = gt[(CHUNK - 1) * C_LDP + j];
  float cr[CHUNK];
#pragma unroll
  for (int s = 0; s < CHUNK; ++s) cr[s] = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int t = f + 4 * q, e = t * N + j, o = t * C_LDP + j;
    const float g_t = gt[o], gp = g_t + expf(to_f(raw[TILE + e])) * C_LOG2E;
    const float r0 = to_f(raw[e]) * exp2f(g_t) * pt[CHUNK * C_LDP + o];
    const float a0 = to_f(raw[3 * TILE + e]) * exp2f(gp) * pt[o];
    const float b0 = fmaf(to_f(raw[4 * TILE + e]), pt[2 * CHUNK * C_LDP + o],
                          to_f(raw[2 * TILE + e]) * pt[3 * CHUNK * C_LDP + o]) * exp2f(gl - g_t);
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) cr[s] += (t >= s ? r0 : 0.f) + (t > s ? a0 : 0.f) + (t < s ? b0 : 0.f);
  }
  // then, two steps at a time (four at once spilled), the sums over s
  // against am, rm, bm, km, the terms of d log w_s that a pair (t, t1)
  // spans, and the gradients at (t, j)
#pragma unroll 1
  for (int q0 = 0; q0 < 4; q0 += 2) {
    float qa[2], qr[2], qb[2], qk[2], amt[2], rmt[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      qa[q] = qr[q] = qb[q] = qk[q] = 0.f;
      amt[q] = am[(f + 4 * (q0 + q)) * C_LDP + j];
      rmt[q] = rm[(f + 4 * (q0 + q)) * C_LDP + j];
    }
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) {
      const float bms = bm[s * C_LDP + j], kms = km[s * C_LDP + j];
      const float ams = am[s * C_LDP + j], rms = rm[s * C_LDP + j];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int t = f + 4 * (q0 + q);
        float xm[8];  // dM, dN, dSB, dSK at [t][s], then at [s][t]
#pragma unroll
        for (int m = 0; m < 8; ++m) xm[m] = cot[m * MC + t * CB_MLD + s];
        // before adding s: qa / qr are the sums over t1 < s
        if (t > s) cr[s] = fmaf(amt[q], qa[q], cr[s]);
        if (t >= s) cr[s] = fmaf(rmt[q], qr[q], cr[s]);
        qa[q] = fmaf(xm[0], bms, fmaf(xm[1], kms, qa[q]));
        qr[q] = fmaf(xm[2], bms, fmaf(xm[3], kms, qr[q]));
        qb[q] = fmaf(xm[4], ams, fmaf(xm[6], rms, qb[q]));
        qk[q] = fmaf(xm[5], ams, fmaf(xm[7], rms, qk[q]));
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int t = f + 4 * (q0 + q), e = t * N + j, o = t * C_LDP + j;
      const float g_t = gt[o], gp = g_t + expf(to_f(raw[TILE + e])) * C_LOG2E;
      const float em = exp2f(gm - g_t), el = exp2f(gl - g_t);
      const float gda = fmaf(pt[o], exp2f(gp), qa[q] * exp2f(gp - gm));
      const float gdr = fmaf(pt[CHUNK * C_LDP + o], exp2f(g_t), qr[q] * exp2f(g_t - gm));
      const float gdb = fmaf(qb[q], em, pt[2 * CHUNK * C_LDP + o] * el);
      const float gdk = fmaf(qk[q], em, pt[3 * CHUNK * C_LDP + o] * el);
      const size_t go = c0 + (size_t)t * tstride + j;
      dr[go] = from_f<T>(gdr);
      dk[go] = from_f<T>(gdk);
      da[go] = from_f<T>(gda);
      db[go] = from_f<T>(gdb);
    }
  }
  // d log w: cr summed over the four threads of the column (thread f keeps
  // steps 4f .. 4f + 3) and e^{g_l} sum_i dZ1 Z0, which every step spans
  reduce_scatter<2, 8>(cr, f & 2);
  reduce_scatter<1, 4>(cr, f & 1);
  const float ez = exp2f(gl) * zz;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int s = 4 * f + m;
    dw[c0 + (size_t)s * tstride + j] = from_f<T>((cr[m] + ez) * -expf(to_f(raw[TILE + s * N + j])));
  }
}

template <int DT, int ROWS, int ZHEADS>
int launch_bwd_state(int B, int T, int H, const void* r, const void* w, const void* k, const void* a,
                     const void* b, const void* dy, const void* dsf, void* dv, void* ds0, void* dz1,
                     cudaStream_t st) {
  using X = ChunkStream<DT>;
  const auto kernel = wkv7_bwd_state_kernel<DT, ROWS, ZHEADS>;
  constexpr size_t smem = ChunkSmem<DT, ROWS>::bytes;
  static hopper_host::SmemOptIn opt_in;
  const int e = opt_in(kernel, smem);
  if (e != 0) return e;
  kernel<<<B * H * (N / ROWS), ROWS * chunk_threads_a_row<ROWS>(), smem, st>>>(
      T, H, (const X*)r, (const X*)w, (const X*)k, (const X*)a, (const X*)b, (const X*)dy,
      (const float*)dsf, (X*)dv, (float*)ds0, (float*)dz1, ZHEADS * N);
  return (int)cudaGetLastError();
}

template <int DT, int ZHEADS>
int launch_bwd_dt(int rows, int B, int T, int H, const void* r, const void* w, const void* k,
                  const void* v, const void* a, const void* b, const void* zin, const void* dy,
                  const void* dsf, void* dr, void* dw, void* dk, void* dv, void* da, void* db,
                  void* ds0, void* dz1, cudaStream_t st) {
  int e;
  switch (rows) {
    case 16: e = launch_bwd_state<DT, 16, ZHEADS>(B, T, H, r, w, k, a, b, dy, dsf, dv, ds0, dz1, st); break;
    case 32: e = launch_bwd_state<DT, 32, ZHEADS>(B, T, H, r, w, k, a, b, dy, dsf, dv, ds0, dz1, st); break;
    case 64: e = launch_bwd_state<DT, 64, ZHEADS>(B, T, H, r, w, k, a, b, dy, dsf, dv, ds0, dz1, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != 0) return e;
  using X = ChunkStream<DT>;
  const auto kernel = wkv7_bwd_chunk_kernel<DT, ZHEADS>;
  constexpr size_t smem = ChunkBwdSmem<DT>::bytes;
  static hopper_host::SmemOptIn opt_in;
  e = opt_in(kernel, smem);
  if (e != 0) return e;
  kernel<<<B * H * (T / CHUNK), CB_THREADS, smem, st>>>(
      T, H, (const X*)r, (const X*)w, (const X*)k, (const X*)v, (const X*)a, (const X*)b, (const X*)dy,
      (const float*)zin, (const float*)dz1, (X*)dr, (X*)dw, (X*)dk, (X*)da, (X*)db, ZHEADS * N);
  return (int)cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16; rows = the value rows a pass-1
// block owns (16, 32 or 64); dz1 a workspace of zin's size. T a positive
// multiple of 16; H even for ZHEADS = 2.
template <int ZHEADS>
int launch_bwd(int dtype, int rows, int B, int T, int H, int n, const void* r, const void* w,
               const void* k, const void* v, const void* a, const void* b, const void* zin,
               const void* dy, const void* dsf, void* dr, void* dw, void* dk, void* dv, void* da,
               void* db, void* ds0, void* dz1, void* stream) {
  if (n != N || B <= 0 || H <= 0 || H % ZHEADS != 0 || T <= 0 || T % CHUNK != 0 || zin == nullptr ||
      dz1 == nullptr || dsf == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd_dt<0, ZHEADS>(rows, B, T, H, r, w, k, v, a, b, zin, dy, dsf, dr, dw, dk, dv, da, db,
                                    ds0, dz1, st);
  if (dtype == 1)
    return launch_bwd_dt<1, ZHEADS>(rows, B, T, H, r, w, k, v, a, b, zin, dy, dsf, dr, dw, dk, dv, da, db,
                                    ds0, dz1, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a pass-2 block, bytes (-1: no such dtype); a
// pass-1 block's is K5's (fwd_res_smem_bytes).
inline int bwd_chunk_smem_bytes(int dtype) {
  return dtype == 0 ? (int)ChunkBwdSmem<0>::bytes : dtype == 1 ? (int)ChunkBwdSmem<1>::bytes : -1;
}

}  // namespace
