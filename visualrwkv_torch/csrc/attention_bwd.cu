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
// Layouts, head dims (64, 72 zero-padded to 80) and the masking of keys and
// queries past N (DINOv2's 1029 tokens) are K3's (attention_tiles.cuh).
//
// The FlashAttention-2 backward from the forward's output O and log-sum-exp:
// p = exp(S scale + bias - lse) is recomputed tile by tile, dP = dO V^T,
// dS = p (dP - delta) with delta = rowsum(dO O); dq = dS K scale,
// dk = dS^T Q scale, dv = p^T dO, d rel_h[q, kh] = sum of dS[q, key] over the
// keys of grid row kh, d rel_w[q, kw] over grid column kw. dS and p are
// rounded to bf16 before the products, as the reference kernels round them
// to the input dtype; the tables' gradients sum the rounded dS in fp32.
//
// K14 attention_bwd_dq: one block of 4 warps per (g, 64-query tile), walking
// 64-key tiles; a warp owns 16 query rows. It first writes delta for its rows
// (read by K15), then per key tile: S = Q K^T and dP = dO V^T on the tensor
// cores (WMMA, bf16 operands, fp32 accumulation) through the warp's fp32
// tile, p and dS in fp32 (two lanes a row, 32 keys each), dq += dS K into
// accumulator fragments held across the key tiles. At SAM-B's Wk = 64 a key
// tile is one grid row and a lane sees the same 32 grid columns in every
// tile: it keeps their rel_w values and d rel_w sums in registers, and each
// d rel_h entry is a row sum, one shuffle and one store. Other grid widths
// sum both tables' gradients for the 64 query rows in shared memory
// (64 x (Hk + Wk) fp32), stepping the grid coordinates along the keys.
// K15 attention_bwd_dkv: one block per (g, 64-key tile), walking 64-query
// tiles; a warp owns 16 keys. Per query tile: S^T = K Q^T and dP^T = V dO^T,
// p^T and dS^T, then dv += p^T dO and dk += dS^T Q into fragments. The query
// tile's rows of the bias tables, lse and delta are staged in shared memory.
//
// Bound on the H100: operations. At SAM's global shape (G=12, N=4096, hd 64)
// the function needs 5 products of G*N^2*hd multiply-adds (S, dP, dq, dk,
// dv), 129 GFLOP, against about 90 MB moved. K14 and K15 run 7: S and dP in
// each kernel, the price of keeping the N x N probabilities out of device
// memory. This is the simple correct form: WMMA, no wgmma, TMA or pipelining
// yet.

#include "attention_tiles.cuh"

namespace {

using namespace vattn;

template <int HD>
struct SmemDq {
  using G = Geom<HD>;
  bf16 q[BQ * G::LDB];
  bf16 dout[BQ * G::LDB];
  bf16 k[BK * G::LDB];
  bf16 v[BK * G::LDB];
  bf16 ds[WARPS][16 * LDP];
  float x[WARPS][16 * G::LDX];  // a warp's S tile, then its dP tile, at the end its dq rows
  // followed by d rel_h [BQ][Hk] and d rel_w [BQ][Wk] fp32 when there is a bias
};

// ROWS: the grid is 64 keys wide (Wk = BK, SAM-B's 64 x 64 grid), so key
// tile k0 is grid row k0 / 64 and a lane's 32 keys are the same 32 grid
// columns in every tile: the lane keeps its 32 rel_w values and its 32
// d rel_w sums in registers, and each (row, grid row) of d rel_h is one
// shuffle and one store. Otherwise both tables' gradients go through
// shared memory.
template <int HD, bool ROWS>
__global__ void __launch_bounds__(THREADS) attention_bwd_dq_kernel(
    int N, int heads, float scale, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ rel_h,
    const float* __restrict__ rel_w, int Hk, int Wk, const bf16* __restrict__ o,
    const bf16* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ delta,
    bf16* __restrict__ dq, float* __restrict__ drh, float* __restrict__ drw) {
  using G = Geom<HD>;
  constexpr int HDP = G::HDP, LDB = G::LDB, LDX = G::LDX, COLS = G::COLS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemDq<HD>& sm = *reinterpret_cast<SmemDq<HD>*>(smem_raw);
  float* drh_s = reinterpret_cast<float*>(smem_raw + sizeof(SmemDq<HD>));
  float* drw_s = drh_s + BQ * Hk;
  const int g = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row_stride = (size_t)heads * HD;
  const size_t base = group_base(g, heads, N, HD);
  const bool has_bias = rel_h != nullptr;

  load_tile<HD>(sm.q, q + base, q0, N, row_stride, tid);
  load_tile<HD>(sm.dout, dout + base, q0, N, row_stride, tid);
  if (has_bias && !ROWS)
    for (int i = tid; i < BQ * (Hk + Wk); i += THREADS) drh_s[i] = 0.f;  // both tables

  // lane owns row `row` of the tile: key columns [khalf, khalf + 32) of each
  // tile and output columns [ohalf, ohalf + COLS)
  const int rloc = lane >> 1;
  const int khalf = (lane & 1) * 32;
  const int ohalf = (lane & 1) * COLS;
  const int row = warp * 16 + rloc;
  const int qrow = q0 + row;
  const bool qvalid = qrow < N;
  const float* rh = has_bias ? rel_h + ((size_t)g * N + (qvalid ? qrow : 0)) * Hk : nullptr;
  const float* rw = has_bias ? rel_w + ((size_t)g * N + (qvalid ? qrow : 0)) * Wk : nullptr;
  float rwv[ROWS ? 32 : 1], drwv[ROWS ? 32 : 1];
  if (ROWS) {
#pragma unroll
    for (int c = 0; c < 32; c += 4) {
      const float4 x = qvalid ? __ldg(reinterpret_cast<const float4*>(rw + khalf + c))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      rwv[c] = x.x, rwv[c + 1] = x.y, rwv[c + 2] = x.z, rwv[c + 3] = x.w;
      drwv[c] = drwv[c + 1] = drwv[c + 2] = drwv[c + 3] = 0.f;
    }
  }
  __syncthreads();

  // delta = rowsum(dO O) in fp32 of the bf16 values, half a row a lane
  float dl = 0.f;
  if (qvalid) {
    const bf16* orow = o + base + (size_t)qrow * row_stride + (lane & 1) * (HD / 2);
    const bf16* drow = sm.dout + row * LDB + (lane & 1) * (HD / 2);
#pragma unroll
    for (int c = 0; c < HD / 2; c += 2) {
      const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(orow + c);
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(drow + c);
      dl = fmaf(__low2float(a), __low2float(b), dl);
      dl = fmaf(__high2float(a), __high2float(b), dl);
    }
  }
  dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  if (qvalid && (lane & 1) == 0) delta[(size_t)g * N + qrow] = dl;
  const float lse_r = qvalid ? lse[(size_t)g * N + qrow] : 0.f;

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[HDP / 16], df[HDP / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dqf[HDP / 16];
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], sm.q + (warp * 16) * LDB + kk * 16, LDB);
    wmma::load_matrix_sync(df[kk], sm.dout + (warp * 16) * LDB + kk * 16, LDB);
    wmma::fill_fragment(dqf[kk], 0.f);
  }

  float* xw = sm.x[warp];
  bf16* dsw = sm.ds[warp];

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<HD>(sm.k, k + base, k0, N, row_stride, tid);
    load_tile<HD>(sm.v, v + base, k0, N, row_stride, tid);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys
#pragma unroll
    for (int nt = 0; nt < BK / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sm.k + (nt * 16) * LDB + kk * 16, LDB);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(xw + nt * 16, sf, LDX, wmma::mem_row_major);
    }
    __syncwarp();

    // grid row and column of the lane's first key in this tile; both loops
    // below step them along instead of dividing for every key
    int kh0 = 0, kw0 = 0;
    if (has_bias && !ROWS) {
      kh0 = (k0 + khalf) / Wk;
      kw0 = k0 + khalf - kh0 * Wk;
    }

    // p from the forward's lse; 0 for keys and queries past N
    float pv[32];
    if (ROWS) {  // N = Hk * 64: every key of the tile is valid
      const float rhv = qvalid ? __ldg(rh + k0 / BK) : 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c)
        pv[c] = qvalid ? __expf(xw[rloc * LDX + khalf + c] * scale + rhv + rwv[c] - lse_r) : 0.f;
    } else {
      int kh = kh0, kw = kw0;
      float rhv = (has_bias && qvalid && kh < Hk) ? __ldg(rh + kh) : 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int key = k0 + khalf + c;
        float p = 0.f;
        if (qvalid && key < N) {
          float x = xw[rloc * LDX + khalf + c] * scale;
          if (has_bias) x += rhv + __ldg(rw + kw);
          p = __expf(x - lse_r);
        }
        pv[c] = p;
        if (has_bias && ++kw == Wk) {
          kw = 0;
          ++kh;
          rhv = (qvalid && kh < Hk) ? __ldg(rh + kh) : 0.f;
        }
      }
    }
    __syncwarp();

    // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < BK / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> vf;
        wmma::load_matrix_sync(vf, sm.v + (nt * 16) * LDB + kk * 16, LDB);
        wmma::mma_sync(sf, df[kk], vf, sf);
      }
      wmma::store_matrix_sync(xw + nt * 16, sf, LDX, wmma::mem_row_major);
    }
    __syncwarp();

    // dS = p (dP - delta), rounded to bf16; the tables' gradients from it:
    // a run sum over the keys of one grid row goes to d rel_h (the two lanes
    // of a row may share a grid row, hence the atomic add)
    if (ROWS) {
      float run = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const bf16 dsb = __float2bfloat16(pv[c] * (xw[rloc * LDX + khalf + c] - dl));
        dsw[rloc * LDP + khalf + c] = dsb;
        const float d = __bfloat162float(dsb);  // 0 for a row past N (p = 0)
        run += d;
        drwv[c] += d;
      }
      run += __shfl_xor_sync(0xffffffffu, run, 1);
      if (qvalid && (lane & 1) == 0) drh[((size_t)g * N + qrow) * Hk + k0 / BK] = run;
    } else {
      int kh = kh0, kw = kw0;
      float run = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int key = k0 + khalf + c;
        const bf16 dsb = __float2bfloat16(pv[c] * (xw[rloc * LDX + khalf + c] - dl));
        dsw[rloc * LDP + khalf + c] = dsb;
        if (has_bias) {
          if (qvalid && key < N) {
            const float d = __bfloat162float(dsb);
            run += d;
            // a 64-key tile holds each grid column once when Wk >= 64: the
            // lane owns its columns; narrower grids repeat columns across lanes
            if (Wk >= BK) drw_s[row * Wk + kw] += d;
            else atomicAdd(drw_s + row * Wk + kw, d);
          }
          if (++kw == Wk) {
            if (kh < Hk) atomicAdd(drh_s + row * Hk + kh, run);
            run = 0.f;
            kw = 0;
            ++kh;
          }
        }
      }
      if (has_bias && kw != 0 && kh < Hk) atomicAdd(drh_s + row * Hk + kh, run);
    }
    __syncwarp();

    // dq += dS K
#pragma unroll
    for (int nt = 0; nt < HDP / 16; ++nt) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> sa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> kb;
        wmma::load_matrix_sync(sa, dsw + kk * 16, LDP);
        wmma::load_matrix_sync(kb, sm.k + (kk * 16) * LDB + nt * 16, LDB);
        wmma::mma_sync(dqf[nt], sa, kb, dqf[nt]);
      }
    }
  }

  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < HDP / 16; ++nt)
    wmma::store_matrix_sync(xw + nt * 16, dqf[nt], LDX, wmma::mem_row_major);
  __syncwarp();
  if (qvalid) store_row_half<HD>(dq + base + (size_t)qrow * row_stride, xw + rloc * LDX, ohalf, scale);

  if (ROWS && qvalid) {
    float* gw = drw + ((size_t)g * N + qrow) * Wk + khalf;
#pragma unroll
    for (int c = 0; c < 32; c += 4)
      *reinterpret_cast<float4*>(gw + c) = make_float4(drwv[c], drwv[c + 1], drwv[c + 2], drwv[c + 3]);
  }
  if (has_bias && !ROWS) {
    __syncthreads();
    const int rows = min(BQ, N - q0);
    float* gh = drh + ((size_t)g * N + q0) * Hk;  // the tile's rows are contiguous
    float* gw = drw + ((size_t)g * N + q0) * Wk;
    for (int i = tid; i < rows * Hk; i += THREADS) gh[i] = drh_s[i];
    for (int i = tid; i < rows * Wk; i += THREADS) gw[i] = drw_s[i];
  }
}

template <int HD>
struct SmemDkv {
  using G = Geom<HD>;
  bf16 k[BK * G::LDB];
  bf16 v[BK * G::LDB];
  bf16 q[BQ * G::LDB];
  bf16 dout[BQ * G::LDB];
  bf16 p[WARPS][16 * LDP];
  bf16 ds[WARPS][16 * LDP];
  float x[WARPS][16 * G::LDX];  // a warp's S^T tile, then its dP^T tile, at the end dk / dv
  float lse[BQ];
  float delta[BQ];
  // followed by the query tile's rows of rel_h [BQ][Hk] and rel_w [BQ][Wk]
};

template <int HD>
__global__ void __launch_bounds__(THREADS) attention_bwd_dkv_kernel(
    int N, int heads, float scale, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ rel_h,
    const float* __restrict__ rel_w, int Hk, int Wk, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv) {
  using G = Geom<HD>;
  constexpr int HDP = G::HDP, LDB = G::LDB, LDX = G::LDX, COLS = G::COLS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemDkv<HD>& sm = *reinterpret_cast<SmemDkv<HD>*>(smem_raw);
  float* rh_s = reinterpret_cast<float*>(smem_raw + sizeof(SmemDkv<HD>));
  float* rw_s = rh_s + BQ * Hk;
  const int g = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row_stride = (size_t)heads * HD;
  const size_t base = group_base(g, heads, N, HD);
  const bool has_bias = rel_h != nullptr;

  load_tile<HD>(sm.k, k + base, k0, N, row_stride, tid);
  load_tile<HD>(sm.v, v + base, k0, N, row_stride, tid);

  // lane owns key row `krow` of the tile: query columns [qhalf, qhalf + 32)
  // of each query tile and output columns [ohalf, ohalf + COLS)
  const int rloc = lane >> 1;
  const int qhalf = (lane & 1) * 32;
  const int ohalf = (lane & 1) * COLS;
  const int key = k0 + warp * 16 + rloc;
  const bool kvalid = key < N;
  const int kh = (has_bias && kvalid) ? key / Wk : 0;
  const int kw = (has_bias && kvalid) ? key - kh * Wk : 0;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> kf[HDP / 16], vf[HDP / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dkf[HDP / 16], dvf[HDP / 16];
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    wmma::load_matrix_sync(kf[kk], sm.k + (warp * 16) * LDB + kk * 16, LDB);
    wmma::load_matrix_sync(vf[kk], sm.v + (warp * 16) * LDB + kk * 16, LDB);
    wmma::fill_fragment(dkf[kk], 0.f);
    wmma::fill_fragment(dvf[kk], 0.f);
  }

  float* xw = sm.x[warp];
  bf16* pw = sm.p[warp];
  bf16* dsw = sm.ds[warp];

  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous query tile
    load_tile<HD>(sm.q, q + base, q0, N, row_stride, tid);
    load_tile<HD>(sm.dout, dout + base, q0, N, row_stride, tid);
    const int rows = min(BQ, N - q0);
    for (int i = tid; i < BQ; i += THREADS) {
      sm.lse[i] = i < rows ? lse[(size_t)g * N + q0 + i] : 0.f;
      sm.delta[i] = i < rows ? delta[(size_t)g * N + q0 + i] : 0.f;
    }
    if (has_bias) {  // the tile's rows are contiguous in the tables
      const float* gh = rel_h + ((size_t)g * N + q0) * Hk;
      const float* gw = rel_w + ((size_t)g * N + q0) * Wk;
      for (int i = tid; i < rows * Hk; i += THREADS) rh_s[i] = gh[i];
      for (int i = tid; i < rows * Wk; i += THREADS) rw_s[i] = gw[i];
    }
    __syncthreads();

    // S^T = K Q^T for the warp's 16 keys x 64 queries
#pragma unroll
    for (int nt = 0; nt < BQ / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> qb;
        wmma::load_matrix_sync(qb, sm.q + (nt * 16) * LDB + kk * 16, LDB);
        wmma::mma_sync(sf, kf[kk], qb, sf);
      }
      wmma::store_matrix_sync(xw + nt * 16, sf, LDX, wmma::mem_row_major);
    }
    __syncwarp();

    float pv[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int qi = qhalf + c;
      float p = 0.f;
      if (kvalid && qi < rows) {
        float x = xw[rloc * LDX + qi] * scale;
        if (has_bias) x += rh_s[qi * Hk + kh] + rw_s[qi * Wk + kw];
        p = __expf(x - sm.lse[qi]);
      }
      pv[c] = p;
      pw[rloc * LDP + qi] = __float2bfloat16(p);
    }
    __syncwarp();

    // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < BQ / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> db;
        wmma::load_matrix_sync(db, sm.dout + (nt * 16) * LDB + kk * 16, LDB);
        wmma::mma_sync(sf, vf[kk], db, sf);
      }
      wmma::store_matrix_sync(xw + nt * 16, sf, LDX, wmma::mem_row_major);
    }
    __syncwarp();

#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int qi = qhalf + c;
      dsw[rloc * LDP + qi] = __float2bfloat16(pv[c] * (xw[rloc * LDX + qi] - sm.delta[qi]));
    }
    __syncwarp();

    // dv += p^T dO, dk += dS^T Q
#pragma unroll
    for (int nt = 0; nt < HDP / 16; ++nt) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, pw + kk * 16, LDP);
        wmma::load_matrix_sync(b, sm.dout + (kk * 16) * LDB + nt * 16, LDB);
        wmma::mma_sync(dvf[nt], a, b, dvf[nt]);
        wmma::load_matrix_sync(a, dsw + kk * 16, LDP);
        wmma::load_matrix_sync(b, sm.q + (kk * 16) * LDB + nt * 16, LDB);
        wmma::mma_sync(dkf[nt], a, b, dkf[nt]);
      }
    }
  }

  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < HDP / 16; ++nt)
    wmma::store_matrix_sync(xw + nt * 16, dkf[nt], LDX, wmma::mem_row_major);
  __syncwarp();
  if (kvalid) store_row_half<HD>(dk + base + (size_t)key * row_stride, xw + rloc * LDX, ohalf, scale);
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < HDP / 16; ++nt)
    wmma::store_matrix_sync(xw + nt * 16, dvf[nt], LDX, wmma::mem_row_major);
  __syncwarp();
  if (kvalid) store_row_half<HD>(dv + base + (size_t)key * row_stride, xw + rloc * LDX, ohalf, 1.f);
}

int check_geometry(int G, int N, int heads, const void* rel_h, const void* rel_w, int Hk, int Wk) {
  if (G <= 0 || N <= 0 || heads <= 0 || G % heads) return (int)cudaErrorInvalidValue;
  if ((rel_h == nullptr) != (rel_w == nullptr)) return (int)cudaErrorInvalidValue;
  if (rel_h != nullptr && (Hk <= 0 || Wk <= 0 || Hk * Wk != N)) return (int)cudaErrorInvalidValue;
  return 0;
}

size_t table_bytes(const void* rel_h, int Hk, int Wk) {
  return rel_h == nullptr ? 0 : (size_t)BQ * (Hk + Wk) * sizeof(float);
}

template <int HD, bool ROWS>
int launch_dq(int G, int N, int heads, float scale, const void* q, const void* k, const void* v,
              const void* rel_h, const void* rel_w, int Hk, int Wk, const void* o,
              const void* dout, const void* lse, void* delta, void* dq, void* drh, void* drw,
              cudaStream_t st) {
  const size_t smem = sizeof(SmemDq<HD>) + (ROWS ? 0 : table_bytes(rel_h, Hk, Wk));
  const cudaError_t e = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<HD, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BQ - 1) / BQ, G), block(THREADS);
  attention_bwd_dq_kernel<HD, ROWS><<<grid, block, smem, st>>>(
      N, heads, scale, (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)rel_h,
      (const float*)rel_w, Hk, Wk, (const bf16*)o, (const bf16*)dout, (const float*)lse,
      (float*)delta, (bf16*)dq, (float*)drh, (float*)drw);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(int G, int N, int heads, float scale, const void* q, const void* k, const void* v,
               const void* rel_h, const void* rel_w, int Hk, int Wk, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, cudaStream_t st) {
  const size_t smem = sizeof(SmemDkv<HD>) + table_bytes(rel_h, Hk, Wk);
  const cudaError_t e = cudaFuncSetAttribute(
      attention_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BK - 1) / BK, G), block(THREADS);
  attention_bwd_dkv_kernel<HD><<<grid, block, smem, st>>>(
      N, heads, scale, (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)rel_h,
      (const float*)rel_w, Hk, Wk, (const bf16*)dout, (const float*)lse, (const float*)delta,
      (bf16*)dk, (bf16*)dv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K14. q, k, v, o, dout, dq: bf16 in K3's layouts (token row stride
// heads*hd, group g = (g / heads, g % heads)); hd 64 or 72. rel_h / rel_w
// [G, N, Hk] / [G, N, Wk] fp32 and drh / drw the same, or all four null.
// lse [G, N] fp32 from K3; writes delta [G, N] fp32 = rowsum(dout o) for K15.
int attention_bwd_dq(int G, int N, int heads, int hd, float scale, const void* q,
                     const void* k, const void* v, const void* rel_h, const void* rel_w,
                     int Hk, int Wk, const void* o, const void* dout, const void* lse,
                     void* delta, void* dq, void* drh, void* drw, void* stream) {
  const int bad = check_geometry(G, N, heads, rel_h, rel_w, Hk, Wk);
  if (bad) return bad;
  if ((rel_h == nullptr) != (drh == nullptr) || (rel_w == nullptr) != (drw == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool rows = rel_h != nullptr && Wk == BK;
  if (hd == 64 && rows)
    return launch_dq<64, true>(G, N, heads, scale, q, k, v, rel_h, rel_w, Hk, Wk, o, dout, lse,
                               delta, dq, drh, drw, st);
  if (hd == 64)
    return launch_dq<64, false>(G, N, heads, scale, q, k, v, rel_h, rel_w, Hk, Wk, o, dout, lse,
                                delta, dq, drh, drw, st);
  if (hd == 72)  // the head dim of SigLIP, whose attention has no bias
    return launch_dq<72, false>(G, N, heads, scale, q, k, v, rel_h, rel_w, Hk, Wk, o, dout, lse,
                                delta, dq, drh, drw, st);
  return (int)cudaErrorInvalidValue;
}

// K15, after K14 on the same stream (it reads K14's delta). dk, dv bf16 in
// the layout of k and v.
int attention_bwd_dkv(int G, int N, int heads, int hd, float scale, const void* q,
                      const void* k, const void* v, const void* rel_h, const void* rel_w,
                      int Hk, int Wk, const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, void* stream) {
  const int bad = check_geometry(G, N, heads, rel_h, rel_w, Hk, Wk);
  if (bad) return bad;
  const cudaStream_t st = (cudaStream_t)stream;
  if (hd == 64)
    return launch_dkv<64>(G, N, heads, scale, q, k, v, rel_h, rel_w, Hk, Wk, dout, lse, delta,
                          dk, dv, st);
  if (hd == 72)
    return launch_dkv<72>(G, N, heads, scale, q, k, v, rel_h, rel_w, Hk, Wk, dout, lse, delta,
                          dk, dv, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
