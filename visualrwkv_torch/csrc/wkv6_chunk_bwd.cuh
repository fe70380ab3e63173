// The chunked RWKV-6 ("x060") backward on Hopper, K9 wkv6_bwd
// (wkv6_train.cu): two kernels launched one after the other,
// wkv6_bwd_state_kernel<DT, ROWS, FORM> and wkv6_bwd_chunk_kernel<DT>.
// Device code and the launch helper only.
//
// It replaces visualrwkv_tpu/ops/wkv6_pallas.py::wkv6_pallas_bwd
// (_wkv6_bwd_kernel): the vector-Jacobian product of the chunk form of
// wkv6_chunk.cuh at chunk 16, from the states K8 saved, zin[bh, c] = Z0 =
// S^T entering chunk c. With dY the chunk's output cotangent [t][i], dZ1 the
// cotangent of the state leaving it [j][i], g the running sum of the floored
// log decay (log2 units), g_p = g - lw, g_l = g at step 15, rt = r e^{g_p},
// kbar = k e^{g_l - g} and sk the strict part of A (wkv6_chunk.cuh), the VJP
// splits in two:
//   (a) per value row i (column i of Z), no sum over rows and no Z0:
//       dv_i  = sk^T dy_i + kbar dz1_i + bonus (.) dy_i
//       dz0_i = rt^T dy_i + e^{g_l} (.) dz1_i
//   the cotangent recurrence, pass 1;
//   (b) the sums over rows, chunk-local once Z0 and dZ1 are known, pass 2:
//       dSK = strict(dY V^T), P_R = dY Z0^T, dKbar = V dZ1^T,
//       zz = sum_i dZ1 (.) Z0, q_t = dy_t . v_t (the bonus's cotangent), then
//       dr_t = P_R,t e^{g_p,t} + sum_{s<t} dSK_ts k_s e^{g_p,t - g_s} + q_t u k_t
//       dk_s = sum_{t>s} dSK_ts r_t e^{g_p,t - g_s} + dKbar_s e^{g_l - g_s} + q_s u r_s
//       du   = sum_t q_t k_t r_t (a partial a (b, h, chunk); the wrapper sums them)
// dw: every term of the chunk's outputs carries e to a sum of log decays
// over the steps it spans, so d log w_q is the sum of the terms that span
// step q: y's r e^{g_p} Z0 (q < t), the pairs (t, s) of sk (s < q < t), Z1's
// kbar term (q > s) and e^{g_l} Z0 (every q); dw_raw = d log w * (-e^{w_raw}),
// 0 where the floor binds. The Pallas kernel's form of the same sum (each
// step's r dr - k dk summed over t >= s) cancels terms of the whole chunk
// against each other in fp32 (4.3e-4 against 3e-6 for the WKV7 backward,
// tests/test_torch_wkv7_chunk_bwd.py).
//
// Range: pass 1 is K8's walk with K8's factor forms (FORM by the floor). In
// pass 2 every factor is a decay formed as one exp2 of a difference (g_p,t -
// g_s for s < t, g_l - g, g_p), never e^{-g} alone, so one form takes every
// floor: a factor underflows to 0 only where its true value is below fp32's.
//
// Pass 1, wkv6_bwd_state_kernel: K8's layout, loop and pipeline in reverse
// (wkv6_chunk.cuh's chunk_walk, MODE 2): a block owns ROWS value rows of one
// (b, h) (ops/wkv6_cuda.py::fwd_plan) and walks the chunks from the last, from
// dsf. It reads r, w, k, u and dy, never v or zin, and writes dv, dZ1 (fp32,
// zin's layout and size: a workspace the wrapper allocates) and ds0.
//
// Pass 2, wkv6_bwd_chunk_kernel: one block of 256 threads for each (b, h,
// chunk), B*H*T/16 of them, each with the whole head; nothing waits on
// another chunk. It loads Z0, dZ1, r, w, k (cp.async) and v, dy (fp32),
// then, one barrier apart:
//   the running log decay g and g_p a column (four threads a column,
//   prefix sums by shuffles);
//   dSK's 16 x 16 sums (a thread an entry, the diagonal q) and zz, then
//   the row sums P_R and dKbar (the two 16 x 64 x 64 products) as 4 x 4
//   register tiles, each thread over half of the rows i, the halves added
//   through shared memory;
//   at column j and steps f + 4 p (thread (j, f)): the terms of d log w that
//   reach Z0 or Z1, then the walk over the chunk's other steps s, each pair
//   factor one exp2, with the pair terms of d log w and the gradients;
//   d log w's sums over the thread's steps are reduced across the four
//   threads of a column by shuffles.
// All arithmetic is fp32; everything reduces inside a block, with no atomics.
//
// Bound on the H100: fp32 operations, 13 B*T*H*64*64 counted as the
// sequential form's (the state rebuilt and its adjoint), which the two
// passes do not exceed; the extra traffic is the dZ1 workspace, written once
// and read once (B*H*(T/16)*16 KiB), and zin read by pass 2.
#pragma once

#include "wkv6_chunk.cuh"

namespace {

constexpr int CB_THREADS = 256;       // pass 2: threads a block
constexpr int CB_P = CB_THREADS / N;  // pass 2: threads a column j
constexpr int CB_MLD = CHUNK + 4;     // row stride of dSK
constexpr int CB_QS = 4;              // pass 2: steps a thread walks at once

// Byte offsets of a pass-2 block's shared memory.
template <int DT>
struct Wkv6BwdSmem {
  static constexpr int FTILE = CHUNK * LDP * 4;  // bytes of an fp32 [t][j] tile
  static constexpr int ZTILE = N * LDP * 4;      // bytes of an fp32 [j][i] state
  static constexpr size_t raw = 0;                                         // r, w, k
  static constexpr size_t vt = raw + 3 * CHUNK * N * sizeof(Stream<DT>);   // v [t][i]
  static constexpr size_t dyt = vt + FTILE;                                // dy [t][i]
  static constexpr size_t gt = dyt + FTILE;                                // g [t][j]
  static constexpr size_t gpt = gt + FTILE;                                // g_p [t][j]
  static constexpr size_t pr = gpt + FTILE;                                // P_R [t][j]
  static constexpr size_t pk = pr + FTILE;                                 // dKbar [t][j]
  static constexpr size_t dsk = pk + FTILE;                                // dSK [t][CB_MLD]
  static constexpr size_t z0 = dsk + CHUNK * CB_MLD * 4;                   // Z0 [j][i]
  static constexpr size_t dz1 = z0 + ZTILE;                                // dZ1 [j][i]
  static constexpr size_t bytes = dz1 + ZTILE;
};

// ---------------------------------------------------------------------------
// Pass 1: the cotangent recurrence over a slice of value rows.
// ---------------------------------------------------------------------------
template <int DT, int ROWS, int FORM>
__global__ void __launch_bounds__(ROWS * threads_a_row<ROWS>(), min_blocks<FORM>()) wkv6_bwd_state_kernel(
    int Tlen, int H, float wfloor, const Stream<DT>* __restrict__ r,
    const Stream<DT>* __restrict__ w, const Stream<DT>* __restrict__ k,
    const Stream<DT>* __restrict__ dy, const float* __restrict__ u, const float* __restrict__ dsf,
    Stream<DT>* __restrict__ dv, float* __restrict__ ds0, float* __restrict__ dz1) {
  chunk_walk<DT, 2, ROWS, FORM>(Tlen, H, wfloor, r, w, k, dy, u, dsf, dv, ds0, dz1);
}

// ---------------------------------------------------------------------------
// Pass 2: the chunk-local sums over value rows, a block a (b, h, chunk).
// ---------------------------------------------------------------------------

// P_R = dY Z0^T and dKbar = V dZ1^T, the two 16 x 64 x 64 sums over rows i,
// into pr and pk ([t][j]), ending on a barrier: 4 x 4 register tiles,
// threads 0-63 and 64-127 P_R over rows i < 32 and i >= 32, 128-255 dKbar
// likewise, the halves added through shared memory; tile rows tb + 4 e,
// columns jb + 16 e2 (the 16 rows a quarter warp reads lie in distinct bank
// groups). 3xTF32 mma.sync m16n8k8 in their place was slower
// (chip_variants.py --wkv6bwd mma).
__device__ __forceinline__ void row_sums(int tid, const float* dyt, const float* vt, const float* z0,
                                         const float* zd, float* pr, float* pk) {
  const int prod = tid / 128, half = tid / 64 % 2, tb = tid % 64 / 16, jb = tid % 16;
  const float* lhs = prod ? vt : dyt;  // [t][i]
  const float* zs = prod ? zd : z0;    // [j][i]
  float acc[4][4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int e2 = 0; e2 < 4; ++e2) acc[e][e2] = 0.f;
#pragma unroll 2
  for (int i4 = 8 * half; i4 < 8 * half + 8; ++i4) {
    float4 x[4], z[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = *reinterpret_cast<const float4*>(lhs + (tb + 4 * e) * LDP + 4 * i4);
      z[e] = *reinterpret_cast<const float4*>(zs + (jb + 16 * e) * LDP + 4 * i4);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2) acc[e][e2] = dot4(x[e], z[e2], acc[e][e2]);
  }
  float* out = prod ? pk : pr;
  if (half) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2) out[(tb + 4 * e) * LDP + jb + 16 * e2] = acc[e][e2];
  }
  __syncthreads();
  if (!half) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2) out[(tb + 4 * e) * LDP + jb + 16 * e2] += acc[e][e2];
  }
  __syncthreads();
}

// three blocks a multiprocessor (80 registers, as shared memory allows): two
// ran 7 % slower (chip_variants.py --wkv6bwd p2_occ2)
template <int DT>
__global__ void __launch_bounds__(CB_THREADS, 3) wkv6_bwd_chunk_kernel(
    int Tlen, int H, float wfloor, const Stream<DT>* __restrict__ r,
    const Stream<DT>* __restrict__ w, const Stream<DT>* __restrict__ k,
    const Stream<DT>* __restrict__ v, const float* __restrict__ u,
    const Stream<DT>* __restrict__ dy, const float* __restrict__ zin,
    const float* __restrict__ dz1, Stream<DT>* __restrict__ dr, Stream<DT>* __restrict__ dw,
    Stream<DT>* __restrict__ dk, float* __restrict__ du) {
  using T = Stream<DT>;
  using L = Wkv6BwdSmem<DT>;
  constexpr int NT = CB_THREADS;
  constexpr int TILE = CHUNK * N, VEC = 16 / sizeof(T);

  extern __shared__ __align__(16) unsigned char smem[];
  T* raw = reinterpret_cast<T*>(smem + L::raw);
  float* vt = reinterpret_cast<float*>(smem + L::vt);
  float* dyt = reinterpret_cast<float*>(smem + L::dyt);
  float* gt = reinterpret_cast<float*>(smem + L::gt);
  float* gpt = reinterpret_cast<float*>(smem + L::gpt);
  float* pr = reinterpret_cast<float*>(smem + L::pr);
  float* pk = reinterpret_cast<float*>(smem + L::pk);
  float* dsk = reinterpret_cast<float*>(smem + L::dsk);
  float* z0 = reinterpret_cast<float*>(smem + L::z0);
  float* zd = reinterpret_cast<float*>(smem + L::dz1);

  const int tid = threadIdx.x;
  const int nc = Tlen / CHUNK;
  const int bh = blockIdx.x / nc, c = blockIdx.x % nc;
  const int h = bh % H;
  const size_t tstride = (size_t)H * N;
  const size_t c0 = ((size_t)(bh / H) * Tlen * H + h) * N + (size_t)c * CHUNK * tstride;  // (b, 16c, h, 0)
  const size_t zoff = ((size_t)bh * nc + c) * N * N;

  // the chunk's r, w, k (raw), Z0 and dZ1 by cp.async; v and dy as fp32
  {
    constexpr int ROW_SEGS = N / VEC, TILE_SEGS = CHUNK * ROW_SEGS;
    for (int idx = tid; idx < 3 * TILE_SEGS; idx += NT) {
      const int tile = idx / TILE_SEGS, t = idx % TILE_SEGS / ROW_SEGS, col = idx % ROW_SEGS * VEC;
      const T* src = tile == 0 ? r : tile == 1 ? w : k;
      cp_async16(raw + tile * TILE + t * N + col, src + c0 + (size_t)t * tstride + col, true);
    }
    for (int idx = tid; idx < 2 * N * (N / 4); idx += NT) {  // 16-byte segments of Z0 and dZ1
      const int which = idx / (N * N / 4), j = idx % (N * N / 4) / (N / 4), col = idx % (N / 4) * 4;
      cp_async16((which ? zd : z0) + j * LDP + col, (which ? dz1 : zin) + zoff + (size_t)j * N + col, true);
    }
    cp_async_commit();
    for (int idx = tid; idx < TILE; idx += NT) {
      const int t = idx / N, i = idx % N;
      vt[t * LDP + i] = to_f(v[c0 + (size_t)t * tstride + i]);
      dyt[t * LDP + i] = to_f(dy[c0 + (size_t)t * tstride + i]);
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // g and g_p at column fj, steps 4 fp .. 4 fp + 3
  {
    const int fj = tid / CB_P, fp = tid % CB_P;
    constexpr int TP = CHUNK / CB_P;
    float lw[TP], g[TP], run = 0.f;
#pragma unroll
    for (int q = 0; q < TP; ++q) {
      lw[q] = fmaxf(-expf(to_f(raw[TILE + (fp * TP + q) * N + fj])), wfloor) * LOG2E;
      run += lw[q];
      g[q] = run;
    }
    float incl = run;
#pragma unroll
    for (int d = 1; d < CB_P; d <<= 1) {
      const float o = __shfl_up_sync(FULL, incl, d, CB_P);
      if (fp >= d) incl += o;
    }
    // g_p of a step is the previous step's g bit for bit (wkv6_chunk.cuh, FORM 2)
    const float excl = incl - run, prev = __shfl_up_sync(FULL, excl + g[TP - 1], 1, CB_P);
#pragma unroll
    for (int q = 0; q < TP; ++q) {
      const int o = (fp * TP + q) * LDP + fj;
      gt[o] = excl + g[q];
      gpt[o] = q ? excl + g[q - 1] : fp ? prev : 0.f;
    }
  }

  // the sums over rows i: dSK (thread (t, s), the diagonal the bonus's
  // cotangent q_t), zz at column j, and P_R = dY Z0^T, dKbar = V dZ1^T
  const int j = tid / CB_P, f = tid % CB_P;
  float zz = 0.f;
  {
    const int t = tid / CHUNK, s = tid % CHUNK;
    float m = 0.f;
#pragma unroll 4
    for (int i4 = 0; i4 < N / 4; ++i4)
      m = dot4(*reinterpret_cast<const float4*>(dyt + t * LDP + 4 * i4),
               *reinterpret_cast<const float4*>(vt + s * LDP + 4 * i4), m);
    dsk[t * CB_MLD + s] = s <= t ? m : 0.f;
#pragma unroll
    for (int i4 = f; i4 < N / 4; i4 += CB_P)
      zz = dot4(*reinterpret_cast<const float4*>(z0 + j * LDP + 4 * i4),
                *reinterpret_cast<const float4*>(zd + j * LDP + 4 * i4), zz);
    zz += __shfl_xor_sync(FULL, zz, 1);
    zz += __shfl_xor_sync(FULL, zz, 2);
  }
  row_sums(tid, dyt, vt, z0, zd, pr, pk);

  // at column j, steps t = f + 4 p: first the terms of d log w_q that reach
  // Z0 or Z1, y's r e^{g_p} P_R (q < t) and Z1's k e^{g_l - g} dKbar (q > t),
  // into cr[q]; then the walk over s with the pair terms (q strictly between
  // s and t) and the gradients at (t, j)
  const float gl = gt[(CHUNK - 1) * LDP + j], uj = u[h * N + j];
  float cr[CHUNK];
#pragma unroll
  for (int q = 0; q < CHUNK; ++q) cr[q] = 0.f;
  float du_acc = 0.f;
#pragma unroll 1
  for (int p0 = 0; p0 < CHUNK / CB_P; p0 += CB_QS) {
    int ts[CB_QS];
    float rt[CB_QS], kt[CB_QS], gpt_[CB_QS], gt_[CB_QS], drp[CB_QS], dkp[CB_QS], run[CB_QS];
#pragma unroll
    for (int p = 0; p < CB_QS; ++p) {
      const int t = ts[p] = f + CB_P * (p0 + p), o = t * LDP + j;
      rt[p] = to_f(raw[t * N + j]);
      kt[p] = to_f(raw[2 * TILE + t * N + j]);
      gt_[p] = gt[o];
      gpt_[p] = gpt[o];
      drp[p] = dkp[p] = run[p] = 0.f;
      const float r0 = rt[p] * exp2f(gpt_[p]) * pr[o];
      const float k0 = kt[p] * exp2f(gl - gt_[p]) * pk[o];
#pragma unroll
      for (int q = 0; q < CHUNK; ++q) cr[q] += (q < t ? r0 : 0.f) + (q > t ? k0 : 0.f);
    }
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) {
      const int o = s * LDP + j;
      const float gs = gt[o], gps = gpt[o];
      const float rs = to_f(raw[s * N + j]), ks = to_f(raw[2 * TILE + s * N + j]);
#pragma unroll
      for (int p = 0; p < CB_QS; ++p) {
        const int t = ts[p];
        if (s < t) {  // the pair (t, s): e^{g_p,t - g_s}
          const float x = dsk[t * CB_MLD + s] * exp2f(fminf(gpt_[p] - gs, 0.f)) * ks;
          cr[s] += run[p];  // the pairs (t, s') with s' < s span step s
          run[p] = fmaf(x, rt[p], run[p]);
          drp[p] += x;
        } else if (s > t) {  // the pair (s, t): e^{g_p,s - g_t}
          dkp[p] = fmaf(dsk[s * CB_MLD + t] * exp2f(fminf(gps - gt_[p], 0.f)), rs, dkp[p]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < CB_QS; ++p) {
      const int t = ts[p], o = t * LDP + j;
      const float q = dsk[t * CB_MLD + t];
      const size_t go = c0 + (size_t)t * tstride + j;
      dr[go] = from_f<T>(fmaf(pr[o], exp2f(gpt_[p]), fmaf(q * uj, kt[p], drp[p])));
      dk[go] = from_f<T>(fmaf(pk[o], exp2f(gl - gt_[p]), fmaf(q * uj, rt[p], dkp[p])));
      du_acc = fmaf(q * kt[p], rt[p], du_acc);
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
    const float lw = -expf(to_f(raw[TILE + s * N + j]));
    dw[c0 + (size_t)s * tstride + j] = from_f<T>(lw > wfloor ? (cr[m] + ez) * lw : 0.f);
  }
  du_acc += __shfl_xor_sync(FULL, du_acc, 1);
  du_acc += __shfl_xor_sync(FULL, du_acc, 2);
  if (f == 0) du[((size_t)bh * nc + c) * N + j] = du_acc;
}

template <int DT, int ROWS, int FORM>
int launch_bwd_state(int B, int T, int H, float wfloor, const void* r, const void* w, const void* k,
                     const void* dy, const void* u, const void* dsf, void* dv, void* ds0, void* dz1,
                     cudaStream_t st) {
  using X = Stream<DT>;
  const auto kernel = wkv6_bwd_state_kernel<DT, ROWS, FORM>;
  constexpr size_t smem = FwdSmem<DT, ROWS>::bytes;
  static hopper_host::SmemOptIn opt_in;
  const int e = opt_in(kernel, smem);
  if (e != 0) return e;
  kernel<<<B * H * (N / ROWS), ROWS * threads_a_row<ROWS>(), smem, st>>>(
      T, H, wfloor, (const X*)r, (const X*)w, (const X*)k, (const X*)dy, (const float*)u,
      (const float*)dsf, (X*)dv, (float*)ds0, (float*)dz1);
  return (int)cudaGetLastError();
}

// pass 1 in the factor form of the floor (wkv6_chunk.cuh), as K8
template <int DT, int ROWS>
int launch_bwd_rows(int B, int T, int H, float wfloor, const void* r, const void* w, const void* k,
                    const void* dy, const void* u, const void* dsf, void* dv, void* ds0, void* dz1,
                    cudaStream_t st) {
  switch (factor_form(wfloor)) {
    case 0: return launch_bwd_state<DT, ROWS, 0>(B, T, H, wfloor, r, w, k, dy, u, dsf, dv, ds0, dz1, st);
    case 1: return launch_bwd_state<DT, ROWS, 1>(B, T, H, wfloor, r, w, k, dy, u, dsf, dv, ds0, dz1, st);
  }
  return launch_bwd_state<DT, ROWS, 2>(B, T, H, wfloor, r, w, k, dy, u, dsf, dv, ds0, dz1, st);
}

template <int DT>
int launch_bwd_dt(int rows, int B, int T, int H, float wfloor, const void* r, const void* w,
                  const void* k, const void* v, const void* u, const void* zin, const void* dy,
                  const void* dsf, void* dr, void* dw, void* dk, void* dv, void* du, void* ds0,
                  void* dz1, cudaStream_t st) {
  int e;
  switch (rows) {
    case 16: e = launch_bwd_rows<DT, 16>(B, T, H, wfloor, r, w, k, dy, u, dsf, dv, ds0, dz1, st); break;
    case 32: e = launch_bwd_rows<DT, 32>(B, T, H, wfloor, r, w, k, dy, u, dsf, dv, ds0, dz1, st); break;
    case 64: e = launch_bwd_rows<DT, 64>(B, T, H, wfloor, r, w, k, dy, u, dsf, dv, ds0, dz1, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != 0) return e;
  using X = Stream<DT>;
  const auto kernel = wkv6_bwd_chunk_kernel<DT>;
  constexpr size_t smem = Wkv6BwdSmem<DT>::bytes;
  static hopper_host::SmemOptIn opt_in;
  e = opt_in(kernel, smem);
  if (e != 0) return e;
  kernel<<<B * H * (T / CHUNK), CB_THREADS, smem, st>>>(
      T, H, wfloor, (const X*)r, (const X*)w, (const X*)k, (const X*)v, (const float*)u, (const X*)dy,
      (const float*)zin, (const float*)dz1, (X*)dr, (X*)dw, (X*)dk, (float*)du);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a pass-2 block, bytes (-1: no such dtype); a
// pass-1 block's is K8's (wkv6_fwd_smem_bytes).
inline int bwd_chunk_smem_bytes(int dtype) {
  return dtype == 0 ? (int)Wkv6BwdSmem<0>::bytes : dtype == 1 ? (int)Wkv6BwdSmem<1>::bytes : -1;
}

}  // namespace
