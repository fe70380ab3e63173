// RWKV-7 ("x070") WKV forward in the chunked matrix form (K16): y and the
// final state of the recurrence of wkv7_chunk.cuh, computed chunk by chunk
// with matrix products, at chunk 32. Plain C interface,
// loaded with ctypes by visualrwkv_torch/ops/wkv7_cuda.py.
//
// Replaces visualrwkv_tpu/ops/wkv7_pallas.py::wkv7_pallas_v2 (kernel
// _wkv7_v2_kernel): the chunk-batched forward, whose chunk-local products
// are batched over a block of chunks and only the chunk-boundary state
// recurrence runs in sequence. Per chunk of L = 32 steps (streams [L, 64],
// Z = S^T the fp32 state [Nk, Nv] entering the chunk, g the inclusive
// cumulative sum of logw = -exp(w_raw) over the chunk, g_prev = g - logw):
//   a_t = a e^{g_prev}, b_h = b e^{-g}, k_h = k e^{-g}, r_t = r e^{g},
//   b_bar = b e^{g_L - g}, k_bar = k e^{g_L - g}
//   M = (a_t b_h^T) strictly lower, Nm = (a_t k_h^T) strictly lower
//   ta = (I - M)^{-1} a_t, tu = (I - M)^{-1} (Nm v)
//   sb = (r_t b_h^T) lower, sk = (r_t k_h^T) lower
//   q_eff = r_t + sb ta, y_loc = sb tu + sk v
//   bta = b_bar^T ta, h_loc = b_bar^T tu + k_bar^T v, p_last = e^{g_L}
//   y = q_eff Z + y_loc,  Z <- diag(p_last) Z + bta Z + h_loc.
// Two launches:
//   * phase 1, one block of 128 threads per (b, h, chunk), all chunks in
//     parallel: everything above that does not need Z, written to a scratch
//     buffer in fp32 (q_eff, y_loc, bta, h_loc, p_last: 48 KiB a chunk).
//     M, Nm and the solve stay fp32 (FMA): the solve amplifies the rounding of
//     M (docs/wkv_chunk_stability.md), so, as the JAX kernels keep M/T/U in
//     fp32, only the bounded products (sb, sk, q_eff, y_loc, bta, h_loc) take
//     bf16 operands on the tensor cores (WMMA, fp32 accumulation) when the
//     streams are bf16; with fp32 streams every product is fp32 FMA. The solve
//     is forward substitution, one row after the other (64 threads a
//     right-hand side, one column each): no inverse is formed, so its solve
//     length is 1, inside the envelope of the reference's length-16 blocks.
//   * phase 2, one block of 256 threads per (b, h): the boundary recurrence
//     over the T/32 chunks, y and Z in fp32 FMA, Z in shared memory, a 4 x 4
//     register tile of the new Z a thread.
// The dependent chain is T/32 chunk steps where K1 takes T/16 (K1 also walks
// each 16-step chunk's solve in sequence).
//
// Bound on the H100: at B=8, T=512, H=32 (the shape the reference kernel's
// note measured) the function reads about 29 MB of bf16 streams; its
// operation count, taken as the sequential recurrence's 9 B T H N^2 in fp32,
// sets the bound (0.072 ms). The chunked form does more operations than the
// recurrence (the L x L products) and moves its 48 KiB of scratch a chunk
// through device memory twice; this is the simple correct form (no fusion
// of the two phases, no pipelining).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int L = 32;      // chunk length
constexpr int NH = 64;     // head size
constexpr int LD = NH + 4;  // fp32 row stride of the [L, 64] arrays
constexpr int LDM = L + 4;  // fp32 row stride of the [L, L] arrays
constexpr int LDO = NH + 8;  // bf16 row stride of the [L, 64] operand copies
constexpr int LDS = L + 8;   // bf16 row stride of the [L, L] operand copies
constexpr int P1_THREADS = 128;
constexpr int P2_THREADS = 256;
constexpr int LDZ = NH + 4;  // Z row stride in phase 2 (float4 rows)
constexpr int LDQ = NH + 1;  // q_eff / bta row stride in phase 2 (conflict-free columns)
// phase 2's shared memory: Z twice (the chunk's input and output), q_eff, bta
constexpr size_t P2_SMEM = (size_t)(2 * NH * LDZ + L * LDQ + NH * LDQ) * sizeof(float);

// scratch floats a chunk: q_eff [L, 64], y_loc [L, 64], bta [64, 64],
// h_loc [64, 64], p_last [64]
constexpr int OFF_Q = 0, OFF_Y = L * NH, OFF_BTA = 2 * L * NH, OFF_H = 2 * L * NH + NH * NH,
              OFF_P = 2 * L * NH + 2 * NH * NH, SCRATCH = OFF_P + NH;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// fp32 shared arrays of phase 1 (floats), then, for bf16 streams, the bf16
// operand copies
constexpr int A_R = 0, A_W = 1, A_K = 2, A_V = 3, A_A = 4, A_B = 5, A_BH = 6, A_KH = 7, A_NV = 8;
constexpr int N_ARR = 9;
constexpr int F_M = N_ARR * L * LD, F_N = F_M + L * LDM, F_SB = F_N + L * LDM,
              F_SK = F_SB + L * LDM, F_END = F_SK + L * LDM;
constexpr int O_RT = 0, O_BH = 1, O_KH = 2, O_BB = 3, O_KB = 4, O_V = 5, O_TA = 6, O_TU = 7;
constexpr int N_OPS = 8;
constexpr size_t P1_SMEM_F32 = (size_t)F_END * sizeof(float);
constexpr size_t P1_SMEM_BF16 =
    P1_SMEM_F32 + (size_t)(N_OPS * L * LDO + 2 * L * LDS) * sizeof(bf16);

// C (=, or += when acc) A B over fp32 operands, one output a thread at a time:
// A(m, k) = A[m * am + k * ak], B(k, n) = B[k * bk + n * bn]
__device__ void fma_mm(float* C, int ldc, const float* A, int am, int ak, const float* B, int bk,
                       int bn, int M, int N, int K, bool acc) {
  for (int idx = threadIdx.x; idx < M * N; idx += P1_THREADS) {
    const int m = idx / N, n = idx % N;
    float s = acc ? C[m * ldc + n] : 0.f;
    for (int k = 0; k < K; ++k) s = fmaf(A[m * am + k * ak], B[k * bk + n * bn], s);
    C[m * ldc + n] = s;
  }
}

// One 16 x 16 tile of C = (Cinit +) sum over ``steps`` 16-deep slices of A B
// on the tensor cores; A and B point at the tile's origin, ``astep`` /
// ``bstep`` advance them by one slice.
template <typename LA, typename LB>
__device__ __forceinline__ void tc_tile(float* C, int ldc, const float* Cinit, int ldci,
                                        const bf16* A, int lda, int astep, const bf16* B, int ldb,
                                        int bstep, int steps) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf;
  if (Cinit != nullptr) wmma::load_matrix_sync(cf, Cinit, ldci, wmma::mem_row_major);
  else wmma::fill_fragment(cf, 0.f);
  for (int s = 0; s < steps; ++s) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> af;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> bfr;
    wmma::load_matrix_sync(af, A + s * astep, lda);
    wmma::load_matrix_sync(bfr, B + s * bstep, ldb);
    wmma::mma_sync(cf, af, bfr, cf);
  }
  wmma::store_matrix_sync(C, cf, ldc, wmma::mem_row_major);
}

template <typename T>
__global__ void __launch_bounds__(P1_THREADS) wkv7_v2_chunk_kernel(
    int T_len, int H, const T* __restrict__ r, const T* __restrict__ w, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ a, const T* __restrict__ b,
    float* __restrict__ scratch) {
  constexpr bool TC = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* f = reinterpret_cast<float*>(smem_raw);
  float* arr[N_ARR];
#pragma unroll
  for (int i = 0; i < N_ARR; ++i) arr[i] = f + i * L * LD;
  float *R = arr[A_R], *W = arr[A_W], *K = arr[A_K], *V = arr[A_V], *A = arr[A_A], *Bv = arr[A_B],
        *BH = arr[A_BH], *KH = arr[A_KH], *NV = arr[A_NV];
  float *Mm = f + F_M, *Nm = f + F_N, *SB = f + F_SB, *SK = f + F_SK;
  bf16* ops = reinterpret_cast<bf16*>(f + F_END);
  bf16* op[N_OPS];
#pragma unroll
  for (int i = 0; i < N_OPS; ++i) op[i] = ops + i * L * LDO;
  bf16* SBo = ops + N_OPS * L * LDO;
  bf16* SKo = SBo + L * LDS;

  const int c = blockIdx.x, bh = blockIdx.y;
  const int bi = bh / H, h = bh % H;
  const int nc = T_len / L;
  const int tid = threadIdx.x;
  float* out = scratch + ((size_t)bh * nc + c) * SCRATCH;

  // the chunk's rows of the six streams, as fp32; w as logw = -exp(w_raw)
  for (int idx = tid; idx < L * NH; idx += P1_THREADS) {
    const int t = idx / NH, j = idx % NH;
    const size_t gi = (((size_t)bi * T_len + (size_t)c * L + t) * H + h) * NH + j;
    const int si = t * LD + j;
    R[si] = to_f(r[gi]);
    W[si] = -expf(to_f(w[gi]));
    K[si] = to_f(k[gi]);
    V[si] = to_f(v[gi]);
    A[si] = to_f(a[gi]);
    Bv[si] = to_f(b[gi]);
  }
  __syncthreads();
  // inclusive cumulative log decay, one channel a thread; W becomes g
  if (tid < NH) {
    float g = 0.f;
    for (int t = 0; t < L; ++t) {
      g += W[t * LD + tid];
      W[t * LD + tid] = g;
    }
    out[OFF_P + tid] = expf(g);
  }
  __syncthreads();
  // the decay-adjusted operands, in place
  for (int idx = tid; idx < L * NH; idx += P1_THREADS) {
    const int t = idx / NH, j = idx % NH, si = t * LD + j;
    const float g = W[si], g_prev = t ? W[si - LD] : 0.f, g_last = W[(L - 1) * LD + j];
    const float e_g = expf(g), e_ng = expf(-g), e_tail = expf(g_last - g);
    const float bb = Bv[si], kk = K[si];
    A[si] *= expf(g_prev);
    BH[si] = bb * e_ng;
    KH[si] = kk * e_ng;
    R[si] *= e_g;
    Bv[si] = bb * e_tail;
    K[si] = kk * e_tail;
    if (TC) {
      const int oi = t * LDO + j;
      op[O_RT][oi] = __float2bfloat16(R[si]);
      op[O_BH][oi] = __float2bfloat16(BH[si]);
      op[O_KH][oi] = __float2bfloat16(KH[si]);
      op[O_BB][oi] = __float2bfloat16(Bv[si]);
      op[O_KB][oi] = __float2bfloat16(K[si]);
      op[O_V][oi] = __float2bfloat16(V[si]);
    }
  }
  __syncthreads();
  // M and Nm in fp32, strictly lower triangular: a 4 x 4 tile of one of
  // them a thread (2 x 64 tiles), 16 FMAs for every 8 shared-memory loads
  {
    const int which = tid / 64, t0 = (tid % 64) / 8 * 4, s0 = tid % 8 * 4;
    const float* rhs = which ? KH : BH;
    float acc[4][4] = {};
    if (s0 < t0 + 3) {
      for (int j = 0; j < NH; ++j) {
        float x[4], y2[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = A[(t0 + i) * LD + j];
          y2[i] = rhs[(s0 + i) * LD + j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(x[i], y2[q], acc[i][q]);
      }
    }
    float* dst = which ? Nm : Mm;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[(t0 + i) * LDM + s0 + q] = s0 + q < t0 + i ? acc[i][q] : 0.f;
  }
  __syncthreads();
  fma_mm(NV, LD, Nm, LDM, 1, V, LD, 1, L, NH, L, false);  // Nm v
  __syncthreads();
  // ta = (I - M)^{-1} a_t and tu = (I - M)^{-1} (Nm v) by forward
  // substitution, in place: u_t = rhs_t + sum_{s<t} M[t, s] u_s
  // (the column lives in registers, so the rows' sums overlap)
  {
    float* U = tid < NH ? A : NV;
    const int j = tid % NH;
    float u[L];
#pragma unroll
    for (int t = 0; t < L; ++t) u[t] = U[t * LD + j];
#pragma unroll
    for (int t = 1; t < L; ++t) {
      float acc = u[t];
#pragma unroll
      for (int s = 0; s < t; ++s) acc = fmaf(Mm[t * LDM + s], u[s], acc);
      u[t] = acc;
    }
#pragma unroll
    for (int t = 0; t < L; ++t) U[t * LD + j] = u[t];
  }
  __syncthreads();

  float* q_eff = out + OFF_Q;
  float* y_loc = out + OFF_Y;
  float* bta = out + OFF_BTA;
  float* h_loc = out + OFF_H;
  if (TC) {
    for (int idx = tid; idx < L * NH; idx += P1_THREADS) {
      const int t = idx / NH, j = idx % NH;
      op[O_TA][t * LDO + j] = __float2bfloat16(A[t * LD + j]);
      op[O_TU][t * LDO + j] = __float2bfloat16(NV[t * LD + j]);
    }
    // sb, sk: 2 x 4 tiles of 16 x 16, one of each a warp
    const int warp = tid >> 5;
    const int ti = warp >> 1, si = warp & 1;
    tc_tile<wmma::row_major, wmma::col_major>(SB + ti * 16 * LDM + si * 16, LDM, nullptr, 0,
                                              op[O_RT] + ti * 16 * LDO, LDO, 16,
                                              op[O_BH] + si * 16 * LDO, LDO, 16, NH / 16);
    tc_tile<wmma::row_major, wmma::col_major>(SK + ti * 16 * LDM + si * 16, LDM, nullptr, 0,
                                              op[O_RT] + ti * 16 * LDO, LDO, 16,
                                              op[O_KH] + si * 16 * LDO, LDO, 16, NH / 16);
    __syncthreads();
    for (int idx = tid; idx < L * L; idx += P1_THREADS) {  // keep s <= t, round to bf16
      const int t = idx / L, s = idx % L;
      SBo[t * LDS + s] = __float2bfloat16(s <= t ? SB[t * LDM + s] : 0.f);
      SKo[t * LDS + s] = __float2bfloat16(s <= t ? SK[t * LDM + s] : 0.f);
    }
    __syncthreads();
    // q_eff = r_t + sb ta, y_loc = sb tu + sk v: 8 tiles each, two a warp
    for (int tile = warp; tile < 8; tile += 4) {
      const int ti2 = tile >> 2, nj = tile & 3;
      float* qc = q_eff + ti2 * 16 * NH + nj * 16;
      float* yc = y_loc + ti2 * 16 * NH + nj * 16;
      tc_tile<wmma::row_major, wmma::row_major>(qc, NH, R + ti2 * 16 * LD + nj * 16, LD,
                                                SBo + ti2 * 16 * LDS, LDS, 16,
                                                op[O_TA] + nj * 16, LDO, 16 * LDO, L / 16);
      tc_tile<wmma::row_major, wmma::row_major>(yc, NH, nullptr, 0, SBo + ti2 * 16 * LDS, LDS, 16,
                                                op[O_TU] + nj * 16, LDO, 16 * LDO, L / 16);
      tc_tile<wmma::row_major, wmma::row_major>(yc, NH, yc, NH, SKo + ti2 * 16 * LDS, LDS, 16,
                                                op[O_V] + nj * 16, LDO, 16 * LDO, L / 16);
    }
    // bta = b_bar^T ta, h_loc = b_bar^T tu + k_bar^T v: 16 tiles each, four a warp
    for (int tile = warp; tile < 16; tile += 4) {
      const int mi = tile >> 2, nj = tile & 3;
      float* bc = bta + mi * 16 * NH + nj * 16;
      float* hc = h_loc + mi * 16 * NH + nj * 16;
      tc_tile<wmma::col_major, wmma::row_major>(bc, NH, nullptr, 0, op[O_BB] + mi * 16, LDO,
                                                16 * LDO, op[O_TA] + nj * 16, LDO, 16 * LDO,
                                                L / 16);
      tc_tile<wmma::col_major, wmma::row_major>(hc, NH, nullptr, 0, op[O_BB] + mi * 16, LDO,
                                                16 * LDO, op[O_TU] + nj * 16, LDO, 16 * LDO,
                                                L / 16);
      tc_tile<wmma::col_major, wmma::row_major>(hc, NH, hc, NH, op[O_KB] + mi * 16, LDO,
                                                16 * LDO, op[O_V] + nj * 16, LDO, 16 * LDO,
                                                L / 16);
    }
  } else {
    fma_mm(SB, LDM, R, LD, 1, BH, 1, LD, L, L, NH, false);  // r_t b_h^T
    fma_mm(SK, LDM, R, LD, 1, KH, 1, LD, L, L, NH, false);  // r_t k_h^T
    __syncthreads();
    for (int idx = tid; idx < L * L; idx += P1_THREADS) {
      const int t = idx / L, s = idx % L;
      if (s > t) SB[t * LDM + s] = SK[t * LDM + s] = 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < L * NH; idx += P1_THREADS) q_eff[idx] = R[(idx / NH) * LD + idx % NH];
    fma_mm(q_eff, NH, SB, LDM, 1, A, LD, 1, L, NH, L, true);
    fma_mm(y_loc, NH, SB, LDM, 1, NV, LD, 1, L, NH, L, false);
    fma_mm(y_loc, NH, SK, LDM, 1, V, LD, 1, L, NH, L, true);
    fma_mm(bta, NH, Bv, 1, LD, A, LD, 1, NH, NH, L, false);
    fma_mm(h_loc, NH, Bv, 1, LD, NV, LD, 1, NH, NH, L, false);
    fma_mm(h_loc, NH, K, 1, LD, V, LD, 1, NH, NH, L, true);
  }
}

// Phase 2: the boundary recurrence of one (b, h) over its chunks, fp32.
// Thread tid owns a 4 x 4 tile of Z (rows 4 (tid / 16), columns 4 (tid % 16))
// and a 2 x 4 tile of the chunk's y, so that a float4 of Z and a few
// broadcast values of bta / q_eff feed 16 (8) FMAs.
template <typename T>
__global__ void __launch_bounds__(P2_THREADS) wkv7_v2_state_kernel(
    int T_len, int H, const float* __restrict__ scratch, const float* __restrict__ s0,
    T* __restrict__ y, float* __restrict__ s_out) {
  extern __shared__ __align__(128) float p2[];
  float* Z[2] = {p2, p2 + NH * LDZ};
  float* Q = p2 + 2 * NH * LDZ;
  float* BT = Q + L * LDQ;
  const int bh = blockIdx.x, bi = bh / H, h = bh % H;
  const int nc = T_len / L;
  const int tid = threadIdx.x;
  const int i0 = tid / 16 * 4, j0 = tid % 16 * 4, t0 = tid / 16 * 2;

  // Z = S0^T (zero without an initial state)
  for (int idx = tid; idx < NH * NH; idx += P2_THREADS) {
    const int vi = idx / NH, ki = idx % NH;  // S0[vi][ki], read coalesced
    Z[0][ki * LDZ + vi] = s0 ? s0[(size_t)bh * NH * NH + idx] : 0.f;
  }
  int cur = 0;
  for (int c = 0; c < nc; ++c) {
    const float* sc = scratch + ((size_t)bh * nc + c) * SCRATCH;
    __syncthreads();  // Z[cur] written; Q and BT free
    for (int idx = tid; idx < L * NH; idx += P2_THREADS)
      Q[idx / NH * LDQ + idx % NH] = sc[OFF_Q + idx];
    for (int idx = tid; idx < NH * NH; idx += P2_THREADS)
      BT[idx / NH * LDQ + idx % NH] = sc[OFF_BTA + idx];
    __syncthreads();
    const float* z = Z[cur];
    float* zn = Z[cur ^ 1];
    // y_c = q_eff Z + y_loc
    {
      float acc[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float4 yl = *reinterpret_cast<const float4*>(sc + OFF_Y + (t0 + a) * NH + j0);
        acc[a][0] = yl.x, acc[a][1] = yl.y, acc[a][2] = yl.z, acc[a][3] = yl.w;
      }
      for (int m = 0; m < NH; ++m) {
        const float4 zm = *reinterpret_cast<const float4*>(z + m * LDZ + j0);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float qv = Q[(t0 + a) * LDQ + m];
          acc[a][0] = fmaf(qv, zm.x, acc[a][0]);
          acc[a][1] = fmaf(qv, zm.y, acc[a][1]);
          acc[a][2] = fmaf(qv, zm.z, acc[a][2]);
          acc[a][3] = fmaf(qv, zm.w, acc[a][3]);
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        T* yr = y + (((size_t)bi * T_len + (size_t)c * L + t0 + a) * H + h) * NH + j0;
#pragma unroll
        for (int q = 0; q < 4; ++q) yr[q] = from_f<T>(acc[a][q]);
      }
    }
    // Z <- diag(p_last) Z + bta Z + h_loc
    {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = sc[OFF_P + i0 + a];
        const float4 hl = *reinterpret_cast<const float4*>(sc + OFF_H + (i0 + a) * NH + j0);
        const float4 zi = *reinterpret_cast<const float4*>(z + (i0 + a) * LDZ + j0);
        acc[a][0] = fmaf(p, zi.x, hl.x);
        acc[a][1] = fmaf(p, zi.y, hl.y);
        acc[a][2] = fmaf(p, zi.z, hl.z);
        acc[a][3] = fmaf(p, zi.w, hl.w);
      }
      for (int m = 0; m < NH; ++m) {
        const float4 zm = *reinterpret_cast<const float4*>(z + m * LDZ + j0);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float bv = BT[(i0 + a) * LDQ + m];
          acc[a][0] = fmaf(bv, zm.x, acc[a][0]);
          acc[a][1] = fmaf(bv, zm.y, acc[a][1]);
          acc[a][2] = fmaf(bv, zm.z, acc[a][2]);
          acc[a][3] = fmaf(bv, zm.w, acc[a][3]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4*>(zn + (i0 + a) * LDZ + j0) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }
    cur ^= 1;
  }
  __syncthreads();
  for (int idx = tid; idx < NH * NH; idx += P2_THREADS) {  // S = Z^T, written coalesced
    const int vi = idx / NH, ki = idx % NH;
    s_out[(size_t)bh * NH * NH + idx] = Z[cur][ki * LDZ + vi];
  }
}

template <typename T>
int launch_v2(int B, int T_len, int H, const void* r, const void* w, const void* k,
              const void* v, const void* a, const void* b, const void* s0, void* y, void* s_out,
              void* scratch, cudaStream_t st) {
  const size_t smem = sizeof(T) == 2 ? P1_SMEM_BF16 : P1_SMEM_F32;
  const cudaError_t e = cudaFuncSetAttribute(
      wkv7_v2_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid1(T_len / L, B * H);
  wkv7_v2_chunk_kernel<T><<<grid1, P1_THREADS, smem, st>>>(
      T_len, H, (const T*)r, (const T*)w, (const T*)k, (const T*)v, (const T*)a, (const T*)b,
      (float*)scratch);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return (int)e1;
  const cudaError_t e2 = cudaFuncSetAttribute(
      wkv7_v2_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P2_SMEM);
  if (e2 != cudaSuccess) return (int)e2;
  wkv7_v2_state_kernel<T><<<B * H, P2_THREADS, P2_SMEM, st>>>(
      T_len, H, (const float*)scratch, (const float*)s0, (T*)y, (float*)s_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Floats of phase 1's scratch a chunk (the wrapper allocates
// B*H*(T/32)*wkv7_v2_scratch_floats() fp32).
int wkv7_v2_scratch_floats() { return SCRATCH; }

// dtype: 0 = float32, 1 = bfloat16 streams [B, T, H, 64]; T a multiple of 32.
// s0: fp32 [B, H, 64, 64] or null; y in the stream dtype; s_out fp32.
int wkv7_fwd_v2(int dtype, int B, int T, int H, int n, const void* r, const void* w,
                const void* k, const void* v, const void* a, const void* b, const void* s0,
                void* y, void* s_out, void* scratch, void* stream) {
  if (n != NH || B <= 0 || H <= 0 || T <= 0 || T % L) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_v2<float>(B, T, H, r, w, k, v, a, b, s0, y, s_out, scratch, st);
  if (dtype == 1) return launch_v2<bf16>(B, T, H, r, w, k, v, a, b, s0, y, s_out, scratch, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
