// RWKV-7 ("x070") WKV forward in the chunked matrix form (K16): y and the
// final state of the recurrence of wkv7_chunk.cuh, computed chunk by chunk
// with matrix products, at chunk 32. Plain C interface, loaded with ctypes
// by visualrwkv_torch/ops/wkv7_cuda.py.
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
//
// Two launches:
//   * phase 1, a block of 128 threads a (b, h, chunk), every chunk in
//     parallel: everything above that does not need Z, written to a scratch
//     buffer (q_eff, y_loc, bta, h_loc in the scratch type, p_last fp32).
//     M, Nm, Nm v and the solve stay fp32 FMA: the solve amplifies the
//     rounding of M (docs/wkv_chunk_stability.md), so, as the JAX kernels
//     keep M/T/U in fp32, only the bounded products take bf16 operands, and
//     only with bf16 streams. The solve is forward substitution, one row
//     after the other (a thread a right-hand side column): no inverse is
//     formed, so its solve length is 1, inside the envelope of the
//     reference's length-16 blocks.
//   * phase 2, a block of 128 threads a (b, h, slice of value columns of Z:
//     v2_cols): the boundary recurrence over the
//     T/32 chunks. Z's columns are S's value rows, and y = q_eff Z and
//     Z' = diag(p) Z + bta Z + h_loc act on Z from the left, so every column
//     evolves on its own and the slices share nothing. Z stays fp32 between
//     chunks.
//
// Bound on the H100: at B=8, T=512, H=32 (the shape the reference kernel's
// note measured) the function reads about 29 MB of bf16 streams; its
// operation count, taken as the sequential recurrence's 9 B T H N^2 in fp32,
// sets the bound (0.072 ms). The chunked form does more operations than the
// recurrence (the L x L products) and moves its scratch through device
// memory twice.
//
// Design (bf16 streams).
// - Phase 1 in 62,464 bytes of shared memory, so that three blocks share a
//   multiprocessor. The streams are read straight from device memory, a
//   warp a quarter of the chunk's steps and a lane two channels, every load
//   issued before any arithmetic (the log decay's prefix sum runs in
//   registers); the fp32 operands of M and Nm (a_t, b_h, k_h) and the bf16
//   operands of the bounded products are written once, in the orientation
//   the products read, and arrays whose lives do not overlap share their
//   bytes (b_h, k_h -> M, Nm and Nm v; the bf16 b_h, k_h -> ta, tu; a_t, b_h,
//   k_h -> the output staging). M, Nm and Nm v are fp32 FMA on thread tiles
//   whose rows and columns lie in distinct shared-memory banks. The bounded
//   products run on mma.sync m16n8k16 (bf16 operands, fp32 sums), their
//   fragments loaded as bf16 pairs from padded rows (no bank conflicts), a
//   warp's A fragments loaded once for all the column tiles of its rows,
//   and their outputs staged in the warp's own rows so that they go to the
//   scratch as whole rows, 16 bytes a lane. The scratch is bf16, as the
//   reference rounds q_eff, y_loc and h_loc (bta too): 24 KiB a chunk.
// - Phase 2 over slices of value columns (v2_cols: the widest of 64, 32 and
//   16 that still gives 256 blocks; 16 at one prefill's B=1 H=32, four
//   blocks a head; whole heads at B=8 H=32), each block walking the chunks
//   with the next two chunks' operands (q_eff, bta, the slice of y_loc and
//   h_loc, p_last) in flight by cp.async into a ring of three stages, one
//   barrier a chunk. Both products run on mma.sync with Z as a bf16 operand,
//   as the reference's boundary products take it; each warp keeps its rows
//   of Z in fp32 in the products' accumulators (the diagonal and h_loc terms
//   are added in fp32) and writes the bf16 copy, transposed for the next
//   chunk's B fragments, into a double buffer.
// With fp32 streams phase 1 is an fp32 FMA kernel through shared memory
// (fp32 scratch, 96,768 B a block) and phase 2 the same ring over slices of
// 8 columns with fp32 FMA products.
// Measured on the H100 (chip_variants.py --v2): phase 2 with 64 columns
// takes 0.057 ms at B=8 T=512 where 16 take 0.076, and 0.072 at B=1 T=1024
// where 16 take 0.027 (128 blocks fill the card only with 16); 8 columns
// suit the fp32 form (0.066 against 0.083 with 16); without prefetch phase
// 2 takes 15-35 % longer, with two stages as long as with three; an fp32
// scratch costs 18 % at B=8; the staged stores take 6 % off phase 1.

#include <math.h>

#include <type_traits>

#include "hopper_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int L = 32;        // chunk length
constexpr int NH = 64;       // head size
constexpr int P1_THREADS = 128;
constexpr int P2_THREADS = 128;
// phase 2: the blocks to reach with bf16 streams (two for each of the
// H100's 132 multiprocessors, about), value columns of Z a block owns with
// fp32 streams, chunks of operands in flight (1: no prefetch), and the
// scratch type with bf16 streams
constexpr int V2_BLOCKS = 256;
constexpr int V2_COLS_F32 = 8;
constexpr int V2_STAGES = 3;
using V2Scratch = bf16;

// phase 2's value columns of Z a block owns for B*H heads: with bf16
// streams the most of 64, 32 and 16 that still give V2_BLOCKS blocks, else
// 16 (a head's q_eff and bta are read once for each of its slices, so
// wider slices read less, while narrower ones fill the card)
int v2_cols(int dtype, int bh) {
  if (dtype == 0) return V2_COLS_F32;
  return bh >= V2_BLOCKS ? 64 : 2 * bh >= V2_BLOCKS ? 32 : 16;
}

// scratch of a chunk: q_eff [L][64], y_loc [L][64], bta [64][64], h_loc
// [64][64] in the scratch type S (element offsets), then p_last [64] fp32
constexpr int OFF_Q = 0, OFF_Y = L * NH, OFF_BTA = 2 * L * NH, OFF_H = 2 * L * NH + NH * NH,
              N_SC = 2 * L * NH + 2 * NH * NH;
template <typename S>
__host__ __device__ constexpr size_t chunk_bytes() {
  return (size_t)N_SC * sizeof(S) + NH * sizeof(float);
}

// bf16 (1) or fp32 (0), the element types a kernel's integer template arguments name
template <int B16>
using V2Type = std::conditional_t<B16 == 1, bf16, float>;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st2(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = hopper::pack_bf16(x, y);
}
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const bf16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(hopper::bf16_lo(u), hopper::bf16_hi(u));
}

// ---------------------------------------------------------------------------
// mma.sync m16n8k16, bf16 operands, fp32 accumulators. g = lane / 4, q =
// lane % 4. A (16 x 16, row-major): rows g and g + 8, columns 2q, 2q + 1 and
// 2q + 8, 2q + 9. B (16 x 8): rows (k) 2q, 2q + 1 and 2q + 8, 2q + 9, column
// g. C (16 x 8): rows g and g + 8, columns 2q, 2q + 1.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pair(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }
__device__ __forceinline__ uint32_t pair(const float* p) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  return hopper::pack_bf16(x.x, x.y);
}

// A fragment at (m0, k0) of a row-major array A[m][k] (stride lda), bf16 or
// fp32 (rounded to bf16 pairs)
template <typename E>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const E* A, int lda, int m0, int k0, int lane) {
  const E* p = A + (m0 + (lane >> 2)) * lda + k0 + 2 * (lane & 3);
  a[0] = pair(p);
  a[1] = pair(p + 8 * lda);
  a[2] = pair(p + 8);
  a[3] = pair(p + 8 * lda + 8);
}

// B fragment at (k0, n0) of B[k][n] stored transposed, Bt[n][k] (stride ldb)
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const bf16* Bt, int ldb, int n0, int k0, int lane) {
  const bf16* p = Bt + (n0 + (lane >> 2)) * ldb + k0 + 2 * (lane & 3);
  b[0] = pair(p);
  b[1] = pair(p + 8);
}

// the C fragment of an m16n8 tile at (m0, n0) into a row-major [.][64] array
template <typename E>
__device__ __forceinline__ void st_tile(E* dst, int m0, int n0, const float (&c)[4], int lane) {
  E* p = dst + (m0 + (lane >> 2)) * NH + n0 + 2 * (lane & 3);
  st2(p, c[0], c[1]);
  st2(p + 8 * NH, c[2], c[3]);
}

// ---------------------------------------------------------------------------
// Phase 1 with fp32 streams: fp32 FMA through shared memory, fp32 scratch.
// ---------------------------------------------------------------------------
constexpr int LD = NH + 4;   // fp32 row stride of the [L, 64] arrays
constexpr int LDM = L + 4;   // fp32 row stride of the [L, L] arrays
constexpr int A_R = 0, A_W = 1, A_K = 2, A_V = 3, A_A = 4, A_B = 5, A_BH = 6, A_KH = 7, A_NV = 8;
constexpr int N_ARR = 9;
constexpr int F_M = N_ARR * L * LD, F_N = F_M + L * LDM, F_SB = F_N + L * LDM,
              F_SK = F_SB + L * LDM, F_END = F_SK + L * LDM;
constexpr size_t P1_SMEM_F32 = (size_t)F_END * sizeof(float);

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

__global__ void __launch_bounds__(P1_THREADS) wkv7_v2_chunk_f32_kernel(
    int T_len, int H, const float* __restrict__ r, const float* __restrict__ w,
    const float* __restrict__ k, const float* __restrict__ v, const float* __restrict__ a,
    const float* __restrict__ b, unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* f = reinterpret_cast<float*>(smem_raw);
  float* arr[N_ARR];
#pragma unroll
  for (int i = 0; i < N_ARR; ++i) arr[i] = f + i * L * LD;
  float *R = arr[A_R], *W = arr[A_W], *K = arr[A_K], *V = arr[A_V], *A = arr[A_A], *Bv = arr[A_B],
        *BH = arr[A_BH], *KH = arr[A_KH], *NV = arr[A_NV];
  float *Mm = f + F_M, *Nm = f + F_N, *SB = f + F_SB, *SK = f + F_SK;

  const int c = blockIdx.x, bh = blockIdx.y;
  const int bi = bh / H, h = bh % H;
  const int nc = T_len / L;
  const int tid = threadIdx.x;
  float* out = reinterpret_cast<float*>(scratch + ((size_t)bh * nc + c) * chunk_bytes<float>());

  // the chunk's rows of the six streams; w as logw = -exp(w_raw)
  for (int idx = tid; idx < L * NH; idx += P1_THREADS) {
    const int t = idx / NH, j = idx % NH;
    const size_t gi = (((size_t)bi * T_len + (size_t)c * L + t) * H + h) * NH + j;
    const int si = t * LD + j;
    R[si] = r[gi];
    W[si] = -expf(w[gi]);
    K[si] = k[gi];
    V[si] = v[gi];
    A[si] = a[gi];
    Bv[si] = b[gi];
  }
  __syncthreads();
  // inclusive cumulative log decay, one channel a thread; W becomes g
  if (tid < NH) {
    float g = 0.f;
    for (int t = 0; t < L; ++t) {
      g += W[t * LD + tid];
      W[t * LD + tid] = g;
    }
    out[N_SC + tid] = expf(g);
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

  fma_mm(SB, LDM, R, LD, 1, BH, 1, LD, L, L, NH, false);  // r_t b_h^T
  fma_mm(SK, LDM, R, LD, 1, KH, 1, LD, L, L, NH, false);  // r_t k_h^T
  __syncthreads();
  for (int idx = tid; idx < L * L; idx += P1_THREADS) {
    const int t = idx / L, s = idx % L;
    if (s > t) SB[t * LDM + s] = SK[t * LDM + s] = 0.f;
  }
  __syncthreads();
  float* q_eff = out + OFF_Q;
  float* y_loc = out + OFF_Y;
  float* bta = out + OFF_BTA;
  float* h_loc = out + OFF_H;
  for (int idx = tid; idx < L * NH; idx += P1_THREADS) q_eff[idx] = R[(idx / NH) * LD + idx % NH];
  fma_mm(q_eff, NH, SB, LDM, 1, A, LD, 1, L, NH, L, true);
  fma_mm(y_loc, NH, SB, LDM, 1, NV, LD, 1, L, NH, L, false);
  fma_mm(y_loc, NH, SK, LDM, 1, V, LD, 1, L, NH, L, true);
  fma_mm(bta, NH, Bv, 1, LD, A, LD, 1, NH, NH, L, false);
  fma_mm(h_loc, NH, Bv, 1, LD, NV, LD, 1, NH, NH, L, false);
  fma_mm(h_loc, NH, K, 1, LD, V, LD, 1, NH, NH, L, true);
}

// ---------------------------------------------------------------------------
// Phase 1 with bf16 streams. Shared memory (bytes from the base):
//   AT  fp32 [L][LDF]   a_t (the solve's first right-hand sides)
//   BH  fp32 [L][LDF]   b_h; then M and Nm, fp32 [L][LDMM] each
//   KH  fp32 [L][LDF]   k_h; then NV = Nm v (the solve's other right-hand sides)
//   RT  bf16 [L][LDB]   r_t
//   HK  bf16 [L][LDB] x 2   b_h, k_h; then TAT, TUT bf16 [64][LDT]: ta^T, tu^T
//   BBT, KBT, VT  bf16 [64][LDT]  b_bar^T, k_bar^T, v^T
//   SB, SK  bf16 [L][LDT]  sb, sk (lower, diagonal included)
//   X  fp32 [4][64]    each warp's log-decay sums
// Rows of LDB = 72 and LDT = 40 bf16 (36 and 20 words) put a fragment's
// eight rows and four column pairs in 32 distinct banks.
// ---------------------------------------------------------------------------
constexpr int LDF = NH + 4;
constexpr int LDMM = L + 1;
constexpr int LDB = NH + 8;
constexpr int LDT = L + 8;
constexpr int B1_AT = 0;
constexpr int B1_BH = B1_AT + L * LDF * 4;
constexpr int B1_KH = B1_BH + L * LDF * 4;
constexpr int B1_RT = B1_KH + L * LDF * 4;
constexpr int B1_HK = B1_RT + L * LDB * 2;
constexpr int B1_HK_BYTES = 2 * L * LDB * 2 > 2 * NH * LDT * 2 ? 2 * L * LDB * 2 : 2 * NH * LDT * 2;
constexpr int B1_BBT = B1_HK + B1_HK_BYTES;
constexpr int B1_SB = B1_BBT + 3 * NH * LDT * 2;
constexpr int B1_X = B1_SB + 2 * L * LDT * 2;
constexpr size_t P1_SMEM_BF16 = B1_X + 4 * NH * 4;
static_assert(2 * L * LDMM <= L * LDF, "M and Nm fit in b_h's place");
static_assert(4 * 2 * 16 * LDB * 2 <= B1_RT, "the warps' output staging fits in the fp32 region");

// SC16: the scratch in bf16 (1) or fp32 (0)
template <int SC16>
__global__ void __launch_bounds__(P1_THREADS) wkv7_v2_chunk_bf16_kernel(
    int T_len, int H, const bf16* __restrict__ r, const bf16* __restrict__ w,
    const bf16* __restrict__ k, const bf16* __restrict__ v, const bf16* __restrict__ a,
    const bf16* __restrict__ b, unsigned char* __restrict__ scratch) {
  using SC = V2Type<SC16>;
  extern __shared__ __align__(128) unsigned char sm[];
  float* AT = reinterpret_cast<float*>(sm + B1_AT);
  float* BH = reinterpret_cast<float*>(sm + B1_BH);
  float* KH = reinterpret_cast<float*>(sm + B1_KH);
  float* MM = BH;
  float* NM = BH + L * LDMM;
  float* NV = KH;
  bf16* RT = reinterpret_cast<bf16*>(sm + B1_RT);
  bf16* BHb = reinterpret_cast<bf16*>(sm + B1_HK);
  bf16* KHb = BHb + L * LDB;
  bf16* TAT = reinterpret_cast<bf16*>(sm + B1_HK);
  bf16* TUT = TAT + NH * LDT;
  bf16* BBT = reinterpret_cast<bf16*>(sm + B1_BBT);
  bf16* KBT = BBT + NH * LDT;
  bf16* VT = KBT + NH * LDT;
  bf16* SB = reinterpret_cast<bf16*>(sm + B1_SB);
  bf16* SK = SB + L * LDT;
  float* X = reinterpret_cast<float*>(sm + B1_X);

  const int c = blockIdx.x, bh = blockIdx.y;
  const int bi = bh / H, h = bh % H;
  const int nc = T_len / L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, q2 = 2 * (lane & 3);
  unsigned char* outb = scratch + ((size_t)bh * nc + c) * chunk_bytes<SC>();
  SC* out = reinterpret_cast<SC*>(outb);
  float* p_out = reinterpret_cast<float*>(outb + (size_t)N_SC * sizeof(SC));

  // The factors. Warp w owns steps 8w .. 8w + 8 and lane l channels 2l and
  // 2l + 1, so that a warp reads a step's 128 contiguous bytes of a stream
  // at once, and a thread issues all its 48 loads before any arithmetic; the
  // log decays' prefix sums run in registers, the warps' totals pass through
  // shared memory.
  const int j = 2 * lane, t0 = 8 * warp;
  const size_t ts = (size_t)H * NH;  // elements between two steps of a stream
  const size_t g0 = (((size_t)bi * T_len + (size_t)c * L + t0) * H + h) * NH + j;
  uint32_t wraw[8], raw[5][8];  // w; r, k, a, b, v: a bf16 pair of channels a step
#pragma unroll
  for (int i = 0; i < 8; ++i) wraw[i] = pair(w + g0 + i * ts);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t gi = g0 + i * ts;
    raw[0][i] = pair(r + gi), raw[1][i] = pair(k + gi), raw[2][i] = pair(a + gi);
    raw[3][i] = pair(b + gi), raw[4][i] = pair(v + gi);
  }
  float g[8][2];
  {
    float run0 = 0.f, run1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      run0 -= expf(hopper::bf16_lo(wraw[i]));
      run1 -= expf(hopper::bf16_hi(wraw[i]));
      g[i][0] = run0, g[i][1] = run1;
    }
    st2(X + warp * NH + j, run0, run1);
  }
  __syncthreads();
  // base: the sums of the earlier warps' steps; gl: g_L, summed in the order
  // that gives warp 3's g at step 31 bit for bit
  float base[2] = {0.f, 0.f}, gl[2] = {0.f, 0.f};
#pragma unroll
  for (int w4 = 0; w4 < 4; ++w4) {
    const float2 x = ld2(X + w4 * NH + j);
    if (w4 < warp) base[0] += x.x, base[1] += x.y;
    gl[0] += x.x, gl[1] += x.y;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) g[i][0] += base[0], g[i][1] += base[1];
  if (warp == 0) st2(p_out + j, expf(gl[0]), expf(gl[1]));
  float e_prev[2] = {expf(base[0]), expf(base[1])};  // e^{g_prev}: e^g of the step before
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    float bt[2][2], kt[2][2], vt[2][2];  // [channel][step]
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = t0 + i + e;
      float at[2], bh[2], kh[2], rt[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const auto val = [&](int x) {
          return q ? hopper::bf16_hi(raw[x][i + e]) : hopper::bf16_lo(raw[x][i + e]);
        };
        const float gg = g[i + e][q];
        const float e_g = expf(gg), e_ng = expf(-gg), e_tail = expf(gl[q] - gg);
        const float kk = val(1), bb = val(3);
        at[q] = val(2) * e_prev[q];
        bh[q] = bb * e_ng;
        kh[q] = kk * e_ng;
        rt[q] = val(0) * e_g;
        bt[q][e] = bb * e_tail;
        kt[q][e] = kk * e_tail;
        vt[q][e] = val(4);
        e_prev[q] = e_g;
      }
      st2(AT + t * LDF + j, at[0], at[1]);
      st2(BH + t * LDF + j, bh[0], bh[1]);
      st2(KH + t * LDF + j, kh[0], kh[1]);
      st2(RT + t * LDB + j, rt[0], rt[1]);
      st2(BHb + t * LDB + j, bh[0], bh[1]);
      st2(KHb + t * LDB + j, kh[0], kh[1]);
    }
    const int t = t0 + i;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      st2(BBT + (j + q) * LDT + t, bt[q][0], bt[q][1]);
      st2(KBT + (j + q) * LDT + t, kt[q][0], kt[q][1]);
      st2(VT + (j + q) * LDT + t, vt[q][0], vt[q][1]);
    }
  }
  __syncthreads();

  // M and Nm in fp32, strictly lower triangular, and sb, sk on the tensor
  // cores. Thread (tq, sq) of the 64 for M (Nm) sums rows tq + 8i and
  // columns sq + 8i' of it, i' <= i (the tiles above hold no entry below the
  // diagonal), four channels a load: its rows and columns lie in distinct
  // banks. Warp w takes rows 16 (w % 2) .. + 16 of sb (w < 2) or sk, all 32
  // columns (four m16n8 tiles, 64 deep).
  float mt[4][4] = {};
  const int which = tid / 64, tq = (tid % 64) / 8, sq = tid % 8;
  {
    const float* rhs = which ? KH : BH;
#pragma unroll 2
    for (int jj = 0; jj < NH; jj += 4) {
      float4 x[4], y4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = *reinterpret_cast<const float4*>(AT + (tq + 8 * i) * LDF + jj);
        y4[i] = *reinterpret_cast<const float4*>(rhs + (sq + 8 * i) * LDF + jj);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q <= i; ++q) mt[i][q] = hopper::dot4(x[i], y4[q], mt[i][q]);
    }
  }
  {
    float acc[4][4] = {};
    const bf16* op = warp >= 2 ? KHb : BHb;
    const int m0 = (warp & 1) * 16;
#pragma unroll
    for (int ks = 0; ks < NH / 16; ++ks) {
      uint32_t af[4];
      load_a(af, RT, LDB, m0, ks * 16, lane);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t bfr[2];
        load_b(bfr, op, LDB, nt * 8, ks * 16, lane);
        mma_bf16(acc[nt], af, bfr);
      }
    }
    bf16* dst = warp >= 2 ? SK : SB;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int s = nt * 8 + q2, t = m0 + g8;
      st2(dst + t * LDT + s, s <= t ? acc[nt][0] : 0.f, s + 1 <= t ? acc[nt][1] : 0.f);
      st2(dst + (t + 8) * LDT + s, s <= t + 8 ? acc[nt][2] : 0.f, s + 1 <= t + 8 ? acc[nt][3] : 0.f);
    }
  }
  __syncthreads();  // b_h and k_h read: M and Nm take b_h's place
  {
    float* dst = which ? NM : MM;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dst[(tq + 8 * i) * LDMM + sq + 8 * q] = q <= i && sq + 8 * q < tq + 8 * i ? mt[i][q] : 0.f;
  }
  __syncthreads();
  // NV = Nm v in fp32 (v exact from its bf16 copy), in k_h's place: thread
  // (tq, jq) sums rows tq + 8i and columns jq + 16q, two steps a load, over
  // the steps where its last row's Nm is not zero
  {
    const int tq8 = tid / 16, jq = tid % 16;
    float acc[4][4] = {};
    for (int s2 = 0; s2 < tq8 + 24; s2 += 2) {
      float nm[4][2];
      float2 vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        nm[i][0] = NM[(tq8 + 8 * i) * LDMM + s2];
        nm[i][1] = NM[(tq8 + 8 * i) * LDMM + s2 + 1];
        vv[i] = ld2(VT + (jq + 16 * i) * LDT + s2);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(nm[i][1], vv[q].y, fmaf(nm[i][0], vv[q].x, acc[i][q]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) NV[(tq8 + 8 * i) * LDF + jq + 16 * q] = acc[i][q];
  }
  __syncthreads();
  // ta = (I - M)^{-1} a_t and tu = (I - M)^{-1} (Nm v) by forward
  // substitution, a thread a column (the column in registers, so the rows'
  // sums overlap), written as bf16 rows of ta^T / tu^T in b_h / k_h's place
  {
    const float* U = tid < NH ? AT : NV;
    const int jj = tid % NH;
    float u[L];
#pragma unroll
    for (int t = 0; t < L; ++t) u[t] = U[t * LDF + jj];
#pragma unroll
    for (int t = 1; t < L; ++t) {
      float acc = u[t];
#pragma unroll
      for (int s = 0; s < t; ++s) acc = fmaf(MM[t * LDMM + s], u[s], acc);
      u[t] = acc;
    }
    bf16* dst = (tid < NH ? TAT : TUT) + jj * LDT;
#pragma unroll
    for (int t = 0; t < L; t += 2) st2(dst + t, u[t], u[t + 1]);
  }
  __syncthreads();

  // The bounded products into the scratch, every one 32 steps deep. With a
  // bf16 scratch a warp's tiles pass through its own staging rows in the
  // fp32 region (free since the solve), so that it writes whole rows, 16
  // bytes a lane, where the fragments hold 4 bytes of 8 rows.
  constexpr bool STAGED = sizeof(SC) == 2;
  bf16* stg = reinterpret_cast<bf16*>(sm + B1_AT) + warp * 2 * 16 * LDB;  // two 16 x 64 tiles a warp
  const auto put = [&](bf16* tile, int ld, int n0, const float (&cf)[4]) {
    st2(tile + g8 * ld + n0 + q2, cf[0], cf[1]);
    st2(tile + (g8 + 8) * ld + n0 + q2, cf[2], cf[3]);
  };
  // rows m0 .. + 16, columns n0 .. + COLS of the staged tile into dst (row-major [.][64])
  const auto flush = [&](SC* dst, const bf16* tile, int ld, int m0, int n0, int cols) {
    __syncwarp();
    const int segs = cols / 8;
    for (int idx = lane; idx < 16 * segs; idx += 32) {
      const int row = idx / segs, seg = idx % segs;
      *reinterpret_cast<uint4*>(dst + (m0 + row) * NH + n0 + seg * 8) =
          *reinterpret_cast<const uint4*>(tile + row * ld + seg * 8);
    }
    __syncwarp();
  };
  // bta = b_bar^T ta and h_loc = b_bar^T tu + k_bar^T v: warp w takes rows
  // 16w .. + 16 of both, its A fragments loaded once for the eight column
  // tiles.
  {
    const int m0 = warp * 16;
    uint32_t abb[2][4], akb[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      load_a(abb[ks], BBT, LDT, m0, ks * 16, lane);
      load_a(akb[ks], KBT, LDT, m0, ks * 16, lane);
    }
#pragma unroll
    for (int nt = 0; nt < NH / 8; ++nt) {
      float bt[4] = {0.f, 0.f, 0.f, 0.f}, hl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t b1[2], b2[2], b3[2];
        load_b(b1, TAT, LDT, nt * 8, ks * 16, lane);
        load_b(b2, TUT, LDT, nt * 8, ks * 16, lane);
        load_b(b3, VT, LDT, nt * 8, ks * 16, lane);
        mma_bf16(bt, abb[ks], b1);
        mma_bf16(hl, abb[ks], b2);
        mma_bf16(hl, akb[ks], b3);
      }
      if constexpr (STAGED) {
        put(stg, LDB, nt * 8, bt);
        put(stg + 16 * LDB, LDB, nt * 8, hl);
      } else {
        st_tile(out + OFF_BTA, m0, nt * 8, bt, lane);
        st_tile(out + OFF_H, m0, nt * 8, hl, lane);
      }
    }
    if constexpr (STAGED) {
      flush(out + OFF_BTA, stg, LDB, m0, 0, NH);
      flush(out + OFF_H, stg + 16 * LDB, LDB, m0, 0, NH);
    }
  }
  // q_eff = r_t + sb ta and y_loc = sb tu + sk v: warp w takes rows 16 (w %
  // 2) .. + 16 and columns 32 (w / 2) .. + 32 of both.
  {
    const int m0 = (warp & 1) * 16, nb = (warp >> 1) * 32;
    uint32_t asb[2][4], ask[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      load_a(asb[ks], SB, LDT, m0, ks * 16, lane);
      load_a(ask[ks], SK, LDT, m0, ks * 16, lane);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n0 = nb + nt * 8;
      const float2 lo = ld2(RT + (m0 + g8) * LDB + n0 + q2), hi = ld2(RT + (m0 + g8 + 8) * LDB + n0 + q2);
      float qe[4] = {lo.x, lo.y, hi.x, hi.y}, yl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t b1[2], b2[2], b3[2];
        load_b(b1, TAT, LDT, n0, ks * 16, lane);
        load_b(b2, TUT, LDT, n0, ks * 16, lane);
        load_b(b3, VT, LDT, n0, ks * 16, lane);
        mma_bf16(qe, asb[ks], b1);
        mma_bf16(yl, asb[ks], b2);
        mma_bf16(yl, ask[ks], b3);
      }
      if constexpr (STAGED) {
        put(stg, LDT, nt * 8, qe);
        put(stg + 16 * LDT, LDT, nt * 8, yl);
      } else {
        st_tile(out + OFF_Q, m0, n0, qe, lane);
        st_tile(out + OFF_Y, m0, n0, yl, lane);
      }
    }
    if constexpr (STAGED) {
      flush(out + OFF_Q, stg, LDT, m0, nb, 32);
      flush(out + OFF_Y, stg + 16 * LDT, LDT, m0, nb, 32);
    }
  }
}

// ---------------------------------------------------------------------------
// Phase 2: the boundary recurrence of one (b, h) and slice of CW value
// columns of Z, over its chunks. Each chunk's operands (q_eff, bta, the
// slice's columns of y_loc and h_loc, p_last) come into a ring of STAGES
// stages by cp.async, STAGES - 1 chunks ahead. MMA (bf16 streams): both
// products on mma.sync with Z as a bf16 operand (the double buffer ZT, Z^T
// in bf16); warp w keeps rows 16w .. + 16 of the slice of Z in fp32 in its
// accumulators. Otherwise fp32 FMA, Z in the double buffer ZF (fp32).
// ---------------------------------------------------------------------------
template <typename SC, bool MMA, int CW>
struct P2Layout {
  static constexpr int LDQ = NH + 16 / (int)sizeof(SC);  // q_eff, bta rows
  static constexpr size_t Q = 0;
  static constexpr size_t BT = Q + (size_t)L * LDQ * sizeof(SC);
  static constexpr size_t YL = BT + (size_t)NH * LDQ * sizeof(SC);
  static constexpr size_t HL = YL + (size_t)L * CW * sizeof(SC);
  static constexpr size_t P = HL + (size_t)NH * CW * sizeof(SC);
  static constexpr size_t STAGE = P + NH * sizeof(float);
  static constexpr int LDZT = NH + 8;  // bf16 rows of Z^T
  static constexpr int LDZF = CW + 4;  // fp32 rows of Z
  static constexpr size_t Z = MMA ? 2 * (size_t)CW * LDZT * sizeof(bf16) : 2 * (size_t)NH * LDZF * sizeof(float);
  static size_t bytes(int stages) { return stages * STAGE + Z; }
  static_assert(CW % 8 == 0 && NH % CW == 0 && (CW * sizeof(SC)) % 16 == 0, "slice width");
};

// DT: the streams (and y) in bf16 (1: the products on mma.sync) or fp32 (0:
// FMA); SC16: the scratch in bf16 (1) or fp32 (0)
template <int DT, int SC16, int CW, int STAGES>
__global__ void __launch_bounds__(P2_THREADS) wkv7_v2_state_kernel(
    int T_len, int H, const unsigned char* __restrict__ scratch, const float* __restrict__ s0,
    V2Type<DT>* __restrict__ y, float* __restrict__ s_out) {
  using T = V2Type<DT>;
  using SC = V2Type<SC16>;
  constexpr bool MMA = DT == 1;
  using Lay = P2Layout<SC, MMA, CW>;
  constexpr int LDQ = Lay::LDQ;
  constexpr int SLICES = NH / CW;
  extern __shared__ __align__(128) unsigned char sm[];
  const int bh = blockIdx.x / SLICES, v0 = blockIdx.x % SLICES * CW;
  const int bi = bh / H, h = bh % H;
  const int nc = T_len / L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, q2 = 2 * (lane & 3);
  unsigned char* zbase = sm + STAGES * Lay::STAGE;
  const float* S0 = s0 ? s0 + (size_t)bh * NH * NH : nullptr;

  // chunk cc's operands into stage st
  auto issue = [&](int cc, int st) {
    const unsigned char* src = scratch + ((size_t)bh * nc + cc) * chunk_bytes<SC>();
    const SC* sc = reinterpret_cast<const SC*>(src);
    unsigned char* dst = sm + st * Lay::STAGE;
    SC* Qs = reinterpret_cast<SC*>(dst + Lay::Q);
    SC* BTs = reinterpret_cast<SC*>(dst + Lay::BT);
    SC* YLs = reinterpret_cast<SC*>(dst + Lay::YL);
    SC* HLs = reinterpret_cast<SC*>(dst + Lay::HL);
    constexpr int E = 16 / sizeof(SC);  // elements a copy
    constexpr int QP = NH / E;          // copies a row of q_eff or bta
    for (int idx = tid; idx < (L + NH) * QP; idx += P2_THREADS) {
      const int row = idx / QP, e = idx % QP * E;
      if (row < L) hopper::cp_async16(Qs + row * LDQ + e, sc + OFF_Q + row * NH + e, true);
      else hopper::cp_async16(BTs + (row - L) * LDQ + e, sc + OFF_BTA + (row - L) * NH + e, true);
    }
    constexpr int SP = CW / E;  // copies a row of the slice
    for (int idx = tid; idx < (L + NH) * SP; idx += P2_THREADS) {
      const int row = idx / SP, e = idx % SP * E;
      if (row < L) hopper::cp_async16(YLs + row * CW + e, sc + OFF_Y + row * NH + v0 + e, true);
      else hopper::cp_async16(HLs + (row - L) * CW + e, sc + OFF_H + (row - L) * NH + v0 + e, true);
    }
    if (tid < NH / 4)
      hopper::cp_async16(dst + Lay::P + tid * 16, src + (size_t)N_SC * sizeof(SC) + tid * 16, true);
  };

#pragma unroll
  for (int s = 0; s + 1 < STAGES; ++s) {
    if (s < nc) issue(s, s);
    hopper::cp_async_commit();
  }

  if constexpr (MMA) {
    constexpr int NT = CW / 8;  // n8 tiles of the slice
    bf16* ZT = reinterpret_cast<bf16*>(zbase);  // [2][CW][LDZT]
    constexpr int LDZT = Lay::LDZT;
    const int i0 = warp * 16 + g8;  // this thread's rows of Z: i0 and i0 + 8
    float z[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + (e >> 1) * 8, jj = nt * 8 + q2 + (e & 1);
        z[nt][e] = S0 ? S0[(size_t)(v0 + jj) * NH + i] : 0.f;  // Z[i][j] = S0[j][i]
        ZT[jj * LDZT + i] = __float2bfloat16(z[nt][e]);
      }
    int cur = 0;
    for (int c = 0; c < nc; ++c) {
      const int st = c % STAGES;
      if constexpr (STAGES == 1) {
        __syncthreads();  // the stage's last chunk read
        issue(c, 0);
        hopper::cp_async_commit();
        hopper::cp_async_wait<0>();
      } else {
        hopper::cp_async_wait<STAGES - 2>();
      }
      __syncthreads();  // chunk c's operands and ZT[cur] visible; stage (c - 1) % STAGES free
      if constexpr (STAGES > 1) {
        if (c + STAGES - 1 < nc) issue(c + STAGES - 1, (c + STAGES - 1) % STAGES);
        hopper::cp_async_commit();
      }
      const unsigned char* sb = sm + st * Lay::STAGE;
      const SC* Qs = reinterpret_cast<const SC*>(sb + Lay::Q);
      const SC* BTs = reinterpret_cast<const SC*>(sb + Lay::BT);
      const SC* YLs = reinterpret_cast<const SC*>(sb + Lay::YL);
      const SC* HLs = reinterpret_cast<const SC*>(sb + Lay::HL);
      const float* Ps = reinterpret_cast<const float*>(sb + Lay::P);
      const bf16* zt = ZT + cur * CW * LDZT;
      // y_c = q_eff Z + y_loc: m16n8 tiles (rows 16 (tt % 2), columns 8 (tt / 2)) by the warps in turn
      for (int tt = warp; tt < 2 * NT; tt += 4) {
        const int m0 = (tt & 1) * 16, n0 = (tt >> 1) * 8;
        float acc[4];
        const float2 lo = ld2(YLs + (m0 + g8) * CW + n0 + q2), hi = ld2(YLs + (m0 + g8 + 8) * CW + n0 + q2);
        acc[0] = lo.x, acc[1] = lo.y, acc[2] = hi.x, acc[3] = hi.y;
#pragma unroll
        for (int ks = 0; ks < NH / 16; ++ks) {
          uint32_t af[4], bfr[2];
          load_a(af, Qs, LDQ, m0, ks * 16, lane);
          load_b(bfr, zt, LDZT, n0, ks * 16, lane);
          mma_bf16(acc, af, bfr);
        }
        const size_t row = ((size_t)bi * T_len + (size_t)c * L + m0 + g8) * H + h;
        T* yr = y + row * NH + v0 + n0 + q2;
        st2(yr, acc[0], acc[1]);
        st2(yr + (size_t)8 * H * NH, acc[2], acc[3]);
      }
      // Z' = diag(p) Z + h_loc + bta Z on rows 16 warp .. + 16
      {
        uint32_t af[NH / 16][4];
#pragma unroll
        for (int ks = 0; ks < NH / 16; ++ks) load_a(af[ks], BTs, LDQ, warp * 16, ks * 16, lane);
        const float p0 = Ps[i0], p1 = Ps[i0 + 8];
        bf16* zn = ZT + (cur ^ 1) * CW * LDZT;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 hl0 = ld2(HLs + i0 * CW + nt * 8 + q2), hl1 = ld2(HLs + (i0 + 8) * CW + nt * 8 + q2);
          float acc[4] = {fmaf(p0, z[nt][0], hl0.x), fmaf(p0, z[nt][1], hl0.y), fmaf(p1, z[nt][2], hl1.x),
                          fmaf(p1, z[nt][3], hl1.y)};
#pragma unroll
          for (int ks = 0; ks < NH / 16; ++ks) {
            uint32_t bfr[2];
            load_b(bfr, zt, LDZT, nt * 8, ks * 16, lane);
            mma_bf16(acc, af[ks], bfr);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            z[nt][e] = acc[e];
            zn[(nt * 8 + q2 + (e & 1)) * LDZT + i0 + (e >> 1) * 8] = __float2bfloat16(acc[e]);
          }
        }
      }
      cur ^= 1;
    }
    // S = Z^T
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s_out[((size_t)bh * NH + v0 + nt * 8 + q2 + (e & 1)) * NH + i0 + (e >> 1) * 8] = z[nt][e];
  } else {
    // thread (column group cg of 4 columns, row group rg): rows rg + RG e of
    // Z, e < RZ, and rows rg + RG e of y, e < RY
    constexpr int CG = CW / 4, RG = P2_THREADS / CG, RZ = NH / RG;
    constexpr int RY = L / RG > 0 ? L / RG : 1;
    constexpr int LDZF = Lay::LDZF;
    float* ZF = reinterpret_cast<float*>(zbase);  // [2][NH][LDZF]
    const int cg = tid % CG, rg = tid / CG, j0 = cg * 4;
    for (int idx = tid; idx < NH * CW; idx += P2_THREADS) {
      const int i = idx % NH, jj = idx / NH;  // S0[v0 + jj][i], read coalesced
      ZF[i * LDZF + jj] = S0 ? S0[(size_t)(v0 + jj) * NH + i] : 0.f;
    }
    int cur = 0;
    for (int c = 0; c < nc; ++c) {
      const int st = c % STAGES;
      if constexpr (STAGES == 1) {
        __syncthreads();
        issue(c, 0);
        hopper::cp_async_commit();
        hopper::cp_async_wait<0>();
      } else {
        hopper::cp_async_wait<STAGES - 2>();
      }
      __syncthreads();
      if constexpr (STAGES > 1) {
        if (c + STAGES - 1 < nc) issue(c + STAGES - 1, (c + STAGES - 1) % STAGES);
        hopper::cp_async_commit();
      }
      const unsigned char* sb = sm + st * Lay::STAGE;
      const SC* Qs = reinterpret_cast<const SC*>(sb + Lay::Q);
      const SC* BTs = reinterpret_cast<const SC*>(sb + Lay::BT);
      const SC* YLs = reinterpret_cast<const SC*>(sb + Lay::YL);
      const SC* HLs = reinterpret_cast<const SC*>(sb + Lay::HL);
      const float* Ps = reinterpret_cast<const float*>(sb + Lay::P);
      const float* z = ZF + cur * NH * LDZF;
      float* zn = ZF + (cur ^ 1) * NH * LDZF;
      float yacc[RY][4], zacc[RZ][4];
#pragma unroll
      for (int e = 0; e < RY; ++e) {
        const int t = rg + RG * e;
#pragma unroll
        for (int q = 0; q < 4; ++q) yacc[e][q] = t < L ? to_f(YLs[t * CW + j0 + q]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < RZ; ++e) {
        const int i = rg + RG * e;
        const float p = Ps[i];
        const float4 zi = *reinterpret_cast<const float4*>(z + i * LDZF + j0);
        zacc[e][0] = fmaf(p, zi.x, to_f(HLs[i * CW + j0]));
        zacc[e][1] = fmaf(p, zi.y, to_f(HLs[i * CW + j0 + 1]));
        zacc[e][2] = fmaf(p, zi.z, to_f(HLs[i * CW + j0 + 2]));
        zacc[e][3] = fmaf(p, zi.w, to_f(HLs[i * CW + j0 + 3]));
      }
      for (int m = 0; m < NH; ++m) {
        const float4 zm = *reinterpret_cast<const float4*>(z + m * LDZF + j0);
#pragma unroll
        for (int e = 0; e < RY; ++e) {
          const int t = rg + RG * e;
          const float qv = t < L ? to_f(Qs[t * LDQ + m]) : 0.f;
          yacc[e][0] = fmaf(qv, zm.x, yacc[e][0]);
          yacc[e][1] = fmaf(qv, zm.y, yacc[e][1]);
          yacc[e][2] = fmaf(qv, zm.z, yacc[e][2]);
          yacc[e][3] = fmaf(qv, zm.w, yacc[e][3]);
        }
#pragma unroll
        for (int e = 0; e < RZ; ++e) {
          const float bv = to_f(BTs[(rg + RG * e) * LDQ + m]);
          zacc[e][0] = fmaf(bv, zm.x, zacc[e][0]);
          zacc[e][1] = fmaf(bv, zm.y, zacc[e][1]);
          zacc[e][2] = fmaf(bv, zm.z, zacc[e][2]);
          zacc[e][3] = fmaf(bv, zm.w, zacc[e][3]);
        }
      }
#pragma unroll
      for (int e = 0; e < RY; ++e) {
        const int t = rg + RG * e;
        if (t < L) {
          T* yr = y + (((size_t)bi * T_len + (size_t)c * L + t) * H + h) * NH + v0 + j0;
          st2(yr, yacc[e][0], yacc[e][1]);
          st2(yr + 2, yacc[e][2], yacc[e][3]);
        }
      }
#pragma unroll
      for (int e = 0; e < RZ; ++e)
        *reinterpret_cast<float4*>(zn + (rg + RG * e) * LDZF + j0) =
            make_float4(zacc[e][0], zacc[e][1], zacc[e][2], zacc[e][3]);
      cur ^= 1;
    }
    __syncthreads();
    for (int idx = tid; idx < NH * CW; idx += P2_THREADS) {  // S = Z^T, written coalesced
      const int i = idx % NH, jj = idx / NH;
      s_out[((size_t)bh * NH + v0 + jj) * NH + i] = ZF[cur * NH * LDZF + i * LDZF + jj];
    }
  }
}

template <typename T, typename SC, bool MMA, int CW>
int launch_state(int B, int T_len, int H, const unsigned char* sc, const void* s0, void* y, void* s_out,
                 cudaStream_t st) {
  static_assert(MMA == (sizeof(T) == 2), "the products on mma.sync with bf16 streams");
  const auto kernel = wkv7_v2_state_kernel<sizeof(T) == 2, sizeof(SC) == 2, CW, V2_STAGES>;
  const size_t smem = P2Layout<SC, MMA, CW>::bytes(V2_STAGES);
  static hopper_host::SmemOptIn opt_in;
  const int e = opt_in(kernel, smem);
  if (e != 0) return e;
  kernel<<<B * H * (NH / CW), P2_THREADS, smem, st>>>(T_len, H, sc, (const float*)s0, (T*)y, (float*)s_out);
  return (int)cudaGetLastError();
}

template <typename SC, bool MMA>
size_t state_smem(int cols) {
  return cols == 64 ? P2Layout<SC, MMA, 64>::bytes(V2_STAGES)
         : cols == 32 ? P2Layout<SC, MMA, 32>::bytes(V2_STAGES)
         : cols == 16 ? P2Layout<SC, MMA, 16>::bytes(V2_STAGES)
                      : P2Layout<SC, MMA, 8>::bytes(V2_STAGES);
}

// phase: 1, 2 or 3 (both), the launches of one call
template <typename T, typename SC, bool MMA>
int launch_v2(int phase, int B, int T_len, int H, const void* r, const void* w, const void* k,
              const void* v, const void* a, const void* b, const void* s0, void* y, void* s_out,
              void* scratch, cudaStream_t st) {
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  if (phase & 1) {
    if constexpr (sizeof(T) == 2) {
      const auto kernel = wkv7_v2_chunk_bf16_kernel<sizeof(SC) == 2>;
      static hopper_host::SmemOptIn opt_in;
      const int e = opt_in(kernel, P1_SMEM_BF16);
      if (e != 0) return e;
      kernel<<<dim3(T_len / L, B * H), P1_THREADS, P1_SMEM_BF16, st>>>(
          T_len, H, (const T*)r, (const T*)w, (const T*)k, (const T*)v, (const T*)a, (const T*)b, sc);
    } else {
      static hopper_host::SmemOptIn opt_in;
      const int e = opt_in(wkv7_v2_chunk_f32_kernel, P1_SMEM_F32);
      if (e != 0) return e;
      wkv7_v2_chunk_f32_kernel<<<dim3(T_len / L, B * H), P1_THREADS, P1_SMEM_F32, st>>>(
          T_len, H, (const float*)r, (const float*)w, (const float*)k, (const float*)v,
          (const float*)a, (const float*)b, sc);
    }
    const cudaError_t e1 = cudaGetLastError();
    if (e1 != cudaSuccess) return (int)e1;
  }
  if (phase & 2) {
    const int cols = v2_cols(MMA ? 1 : 0, B * H);
    if constexpr (MMA) {
      if (cols == 64) return launch_state<T, SC, MMA, 64>(B, T_len, H, sc, s0, y, s_out, st);
      if (cols == 32) return launch_state<T, SC, MMA, 32>(B, T_len, H, sc, s0, y, s_out, st);
      return launch_state<T, SC, MMA, 16>(B, T_len, H, sc, s0, y, s_out, st);
    } else {
      return launch_state<T, SC, MMA, V2_COLS_F32>(B, T_len, H, sc, s0, y, s_out, st);
    }
  }
  return (int)cudaGetLastError();
}

int launch(int phase, int dtype, int B, int T, int H, int n, const void* r, const void* w,
           const void* k, const void* v, const void* a, const void* b, const void* s0, void* y,
           void* s_out, void* scratch, void* stream) {
  if (n != NH || B <= 0 || H <= 0 || T <= 0 || T % L || phase < 1 || phase > 3)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_v2<float, float, false>(phase, B, T, H, r, w, k, v, a, b, s0, y, s_out, scratch, st);
  if (dtype == 1)
    return launch_v2<bf16, V2Scratch, true>(phase, B, T, H, r, w, k, v, a, b, s0, y, s_out, scratch, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Bytes of phase 1's scratch a chunk with streams of dtype (0 = float32, 1 =
// bfloat16): the wrapper allocates B*H*(T/32) times this.
int wkv7_v2_scratch_bytes(int dtype) {
  return dtype == 0 ? (int)chunk_bytes<float>() : dtype == 1 ? (int)chunk_bytes<V2Scratch>() : -1;
}

// The launch of phase 2 for bh = B*H heads: value columns of Z a block owns,
// chunks of operands in flight, dynamic shared memory bytes (dtype as
// above); out[3].
int wkv7_v2_state_plan(int dtype, int bh, int* out) {
  if ((dtype != 0 && dtype != 1) || bh <= 0) return (int)cudaErrorInvalidValue;
  out[0] = v2_cols(dtype, bh);
  out[1] = V2_STAGES;
  out[2] = dtype == 0 ? (int)state_smem<float, false>(out[0]) : (int)state_smem<V2Scratch, true>(out[0]);
  return 0;
}

// Dynamic shared memory of a phase-1 block, bytes.
int wkv7_v2_chunk_smem_bytes(int dtype) {
  return dtype == 0 ? (int)P1_SMEM_F32 : dtype == 1 ? (int)P1_SMEM_BF16 : -1;
}

// dtype: 0 = float32, 1 = bfloat16 streams [B, T, H, 64]; T a multiple of 32.
// s0: fp32 [B, H, 64, 64] or null; y in the stream dtype; s_out fp32;
// scratch: B*H*(T/32)*wkv7_v2_scratch_bytes(dtype) bytes, 16-byte aligned.
int wkv7_fwd_v2(int dtype, int B, int T, int H, int n, const void* r, const void* w,
                const void* k, const void* v, const void* a, const void* b, const void* s0,
                void* y, void* s_out, void* scratch, void* stream) {
  return launch(3, dtype, B, T, H, n, r, w, k, v, a, b, s0, y, s_out, scratch, stream);
}

// One phase of wkv7_fwd_v2 alone (1: the chunk products into the scratch, 2:
// the boundary recurrence from it), to time the phases apart; no path runs it.
int wkv7_fwd_v2_phase(int phase, int dtype, int B, int T, int H, int n, const void* r,
                      const void* w, const void* k, const void* v, const void* a, const void* b,
                      const void* s0, void* y, void* s_out, void* scratch, void* stream) {
  return launch(phase, dtype, B, T, H, n, r, w, k, v, a, b, s0, y, s_out, scratch, stream);
}

}  // extern "C"
