// Flash-style attention forward for the vision towers (K3), with an optional
// decomposed relative-position bias. Plain C interface, loaded with ctypes by
// visualrwkv_torch/vision/flash.py.
//
// Replaces two TPU kernels:
//   * visualrwkv_tpu/vision/flash.py::_sam_flash_fwd_impl (via
//     sam_flash_attention; kernel _sam_flash_kernel): SAM's global blocks,
//     bias[q, key] = rel_h[q, key / Wk] + rel_w[q, key % Wk], q/k/v [G, N, hd];
//   * visualrwkv_tpu/vision/flash.py::flash_mha (JAX's stock TPU flash
//     kernel): the no-bias MHA of DINOv2, SigLIP and CLIP, q/k/v [B, N, h, hd].
// Both layouts are read in place by 4-D tensor maps over [B, N, h, hd]
// (SAM's [G, N, hd] is h = 1). Head dims 64 (SAM-B, DINOv2-L, CLIP-L) and 72
// (SigLIP-so400m: 1152 / 16); 72 is padded to 80 by TMA's zero fill and
// columns past 72 are never written. Keys past N (DINOv2's 1029 tokens) are
// masked in the last tile (a zero-filled key would give logit 0, not -inf)
// and query rows past N are not written. Under autograd the kernel also
// writes lse = m + log l, the natural log-sum-exp of each query row's
// logits (a null pointer otherwise, as on the serving path), from which the
// backward K14 / K15 (attention_bwd.cu) recompute the probabilities; so S is
// the unscaled bf16 q times k, times `scale` in fp32, p is rounded to bf16
// before P V, and l sums the unrounded fp32 p.
//
// Bound on the H100: operations. SAM-global at N=4096, G=12, hd=64 is
// 4*G*N^2*hd = 51.5 GFLOP against about 50 MB of inputs and outputs, far
// above the card's 295 FLOP/byte ridge (0.052 ms at the tensor peak), and
// the N^2 exponentials (16 a clock per multiprocessor: ~0.05 ms) are of the
// same order; DINOv2 at N=1029 is 4.3 GFLOP a layer.
//
// Design (Hopper), K14's structure with an online softmax. A block is
// consumer warpgroups of 64 query rows each and a producer: two consumers
// and a producer warpgroup (384 threads; setmaxnreg gives the consumers 232
// registers and the producer 40; one block a multiprocessor), or, for head
// dim 64 without a bias, one consumer and a producer warp (160 threads,
// three blocks a multiprocessor: DINOv2's 1029 rows in 128-row blocks are
// 144 blocks on 132 multiprocessors, a second wave of 12; 64-row blocks
// are faster there and at CLIP's 577, slower at SigLIP's hd 72, which
// keeps 128: chip_variants.py, PERF.md). One producer thread brings Q in
// once by TMA and streams the K and V tiles through a ring of 3 stages,
// each guarded by a full and an empty mbarrier. S = Q K^T runs on wgmma (both operands
// K-major in shared memory, fp32 accumulators in registers); the online
// softmax runs in registers in base 2 (scale * log2 e folded into one
// multiply-add, the row max over the 4 threads of a quad); p is rounded to
// bf16 pairs in place and is the register A operand of O += P V (V read
// MN-major); O stays in registers and is rescaled by each tile's alpha. No
// fp32 tile goes through shared memory. A tile's S is issued with the last
// tile's P V, so that its softmax overlaps that product, and two consumer
// warpgroups take turns to issue (named barriers).
// With a bias and a grid at most 64 wide (SAM-B at 1024 / 768 / 512 pixels:
// 64 / 48 / 32), a key tile is one grid row of Wk keys, padded to a multiple
// of 16 and masked ("rows"): a thread owns the same grid columns in every
// tile, so its rel_w (times log2 e) stays in registers for the whole key
// loop and rel_h is one value a row a tile, staged in shared memory. Wider
// grids, tall ones (Hk > 256: rel_h would not fit in shared memory) and hd
// 72 with a bias take 64-key tiles with the bias read from the tables
// ("general": correct and slow; no tower takes it).
//
// This replaces a WMMA form (16x16x16 fragments re-read from shared memory,
// fp32 S and P V tiles through shared memory, synchronous loads between two
// __syncthreads a tile, the softmax on two lanes a row) that took 1.9247 ms
// at SAM's global shape and 0.0991 / 0.1076 / 0.0530 ms at DINOv2-L / SigLIP /
// CLIP-L (B=1, 16 heads) on an H100 80GB HBM3 at 700 W (PERF.md rows 3, 4).

#include "hopper_tiles.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int STAGES = 3;            // K / V tiles in flight
constexpr int ROWS_MAX_HK = 256;     // "rows" stages rel_h [ROWS][Hk + 1] fp32: grids at most this tall
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Two consumer warpgroups take turns to issue their products (named
// barriers 3 and 4, over both): warpgroup 1 first waits for warpgroup 0's
// first issue, each issue hands the turn over, and warpgroup 0 takes one
// turn more after its last issue, so that every arrival is matched.
__device__ __forceinline__ void turn_wait(int wg) { named_sync(3 + wg, 256); }
__device__ __forceinline__ void turn_pass(int wg) { named_arrive(4 - wg, 256); }

// A block: NC consumer warpgroups of 64 query rows each, then the producer:
// a warpgroup where there are two consumers (setmaxnreg moves its registers
// to them; one block a multiprocessor), one warp where there is one (three
// blocks a multiprocessor).
template <int NC>
struct Block {
  static constexpr int ROWS = 64 * NC;
  static constexpr int THREADS = NC * 128 + (NC == 1 ? 32 : 128);
  static constexpr int MIN_BLOCKS = NC == 1 ? 3 : 1;
};

// Consumer warpgroups a block without a bias: one at hd 64, two at hd 72
// (with a bias, always two).
constexpr int mha_nc(int hd) { return hd == 64 ? 1 : 2; }

struct Plan {
  int mode, key_tile, nc;
};

Plan make_plan(int hd, bool bias, int Hk, int Wk) {
  if (!bias) return {NOBIAS, 64, mha_nc(hd)};
  if (hd == 64 && Wk <= 64 && Hk <= ROWS_MAX_HK) return {GRID_ROWS, grid_rows_tile(Wk), 2};
  return {GENERAL, 64, 2};
}

template <int HD, int BKN, int NC>
struct Layout {
  using C = Cols<HD>;
  static constexpr int ROWS = Block<NC>::ROWS;
  static constexpr int Q = 0;
  static constexpr int K = Q + C::tile_bytes(ROWS);
  static constexpr int V = K + STAGES * C::tile_bytes(BKN);
  static constexpr int QT = V + STAGES * C::tile_bytes(BKN);
  static constexpr int KT = QT + C::tail_bytes(ROWS);
  static constexpr int VT = KT + STAGES * C::tail_bytes(BKN);
  static constexpr int BARS = (VT + STAGES * C::tail_bytes(BKN) + 15) / 16 * 16;
  // then, GRID_ROWS only: rel_h times log2 e of the block's rows, fp32 [ROWS][Hk + 1]
  static constexpr int TABLES = (BARS + (2 * STAGES + 1) * 8 + 15) / 16 * 16;
  static constexpr int STAGE_TX = 2 * (C::tile_bytes(BKN) + C::tail_bytes(BKN));
  static constexpr int Q_TX = C::tile_bytes(ROWS) + C::tail_bytes(ROWS);
};

struct Maps {
  CUtensorMap q[2], k[2], v[2];  // [0] columns 0..63, [1] 64..79 (hd 72)
};

template <int HD, int BKN, int MODE, int NC>
__global__ void __launch_bounds__(Block<NC>::THREADS, Block<NC>::MIN_BLOCKS) attention_fwd_kernel(
    __grid_constant__ const Maps maps, int N, int heads, float scale,
    const float* __restrict__ rel_h, const float* __restrict__ rel_w, int Hk, int Wk,
    bf16* __restrict__ o, float* __restrict__ lse) {
  using L = Layout<HD, BKN, NC>;
  using C = Cols<HD>;
  constexpr int ROWS = Block<NC>::ROWS;
  constexpr int NJ = BKN / 8;  // 8-column groups of a key tile
  extern __shared__ __align__(1024) unsigned char sm_raw[];
  unsigned char* sm = align_1024(sm_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  const int g = blockIdx.y, b = g / heads, head = g % heads;
  const int qb0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int ntiles = MODE == GRID_ROWS ? Hk : (N + BKN - 1) / BKN;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 128);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NC * 128) {  // producer: one thread issues every load
    if (NC == 2) setmaxnreg_dec<40>();
    if (tid == NC * 128) {
      mbar_arrive_expect_tx(qbar, L::Q_TX);
      load_rows<HD>(maps.q, sm + L::Q, sm + L::QT, qbar, head, qb0, b);
      Ring<STAGES> ring;
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

  if (NC == 2) setmaxnreg_inc<232>();
  const int wg = tid >> 7, t = tid & 127;
  const int r = 16 * (t >> 5) + ((t & 31) >> 2), c = t & 3;
  const int q0 = qb0 + wg * 64;  // this warpgroup's first query row
  float* tab = reinterpret_cast<float*>(sm + L::TABLES) + (size_t)wg * 64 * (Hk + 1);

  if (MODE == GRID_ROWS) {  // rel_h of the warpgroup's rows times log2 e, [64][Hk + 1]
    for (int i = t; i < 64 * Hk; i += 128) {
      const int row = i / Hk, col = i - row * Hk;
      tab[row * (Hk + 1) + col] =
          q0 + row < N ? __ldg(rel_h + ((size_t)g * N + q0 + row) * Hk + col) * LOG2E : 0.f;
    }
    named_sync(1 + wg, 128);
  }

  // the thread's rows r and r + 8 of the warpgroup's 64
  int qr[2];
  bool qv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qr[h] = q0 + r + 8 * h;
    qv[h] = qr[h] < N;
  }
  const float sl2 = scale * LOG2E;
  // GRID_ROWS: rel_w times log2 e of the thread's columns, -inf for the
  // padding past Wk (so p = 0 there); GENERAL: the tables' rows (row 0 past N)
  float rw2[MODE == GRID_ROWS ? 2 : 1][MODE == GRID_ROWS ? 2 * NJ : 1];
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
          rw2[h][2 * j + e] = col < Wk ? (qv[h] ? __ldg(rw_row[h] + col) * LOG2E : 0.f) : -INFINITY;
        }
  }

  // running max (base 2) and the thread's share of the row sums
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float oa[32], ot[8];
#pragma unroll
  for (int i = 0; i < 32; ++i) oa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) ot[i] = 0.f;

  mbar_wait(qbar, 0);
  const unsigned char* qm = sm + L::Q;
  const unsigned char* qtl = sm + L::QT;
  const int r0 = wg * 64;

  // S = Q K^T of the key tile in stage s into sa
  auto issue_s = [&](int s, float (&sa)[BKN / 2]) {
    const unsigned char* km = sm + L::K + s * C::tile_bytes(BKN);
    const unsigned char* ktl = sm + L::KT + s * C::tail_bytes(BKN);
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk)
      wgmma_ss<BKN>(sa, desc_k<HD>(qm, qtl, r0, kk), desc_k<HD>(km, ktl, 0, kk), kk);
    wgmma_commit();
  };
  // O += P V of the key tile in stage s
  auto issue_pv = [&](int s, const uint32_t (&pa)[BKN / 16][4]) {
    const unsigned char* vm = sm + L::V + s * C::tile_bytes(BKN);
    const unsigned char* vtl = sm + L::VT + s * C::tail_bytes(BKN);
#pragma unroll
    for (int kb = 0; kb < BKN / 16; ++kb) {
      wgmma_rs_n64(oa, pa[kb], desc_mn(vm, kb));
      if (C::TAIL) wgmma_rs_n16(ot, pa[kb], desc_mn_tail(vtl, kb));
    }
    wgmma_commit();
  };
  // The online softmax of key tile kt's S: logits in base 2 with the bias,
  // keys past N (or past Wk) at -inf; the new running max, alpha = 2^(m_old
  // - m_new), p = 2^(x - m_new) rounded to bf16 pairs as the A operand of
  // P V, and the sums of the unrounded p (ls)
  auto softmax = [&](int kt, float (&sa)[BKN / 2], uint32_t (&pa)[BKN / 16][4], float (&alpha)[2],
                     float (&ls)[2]) {
    const int key0 = MODE == GRID_ROWS ? kt * Wk : kt * BKN;
    float rh2[2] = {0.f, 0.f};
    if (MODE == GRID_ROWS)
#pragma unroll
      for (int h = 0; h < 2; ++h) rh2[h] = tab[(r + 8 * h) * (Hk + 1) + kt];
    const bool ragged = MODE != GRID_ROWS && key0 + BKN > N;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * c + e, idx = 4 * j + 2 * h + e;
          float x;
          if (MODE == GRID_ROWS) {
            x = fmaf(sa[idx], sl2, rh2[h] + rw2[h][2 * j + e]);
          } else {
            const int key = key0 + col;
            float bias2 = 0.f;
            if (MODE == GENERAL && key < N) {
              const int kh = key / Wk;
              bias2 = (__ldg(rh_row[h] + kh) + __ldg(rw_row[h] + key - kh * Wk)) * LOG2E;
            }
            x = ragged && key >= N ? -INFINITY : fmaf(sa[idx], sl2, bias2);
          }
          sa[idx] = x;
          tmax[h] = fmaxf(tmax[h], x);
        }
    // every tile has a valid key, so the new max is finite and alpha = 0 on
    // the first tile (2^-inf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float mn = fmaxf(m2[h], tmax[h]);
      alpha[h] = ex2(m2[h] - mn);
      m2[h] = mn;
      ls[h] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = 4 * j + 2 * h;
        const float p0 = ex2(sa[idx] - m2[h]), p1 = ex2(sa[idx + 1] - m2[h]);
        ls[h] += p0 + p1;
        pa[j >> 1][(j & 1) * 2 + h] = pack_bf16(p0, p1);
      }
  };
  // l and O scaled by alpha, this tile's sums added to l
  auto rescale = [&](const float (&alpha)[2], const float (&ls)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + ls[h];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        oa[4 * j + 2 * h] *= alpha[h];
        oa[4 * j + 2 * h + 1] *= alpha[h];
      }
    if (C::TAIL)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ot[4 * j + 2 * h] *= alpha[h];
          ot[4 * j + 2 * h + 1] *= alpha[h];
        }
  };

  // Tile kt's S is issued together with tile kt - 1's P V, and its softmax
  // runs while that product does; the first S and the last P V are peeled,
  // so that the steady loop issues both unconditionally (with the issue
  // under a branch, ptxas serialised the wgmma: warnings C7514 and C7520).
  // The turns hand the tensor cores from one warpgroup's issue to the
  // other's.
  Ring<STAGES> ring;
  float sa[BKN / 2], alpha[2], ls[2];
  uint32_t pa[BKN / 16][4], pn[BKN / 16][4];
  int sp = ring.stage;
  mbar_wait(&full[sp], ring.phase);
  if (NC == 2 && wg == 1) turn_wait(wg);
  wgmma_fence();
  issue_s(sp, sa);
  if (NC == 2) turn_pass(wg);
  wgmma_wait<0>();
  fence_regs(sa);
  softmax(0, sa, pa, alpha, ls);
  rescale(alpha, ls);
  ring.advance();
  for (int kt = 1; kt < ntiles; ++kt) {
    const int s = ring.stage;
    mbar_wait(&full[s], ring.phase);
    if (NC == 2) turn_wait(wg);
    wgmma_fence();
    issue_s(s, sa);
    issue_pv(sp, pa);
    if (NC == 2) turn_pass(wg);
    wgmma_wait<1>();
    fence_regs(sa);
    softmax(kt, sa, pn, alpha, ls);
    wgmma_wait<0>();
    fence_regs(oa);
    fence_regs(ot);
    fence_regs(pa);
    mbar_arrive(&empty[sp]);
    rescale(alpha, ls);
#pragma unroll
    for (int kb = 0; kb < BKN / 16; ++kb)
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kb][i] = pn[kb][i];
    sp = s;
    ring.advance();
  }
  if (NC == 2) turn_wait(wg);
  wgmma_fence();
  issue_pv(sp, pa);
  if (NC == 2) turn_pass(wg);
  wgmma_wait<0>();
  fence_regs(oa);
  fence_regs(ot);
  fence_regs(pa);
  mbar_arrive(&empty[sp]);
  // warpgroup 0's last turn, matching warpgroup 1's last hand-over
  if (NC == 2 && wg == 0) turn_wait(0);

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / l[h];
  }
  const size_t row_stride = (size_t)heads * HD;
  const size_t base = ((size_t)b * N * heads + head) * HD;
  store_acc<HD>(o + base, row_stride, N, q0, oa, ot, inv[0], inv[1]);
  // the natural log-sum-exp of the row's logits, for the backward (K14 / K15)
  if (lse != nullptr && c == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (qv[h]) lse[(size_t)g * N + qr[h]] = m2[h] * LN2 + logf(l[h]);
}

// Dynamic shared memory of a launch (the layout's arithmetic at run time,
// held equal to it by the launcher's static_assert).
constexpr int tables_offset(int hd, int bkn, int nc) {
  return ((64 * nc * (hd > 64 ? 160 : 128) + 2 * STAGES * bkn * (hd > 64 ? 160 : 128) + 15) / 16 * 16 +
          (2 * STAGES + 1) * 8 + 15) / 16 * 16;
}
size_t fwd_smem(int hd, int bkn, int mode, int Hk, int nc) {
  return SMEM_ALIGN + tables_offset(hd, bkn, nc) +
         (mode == GRID_ROWS ? (size_t)64 * nc * (Hk + 1) * 4 : 0);
}

template <int HD, int BKN, int MODE, int NC>
int launch(const Maps& maps, int G, int N, int heads, float scale, const void* rel_h,
           const void* rel_w, int Hk, int Wk, void* o, void* lse, cudaStream_t st) {
  static_assert(Layout<HD, BKN, NC>::TABLES == tables_offset(HD, BKN, NC), "K3 layout");
  const size_t smem = fwd_smem(HD, BKN, MODE, Hk, NC);
  auto kernel = attention_fwd_kernel<HD, BKN, MODE, NC>;
  static hopper_host::SmemOptIn opt_in;
  const int e = opt_in(kernel, smem);
  if (e) return e;
  constexpr int rows = Block<NC>::ROWS, threads = Block<NC>::THREADS;
  const dim3 grid((N + rows - 1) / rows, G);
  kernel<<<grid, threads, smem, st>>>(maps, N, heads, scale, (const float*)rel_h,
                                      (const float*)rel_w, Hk, Wk, (bf16*)o, (float*)lse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The plan of a call (flash.py::fwd_plan mirrors it): plan[0] the path (0
// no bias, 1 one grid row a key tile, 2 general), plan[1] the key tile,
// plan[2] the query rows a block, plan[3] the dynamic shared memory in bytes.
int attention_fwd_plan(int hd, int has_bias, int Hk, int Wk, int* plan) {
  const Plan p = make_plan(hd, has_bias != 0, Hk, Wk);
  plan[0] = p.mode, plan[1] = p.key_tile, plan[2] = 64 * p.nc;
  plan[3] = (int)fwd_smem(hd, p.key_tile, p.mode, Hk, p.nc);
  return 0;
}

// q, k, v, o: bf16, token row stride heads*hd, (batch, head) = (g / heads,
// g % heads); hd is 64 or 72. rel_h [G, N, Hk] and rel_w [G, N, Wk] fp32,
// or both null. lse [G, N] fp32 (m + log l of every query row), or null.
int attention_fwd(int G, int N, int heads, int hd, float scale, const void* q,
                  const void* k, const void* v, const void* rel_h, const void* rel_w,
                  int Hk, int Wk, void* o, void* lse, void* stream) {
  const int bad = hopper_host::check_geometry(G, N, heads, hd, rel_h, rel_w, Hk, Wk);
  if (bad) return bad;
  const cudaStream_t st = (cudaStream_t)stream;
  const Plan p = make_plan(hd, rel_h != nullptr, Hk, Wk);
  const int B = G / heads;
  Maps maps;
  int e = hopper_host::make_head_maps(maps.q, q, B, N, heads, hd, 64 * p.nc);
  if (!e) e = hopper_host::make_head_maps(maps.k, k, B, N, heads, hd, p.key_tile);
  if (!e) e = hopper_host::make_head_maps(maps.v, v, B, N, heads, hd, p.key_tile);
  if (e) return e;
#define VRWKV_FWD(HD, BKN, MODE, NC) \
  return launch<HD, BKN, MODE, NC>(maps, G, N, heads, scale, rel_h, rel_w, Hk, Wk, o, lse, st)
  if (hd == 64) {
    if (p.mode == NOBIAS) VRWKV_FWD(64, 64, NOBIAS, mha_nc(64));
    if (p.mode == GENERAL) VRWKV_FWD(64, 64, GENERAL, 2);
    switch (p.key_tile) {
      case 16: VRWKV_FWD(64, 16, GRID_ROWS, 2);
      case 32: VRWKV_FWD(64, 32, GRID_ROWS, 2);
      case 48: VRWKV_FWD(64, 48, GRID_ROWS, 2);
      default: VRWKV_FWD(64, 64, GRID_ROWS, 2);
    }
  }
  // hd 72: SigLIP's head dim, whose attention has no bias
  if (p.mode == NOBIAS) VRWKV_FWD(72, 64, NOBIAS, mha_nc(72));
  VRWKV_FWD(72, 64, GENERAL, 2);
#undef VRWKV_FWD
}

}  // extern "C"
