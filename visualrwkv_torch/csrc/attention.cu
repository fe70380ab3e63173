// Flash-style attention forward for the vision towers (K3), with an optional
// decomposed relative-position bias. Plain C interface, loaded with ctypes by
// visualrwkv_torch/vision/flash.py.
//
// Replaces two TPU kernels:
//   * visualrwkv_tpu/vision/flash.py::_sam_flash_fwd_impl (via
//     sam_flash_attention; kernel _sam_flash_kernel): SAM's global blocks,
//     bias[q, key] = rel_h[q, key / Wk] + rel_w[q, key % Wk], q/k/v [G, N, hd];
//   * visualrwkv_tpu/vision/flash.py::flash_mha (JAX's stock TPU flash
//     kernel): the no-bias MHA of DINOv2 and SigLIP, q/k/v [B, N, h, hd].
// Both layouts are read in place: token row stride heads*hd, and the
// (batch, head) pair of a block comes from its grid row g. Head dims 64
// (SAM-B, DINOv2-L) and 72 (SigLIP-so400m: 1152 / 16) are compiled; a head
// dim that is not a multiple of 16 is zero-padded to one in shared memory.
//
// Bound on the H100: operations. SAM-global at N=4096, G=12, hd=64 is
// 4*G*N^2*hd = 51.5 GFLOP against about 50 MB of inputs and outputs, far
// above the card's 295 FLOP/byte ridge; DINOv2 at N=1029 is 4.3 GFLOP a
// layer. The design keeps the [N, N] logits out of device memory: one block
// of 4 warps per (g, 64-query tile) walks 64-key tiles, with a running max
// and sum per query row in fp32. Products run on the tensor cores through
// WMMA (bf16 16x16x16 fragments, fp32 accumulation); the online softmax and
// the bias run in fp32 on each warp's 16 rows through a shared-memory tile,
// two lanes per row. The bias is read straight from the rel_h / rel_w tables
// (no one-hot products, which were a Mosaic lowering workaround). Keys and
// queries past N (DINOv2's 1029 tokens) are masked / not written. This is the
// simple correct form: no wgmma, TMA or pipelining yet. Under autograd the
// kernel also writes lse = m + log l of every query row (a null pointer
// otherwise, as on the serving path), which the backward K14 / K15
// (attention_bwd.cu) recomputes the probabilities from.

#include "attention_tiles.cuh"

namespace {

using namespace vattn;

template <int HD>
struct Smem {
  using G = Geom<HD>;
  bf16 q[BQ * G::LDB];
  bf16 k[BK * G::LDB];
  bf16 v[BK * G::LDB];
  bf16 p[WARPS][16 * LDP];
  float x[WARPS][16 * G::LDX];  // a warp's S tile, then its PV tile
};

template <int HD>
__global__ void __launch_bounds__(THREADS) attention_fwd_kernel(
    int N, int heads, float scale, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ rel_h,
    const float* __restrict__ rel_w, int Hk, int Wk, bf16* __restrict__ o,
    float* __restrict__ lse) {
  using G = Geom<HD>;
  constexpr int HDP = G::HDP, LDB = G::LDB, LDX = G::LDX, COLS = G::COLS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  const int g = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row_stride = (size_t)heads * HD;
  const size_t base = group_base(g, heads, N, HD);

  load_tile<HD>(sm.q, q + base, q0, N, row_stride, tid);

  // lane owns row rloc of its warp's 16 rows: key columns [khalf, khalf + 32)
  // of each S tile and output columns [ohalf, ohalf + COLS)
  const int rloc = lane >> 1;
  const int khalf = (lane & 1) * 32;
  const int ohalf = (lane & 1) * COLS;
  const int qrow = q0 + warp * 16 + rloc;
  const bool qvalid = qrow < N;
  const bool has_bias = rel_h != nullptr;
  const float* rh = has_bias ? rel_h + ((size_t)g * N + (qvalid ? qrow : 0)) * Hk : nullptr;
  const float* rw = has_bias ? rel_w + ((size_t)g * N + (qvalid ? qrow : 0)) * Wk : nullptr;

  float m = -INFINITY, l = 0.f;
  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;

  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[HDP / 16];
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], sm.q + (warp * 16) * LDB + kk * 16, LDB);

  float* xw = sm.x[warp];
  bf16* pw = sm.p[warp];

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

    // online softmax over this tile, fp32
    float sv[32];
    float tmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int key = k0 + khalf + c;
      float x = xw[rloc * LDX + khalf + c] * scale;
      if (key < N) {
        if (has_bias) x += __ldg(rh + key / Wk) + __ldg(rw + key % Wk);
      } else {
        x = -INFINITY;
      }
      sv[c] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);  // finite: key k0 < N is always valid
    const float alpha = __expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float pc = __expf(sv[c] - m_new);
      psum += pc;
      pw[rloc * LDP + khalf + c] = __float2bfloat16(pc);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();

    // PV for this tile into the warp's tile, then fold into the running output
#pragma unroll
    for (int nt = 0; nt < HDP / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, pw + kk * 16, LDP);
        wmma::load_matrix_sync(vf, sm.v + (kk * 16) * LDB + nt * 16, LDB);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(xw + nt * 16, of, LDX, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] = fmaf(acc[c], alpha, xw[rloc * LDX + ohalf + c]);
    __syncwarp();  // the next tile's S overwrites this buffer
  }

  if (qvalid) {
    const float inv = 1.f / l;
    bf16* out = o + base + (size_t)qrow * row_stride;
#pragma unroll
    for (int c = 0; c < COLS; c += 2)
      if (ohalf + c < HD)
        *reinterpret_cast<__nv_bfloat162*>(out + ohalf + c) =
            __floats2bfloat162_rn(acc[c] * inv, acc[c + 1] * inv);
    // the log-sum-exp of the row's logits, for the backward (K14 / K15)
    if (lse != nullptr && (lane & 1) == 0) lse[(size_t)g * N + qrow] = m + logf(l);
  }
}

template <int HD>
int launch(int G, int N, int heads, float scale, const void* q, const void* k, const void* v,
           const void* rel_h, const void* rel_w, int Hk, int Wk, void* o, void* lse,
           cudaStream_t st) {
  // The shared-memory opt-in is per device, so it is set on every launch
  // (a host-side attribute write, cheap next to the launch).
  const cudaError_t e = cudaFuncSetAttribute(
      attention_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem<HD>));
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BQ - 1) / BQ, G), block(THREADS);
  attention_fwd_kernel<HD><<<grid, block, sizeof(Smem<HD>), st>>>(
      N, heads, scale, (const bf16*)q, (const bf16*)k, (const bf16*)v,
      (const float*)rel_h, (const float*)rel_w, Hk, Wk, (bf16*)o, (float*)lse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q, k, v, o: bf16, token row stride heads*hd, (batch, head) = (g / heads,
// g % heads); hd is 64 or 72. rel_h [G, N, Hk] and rel_w [G, N, Wk] fp32,
// or both null. lse [G, N] fp32 (m + log l of every query row), or null.
int attention_fwd(int G, int N, int heads, int hd, float scale, const void* q,
                  const void* k, const void* v, const void* rel_h, const void* rel_w,
                  int Hk, int Wk, void* o, void* lse, void* stream) {
  if (G <= 0 || N <= 0 || heads <= 0 || G % heads) return (int)cudaErrorInvalidValue;
  if ((rel_h == nullptr) != (rel_w == nullptr)) return (int)cudaErrorInvalidValue;
  if (rel_h != nullptr && (Hk <= 0 || Wk <= 0 || Hk * Wk != N)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (hd == 64) return launch<64>(G, N, heads, scale, q, k, v, rel_h, rel_w, Hk, Wk, o, lse, st);
  if (hd == 72) return launch<72>(G, N, heads, scale, q, k, v, rel_h, rel_w, Hk, Wk, o, lse, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
