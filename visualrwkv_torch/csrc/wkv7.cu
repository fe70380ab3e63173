// RWKV-7 ("x070") WKV recurrence on Hopper: the prefill forward (K1), the
// one-token decode step on the head layout (K2) and on the flat layout (K4),
// and the training forward that also saves the chunk states (K5). Plain C
// interface, loaded with ctypes by visualrwkv_torch/ops/wkv7_cuda.py. The
// backward (K6) is in wkv7_train.cu. K1 and K5 are the chunked kernel of
// wkv7_chunk.cuh, K6 the two-pass chunked VJP of wkv7_chunk_bwd.cuh.
//
// K1 wkv7_fwd replaces visualrwkv_tpu/ops/wkv7_pallas.py::wkv7_pallas (the
// chunked forward, kernel _wkv7_kernel): y and the final state, at any T
// >= 0. It is wkv7_fwd_res_kernel<DT, ROWS, 1, 0> of wkv7_chunk.cuh, K5's
// chunk form with a block per slice of value rows of a head, without the
// saved states and with the steps past T of the last chunk masked to
// identity steps; the design and its bound are described there.
//
// K2 wkv7_step replaces visualrwkv_tpu/ops/wkv7_pallas.py::wkv7_step_pallas
// (_wkv7_step_kernel). Bound: state bytes, B*H*64*64 read once and written
// once (fp32 or bf16 state; math fp32). One block of 8 warps per (b, h);
// a warp walks rows, each lane owns two adjacent columns, so every row is
// read and written as one coalesced 128- or 256-byte transaction, and the two
// row sums are warp shuffles.
//
// K4 wkv7_step_flat replaces wkv7_step_flat_pallas (_wkv7_step_flat_kernel):
// the same step on the flat state [B, Nv, H*Nk]. The Pallas kernel turns the
// per-head sums into matrix-unit dots against one-hot masks, because a TPU
// lane dimension of 64 pads to 128; here a state row of one head is 64
// contiguous elements in both layouts and only the stride between rows
// differs (H*64 instead of 64), so K4 is K2's body with that stride. Bound:
// state bytes, as K2.
//
// K5 wkv7_fwd_res replaces wkv7_pallas_fwd_res: the forward that also
// writes the state entering every 16-step chunk, zin[bh, c] = transpose of S
// before step 16c (fp32; Z = S^T, as the Pallas kernel saves it and K6 reads
// it coalesced). It is wkv7_fwd_res_kernel<DT, ROWS, 1, 1> of wkv7_chunk.cuh,
// the Pallas kernel's chunk form with a block per slice of value rows of a
// head; the design and its bound are described there.

#include "wkv7_chunk.cuh"

namespace {

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
// K2 / K4: one decode step. Vectors [B, H, N] fp32; state in TS, laid out
// [B, H, Nv, Nk] (K2) or, with FLAT, [B, Nv, H*Nk] (K4).
// ---------------------------------------------------------------------------
constexpr int STEP_WARPS = 8;

template <typename TS, bool FLAT>
__global__ void __launch_bounds__(STEP_WARPS * 32) wkv7_step_kernel(
    int H, const TS* __restrict__ s_in, const float* __restrict__ r, const float* __restrict__ w,
    const float* __restrict__ k, const float* __restrict__ v, const float* __restrict__ a,
    const float* __restrict__ b, TS* __restrict__ s_out, float* __restrict__ y) {
  const int bh = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = 2 * lane;
  const size_t vo = (size_t)bh * N;
  // row i of this head's state starts at base + i * row_stride
  const size_t base = FLAT ? ((size_t)(bh / H) * N * H + bh % H) * N : vo * N;
  const size_t row_stride = FLAT ? (size_t)H * N : N;
  float r0, r1, w0, w1, k0, k1, a0, a1, b0, b1;
  load2(r + vo + j0, r0, r1);
  load2(w + vo + j0, w0, w1);
  load2(k + vo + j0, k0, k1);
  load2(a + vo + j0, a0, a1);
  load2(b + vo + j0, b0, b1);
  w0 = expf(-expf(w0));
  w1 = expf(-expf(w1));

  constexpr int ROWS = N / STEP_WARPS;
#pragma unroll
  for (int ii = 0; ii < ROWS; ++ii) {
    const int i = warp * ROWS + ii;
    const size_t so = base + i * row_stride + j0;
    float s0, s1;
    load2(s_in + so, s0, s1);
    const float sai = warp_sum(s0 * a0 + s1 * a1);
    const float vi = v[vo + i];
    s0 = fmaf(s0, w0, fmaf(sai, b0, vi * k0));
    s1 = fmaf(s1, w1, fmaf(sai, b1, vi * k1));
    store2(s_out + so, s0, s1);
    const float yi = warp_sum(s0 * r0 + s1 * r1);
    if (lane == 0) y[vo + i] = yi;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

namespace {

template <bool FLAT>
int launch_step(int state_dtype, int B, int H, int n, const void* s_in, const float* r,
                const float* w, const float* k, const float* v, const float* a,
                const float* b, void* s_out, float* y, void* stream) {
  if (n != N || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B * H), block(STEP_WARPS * 32);
  if (state_dtype == 0) {
    wkv7_step_kernel<float, FLAT><<<grid, block, 0, st>>>(H, (const float*)s_in, r, w, k, v,
                                                          a, b, (float*)s_out, y);
  } else if (state_dtype == 1) {
    using bf = __nv_bfloat16;
    wkv7_step_kernel<bf, FLAT><<<grid, block, 0, st>>>(H, (const bf*)s_in, r, w, k, v, a, b,
                                                       (bf*)s_out, y);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: streams [B, T, H, 64], any T >= 0; s0 (may be null) and s_out fp32
// [B, H, 64, 64]; rows = the value rows a block owns (16, 32 or 64).
int wkv7_fwd(int dtype, int rows, int B, int T, int H, int n, const void* r, const void* w,
             const void* k, const void* v, const void* a, const void* b,
             const void* s0, void* y, void* s_out, void* stream) {
  return launch_fwd_res<1, 0>(dtype, rows, B, T, H, n, r, w, k, v, a, b, s0, y, s_out, nullptr, stream);
}

// K5: T a positive multiple of 16; zin is fp32 [B*H, T/16, 64, 64]; rows =
// the value rows a block owns (16, 32 or 64).
int wkv7_fwd_res(int dtype, int rows, int B, int T, int H, int n, const void* r, const void* w,
                 const void* k, const void* v, const void* a, const void* b,
                 const void* s0, void* y, void* s_out, void* zin, void* stream) {
  return launch_fwd_res<1, 1>(dtype, rows, B, T, H, n, r, w, k, v, a, b, s0, y, s_out, zin, stream);
}

// Dynamic shared memory of a K1 / K5 / K11 / K12 block, bytes (-1: no such
// instantiation).
int wkv7_fwd_res_smem_bytes(int dtype, int rows) { return fwd_res_smem_bytes(dtype, rows); }

int wkv7_step(int state_dtype, int B, int H, int n, const void* s_in, const float* r,
              const float* w, const float* k, const float* v, const float* a,
              const float* b, void* s_out, float* y, void* stream) {
  return launch_step<false>(state_dtype, B, H, n, s_in, r, w, k, v, a, b, s_out, y, stream);
}

// K4: state [B, 64, H*64].
int wkv7_step_flat(int state_dtype, int B, int H, int n, const void* s_in, const float* r,
                   const float* w, const float* k, const float* v, const float* a,
                   const float* b, void* s_out, float* y, void* stream) {
  return launch_step<true>(state_dtype, B, H, n, s_in, r, w, k, v, a, b, s_out, y, stream);
}

}  // extern "C"
