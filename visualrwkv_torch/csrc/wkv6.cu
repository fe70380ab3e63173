// RWKV-6 ("x060") WKV recurrence on Hopper: sequence forward (K7), the
// training forward that also saves the chunk states (K8) and the one-token
// decode step (K10). Plain C interface, loaded with ctypes by
// visualrwkv_torch/ops/wkv6_cuda.py. K7 and K8 are wkv6_fwd_kernel<DT, SAVE,
// ROWS, FORM>, the chunk walk of wkv6_chunk.cuh (design, bound and the
// factor forms there); the backward (K9) is in wkv6_train.cu.
//
// K10 wkv6_step replaces wkv6_step_pallas (_wkv6_step_kernel): K2's body
// without a, b and the S.a term, with no decay floor. Bound: state bytes,
// B*H*64*64 read once and written once (fp32 or bf16 state; math fp32). One
// block of 8 warps per (b, h); a warp walks rows, each lane owns two adjacent
// columns, so every row is read and written as one coalesced 128- or 256-byte
// transaction, and the row sum and the bonus are warp shuffles.

#include "wkv6_chunk.cuh"

namespace {

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

// K7 (SAVE 0) / K8 (SAVE 1): the chunk walk forward
template <int DT, int SAVE, int ROWS, int FORM>
__global__ void __launch_bounds__(ROWS * threads_a_row<ROWS>(), min_blocks<FORM>()) wkv6_fwd_kernel(
    int Tlen, int H, float wfloor, const Stream<DT>* __restrict__ r,
    const Stream<DT>* __restrict__ w, const Stream<DT>* __restrict__ k,
    const Stream<DT>* __restrict__ v, const float* __restrict__ u, const float* __restrict__ s0,
    Stream<DT>* __restrict__ y, float* __restrict__ s_out, float* __restrict__ zin) {
  chunk_walk<DT, SAVE, ROWS, FORM>(Tlen, H, wfloor, r, w, k, v, u, s0, y, s_out, zin);
}

// ---------------------------------------------------------------------------
// K10: one decode step. Vectors [B, H, N] fp32, u [H, N] fp32; state in TS,
// [B, H, Nv, Nk].
// ---------------------------------------------------------------------------
constexpr int STEP_WARPS = 8;

template <typename TS>
__global__ void __launch_bounds__(STEP_WARPS * 32) wkv6_step_kernel(
    int H, const TS* __restrict__ s_in, const float* __restrict__ r, const float* __restrict__ w,
    const float* __restrict__ k, const float* __restrict__ v, const float* __restrict__ u,
    TS* __restrict__ s_out, float* __restrict__ y) {
  const int bh = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = 2 * lane;
  const size_t vo = (size_t)bh * N;
  const size_t base = vo * N;
  float r0, r1, w0, w1, k0, k1, u0, u1;
  load2(r + vo + j0, r0, r1);
  load2(w + vo + j0, w0, w1);
  load2(k + vo + j0, k0, k1);
  load2(u + (size_t)(bh % H) * N + j0, u0, u1);
  w0 = expf(-expf(w0));
  w1 = expf(-expf(w1));
  const float bonus = warp_sum(u0 * k0 * r0 + u1 * k1 * r1);

  constexpr int ROWS = N / STEP_WARPS;
#pragma unroll
  for (int ii = 0; ii < ROWS; ++ii) {
    const int i = warp * ROWS + ii;
    const size_t so = base + (size_t)i * N + j0;
    float s0, s1;
    load2(s_in + so, s0, s1);
    const float vi = v[vo + i];
    const float yi = warp_sum(s0 * r0 + s1 * r1);
    s0 = fmaf(s0, w0, vi * k0);
    s1 = fmaf(s1, w1, vi * k1);
    store2(s_out + so, s0, s1);
    if (lane == 0) y[vo + i] = fmaf(bonus, vi, yi);
  }
}

template <int DT, int SAVE, int ROWS, int FORM>
int launch_form(int B, int T, int H, float wfloor, const void* r, const void* w, const void* k,
                const void* v, const void* u, const void* s0, void* y, void* s_out, void* zin,
                cudaStream_t st) {
  using X = Stream<DT>;
  const auto kernel = wkv6_fwd_kernel<DT, SAVE, ROWS, FORM>;
  constexpr size_t smem = FwdSmem<DT, ROWS>::bytes;
  static hopper_host::SmemOptIn opt_in;
  const int e = opt_in(kernel, smem);
  if (e != 0) return e;
  kernel<<<B * H * (N / ROWS), ROWS * threads_a_row<ROWS>(), smem, st>>>(
      T, H, wfloor, (const X*)r, (const X*)w, (const X*)k, (const X*)v, (const float*)u,
      (const float*)s0, (X*)y, (float*)s_out, (float*)zin);
  return (int)cudaGetLastError();
}

// the factor form by the floor (wkv6_chunk.cuh), each its own instantiation
template <int DT, int SAVE, int ROWS>
int launch_rows(int B, int T, int H, float wfloor, const void* r, const void* w, const void* k,
                const void* v, const void* u, const void* s0, void* y, void* s_out, void* zin,
                cudaStream_t st) {
  switch (factor_form(wfloor)) {
    case 0: return launch_form<DT, SAVE, ROWS, 0>(B, T, H, wfloor, r, w, k, v, u, s0, y, s_out, zin, st);
    case 1: return launch_form<DT, SAVE, ROWS, 1>(B, T, H, wfloor, r, w, k, v, u, s0, y, s_out, zin, st);
  }
  return launch_form<DT, SAVE, ROWS, 2>(B, T, H, wfloor, r, w, k, v, u, s0, y, s_out, zin, st);
}

template <int DT, int SAVE>
int launch_dt(int rows, int B, int T, int H, float wfloor, const void* r, const void* w,
              const void* k, const void* v, const void* u, const void* s0, void* y, void* s_out,
              void* zin, cudaStream_t st) {
  switch (rows) {
    case 16: return launch_rows<DT, SAVE, 16>(B, T, H, wfloor, r, w, k, v, u, s0, y, s_out, zin, st);
    case 32: return launch_rows<DT, SAVE, 32>(B, T, H, wfloor, r, w, k, v, u, s0, y, s_out, zin, st);
    case 64: return launch_rows<DT, SAVE, 64>(B, T, H, wfloor, r, w, k, v, u, s0, y, s_out, zin, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int SAVE>
int launch_fwd(int dtype, int rows, int B, int T, int H, int n, float wfloor, const void* r,
               const void* w, const void* k, const void* v, const void* u, const void* s0,
               void* y, void* s_out, void* zin, void* stream) {
  if (n != N || B <= 0 || H <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (SAVE && (T % CHUNK != 0 || zin == nullptr)) return (int)cudaErrorInvalidValue;
  // the floor -80 / chunk_len of a chunk_len >= 1
  if (!(wfloor >= -80.f && wfloor < 0.f)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dt<0, SAVE>(rows, B, T, H, wfloor, r, w, k, v, u, s0, y, s_out, zin, st);
  if (dtype == 1)
    return launch_dt<1, SAVE>(rows, B, T, H, wfloor, r, w, k, v, u, s0, y, s_out, zin, st);
  return (int)cudaErrorInvalidValue;
}

template <int DT>
int fwd_smem_bytes(int rows) {
  switch (rows) {
    case 16: return (int)FwdSmem<DT, 16>::bytes;
    case 32: return (int)FwdSmem<DT, 32>::bytes;
    case 64: return (int)FwdSmem<DT, 64>::bytes;
  }
  return -1;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K7: streams [B, T, H, 64] in one dtype; u fp32 [H, 64]; s0 (may be null)
// and s_out fp32 [B, H, 64, 64]; wfloor = -80 / chunk_len, chunk_len >= 1;
// rows = the value rows a block owns (16, 32 or 64; 8 threads a row, 4 at 64).
int wkv6_fwd(int dtype, int rows, int B, int T, int H, int n, float wfloor, const void* r,
             const void* w, const void* k, const void* v, const void* u, const void* s0, void* y,
             void* s_out, void* stream) {
  return launch_fwd<0>(dtype, rows, B, T, H, n, wfloor, r, w, k, v, u, s0, y, s_out, nullptr,
                       stream);
}

// K8: K7 with T a multiple of 16; zin is fp32 [B*H, T/16, 64, 64].
int wkv6_fwd_res(int dtype, int rows, int B, int T, int H, int n, float wfloor, const void* r,
                 const void* w, const void* k, const void* v, const void* u, const void* s0,
                 void* y, void* s_out, void* zin, void* stream) {
  return launch_fwd<1>(dtype, rows, B, T, H, n, wfloor, r, w, k, v, u, s0, y, s_out, zin,
                       stream);
}

// Dynamic shared memory of a K7 / K8 block, bytes (-1: no such instantiation).
int wkv6_fwd_smem_bytes(int dtype, int rows) {
  return dtype == 0 ? fwd_smem_bytes<0>(rows) : dtype == 1 ? fwd_smem_bytes<1>(rows) : -1;
}

// K10: state [B, H, 64, 64] fp32 (0) or bf16 (1); vectors fp32 [B, H, 64].
int wkv6_step(int state_dtype, int B, int H, int n, const void* s_in, const float* r,
              const float* w, const float* k, const float* v, const float* u, void* s_out,
              float* y, void* stream) {
  if (n != N || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B * H), block(STEP_WARPS * 32);
  if (state_dtype == 0) {
    wkv6_step_kernel<float><<<grid, block, 0, st>>>(H, (const float*)s_in, r, w, k, v, u,
                                                    (float*)s_out, y);
  } else if (state_dtype == 1) {
    using bf = __nv_bfloat16;
    wkv6_step_kernel<bf><<<grid, block, 0, st>>>(H, (const bf*)s_in, r, w, k, v, u, (bf*)s_out,
                                                 y);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
