// RWKV-6 ("x060") WKV recurrence on Hopper: sequence forward (K7), the
// training forward that also saves the chunk states (K8) and the one-token
// decode step (K10). Plain C interface, loaded with ctypes by
// visualrwkv_torch/ops/wkv6_cuda.py. K7 and K8 are wkv6_fwd_kernel<DT, SAVE,
// ROWS, FORM>, the chunk walk of wkv6_chunk.cuh (design, bound and the
// factor forms there); the backward (K9) is in wkv6_train.cu.
//
// K10 wkv6_step replaces wkv6_step_pallas (_wkv6_step_kernel): one token,
// y = S r + (sum_j u_j k_j r_j) v from the old state, S' = S diag(w) + v k^T
// with no decay floor. It is wkv_step_kernel<6, DT, 0, ROWS> of wkv_step.cuh,
// the body of K2 / K4 (wkv7.cu) without a, b and the (S a) b^T term and with
// the bonus: a block a slice of value rows of one head, 16-byte state
// accesses, every state load in flight before the first sum; the design and
// its bound are described there.

#include "wkv6_chunk.cuh"
#include "wkv_step.cuh"

namespace {

// K7 (SAVE 0) / K8 (SAVE 1): the chunk walk forward
template <int DT, int SAVE, int ROWS, int FORM>
__global__ void __launch_bounds__(ROWS * threads_a_row<ROWS>(), min_blocks<FORM>()) wkv6_fwd_kernel(
    int Tlen, int H, float wfloor, const Stream<DT>* __restrict__ r,
    const Stream<DT>* __restrict__ w, const Stream<DT>* __restrict__ k,
    const Stream<DT>* __restrict__ v, const float* __restrict__ u, const float* __restrict__ s0,
    Stream<DT>* __restrict__ y, float* __restrict__ s_out, float* __restrict__ zin) {
  chunk_walk<DT, SAVE, ROWS, FORM>(Tlen, H, wfloor, r, w, k, v, u, s0, y, s_out, zin);
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

// K10: state [B, H, 64, 64] fp32 (0) or bf16 (1); vectors fp32 [B, H, 64],
// u fp32 [H, 64]; rows = the value rows a block owns (8, 16, 32 or 64);
// every pointer 16-byte aligned.
int wkv6_step(int state_dtype, int rows, int B, int H, int n, const void* s_in, const float* r,
              const float* w, const float* k, const float* v, const float* u, void* s_out,
              float* y, void* stream) {
  return step::launch_step<6, 0>(state_dtype, rows, B, H, n, s_in, r, w, k, v, nullptr, nullptr, u,
                                 s_out, y, stream);
}

}  // extern "C"
