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
// (_wkv7_step_kernel) and K4 wkv7_step_flat replaces wkv7_step_flat_pallas
// (_wkv7_step_flat_kernel): one token of the recurrence,
//   S' = S diag(w) + (S a) b^T + v k^T,  w = exp(-exp(w_raw)),  y = S' r,
// on the state [B, H, 64, 64] (K2) or flat [B, 64, H*64] (K4), fp32 or bf16;
// vectors fp32 [B, H, 64]; all math in fp32, y from the fp32 S', and the new
// state rounded once to the state's dtype. The Pallas flat kernel turns the
// per-head sums into matrix-unit dots against one-hot masks, because a TPU
// lane dimension of 64 pads to 128; here a state row of one head is 64
// contiguous elements in both layouts and only the stride between rows
// differs (64 or H*64), so K4 is K2's template with that stride: the same
// arithmetic, and outputs bit-equal to K2's on the same state.
//
// K2 and K4 are wkv_step_kernel<7, DT, FLAT, ROWS> of wkv_step.cuh, a block
// a slice of value rows of one head (the body K10 of wkv6.cu shares); the
// design and its bound are described there.
//
// K5 wkv7_fwd_res replaces wkv7_pallas_fwd_res: the forward that also
// writes the state entering every 16-step chunk, zin[bh, c] = transpose of S
// before step 16c (fp32; Z = S^T, as the Pallas kernel saves it and K6 reads
// it coalesced). It is wkv7_fwd_res_kernel<DT, ROWS, 1, 1> of wkv7_chunk.cuh,
// the Pallas kernel's chunk form with a block per slice of value rows of a
// head; the design and its bound are described there.

#include "wkv7_chunk.cuh"
#include "wkv_step.cuh"

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

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

// K2: state [B, H, 64, 64]; rows = the value rows a block owns (8, 16, 32
// or 64).
int wkv7_step(int state_dtype, int rows, int B, int H, int n, const void* s_in, const float* r,
              const float* w, const float* k, const float* v, const float* a, const float* b,
              void* s_out, float* y, void* stream) {
  return step::launch_step<7, 0>(state_dtype, rows, B, H, n, s_in, r, w, k, v, a, b, nullptr, s_out, y,
                                 stream);
}

// K4: state [B, 64, H*64]; rows as K2's.
int wkv7_step_flat(int state_dtype, int rows, int B, int H, int n, const void* s_in, const float* r,
                   const float* w, const float* k, const float* v, const float* a, const float* b,
                   void* s_out, float* y, void* stream) {
  return step::launch_step<7, 1>(state_dtype, rows, B, H, n, s_in, r, w, k, v, a, b, nullptr, s_out, y,
                                 stream);
}

}  // extern "C"
