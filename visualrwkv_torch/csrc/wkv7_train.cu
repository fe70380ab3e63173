// RWKV-7 ("x070") WKV backward on Hopper (K6). Plain C interface, loaded with
// ctypes by visualrwkv_torch/ops/wkv7_cuda.py.
//
// K6 wkv7_bwd replaces visualrwkv_tpu/ops/wkv7_pallas.py::wkv7_pallas_bwd
// (_wkv7_bwd_kernel / _wkv7_bwd_math): the vector-Jacobian product of the
// recurrence over a sequence, from the states saved by K5 at every 16-step
// chunk. It is the two-pass chunked VJP of wkv7_chunk_bwd.cuh with the
// head-layout zin (ZHEADS = 1): pass 1 (wkv7_bwd_state_kernel, a block a
// slice of value rows, the chunks in reverse) carries the state cotangent
// and writes dv, ds0 and the cotangent leaving every chunk into a
// workspace; pass 2 (wkv7_bwd_chunk_kernel, a block a (b, h, chunk)) forms
// the sums over value rows: dr, dw, dk, da, db. The design and its bound
// are described there.

#include "wkv7_chunk_bwd.cuh"

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Streams and dy [B, T, H, 64] in one dtype, T a positive multiple of 16;
// zin fp32 [B*H, T/16, 64, 64] as K5 wrote it; dsf (cotangent of the final
// state) and ds0 (of the initial state) fp32 [B, H, 64, 64]; dz1 an fp32
// workspace of zin's size; rows = the value rows a pass-1 block owns (16,
// 32 or 64).
int wkv7_bwd(int dtype, int rows, int B, int T, int H, int n, const void* r, const void* w,
             const void* k, const void* v, const void* a, const void* b, const void* zin,
             const void* dy, const void* dsf, void* dr, void* dw, void* dk, void* dv, void* da,
             void* db, void* ds0, void* dz1, void* stream) {
  return launch_bwd<1>(dtype, rows, B, T, H, n, r, w, k, v, a, b, zin, dy, dsf, dr, dw, dk, dv, da,
                       db, ds0, dz1, stream);
}

// Dynamic shared memory of a pass-2 block, bytes (-1: no such dtype).
int wkv7_bwd_chunk_smem_bytes(int dtype) { return bwd_chunk_smem_bytes(dtype); }

}  // extern "C"
