// RWKV-7 ("x070") WKV backward on Hopper (K6). Plain C interface, loaded with
// ctypes by visualrwkv_torch/ops/wkv7_cuda.py.
//
// K6 wkv7_bwd replaces visualrwkv_tpu/ops/wkv7_pallas.py::wkv7_pallas_bwd
// (_wkv7_bwd_kernel / _wkv7_bwd_math): the vector-Jacobian product of the
// recurrence over a sequence, from the states saved by K5 at every 16-step
// chunk. The Pallas kernel differentiates the chunk's matrix form (two
// triangular solves and about twenty small matmuls a chunk), which suits a
// matrix unit and whose exp(-g) factors need the 16-step stability envelope.
// Here the design is the per-step adjoint, which has no such factors:
// wkv7_bwd_kernel<T, 1> of wkv7_seq.cuh (one block of 128 threads per (b, h),
// dS kept by 64 row and 64 column threads, the states before each step
// recomputed from zin in two halves of eight; 170,496 bytes of dynamic
// shared memory).
//
// Bound on the H100: like K1 the T steps are dependent and there are only B*H
// blocks, so the kernel is bound by latency, far above both the byte bound
// (14 streams + the saved states) and the fp32 operation bound.

#include "wkv7_seq.cuh"

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Streams and dy [B, T, H, 64] in one dtype, T a multiple of 16; zin fp32
// [B*H, T/16, 64, 64] as K5 wrote it; dsf (cotangent of the final state) and
// ds0 (of the initial state) fp32 [B, H, 64, 64].
int wkv7_bwd(int dtype, int B, int T, int H, int n, const void* r, const void* w,
             const void* k, const void* v, const void* a, const void* b, const void* zin,
             const void* dy, const void* dsf, void* dr, void* dw, void* dk, void* dv,
             void* da, void* db, void* ds0, void* stream) {
  return launch_bwd<1>(dtype, B, T, H, n, r, w, k, v, a, b, zin, dy, dsf, dr, dw, dk, dv, da,
                       db, ds0, stream);
}

}  // extern "C"
