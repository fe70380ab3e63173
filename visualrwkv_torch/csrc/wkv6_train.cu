// RWKV-6 ("x060") WKV backward on Hopper (K9). Plain C interface, loaded with
// ctypes by visualrwkv_torch/ops/wkv6_cuda.py. The design, its bound and the
// two kernels it launches are in wkv6_chunk_bwd.cuh.

#include "wkv6_chunk_bwd.cuh"

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Streams and dy [B, T, H, 64] in one dtype, T a positive multiple of 16; u
// fp32 [H, 64]; zin fp32 [B*H, T/16, 64, 64] as K8 wrote it; dsf (cotangent
// of the final state) and ds0 (of the initial state) fp32 [B, H, 64, 64];
// du fp32 [B*H*T/16, 64] (a partial a (b, h, chunk), summed by the caller);
// dz1 a workspace of zin's size; rows = the value rows a first-pass block
// owns (16, 32 or 64, K8's plan); wfloor = -80 / chunk_len, chunk_len >= 1.
int wkv6_bwd(int dtype, int rows, int B, int T, int H, int n, float wfloor, const void* r,
             const void* w, const void* k, const void* v, const void* u, const void* zin,
             const void* dy, const void* dsf, void* dr, void* dw, void* dk, void* dv, void* du,
             void* ds0, void* dz1, void* stream) {
  if (n != N || B <= 0 || H <= 0 || T <= 0 || T % CHUNK != 0 || zin == nullptr || dz1 == nullptr ||
      dsf == nullptr || !(wfloor >= -80.f && wfloor < 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd_dt<0>(rows, B, T, H, wfloor, r, w, k, v, u, zin, dy, dsf, dr, dw, dk, dv, du, ds0,
                            dz1, st);
  if (dtype == 1)
    return launch_bwd_dt<1>(rows, B, T, H, wfloor, r, w, k, v, u, zin, dy, dsf, dr, dw, dk, dv, du, ds0,
                            dz1, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a second-pass block, bytes (-1: no such dtype).
int wkv6_bwd_chunk_smem_bytes(int dtype) { return bwd_chunk_smem_bytes(dtype); }

}  // extern "C"
