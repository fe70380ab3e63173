// RWKV-7 ("x070") WKV on head pairs (the "packed" implementation) on Hopper:
// K11 wkv7_fwd_packed, K12 wkv7_fwd_res_packed and K13 wkv7_bwd_packed.
// Plain C interface, loaded with ctypes by visualrwkv_torch/ops/wkv7_cuda.py.
// The head count must be even.
//
// They replace visualrwkv_tpu/ops/wkv7_pallas.py::wkv7_pallas_packed (K11),
// wkv7_pallas_fwd_res_packed (K12) and wkv7_pallas_bwd_packed (K13). On the
// TPU a head's 64 lanes pad to 128, so the Pallas kernels transpose every
// stream into [B*H/2, T, 128], a head pair side by side, to make each DMA
// full-width. On the H100 nothing pads: a head pair is already 128
// contiguous elements of each [b, t] row of the [B, T, H, 64] streams, so the
// kernels read it in place and keep the streams' public layout. What the
// packing leaves is the layout of the saved chunk states, which K12 writes
// and K13 reads as the JAX package does:
//   zin[p, c, j, h2 * 64 + i] = S_{2p+h2}[i, j]   (fp32 [B*H/2, T/16, 64, 128])
// before step 16c, with p = b * H/2 + head pair.
//
// K11: wkv7_fwd_res_kernel<DT, ROWS, 2, 0> of wkv7_chunk.cuh, K1's chunked
// kernel (a block per slice of value rows of one head, any T >= 0). Without
// the saved states ZHEADS addresses nothing, so K11's arithmetic and
// addresses are K1's and its outputs bit-equal to K1's; ZHEADS = 2 keeps it a
// kernel of its own in a profile.
//
// K12: wkv7_fwd_res_kernel<DT, ROWS, 2, 1> of wkv7_chunk.cuh, K5's chunked
// kernel (a block per slice of value rows of one head) with zin addressed
// in the packed layout: row stride 128 and column offset (h % 2) * 64, so
// each warp's store is still a run of adjacent floats. Its y, final state
// and zin values are bit-equal to K5's.
//
// K13: K6's two-pass chunked VJP (wkv7_chunk_bwd.cuh) with ZHEADS = 2:
// pass 2 reads each head's half of the packed zin rows (64 adjacent floats
// at the run-time row stride 128) and pass 1 writes its cotangent workspace
// in the same packed layout. Its results are bit-equal to K6's. dstate comes
// in and out per head in [B, H, 64, 64]. WKV7 has no bonus u, so no sum over
// B is needed.

#include "wkv7_chunk_bwd.cuh"

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K11: streams [B, T, H, 64], any T >= 0, H even; s0 (may be null) and s_out
// fp32 [B, H, 64, 64]; rows = the value rows a block owns (16, 32 or 64).
int wkv7_fwd_packed(int dtype, int rows, int B, int T, int H, int n, const void* r, const void* w,
                    const void* k, const void* v, const void* a, const void* b,
                    const void* s0, void* y, void* s_out, void* stream) {
  return launch_fwd_res<2, 0>(dtype, rows, B, T, H, n, r, w, k, v, a, b, s0, y, s_out, nullptr, stream);
}

// K12: K5 (wkv7.cu) with the packed zin; T a positive multiple of 16, H
// even; rows = the value rows a block owns (16, 32 or 64).
int wkv7_fwd_res_packed(int dtype, int rows, int B, int T, int H, int n, const void* r,
                        const void* w, const void* k, const void* v, const void* a,
                        const void* b, const void* s0, void* y, void* s_out, void* zin,
                        void* stream) {
  return launch_fwd_res<2, 1>(dtype, rows, B, T, H, n, r, w, k, v, a, b, s0, y, s_out, zin, stream);
}

// K13: as wkv7_bwd (wkv7_train.cu), with zin packed as K12 wrote it and the
// dz1 workspace of the same packed shape; H even.
int wkv7_bwd_packed(int dtype, int rows, int B, int T, int H, int n, const void* r, const void* w,
                    const void* k, const void* v, const void* a, const void* b, const void* zin,
                    const void* dy, const void* dsf, void* dr, void* dw, void* dk, void* dv,
                    void* da, void* db, void* ds0, void* dz1, void* stream) {
  return launch_bwd<2>(dtype, rows, B, T, H, n, r, w, k, v, a, b, zin, dy, dsf, dr, dw, dk, dv, da,
                       db, ds0, dz1, stream);
}

}  // extern "C"
