// An empty kernel, to measure the launch floor: the time the card takes for
// a launch that does no work, on a given grid. It replaces no TPU kernel and
// no path of the port runs it. chip_smoke.py times it beside the decode steps
// K2 / K4 (wkv7.cu) and K10 (wkv6.cu), on the step's grid, with the step's
// arguments and replayed in a CUDA graph as the step is, so that the part of
// the step's time that is launch can be told from the part that is work.
// Plain C interface, loaded with ctypes by visualrwkv_torch/ops/wkv7_cuda.py::
// step_floor and wkv6_cuda.py::step_floor.

#include <cuda_runtime.h>

namespace {

// the parameters of K2's wkv_step_kernel (wkv_step.cuh) but u, unused
__global__ void launch_floor_kernel(int, const void*, const float*, const float*, const float*,
                                    const float*, const float*, const float*, void*, float*) {}

}  // namespace

extern "C" {

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int launch_floor(int blocks, int threads, int H, const void* s_in, const float* r, const float* w,
                 const float* k, const float* v, const float* a, const float* b, void* s_out,
                 float* y, void* stream) {
  if (blocks <= 0 || threads <= 0 || threads > 1024) return (int)cudaErrorInvalidValue;
  launch_floor_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(H, s_in, r, w, k, v, a, b, s_out, y);
  return (int)cudaGetLastError();
}

}  // extern "C"
