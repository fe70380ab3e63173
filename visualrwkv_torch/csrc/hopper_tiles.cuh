// Hopper (sm_90a) building blocks for hand-written kernels: mbarriers, TMA
// tile loads and their tensor maps, the shared-memory matrix descriptors of
// wgmma and the wgmma instructions themselves, a ring of stages shared by a
// producer and its consumers, and the tiles of the vision towers' attention
// over [B, N, heads, hd] read in place. Used by the attention forward K3
// (attention.cu) and backward K14 / K15 (attention_bwd.cu); its cp.async
// and small-sum helpers by the chunked WKV forwards (wkv6.cu, wkv7_chunk.cuh).
//
// Layouts. A tile of bf16 rows is brought in by TMA with a 128-byte swizzle
// (CU_TENSOR_MAP_SWIZZLE_128B, 64 columns a row) or, for the 16 columns of a
// head dim past 64, a 32-byte swizzle (SWIZZLE_32B). Row i of a tile lies at
// i * 128 (i * 32) bytes from its base, which is 1024-byte aligned. wgmma
// reads the same tile either K-major (the row is the reduction dimension: a
// product over the head dim) or MN-major (the rows are the reduction
// dimension: a product over tokens), with the descriptors below.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------- barriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------ cp.async and small sums
// (the chunked WKV kernels: wkv6.cu's K7 / K8, wkv7_chunk.cuh's K1 / K5 /
// K11 / K12)

// 16 bytes from device memory into shared memory; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// Halves the NV partial sums in acc[0 .. 2 NV) across the lanes l and l ^ O:
// the lane with O set keeps the upper half, the other the lower, each
// summed with its partner's, in acc[0 .. NV).
template <int O, int NV>
__device__ __forceinline__ void reduce_scatter(float* acc, bool upper) {
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    const float send = upper ? acc[m] : acc[m + NV];
    const float keep = upper ? acc[m + NV] : acc[m];
    acc[m] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after the barriers are initialised, before any thread or TMA uses them
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival, and `bytes` more to come from TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` more to come from TMA, without an arrival
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A phase that has
// not completed after about 2^32 clocks (seconds) is a fault of the kernel:
// it traps, so that the launch fails with an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 32)) __trap();
  }
}

// a barrier over the `count` threads of one warpgroup (id 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// arrive at a named barrier without waiting (a producer-consumer pairing
// with a warpgroup that waits on it with named_sync)
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Stage and phase of a ring of S buffers, each guarded by a "full" barrier
// (the producer's data has landed) and an "empty" one (the consumers are
// done with it). The consumers wait on full with `phase`, the producer on
// empty with `phase ^ 1`, so that its first round passes at once.
template <int S>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == S) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- TMA

// A 4-D box of `map` at coordinates (c0 innermost) into shared memory `dst`;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A 2-D box of `map` at coordinates (c0 innermost, c1).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---------------------------------------------------------------- wgmma

enum Swizzle : uint32_t { SW128 = 1, SW32 = 3 };

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle. For the tiles above the stride
// between 8-row groups is one swizzle atom: 1024 bytes (SW128) or 256
// (SW32). Both offsets are set to it: a K-major operand reads only the
// stride offset, and an MN-major one of at most 64 (SW128) or 16 (SW32)
// columns reads only the offset between 8-row groups of the reduction
// dimension, whichever field the hardware takes it from.
__device__ __forceinline__ uint64_t make_desc(const void* p, Swizzle sw) {
  const uint64_t atom = sw == SW128 ? 1024u : 256u;
  uint64_t d = (smem_u32(p) & 0x3FFFFu) >> 4;
  d |= ((atom >> 4) & 0x3FFFu) << 16;
  d |= ((atom >> 4) & 0x3FFFu) << 32;
  d |= (uint64_t)sw << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its issue and wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], fp32 accumulators, bf16 operands.
// _ss: A and B K-major in shared memory; `acc` 0 overwrites D.
// _rs: A from registers (the accumulator layout of a previous product,
// rounded to bf16 pairs), B MN-major in shared memory; always accumulates.
// Accumulator layout (thread t of the warpgroup, warp w = t / 32, lane l):
// d[4j + 2h + e] is row 16w + l/4 + 8h, column 8j + 2(l%4) + e.

__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n48(float (&d)[24], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 16) wgmma_ss_n16(d, a, b, acc);
  else if constexpr (N == 32) wgmma_ss_n32(d, a, b, acc);
  else if constexpr (N == 48) wgmma_ss_n48(d, a, b, acc);
  else {
    static_assert(N == 64, "wgmma_ss: N in 16, 32, 48, 64");
    wgmma_ss_n64(d, a, b, acc);
  }
}

// Two fp32 values as a bf16 pair, rounded to nearest (the lower column in
// the low half), and the two halves back as fp32.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(u) : "f"(hi), "f"(lo));
  return u;
}
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }


// ---------------------------------------------------------------- attention tiles

// The swizzled tiles need 1024-byte aligned bases: a launch asks for
// SMEM_ALIGN bytes more than its layout and the kernel aligns its pointer.
constexpr int SMEM_ALIGN = 1024;
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((SMEM_ALIGN - (smem_u32(p) & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x on the multi-function unit; 0 at -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// How a kernel with the decomposed bias walks the keys: NOBIAS and GENERAL
// take 64-key tiles; GRID_ROWS (head dim 64, a grid at most 64 wide) takes
// one grid row of Wk keys a tile, padded to a multiple of 16 and masked, so
// that a thread owns the same grid columns in every tile.
enum Mode { NOBIAS = 0, GRID_ROWS = 1, GENERAL = 2 };

__host__ __device__ constexpr int grid_rows_tile(int Wk) { return (Wk + 15) / 16 * 16; }

// Tiles of a [rows x hd] bf16 block: the first 64 columns with the 128-byte
// swizzle (128 bytes a row) and, for hd 72, columns 64..79 with the 32-byte
// swizzle (32 bytes a row; TMA's zero fill pads columns 72..79).
template <int HD>
struct Cols {
  static_assert(HD == 64 || HD == 72, "head dims 64 and 72");
  static constexpr bool TAIL = HD > 64;
  static constexpr int KSTEPS = TAIL ? 5 : 4;     // 16-column steps of a product over hd
  __host__ __device__ static constexpr int tile_bytes(int rows) { return rows * 128; }
  __host__ __device__ static constexpr int tail_bytes(int rows) { return TAIL ? rows * 32 : 0; }
};

// K-major descriptor of 16-column step kk of a [rows x hd] tile whose row r0
// starts the operand (main tile at `m`, tail at `t`).
template <int HD>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* m, const unsigned char* t, int r0,
                                           int kk) {
  if (Cols<HD>::TAIL && kk == 4) return make_desc(t + r0 * 32, SW32);
  return make_desc(m + r0 * 128 + kk * 32, SW128);
}

// MN-major descriptors of 16-row step kb (rows are the reduction dimension):
// the first 64 columns, and the tail's 16.
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* m, int kb) {
  return make_desc(m + kb * 16 * 128, SW128);
}
__device__ __forceinline__ uint64_t desc_mn_tail(const unsigned char* t, int kb) {
  return make_desc(t + kb * 16 * 32, SW32);
}

// Issue the TMA loads of a box of rows from token `row0` of one head's
// maps (hopper_host::make_head_maps) into a main tile and a tail tile.
template <int HD>
__device__ __forceinline__ void load_rows(const CUtensorMap (&m)[2], unsigned char* main,
                                          unsigned char* tail, uint64_t* bar, int head, int row0,
                                          int b) {
  tma_load_4d(main, &m[0], bar, 0, head, row0, b);
  if (Cols<HD>::TAIL) tma_load_4d(tail, &m[1], bar, 64, head, row0, b);
}

// Store a 64 x HD accumulator of a warpgroup (its first 64 columns in d, the
// tail's 16 in dt) as bf16 rows `row0 + r` of `out`, row r times mul0 and
// row r + 8 times mul1 (the two rows a thread holds), rows past N dropped
// and columns past HD never written.
template <int HD>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, size_t row_stride, int N, int row0,
                                          const float (&d)[32], const float (&dt)[8], float mul0,
                                          float mul1) {
  const int t = threadIdx.x & 127, r = 16 * (t >> 5) + ((t & 31) >> 2), c = t & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r + 8 * h;
    const float mul = h ? mul1 : mul0;
    if (row >= N) continue;
    __nv_bfloat16* o = out + (size_t)row * row_stride;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j + 2 * c) =
          __floats2bfloat162_rn(d[4 * j + 2 * h] * mul, d[4 * j + 2 * h + 1] * mul);
    if (Cols<HD>::TAIL) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 64 + 8 * j + 2 * c;
        if (col < HD)
          *reinterpret_cast<__nv_bfloat162*>(o + col) =
              __floats2bfloat162_rn(dt[4 * j + 2 * h] * mul, dt[4 * j + 2 * h + 1] * mul);
      }
    }
  }
}

}  // namespace hopper

// ---------------------------------------------------------------- host side

namespace hopper_host {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime's entry-point query
// so that the library needs no -lcuda; null where it is not offered.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a bf16 tensor [B][N][heads][hd] (SAM's [G, N, hd] is heads =
// 1, B = G): boxes of `rows` tokens of one head, `cols` columns (64 with the
// 128-byte swizzle, 16 with the 32-byte one) from column `col0` on. Rows
// past N and columns past hd read as zeros. Returns a CUDA error or 0.
inline int make_rows_map(CUtensorMap* map, const void* base, int B, int N, int heads, int hd,
                         int rows, int cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16) return (int)cudaErrorMisalignedAddress;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)N * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The two maps of one [B][N][heads][hd] tensor: m[0] columns 0..63 (128-byte
// swizzle), m[1] columns 64..79 (32-byte swizzle; hd 72 only), boxes of
// `rows` tokens. Returns a CUDA error or 0.
inline int make_head_maps(CUtensorMap (&m)[2], const void* base, int B, int N, int heads, int hd,
                          int rows) {
  int e = make_rows_map(&m[0], base, B, N, heads, hd, rows, 64);
  if (!e && hd > 64) e = make_rows_map(&m[1], base, B, N, heads, hd, rows, 16);
  return e;
}

// The geometry the attention kernels take: G groups of `heads` heads,
// head dim 64 or 72, and both rel-pos tables or neither, Hk * Wk = N.
inline int check_geometry(int G, int N, int heads, int hd, const void* rel_h, const void* rel_w,
                          int Hk, int Wk) {
  if (G <= 0 || N <= 0 || heads <= 0 || G % heads || (hd != 64 && hd != 72))
    return (int)cudaErrorInvalidValue;
  if ((rel_h == nullptr) != (rel_w == nullptr)) return (int)cudaErrorInvalidValue;
  if (rel_h != nullptr && (Hk <= 0 || Wk <= 0 || Hk * Wk != N)) return (int)cudaErrorInvalidValue;
  return 0;
}

// The opt-in of one kernel to dynamic shared memory above 48 KB, set once a
// device (the largest asked for so far): the attribute is per device, and
// setting it on every launch costs host time. A launcher keeps one as a
// function-local static for its kernel.
struct SmemOptIn {
  static constexpr int DEVICES = 64;
  size_t set[DEVICES] = {};
  template <typename K>
  int operator()(K kernel, size_t smem) {
    if (smem > 232448) return (int)cudaErrorInvalidValue;  // more than a block can have
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < DEVICES && set[dev] >= smem) return 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess && dev < DEVICES) set[dev] = smem;
    return (int)e;
  }
};

// Tensor map of an fp32 matrix [rows][cols] (row stride cols, a multiple of
// 4): boxes of `box_rows` x `box_cols`, with the 128-byte swizzle
// (box_cols 32) or none. Out-of-bounds elements read as zeros.
inline int make_f32_map(CUtensorMap* map, const void* base, int cols, int rows, int box_cols,
                        int box_rows, bool swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 || cols % 4) return (int)cudaErrorMisalignedAddress;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper_host
