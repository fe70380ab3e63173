// Tiles of the vision towers' attention forward K3 (attention.cu; the
// backward K14 / K15 build on hopper_tiles.cuh instead). A block has
// 4 warps and covers 64 rows of one (batch, head) group g; tiles of 64 rows
// x the head dim are staged in shared memory as bf16, the head dim
// zero-padded to a multiple of 16 for the 16x16x16 WMMA fragments. Both
// layouts are read in place: token row stride heads*hd, and the (batch,
// head) pair of a block comes from its grid row g.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace vattn {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;     // query rows per tile, 16 per warp
constexpr int BK = 64;     // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int LDP = BK + 8;  // bf16 row stride of a warp's 16 x 64 P / dS tile

template <int HD>
struct Geom {
  static constexpr int HDP = (HD + 15) / 16 * 16;  // head dim padded for 16x16x16 WMMA
  static constexpr int LDB = HDP + 8;              // bf16 row stride of the Q/K/V tiles
  static constexpr int LDX = (HDP > BK ? HDP : BK) + 4;  // fp32 stride of a warp's 16-row tile
  static constexpr int COLS = HDP / 2;             // output columns a lane owns
  static_assert(HD % 8 == 0, "rows are copied 16 bytes at a time");
};

// Offset of group g's first element: (batch g / heads, head g % heads).
__device__ __forceinline__ size_t group_base(int g, int heads, int N, int HD) {
  return ((size_t)(g / heads) * N * heads + (g % heads)) * HD;
}

template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int N,
                                          size_t row_stride, int tid) {
  // 64 rows x HDP bf16, 16 bytes per thread per pass; rows >= N and the
  // padding columns >= HD are zero
  using G = Geom<HD>;
  constexpr int CHUNKS = G::HDP / 8;
  for (int c = tid; c < 64 * CHUNKS; c += THREADS) {
    const int row = c / CHUNKS, col = (c % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + row < N && col < HD)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + row) * row_stride + col);
    *reinterpret_cast<uint4*>(dst + row * G::LDB + col) = val;
  }
}

}  // namespace vattn
