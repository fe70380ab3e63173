#!/usr/bin/env python3
"""Variants of a kernel against each other on one card, in turns: the
attention forward K3 (``visualrwkv_torch/csrc/attention.cu``), the WKV6
forward K7 / K8 (``csrc/wkv6_chunk.cuh``, built through ``csrc/wkv6.cu``),
the WKV6 backward K9 (``csrc/wkv6_chunk_bwd.cuh`` and its first pass in
``csrc/wkv6_chunk.cuh``, built through ``csrc/wkv6_train.cu``), the WKV7
training forward K5 (``csrc/wkv7_chunk.cuh``, built through
``csrc/wkv7.cu``), the WKV7 prefill forward K1 / K11 (the same kernel
without the saved states, built through ``csrc/wkv7.cu`` and
``csrc/wkv7_packed.cu``), the WKV7 backward K6 (``csrc/wkv7_chunk_bwd.cuh``, built
through ``csrc/wkv7_train.cu``), the WKV7 decode steps K2 / K4
(``csrc/wkv_step.cuh``, built through ``csrc/wkv7.cu``) or the WKV6 decode
step K10 (the same body, built through ``csrc/wkv6.cu``) or the chunk-batched
WKV7 forward K16 (``csrc/wkv7_v2.cu``) or the RWKV-4 sequence forward K17
(``csrc/wkv4.cu``) and its VJP K18.

    python3 chip_variants.py                       # every variant of K3 in VARIANTS
    python3 chip_variants.py base stages2          # some of them
    python3 chip_variants.py --wkv6 [names]        # K7 / K8: WKV6_VARIANTS
    python3 chip_variants.py --wkv6bwd [names]     # K9: WKV6BWD_VARIANTS
    python3 chip_variants.py --wkv7 [names]        # K5: WKV7_VARIANTS
    python3 chip_variants.py --wkv7fwd [names]     # K1 / K11: WKV7FWD_VARIANTS
    python3 chip_variants.py --wkv7bwd [names]     # K6: WKV7BWD_VARIANTS
    python3 chip_variants.py --wkv7step [names]    # K2 / K4: WKV7STEP_VARIANTS
    python3 chip_variants.py --wkv6step [names]    # K10: WKV6STEP_VARIANTS
    python3 chip_variants.py --v2 [names]          # K16: V2_VARIANTS
    python3 chip_variants.py --wkv4 [names]        # K17 and K18: WKV4_VARIANTS

A variant is the source with text substitutions (each names the design
choice it undoes, or the part of the work it leaves out). Each is compiled
by ``nvcc`` into ``build/variants/<source>/<name>/``, all at once, and ptxas's
registers, spills and wgmma serialisation warnings are printed. Then, with
the loaded library swapped between turns (the variants in order, then in
reverse), K3 runs through the port's own wrappers at ``chip_ab.K3_CASES``,
held against its plain version (out relative RMS <= 1e-2, lse <= 1e-3) and
timed in CUDA graphs as the serving path calls it (``sam_attention``,
``mha``); or K8 and K7 run at ``WKV6_CASES`` through ``wkv6_cuda``, each
exact variant held against the floored scan (y <= 1e-2 with bf16 streams,
1e-3 with fp32, the final state 1e-3); or K9 runs at ``WKV6BWD_CASES`` from
K8's states, each exact variant held against ``wkv6_bwd_plain`` (the six
gradients <= 2e-2 with bf16 streams, 1e-3 with fp32); or K5 runs at
``WKV7_CASES`` through
``wkv7_cuda``, each exact variant held against ``wkv7_fwd_res_plain`` (y
<= 1e-2 with bf16 streams, 1e-3 with fp32, the final state and ``zin``
1e-3); or K1 / K11 at ``WKV7FWD_CASES`` against the fp32 sequential scan
(the same limits); or K6 runs at ``WKV7BWD_CASES`` from K5's states, each exact variant
held against ``wkv7_bwd_plain`` (the seven gradients <= 2e-2 with bf16
streams, 1e-3 with fp32); or K2 / K4 at ``WKV7STEP_CASES``, L2-hot and
L2-cold, each exact variant held against the plain step (y <= 1e-3, the
new state 1e-3 fp32, 1e-2 bf16); or K10 at ``WKV6STEP_CASES`` in the same
way; or K16 at ``V2_CASES``, whole and each phase alone, each exact variant
held against ``wkv7_v2_plain`` (y and the final state <= 1e-2 with bf16
streams, 1e-3 with fp32); or K17 at ``WKV4_VARIANT_CASES`` and K18 at
``WKV4_BWD_VARIANT_CASES``, each exact variant held against ``wkv4_plain``
/ ``wkv4_bwd_plain`` in float64 (y and the final state <= 1e-5, the
gradients <= 1e-4), its plan constants set on ``wkv4_cuda`` for its turn. The
card's name and power limit come first, the SDPA forward's time
at each no-bias case next (K3), and one ``VARIANT {json}`` line a variant
last (its times in turn order).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# name -> [(text in attention.cu, replacement)]
VARIANTS = {
    "base": [],
    # 128-row blocks (two consumer warpgroups) for hd 64 without a bias
    "rows128": [("constexpr int mha_nc(int hd) { return hd == 64 ? 1 : 2; }",
                 "constexpr int mha_nc(int) { return 2; }")],
    # 64-row blocks (one consumer warpgroup, three blocks an SM) for hd 72 too
    "rows64_hd72": [("constexpr int mha_nc(int hd) { return hd == 64 ? 1 : 2; }",
                     "constexpr int mha_nc(int) { return 1; }")],
    # a 2-stage K / V ring
    "stages2": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
    # the softmax of tile kt waits for tile kt - 1's P V too (no overlap)
    "nooverlap": [("    wgmma_wait<1>();\n", "    wgmma_wait<0>();\n")],
    # no turns between the two consumer warpgroups
    "noturn": [("void turn_wait(int wg) { named_sync(3 + wg, 256); }", "void turn_wait(int) {}"),
               ("void turn_pass(int wg) { named_arrive(4 - wg, 256); }", "void turn_pass(int) {}")],
}


_FAST_EXP = """constexpr unsigned FULL = 0xffffffffu;
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
"""
# K7 / K8: name -> ([(text in wkv6.cu, replacement)], value of
# wkv6_cuda.FWD_BLOCKS or None, exact). The "no_*" variants leave a part of
# the chunk loop's work out (their results are wrong), to show its share.
WKV6_VARIANTS = {
    "base": ([], None, True),
    # 16 / 64 value rows a block at B*H = 64 (256 / 64 blocks)
    "rows16": ([], 256, True),
    "rows64": ([], 64, True),
    # 4 threads a value row at 32 rows a block too (128 threads, 16 columns each)
    "tpr4": ([("return ROWS == 64 ? 4 : 8;", "return ROWS >= 32 ? 4 : 8;")], None, True),
    # the approximate exponentials (ex2.approx, __expf)
    "fastexp": ([("constexpr unsigned FULL = 0xffffffffu;\n", _FAST_EXP),
                 ("exp2f(", "ex2_approx("), ("-expf(", "-__expf(")], None, True),
    # the outputs' and the bonus's dot products unrolled in full
    "unroll16": ([("constexpr int UNROLL = ROWS == 64 ? 1 : 4;", "constexpr int UNROLL = 16;")], None, True),
    # A's factors each as one exp2 of its difference at chunk_len 16 too (the
    # form a floor below -5 a step needs)
    "exp2_each": ([("    if constexpr (FORM == 0) {", "    if constexpr (false) {"),
                   ("    } else if constexpr (FORM == 1) {", "    } else if constexpr (FORM <= 1) {")], None, True),
    # every pair factor of A one exp2 at chunk_len 16 too (the form below -10)
    "pair_form": ([("inline int factor_form(float wfloor) { return wfloor >= -80.f / CHUNK ? 0 : wfloor >= -10.f ? 1 : 2; }",
                    "inline int factor_form(float) { return 2; }")], None, True),
    "no_amatrix": ([("    if (c + 1 < nc) amatrix(c + 1);\n", "")], None, False),
    "no_factors": ([("    if (c + 1 < nc) factors(c + 1);\n", "")], None, False),
    "no_outputs": ([("    outputs(c);\n", "")], None, False),
    "no_update": ([("    update(c);\n", "")], None, False),
}
# K5: name -> ([(text in wkv7_chunk.cuh, replacement)], value of
# wkv7_cuda.FWD_RES_BLOCKS or None, exact). The "no_*" variants leave a part
# of the chunk loop's work out (their results are wrong), to show its share.
WKV7_VARIANTS = {
    "base": ([], None, True),
    # 16 / 64 value rows a block at B*H = 64 (256 / 64 blocks)
    "rows16": ([], 256, True),
    "rows64": ([], 64, True),
    # 4 threads a value row at 32 rows a block too (128 threads, 16 columns each)
    "tpr4": ([("return ROWS == 64 ? 4 : 8;", "return ROWS >= 32 ? 4 : 8;")], None, True),
    # 16 threads a value row at 32 rows a block (512 threads, 4 columns and 1 step each)
    "tpr16": ([("return ROWS == 64 ? 4 : 8;", "return ROWS == 64 ? 4 : ROWS == 32 ? 16 : 8;"),
               ("NT >= 128 && NT <= 256", "NT >= 128 && NT <= 512")], None, True),
    # 64 rows a block with 8 threads a row (512 threads, a whole head, 64 blocks)
    "rows64_tpr8": ([("return ROWS == 64 ? 4 : 8;", "return 8;"),
                     ("NT >= 128 && NT <= 256", "NT >= 128 && NT <= 512")], 64, True),
    # the products along j unrolled in full (4 deep in the source)
    "unroll16": ([("#pragma unroll 4\n    for (int jj", "#pragma unroll\n    for (int jj")], None, True),
    "no_factors": ([("    if (c + 1 < nc) factors(c + 1);\n", "")], None, False),
    "no_matrices": ([("    if (c + 1 < nc) matrices(c + 1);\n", "")], None, False),
    "no_products": ([("    products(c, yp);\n", "    for (int o = 0; o < OPT; ++o) yp[o] = 0.f;\n")], None, False),
    "no_solve": ([("s < CHUNK - 1; ++s) {  // column s of M", "s < 0; ++s) {  // column s of M")], None, False),
    "no_zin": ([("for (int q = 0; q < Q4; ++q) {\n        z[", "for (int q = 0; q < 0; ++q) {\n        z[")], None, False),
    "no_update": ([("for (int s = 0; s < CHUNK; ++s) {\n      const float us", "for (int s = 0; s < 0; ++s) {\n      const float us")],
                  None, False),
}
WKV7_CASES = (("wkv7_fwd_res", 2, 2048, 32, "bfloat16"), ("wkv7_fwd_res", 2, 2048, 32, "float32"))
# K1 / K11 (the same kernel without SAVE; built through wkv7.cu and
# wkv7_packed.cu): name -> ([(text in wkv7_chunk.cuh, replacement)], value of
# wkv7_cuda.FWD_RES_BLOCKS or None, exact). The plan variants set the value
# rows a block at the prefill's B*H = 32 (B=1) and 128 (B=4): the source's
# plan gives 16 rows (128 blocks) and 64 (128 blocks); "blocks64" 32 rows at
# B=1 (64 blocks), "blocks32" 64 rows at B=1 (32 blocks), "blocks256" 32
# rows at B=4 (256 blocks), "blocks512" 16 rows at B=4 (512 blocks). The
# "no_*" variants leave a part of the chunk loop out (their results are
# wrong), to show its share; the others are K5's.
WKV7FWD_VARIANTS = {
    "base": ([], None, True),
    "blocks64": ([], 64, True),
    "blocks32": ([], 32, True),
    "blocks256": ([], 256, True),
    "blocks512": ([], 512, True),
    **{name: WKV7_VARIANTS[name] for name in ("tpr4", "unroll16", "no_factors", "no_matrices", "no_products",
                                              "no_solve", "no_update")},
}
# K1 / K11 timed: (kernel, B, T, H, stream dtype), with an initial state: the
# prefill's shapes of chip_smoke's check_wkv7_fwd and check_wkv7_fwd_packed
WKV7FWD_CASES = (("wkv7_fwd", 1, 1056, 32, "bfloat16"), ("wkv7_fwd", 1, 1056, 32, "float32"),
                 ("wkv7_fwd", 4, 1056, 32, "bfloat16"), ("wkv7_fwd_packed", 1, 1056, 32, "bfloat16"))
# K6 (the two passes of wkv7_chunk_bwd.cuh, built through wkv7_train.cu): name
# -> ([(text in wkv7_chunk_bwd.cuh, replacement)], value of
# wkv7_cuda.FWD_RES_BLOCKS (pass 1's plan) or None, exact). The "no_*"
# variants leave a part of a pass out (their results are wrong), to show its
# share; "no_pass1" / "no_pass2" time one pass alone.
_P2_LAST = """    dw[c0 + (size_t)s * tstride + j] = from_f<T>((cr[m] + ez) * -expf(to_f(raw[TILE + s * N + j])));
  }
}
"""
WKV7BWD_VARIANTS = {
    "base": ([], None, True),
    # 16 / 64 value rows a pass-1 block at B*H = 64 (256 / 64 blocks)
    "rows16": ([], 256, True),
    "rows64": ([], 64, True),
    # a block a head for both passes: pass 1 with the head's 64 rows (64
    # blocks) and pass 2 walking the head's chunks in one block (64 blocks)
    "head_blocks": ([("  const int bh = blockIdx.x / nc, c = blockIdx.x % nc;\n",
                      "  const int bh = blockIdx.x;\n  for (int c = 0; c < nc; ++c) {\n"),
                     (_P2_LAST, _P2_LAST[:-2] + "  __syncthreads();\n  }\n}\n"),
                     ("kernel<<<B * H * (T / CHUNK), CB_THREADS", "kernel<<<B * H, CB_THREADS")], 64, True),
    # the pair walk four steps at once (spills) or one at a time
    "pairs4": ([("q0 < 4; q0 += 2) {\n    float qa[2], qr[2], qb[2], qk[2], amt[2], rmt[2];",
                 "q0 < 4; q0 += 4) {\n    float qa[4], qr[4], qb[4], qk[4], amt[4], rmt[4];"),
                ("for (int q = 0; q < 2; ++q) {\n      qa[q]", "for (int q = 0; q < 4; ++q) {\n      qa[q]"),
                ("for (int q = 0; q < 2; ++q) {\n        const int t = f + 4 * (q0 + q);\n        float xm",
                 "for (int q = 0; q < 4; ++q) {\n        const int t = f + 4 * (q0 + q);\n        float xm"),
                ("for (int q = 0; q < 2; ++q) {\n      const int t = f + 4 * (q0 + q), e",
                 "for (int q = 0; q < 4; ++q) {\n      const int t = f + 4 * (q0 + q), e")], None, True),
    "pairs1": ([("q0 < 4; q0 += 2) {\n    float qa[2], qr[2], qb[2], qk[2], amt[2], rmt[2];",
                 "q0 < 4; q0 += 1) {\n    float qa[1], qr[1], qb[1], qk[1], amt[1], rmt[1];"),
                ("for (int q = 0; q < 2; ++q) {\n      qa[q]", "for (int q = 0; q < 1; ++q) {\n      qa[q]"),
                ("for (int q = 0; q < 2; ++q) {\n        const int t = f + 4 * (q0 + q);\n        float xm",
                 "for (int q = 0; q < 1; ++q) {\n        const int t = f + 4 * (q0 + q);\n        float xm"),
                ("for (int q = 0; q < 2; ++q) {\n      const int t = f + 4 * (q0 + q), e",
                 "for (int q = 0; q < 1; ++q) {\n      const int t = f + 4 * (q0 + q), e")], None, True),
    # pass 2 without the register cap of two blocks a multiprocessor
    "no_cap": ([("__launch_bounds__(CB_THREADS, 2) wkv7_bwd_chunk_kernel(",
                 "__launch_bounds__(CB_THREADS, 1) wkv7_bwd_chunk_kernel(")], None, True),
    # the row sums' loop unrolled 4 deep (2 in the source)
    "unroll4": ([("#pragma unroll 2\n    for (int i4 = 0; i4 < N / 4; ++i4) {\n      float4 x[4], z[4];",
                  "#pragma unroll 4\n    for (int i4 = 0; i4 < N / 4; ++i4) {\n      float4 x[4], z[4];")], None, True),
    "no_pass1": ([("  int e;\n  switch (rows) {", "  int e = 0;\n  if (rows < 0) switch (rows) {")], None, False),
    "no_pass2": ([("  static hopper_host::SmemOptIn opt_in;\n  e = opt_in(kernel, smem);",
                   "  return 0;\n  static hopper_host::SmemOptIn opt_in;\n  e = opt_in(kernel, smem);")], None, False),
    "no_p1_factors": ([("    if (p + 1 < nc) factors(p + 1);\n", "")], None, False),
    "no_p1_matrices": ([("    if (p + 1 < nc) matrices(p + 1);\n", "")], None, False),
    "no_p1_products": ([("    products(p, pv);\n", "    for (int o = 0; o < OPT; ++o) pv[o] = 0.f;\n")], None, False),
    "no_p1_solve": ([("for (int tp = CHUNK - 1; tp > 0; --tp) {", "for (int tp = CHUNK - 1; tp > CHUNK; --tp) {")],
                    None, False),
    "no_p1_dz1": ([("for (int q = 0; q < Q4; ++q) {\n      z[(size_t)(4 * q) * zrow]",
                    "for (int q = 0; q < 0; ++q) {\n      z[(size_t)(4 * q) * zrow]")], None, False),
    "no_p1_update": ([("for (int s = 0; s < CHUNK; ++s) {\n      const float ys",
                       "for (int s = 0; s < 0; ++s) {\n      const float ys")], None, False),
    # w_pre, dU and both solves: at most what pass 1 storing u and dWpre
    # for pass 2 could save (less the traffic of storing and reading them)
    "no_p2_solves": ([("for (int j4 = 0; j4 < N / 4; ++j4) {\n      float4 zr[4];",
                       "for (int j4 = 0; j4 < 0; ++j4) {\n      float4 zr[4];"),
                      ("for (int s = 0; s < CHUNK; ++s) {\n      const float4 x = *",
                       "for (int s = 0; s < 0; ++s) {\n      const float4 x = *"),
                      ("  if (tid < 2 * N) {\n    const int i = tid % N;\n    const bool back",
                       "  if (tid < 0) {\n    const int i = tid % N;\n    const bool back")], None, False),
    "no_p2_rowsums": ([("for (int i4 = 0; i4 < N / 4; ++i4) {\n      const float4 wt",
                        "for (int i4 = 0; i4 < 0; ++i4) {\n      const float4 wt"),
                       ("for (int i4 = 0; i4 < N / 4; ++i4) {\n      float4 x[4], z[4];",
                        "for (int i4 = 0; i4 < 0; ++i4) {\n      float4 x[4], z[4];")], None, False),
    "no_p2_pairs": ([("for (int s = 0; s < CHUNK; ++s) {\n      const float bms",
                      "for (int s = 0; s < 0; ++s) {\n      const float bms")], None, False),
}
WKV7BWD_CASES = ((2, 2048, 32, "bfloat16"), (2, 2048, 32, "float32"))
# K9: name -> ([(text in wkv6_chunk_bwd.cuh or wkv6_chunk.cuh, replacement)],
# value of wkv6_cuda.FWD_BLOCKS for the first pass or None, exact). The
# "no_*" variants leave a part out (their results are wrong), to show its
# share; "no_pass1" / "no_pass2" time one pass alone.
# K9's alternative for the second pass's row sums: 3xTF32 mma.sync m16n8k8
# (each operand split into a tf32 high and low part, three products), a warp
# a column tile of P_R and of dKbar. Measured slower than the FMA register
# tiles of the source, so its code lives only here.
_P2_ANCHOR = "// P_R = dY Z0^T and dKbar = V dZ1^T, the two 16 x 64 x 64 sums over rows i,\n"
_P2_MMA = """// tf32 split of x: hi + lo, each a tf32 value in a 32-bit register
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// d += a b, one m16n8k8 tf32 product (a: 16 x 8 row-major, b: 8 x 8 column-major)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's 16 x 8 tile of lhs rhs^T over the 64 rows i in 3xTF32: lhs
// [16][LDP] ([t][i]), rhs rows n0 .. n0 + 8 of [.][LDP] ([n][i]); d holds
// (groupID, 2 tig + {0, 1}) and (groupID + 8, ...) of the tile.
__device__ __forceinline__ void mma_rowsum(float (&d)[4], const float* lhs, const float* rhs, int n0, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < N; k0 += 8) {
    uint32_t ah[4], al[4], bh[2], bl[2];
    tf32_split(lhs[gid * LDP + k0 + tig], ah[0], al[0]);
    tf32_split(lhs[(gid + 8) * LDP + k0 + tig], ah[1], al[1]);
    tf32_split(lhs[gid * LDP + k0 + tig + 4], ah[2], al[2]);
    tf32_split(lhs[(gid + 8) * LDP + k0 + tig + 4], ah[3], al[3]);
    tf32_split(rhs[(n0 + gid) * LDP + k0 + tig], bh[0], bl[0]);
    tf32_split(rhs[(n0 + gid) * LDP + k0 + tig + 4], bh[1], bl[1]);
    mma_tf32(d, al, bh);
    mma_tf32(d, ah, bl);
    mma_tf32(d, ah, bh);
  }
}

// P_R and dKbar as row_sums computes them, on the tensor cores: warp w forms
// column tile w (columns 8 w .. 8 w + 8) of each
__device__ __forceinline__ void row_sums_mma(int tid, const float* dyt, const float* vt, const float* z0,
                                             const float* zd, float* pr, float* pk) {
  const int warp = tid / 32, lane = tid % 32, gid = lane >> 2, tig = lane & 3;
  float dp[4], dq[4];
  mma_rowsum(dp, dyt, z0, 8 * warp, lane);
  mma_rowsum(dq, vt, zd, 8 * warp, lane);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int o = (gid + 8 * (e / 2)) * LDP + 8 * warp + 2 * tig + e % 2;
    pr[o] = dp[e];
    pk[o] = dq[e];
  }
  __syncthreads();
}

"""
WKV6BWD_VARIANTS = {
    "base": ([], None, True),
    # 16 / 64 value rows a first-pass block at B*H = 64 (256 / 64 blocks)
    "rows16": ([], 256, True),
    "rows64": ([], 64, True),
    # the second pass's row sums P_R and dKbar as 3xTF32 mma.sync m16n8k8
    # (a warp a column tile of each) in place of the FMA register tiles
    "mma": ([(_P2_ANCHOR, _P2_MMA + _P2_ANCHOR),
             ("  row_sums(tid, dyt, vt, z0, zd, pr, pk);", "  row_sums_mma(tid, dyt, vt, z0, zd, pr, pk);")],
            None, True),
    # the pair walk two steps at a time (four in the source)
    "pairs2": ([("constexpr int CB_QS = 4;", "constexpr int CB_QS = 2;")], None, True),
    # the first pass's A stored transposed, so that dv's sums read rows of it
    "p1_at": ([("          if (s < t) am[t * CHUNK + s] = acc[m];",
                "          if (s < t) am[MODE == 2 ? s * CHUNK + t : t * CHUNK + s] = acc[m];"),
               ("          if (s >= ts[o]) ys[o] = fmaf(am[s * CHUNK + ts[o]], vs, ys[o]);",
                "          if (s >= ts[o]) ys[o] = fmaf(am[ts[o] * CHUNK + s], vs, ys[o]);")], None, True),
    # the second pass's register budget for two blocks a multiprocessor (three)
    "p2_occ2": ([("__launch_bounds__(CB_THREADS, 3) wkv6_bwd_chunk_kernel(",
                  "__launch_bounds__(CB_THREADS, 2) wkv6_bwd_chunk_kernel(")], None, True),
    "no_pass1": ([("  int e;\n  switch (rows) {", "  int e = 0;\n  if (rows < 0) switch (rows) {")], None, False),
    "no_pass2": ([("  static hopper_host::SmemOptIn opt_in;\n  e = opt_in(kernel, smem);",
                   "  return 0;\n  static hopper_host::SmemOptIn opt_in;\n  e = opt_in(kernel, smem);")], None, False),
    "no_p2_rowsums": ([("for (int i4 = 8 * half; i4 < 8 * half + 8; ++i4) {",
                        "for (int i4 = 8 * half; i4 < 8 * half; ++i4) {")], None, False),
    "no_p2_pairs": ([("    for (int s = 0; s < CHUNK; ++s) {\n      const int o = s * LDP + j;",
                      "    for (int s = 0; s < 0; ++s) {\n      const int o = s * LDP + j;")], None, False),
}
WKV6BWD_CASES = ((2, 2048, 32, "bfloat16"), (2, 2048, 32, "float32"))
# K2 / K4 (csrc/wkv7.cu): name -> ([(text in wkv7.cu, replacement)], the
# value rows a block at every case (in place of wkv7_cuda.step_plan's) or
# None for the plan's, exact). "bulk" brings the block's slice of the state
# into shared memory by cp.async.bulk (one copy for K2's contiguous slice,
# one a row for K4's, completing on an mbarrier) while the threads load the
# vectors and form w, in place of the register loads; "vec8" has 8-byte
# accesses (2 fp32 or 4 bf16 columns a lane, rows of 32 or 16 lanes);
# "threads128" gives a thread two rows past 128 threads a block (256 in the
# source).
_BULK_COPY = """// one bulk asynchronous copy of `bytes` from device to shared memory, completing on bar
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\\n"
               ::"r"(hopper::smem_u32(smem)), "l"(gmem), "r"(bytes), "r"(hopper::smem_u32(bar))
               : "memory");
}

"""
_BULK_ANCHOR = "// Block (bh, slice): value rows row0 .. row0 + ROWS of head bh."
_STEP_LOADS = """  uint32_t u[PARTS][W];
#pragma unroll
  for (int p = 0; p < PARTS; ++p) load_words<W>(s_in + base + (i0 + p) * row_stride + j0, u[p]);
"""
_BULK_LOADS = """  constexpr uint32_t ROW_BYTES = N * sizeof(StepState<DT>);
  __shared__ __align__(128) StepState<DT> slice[ROWS * N];
  __shared__ uint64_t bar;
  const int row0 = (blockIdx.x % SLICES) * ROWS;
  if (threadIdx.x == 0) {
    hopper::mbar_init(&bar, 1);
    hopper::fence_barrier_init();
    hopper::mbar_arrive_expect_tx(&bar, ROWS * ROW_BYTES);
    if (FLAT) {
      for (int i = 0; i < ROWS; ++i) bulk_copy(slice + i * N, s_in + base + (row0 + i) * row_stride, ROW_BYTES, &bar);
    } else {
      bulk_copy(slice, s_in + base + (size_t)row0 * N, ROWS * ROW_BYTES, &bar);
    }
  }
  uint32_t u[PARTS][W];
"""
_STEP_W = """  for (int j = 0; j < CPL; ++j) ww[j] = expf(-expf(ww[j]));
"""
_BULK_W = _STEP_W + """  __syncthreads();
  hopper::mbar_wait(&bar, 0);
#pragma unroll
  for (int p = 0; p < PARTS; ++p) load_words<W>(slice + (i0 - row0 + p) * N + j0, u[p]);
"""
WKV7STEP_VARIANTS = {
    "base": ([], None, True),
    "rows8": ([], 8, True),
    "rows16": ([], 16, True),
    "rows32": ([], 32, True),
    "rows64": ([], 64, True),
    "bulk": ([(_BULK_ANCHOR, _BULK_COPY + _BULK_ANCHOR), (_STEP_LOADS, _BULK_LOADS), (_STEP_W, _BULK_W)], None, True),
    "vec8": ([("constexpr int STEP_VEC = 16;", "constexpr int STEP_VEC = 8;")], None, True),
    "threads128": ([("constexpr int STEP_THREADS = 256;", "constexpr int STEP_THREADS = 128;")], None, True),
}
# K2 / K4 timed: (kernel, B, state dtype) at H=32, L2-hot and L2-cold
WKV7STEP_CASES = tuple((kernel, B, dname) for B in (1, 4, 32) for dname in ("float32", "bfloat16")
                       for kernel in ("wkv7_step", "wkv7_step_flat"))
# K10 (csrc/wkv_step.cuh's body built through wkv6.cu): name -> ([(text,
# replacement)], value rows a block at every case in place of
# wkv6_cuda.step_plan's, or None, exact). "vec8" has 8-byte state accesses.
WKV6STEP_VARIANTS = {
    "base": ([], None, True),
    "rows8": ([], 8, True),
    "rows16": ([], 16, True),
    "rows32": ([], 32, True),
    "rows64": ([], 64, True),
    "vec8": ([("constexpr int STEP_VEC = 16;", "constexpr int STEP_VEC = 8;")], None, True),
}
# K10 timed: (kernel, B, state dtype) at H=64, L2-hot and L2-cold
WKV6STEP_CASES = tuple(("wkv6_step", B, dname) for B in (1, 4, 32) for dname in ("float32", "bfloat16"))
# K17 / K18: name -> ([(text in wkv4.cu, replacement)], {wkv4_cuda plan
# constant: value} or None, exact). The chunk slots a block at most and the
# steps a chunk at most (so the chunk length and the rounds at T = 1056:
# "slots32" K17 32 chunks of 33 steps in one round, K18 16 slots; "chunk8"
# K17 three rounds of 64 chunks of 6, K18 five rounds of 32 of 7), the steps
# a slot at least at small T ("min_chunk2", "min_chunk4": the adapter's B=8
# T=64 in 32 chunks of 2, or 16 of 4, in place of 8 of 8), the channels a
# block ("ch8", "ch32":
# CH, so two slots a warp become four or one), "no_cp_async" (k, v, dy staged
# one element a lane, with plain loads) and "fast_math" (the exps and K17's
# divide on the approximate special-function unit: another rounding; its
# error is printed, not held)
_CH = "constexpr int CH = 16;"
WKV4_VARIANTS = {
    "base": ([], None, True),
    "slots32": ([], {"FWD_SLOTS": 32, "FWD_MAX_CHUNK": 40, "BWD_SLOTS": 16, "BWD_MAX_CHUNK": 24}, True),
    "chunk8": ([], {"FWD_MAX_CHUNK": 8, "BWD_MAX_CHUNK": 8}, True),
    "min_chunk2": ([], {"MIN_CHUNK": 2}, True),
    "min_chunk4": ([], {"MIN_CHUNK": 4}, True),
    "ch8": ([(_CH, "constexpr int CH = 8;")], {"CHANNELS": 8, "FWD_SLOTS": 128, "BWD_SLOTS": 64}, True),
    "ch32": ([(_CH, "constexpr int CH = 32;")], {"CHANNELS": 32, "FWD_SLOTS": 32, "BWD_SLOTS": 16}, True),
    "no_cp_async": ([("const bool tile_vec = vec && f.c0 + CH <= C;", "const bool tile_vec = false;")], None,
                    True),
    "fast_math": ([("= expf(", "= __expf("),
                   ("(e1 * aa + e2 * vt) / (e1 * bb + e2)", "__fdividef(e1 * aa + e2 * vt, e1 * bb + e2)")],
                  None, False),
}
# K17 timed: (B, T, C, k/v dtype) of the x040 prefill, fp32 as the model
# passes them; K18 timed: those and the v4 adapter's B=8 T=64
WKV4_VARIANT_CASES = ((1, 1056, 2048, "float32"), (4, 1056, 2048, "float32"))
WKV4_BWD_VARIANT_CASES = WKV4_VARIANT_CASES + ((8, 64, 2048, "float32"),)
# K16: name -> ([(text in wkv7_v2.cu, replacement)], None, exact): phase 2's
# value columns a block (with bf16 streams chosen by the blocks to reach,
# V2_BLOCKS; V2_COLS_F32 with fp32 streams), its chunks of operands in flight
# (V2_STAGES; 1: no prefetch) and the scratch type with bf16 streams. The "no_*" variants leave a part of phase 1 with bf16
# streams out (their results are wrong), to show its share.
V2_VARIANTS = {
    "base": ([], None, True),
    "cols16": ([("  return bh >= V2_BLOCKS ? 64 : 2 * bh >= V2_BLOCKS ? 32 : 16;", "  return 16;")], None, True),
    "cols32": ([("  return bh >= V2_BLOCKS ? 64 : 2 * bh >= V2_BLOCKS ? 32 : 16;", "  return 32;")], None, True),
    "cols64": ([("  return bh >= V2_BLOCKS ? 64 : 2 * bh >= V2_BLOCKS ? 32 : 16;", "  return 64;")], None, True),
    "f32_cols16": ([("constexpr int V2_COLS_F32 = 8;", "constexpr int V2_COLS_F32 = 16;")], None, True),
    "stages1": ([("constexpr int V2_STAGES = 3;", "constexpr int V2_STAGES = 1;")], None, True),
    "stages2": ([("constexpr int V2_STAGES = 3;", "constexpr int V2_STAGES = 2;")], None, True),
    "scratch_f32": ([("using V2Scratch = bf16;", "using V2Scratch = float;")], None, True),
    # phase 1's bf16 outputs stored from the fragments (4 bytes of 8 rows an
    # instruction) in place of whole rows from the warp's staging rows
    "unstaged": ([("constexpr bool STAGED = sizeof(SC) == 2;", "constexpr bool STAGED = false;")], None, True),
    "no_loads": ([("for (int i = 0; i < 8; ++i) wraw[i] = pair(w + g0 + i * ts);",
                   "for (int i = 0; i < 8; ++i) wraw[i] = 0xbf80bf00u + i;"),
                  ("raw[0][i] = pair(r + gi), raw[1][i] = pair(k + gi), raw[2][i] = pair(a + gi);\n"
                   "    raw[3][i] = pair(b + gi), raw[4][i] = pair(v + gi);",
                   "raw[0][i] = raw[1][i] = raw[2][i] = raw[3][i] = raw[4][i] = 0x3f003e80u + (uint32_t)gi % 7;")],
                 None, False),
    "no_mnm": ([("for (int jj = 0; jj < NH; jj += 4) {", "for (int jj = 0; jj < 0; jj += 4) {")], None, False),
    "no_sbsk": ([("for (int ks = 0; ks < NH / 16; ++ks) {\n      uint32_t af[4];\n      load_a(af, RT,",
                  "for (int ks = 0; ks < 0; ++ks) {\n      uint32_t af[4];\n      load_a(af, RT,")], None, False),
    "no_nv": ([("for (int s2 = 0; s2 < tq8 + 24; s2 += 2) {", "for (int s2 = 0; s2 < 0; s2 += 2) {")], None, False),
    "no_solve": ([("      for (int s = 0; s < t; ++s) acc = fmaf(MM[t * LDMM + s], u[s], acc);\n", "")], None, False),
    "no_products": ([("for (int nt = 0; nt < NH / 8; ++nt) {", "for (int nt = 0; nt < 0; ++nt) {"),
                     ("for (int nt = 0; nt < 4; ++nt) {\n      const int n0 = nb", "for (int nt = 0; nt < 0; ++nt) {\n      const int n0 = nb")],
                    None, False),
}
# K16 timed: (B, T, H, stream dtype), chip_smoke.check_wkv7_v2's cases
V2_CASES = ((8, 512, 32, "bfloat16"), (1, 1024, 32, "bfloat16"), (1, 1024, 32, "float32"))
# K8 and K7 timed: (kernel, B, T, H, stream dtype)
WKV6_CASES = (("wkv6_fwd_res", 2, 2048, 32, "bfloat16"), ("wkv6_fwd_res", 2, 2048, 32, "float32"),
              ("wkv6_fwd", 1, 624, 64, "bfloat16"), ("wkv6_fwd", 4, 624, 64, "bfloat16"))


def build(names, source="attention", variants=VARIANTS, headers=()):
    """Compile the variants of ``csrc/<source>.cu``, one nvcc each, all
    started together, into ``build/variants/<source>/<name>/``; returns
    {name: loaded library}. The
    substitutions apply, in order, to the source and ``csrc/<header>`` for
    each of ``headers`` (each in every file that holds its text); the
    headers are written beside the copy of the source (and so included in
    place of the originals)."""
    from visualrwkv_torch import cuda_build

    targets = (f"{source}.cu",) + tuple(headers)
    srcs = {t: open(os.path.join(cuda_build.CSRC_DIR, t)).read() for t in targets}
    nvcc, procs = cuda_build.find_nvcc(), {}
    variant_dir = lambda name: os.path.join(cuda_build.BUILD_DIR, "variants", source, name)
    for name in names:
        out_dir = variant_dir(name)
        os.makedirs(out_dir, exist_ok=True)
        texts = dict(srcs)
        subs = variants[name] if source == "attention" else variants[name][0]
        for old, new in subs:
            where = [t for t in targets if old in texts[t]]
            assert where, (name, old)
            for t in where:
                texts[t] = texts[t].replace(old, new)
        for t, text in texts.items():
            with open(os.path.join(out_dir, t), "w") as f:
                f.write(text)
        path = os.path.join(out_dir, f"{source}.cu")
        cmd = [nvcc, *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", cuda_build.CSRC_DIR,
               "-o", os.path.join(out_dir, f"lib{source}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        for line in out.splitlines():
            if any(w in line for w in ("registers", "spill stores", "C751", "C752")) and \
                    "0 bytes spill stores, 0 bytes spill loads" not in line:
                print(f"  [{name}] {line.strip()[:200]}", flush=True)
        lib = ctypes.CDLL(os.path.join(variant_dir(name), f"lib{source}.so"))
        lib.vrwkv_error_string.argtypes = [ctypes.c_int]
        lib.vrwkv_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def time_wkv6(names, libs, dev) -> int:
    """K8 and K7 at ``WKV6_CASES`` under each variant, in turns."""
    import torch

    import chip_smoke as cs
    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.ops import wkv6 as pw
    from visualrwkv_torch.ops import wkv6_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    for kernel, B, T, H, dname in WKV6_CASES:
        sdt = getattr(torch, dname)
        xs, u = cs._wkv6_streams(gen, (B, T, H, 64), sdt, dev)
        s0 = torch.randn(B, H, 64, 64, generator=gen, device=dev) * 0.3
        y_ref, s_ref = pw.wkv6_reference(*xs, u, s0, chunk=16)
        fn = getattr(wkv6_cuda, kernel)
        cases.append((f"{kernel} B={B} T={T} H={H} {dname}", lambda fn=fn, xs=xs, u=u, s0=s0: fn(*xs, u, s0, 16),
                      y_ref, s_ref, 1e-2 if sdt == torch.bfloat16 else 1e-3))
    times = {n: {c[0]: [] for c in cases} for n in names}
    blocks = wkv6_cuda.FWD_BLOCKS
    for name in names + names[::-1]:
        cuda_build._LIBS["wkv6"] = libs[name]
        _, plan_blocks, exact = WKV6_VARIANTS[name]
        wkv6_cuda.FWD_BLOCKS = blocks if plan_blocks is None else plan_blocks
        for case, run, y_ref, s_ref, ytol in cases:
            y, s = run()[:2]
            torch.cuda.synchronize()
            if exact:
                e_y, e_s = cs.rel_rms(y.float(), y_ref.float()), cs.rel_rms(s, s_ref)
                assert e_y <= ytol and e_s <= 1e-3, (name, case, e_y, e_s)
            times[name][case].append(cs.cuda_ms(run, reps=10))
    wkv6_cuda.FWD_BLOCKS = blocks
    for name in names:
        print("VARIANT " + json.dumps({"name": name, "ms": times[name]}), flush=True)
    return 0


def time_wkv7(names, libs, dev, variants=WKV7_VARIANTS, case_list=WKV7_CASES) -> int:
    """K5 at ``WKV7_CASES`` (or K1 / K11 at ``WKV7FWD_CASES``, each exact
    variant held against the fp32 sequential scan: y <= 1e-2 with bf16
    streams, 1e-3 with fp32, the final state 1e-3) under each variant, in
    turns."""
    import torch

    import chip_smoke as cs
    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.ops import wkv7 as pw
    from visualrwkv_torch.ops import wkv7_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    for kernel, B, T, H, dname in case_list:
        sdt = getattr(torch, dname)
        xs = cs._wkv_streams(gen, (B, T, H, 64), sdt, dev)
        s0 = torch.randn(B, H, 64, 64, generator=gen, device=dev) * 0.3
        ref = pw.wkv7_fwd_res_plain(*xs, s0) if kernel.startswith("wkv7_fwd_res") else \
            pw.wkv7_reference(*[x.float() for x in xs], s0)
        fn = getattr(wkv7_cuda, kernel)
        cases.append((f"{kernel} B={B} T={T} H={H} {dname}", lambda fn=fn, xs=xs, s0=s0: fn(*xs, s0),
                      ref, 1e-2 if sdt == torch.bfloat16 else 1e-3))
    times = {n: {c[0]: [] for c in cases} for n in names}
    blocks = wkv7_cuda.FWD_RES_BLOCKS
    for name in names + names[::-1]:
        for lib in libs[name]:
            cuda_build._LIBS[lib] = libs[name][lib]
        _, plan_blocks, exact = variants[name]
        wkv7_cuda.FWD_RES_BLOCKS = blocks if plan_blocks is None else plan_blocks
        for case, run, ref, ytol in cases:
            out = run()
            torch.cuda.synchronize()
            if exact:  # y, the final state (and zin)
                e = [cs.rel_rms(x.float(), r.float()) for x, r in zip(out, ref)]
                assert e[0] <= ytol and max(e[1:]) <= 1e-3, (name, case, e)
            times[name][case].append(cs.cuda_ms(run, reps=10))
    wkv7_cuda.FWD_RES_BLOCKS = blocks
    for name in names:
        print("VARIANT " + json.dumps({"name": name, "ms": times[name]}), flush=True)
    return 0


def time_wkv7bwd(names, libs, dev) -> int:
    """K6 at ``WKV7BWD_CASES`` (from K5's states, with an initial state and a
    non-zero final-state cotangent) under each variant, in turns; an exact
    variant's seven gradients held against ``wkv7_bwd_plain`` (2e-2 with
    bf16 streams, 1e-3 with fp32)."""
    import torch

    import chip_smoke as cs
    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.ops import wkv7 as pw
    from visualrwkv_torch.ops import wkv7_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    for B, T, H, dname in WKV7BWD_CASES:
        sdt = getattr(torch, dname)
        xs = cs._wkv_streams(gen, (B, T, H, 64), sdt, dev)
        s0 = torch.randn(B, H, 64, 64, generator=gen, device=dev) * 0.3
        dy = (torch.randn(B, T, H, 64, generator=gen, device=dev) * 0.5).to(sdt)
        dsf = torch.randn(B, H, 64, 64, generator=gen, device=dev) * 0.1
        _, _, zin = wkv7_cuda.wkv7_fwd_res(*xs, s0)
        ref = pw.wkv7_bwd_plain(*[x.float() for x in xs], zin, dy.float(), dsf)
        cases.append((f"wkv7_bwd B={B} T={T} H={H} {dname}",
                      lambda xs=xs, zin=zin, dy=dy, dsf=dsf: wkv7_cuda.wkv7_bwd(*xs, zin, dy, dsf),
                      ref, 2e-2 if sdt == torch.bfloat16 else 1e-3))
    times = {n: {c[0]: [] for c in cases} for n in names}
    blocks = wkv7_cuda.FWD_RES_BLOCKS
    for name in names + names[::-1]:
        cuda_build._LIBS["wkv7_train"] = libs[name]
        _, plan_blocks, exact = WKV7BWD_VARIANTS[name]
        wkv7_cuda.FWD_RES_BLOCKS = blocks if plan_blocks is None else plan_blocks
        for case, run, ref, tol in cases:
            grads = run()
            torch.cuda.synchronize()
            if exact:
                e = [cs.rel_rms(g.float(), r) for g, r in zip(grads, ref)]
                assert max(e) <= tol, (name, case, e)
            times[name][case].append(cs.cuda_ms(run, reps=5))
    wkv7_cuda.FWD_RES_BLOCKS = blocks
    for name in names:
        print("VARIANT " + json.dumps({"name": name, "ms": times[name]}), flush=True)
    return 0


def time_wkv6bwd(names, libs, dev) -> int:
    """K9 at ``WKV6BWD_CASES`` (from K8's states, with an initial state and a
    non-zero final-state cotangent) under each variant, in turns; an exact
    variant's six gradients held against ``wkv6_bwd_plain`` (2e-2 with bf16
    streams, 1e-3 with fp32)."""
    import torch

    import chip_smoke as cs
    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.ops import wkv6 as pw
    from visualrwkv_torch.ops import wkv6_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    for B, T, H, dname in WKV6BWD_CASES:
        sdt = getattr(torch, dname)
        xs, u = cs._wkv6_streams(gen, (B, T, H, 64), sdt, dev)
        s0 = torch.randn(B, H, 64, 64, generator=gen, device=dev) * 0.3
        dy = (torch.randn(B, T, H, 64, generator=gen, device=dev) * 0.5).to(sdt)
        dsf = torch.randn(B, H, 64, 64, generator=gen, device=dev) * 0.1
        _, _, zin = wkv6_cuda.wkv6_fwd_res(*xs, u, s0, 16)
        ref = pw.wkv6_bwd_plain(*[x.float() for x in xs], u, zin, dy.float(), dsf)
        cases.append((f"wkv6_bwd B={B} T={T} H={H} {dname}",
                      lambda xs=xs, u=u, zin=zin, dy=dy, dsf=dsf: wkv6_cuda.wkv6_bwd(*xs, u, zin, dy, dsf, 16),
                      ref, 2e-2 if sdt == torch.bfloat16 else 1e-3))
    times = {n: {c[0]: [] for c in cases} for n in names}
    blocks = wkv6_cuda.FWD_BLOCKS
    for name in names + names[::-1]:
        cuda_build._LIBS["wkv6_train"] = libs[name]
        _, plan_blocks, exact = WKV6BWD_VARIANTS[name]
        wkv6_cuda.FWD_BLOCKS = blocks if plan_blocks is None else plan_blocks
        for case, run, ref, tol in cases:
            grads = run()
            torch.cuda.synchronize()
            if exact:
                e = [cs.rel_rms(g.float(), r) for g, r in zip(grads, ref)]
                assert max(e) <= tol, (name, case, e)
            times[name][case].append(cs.cuda_ms(run, reps=5))
    wkv6_cuda.FWD_BLOCKS = blocks
    for name in names:
        print("VARIANT " + json.dumps({"name": name, "ms": times[name]}), flush=True)
    return 0


def time_step(names, libs, dev, family=7) -> int:
    """K2 / K4 at ``WKV7STEP_CASES`` (``family`` 7) or K10 at
    ``WKV6STEP_CASES`` (6) under each variant, in turns, L2-hot
    (:func:`chip_smoke.cuda_ms`) and L2-cold (:func:`chip_smoke.cold_ms`);
    each exact variant held against the plain step (y <= 1e-3, the new state
    1e-3 fp32, 1e-2 bf16)."""
    import torch

    import chip_smoke as cs
    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.ops import wkv6 as pw6
    from visualrwkv_torch.ops import wkv6_cuda
    from visualrwkv_torch.ops import wkv7 as pw
    from visualrwkv_torch.ops import wkv7_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    for kernel, B, dname in (WKV7STEP_CASES if family == 7 else WKV6STEP_CASES):
        sdt = getattr(torch, dname)
        if family == 7:
            vecs, s0 = cs._step_inputs(gen, B, 32, sdt, dev)
            if kernel == "wkv7_step_flat":
                s0 = pw.state_to_flat(s0).contiguous()
            s_ref, y_ref = getattr(pw, kernel)(s0.float(), *vecs)
            fn = getattr(wkv7_cuda, kernel)
        else:
            vecs, u = cs._wkv6_streams(gen, (B, 64, 64), torch.float32, dev)
            vecs = (*vecs, u)
            s0 = (torch.randn(B, 64, 64, 64, generator=gen, device=dev) * 0.3).to(sdt)
            s_ref, y_ref = pw6.wkv6_step(s0.float(), *vecs)
            fn = wkv6_cuda.wkv6_step
        cases.append((f"{kernel} B={B} {dname}", fn, s0, vecs, s_ref, y_ref, 1e-3 if sdt == torch.float32 else 1e-2))
    times = {n: {f"{c[0]} {t}": [] for c in cases for t in ("hot", "cold")} for n in names}
    mod, lib_name, variants = ((wkv7_cuda, "wkv7", WKV7STEP_VARIANTS) if family == 7
                               else (wkv6_cuda, "wkv6", WKV6STEP_VARIANTS))
    plan = mod.step_plan
    for name in names + names[::-1]:
        cuda_build._LIBS[lib_name] = libs[name]
        _, plan_rows, exact = variants[name]
        mod.step_plan = plan if plan_rows is None else \
            (lambda *a, rows=plan_rows, **kw: {**plan(*a, **kw), "rows": rows})
        for case, fn, s0, vecs, s_ref, y_ref, stol in cases:
            s, y = fn(s0, *vecs)
            torch.cuda.synchronize()
            if exact:
                e_y, e_s = cs.rel_rms(y, y_ref), cs.rel_rms(s.float(), s_ref.float())
                assert e_y <= 1e-3 and e_s <= stol, (name, case, e_y, e_s)
            times[name][f"{case} hot"].append(cs.cuda_ms(lambda fn=fn, s0=s0, vecs=vecs: fn(s0, *vecs), reps=50))
            times[name][f"{case} cold"].append(cs.cold_ms(lambda st, fn=fn, vecs=vecs: fn(st, *vecs), s0))
    mod.step_plan = plan
    for name in names:
        print("VARIANT " + json.dumps({"name": name, "ms": times[name]}), flush=True)
    return 0


def time_wkv4(names, libs, dev) -> int:
    """K17 at ``WKV4_VARIANT_CASES`` and K18 at ``WKV4_BWD_VARIANT_CASES``
    under each variant, in turns (each variant's plan constants set on
    ``wkv4_cuda`` for its turn), each exact variant held against the plain
    walks in float64 (y and the final state relative RMS <= 1e-5, every
    gradient <= 1e-4); each case's chunk plan printed."""
    import torch

    import chip_smoke as cs
    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.ops import wkv4 as pw
    from visualrwkv_torch.ops import wkv4_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    f64 = lambda xs: [None if x is None else x.double() for x in xs]
    cases = []
    for kernel, case_list in (("wkv4_fwd", WKV4_VARIANT_CASES), ("wkv4_bwd", WKV4_BWD_VARIANT_CASES)):
        for B, T, C, dname in case_list:
            w, u, k, v, s0 = cs._wkv4_inputs(gen, B, T, C, dname, False, B > 1, dev)
            if kernel == "wkv4_bwd":
                dy = torch.randn(B, T, C, generator=gen, device=dev)
                ds = None if s0 is None else torch.randn(B, C, 3, generator=gen, device=dev)
                xs = (w, u, k, v, s0, dy, ds)
                ref, tol = pw.wkv4_bwd_plain(*f64(xs)), 1e-4
            else:
                xs = (w, u, k, v, s0)
                ref, tol = pw.wkv4_plain(*f64(xs)), 1e-5
            cases.append((f"{kernel} B={B} T={T} C={C} {dname}", getattr(wkv4_cuda, kernel), xs, ref, tol))
    consts = ("CHANNELS", "FWD_SLOTS", "BWD_SLOTS", "FWD_MAX_CHUNK", "BWD_MAX_CHUNK", "MIN_CHUNK")
    saved = {c: getattr(wkv4_cuda, c) for c in consts}
    times = {n: {c[0]: [] for c in cases} for n in names}
    for turn, name in enumerate(names + names[::-1]):
        cuda_build._LIBS["wkv4"] = libs[name]
        for c, val in {**saved, **(WKV4_VARIANTS[name][1] or {})}.items():
            setattr(wkv4_cuda, c, val)
        for case, fn, xs, ref, tol in cases:
            if turn < len(names):
                B, T, C = xs[2].shape
                plan = (wkv4_cuda.fwd_plan if fn is wkv4_cuda.wkv4_fwd else wkv4_cuda.bwd_plan)(B, T, C)
                print(f"  {name} [{case}] plan {plan}", flush=True)
            got = [g for g in fn(*xs) if g is not None]
            torch.cuda.synchronize()
            errs = [cs.rel_rms(g, r) for g, r in zip(got, [r for r in ref if r is not None])]
            if turn < len(names):
                print(f"  {name} [{case}] rel_rms against the float64 walk {['%.3e' % e for e in errs]}", flush=True)
            if WKV4_VARIANTS[name][2]:
                assert max(errs) <= tol, (name, case, errs)
            times[name][case].append(cs.cuda_ms(lambda fn=fn, xs=xs: fn(*xs)))
    for c, val in saved.items():
        setattr(wkv4_cuda, c, val)
    for name in names:
        print("VARIANT " + json.dumps({"name": name, "ms": times[name]}), flush=True)
    return 0


def time_v2(names, libs, dev) -> int:
    """K16 at ``V2_CASES`` under each variant, in turns: the whole call and
    each phase alone (``wkv7_cuda.wkv7_fwd_v2_phase``); each exact variant
    held against ``wkv7_v2_plain``."""
    import torch

    import chip_smoke as cs
    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.ops import wkv7 as pw
    from visualrwkv_torch.ops import wkv7_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    for B, T, H, dname in V2_CASES:
        xs = cs._wkv_streams(gen, (B, T, H, 64), getattr(torch, dname), dev)
        s0 = torch.randn(B, H, 64, 64, generator=gen, device=dev) * 0.3
        cases.append((f"B={B} T={T} {dname}", xs, s0, pw.wkv7_v2_plain(*[x.float() for x in xs], s0),
                      1e-2 if dname == "bfloat16" else 1e-3))
    times = {n: {f"{c[0]} {p}": [] for c in cases for p in ("ms", "phase1", "phase2")} for n in names}
    for name in names + names[::-1]:
        cuda_build._LIBS["wkv7_v2"] = libs[name]
        for case, xs, s0, (y_ref, s_ref), tol in cases:
            y, s = wkv7_cuda.wkv7_fwd_v2(*xs, s0)
            torch.cuda.synchronize()
            if V2_VARIANTS[name][2]:
                e_y, e_s = cs.rel_rms(y.float(), y_ref), cs.rel_rms(s, s_ref)
                assert e_y <= tol and e_s <= tol, (name, case, e_y, e_s)
            bufs = wkv7_cuda.v2_buffers(xs[0])
            times[name][f"{case} ms"].append(cs.cuda_ms(lambda: wkv7_cuda.wkv7_fwd_v2(*xs, s0), reps=10))
            for p in (1, 2):
                times[name][f"{case} phase{p}"].append(
                    cs.cuda_ms(lambda p=p: wkv7_cuda.wkv7_fwd_v2_phase(p, *xs, s0, bufs), reps=10))
            del bufs
    for name in names:
        print("VARIANT " + json.dumps({"name": name, "ms": times[name]}), flush=True)
    return 0


def main(argv) -> int:
    kinds = ("wkv6", "wkv6bwd", "wkv7", "wkv7fwd", "wkv7bwd", "wkv7step", "wkv6step", "v2", "wkv4")
    kind = argv[0][2:] if argv and argv[0][2:] in kinds and argv[0][:2] == "--" else None
    argv = argv[1:] if kind else argv
    known = {"wkv6": WKV6_VARIANTS, "wkv6bwd": WKV6BWD_VARIANTS, "wkv7": WKV7_VARIANTS,
             "wkv7fwd": WKV7FWD_VARIANTS, "wkv7bwd": WKV7BWD_VARIANTS, "wkv7step": WKV7STEP_VARIANTS,
             "wkv6step": WKV6STEP_VARIANTS, "v2": V2_VARIANTS, "wkv4": WKV4_VARIANTS, None: VARIANTS}[kind]
    names = argv or list(known)
    bad = [n for n in names if n not in known]
    if bad:
        print(f"unknown variants {bad}; known: {list(known)}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_ab
    import chip_smoke as cs
    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.vision import flash as pf

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    if kind == "wkv6":
        return time_wkv6(names, build(names, "wkv6", WKV6_VARIANTS, headers=("wkv6_chunk.cuh",)), dev)
    if kind == "wkv6bwd":
        return time_wkv6bwd(names, build(names, "wkv6_train", WKV6BWD_VARIANTS,
                                         headers=("wkv6_chunk_bwd.cuh", "wkv6_chunk.cuh")), dev)
    if kind == "wkv7":
        libs = build(names, "wkv7", WKV7_VARIANTS, headers=("wkv7_chunk.cuh",))
        return time_wkv7(names, {n: {"wkv7": lib} for n, lib in libs.items()}, dev)
    if kind == "wkv7fwd":
        # wkv7_packed.cu reaches wkv7_chunk.cuh through wkv7_chunk_bwd.cuh: both are copied
        libs = {src: build(names, src, WKV7FWD_VARIANTS, headers=("wkv7_chunk.cuh", "wkv7_chunk_bwd.cuh"))
                for src in ("wkv7", "wkv7_packed")}
        return time_wkv7(names, {n: {src: libs[src][n] for src in libs} for n in names}, dev,
                         WKV7FWD_VARIANTS, WKV7FWD_CASES)
    if kind == "wkv7step":
        return time_step(names, build(names, "wkv7", WKV7STEP_VARIANTS, headers=("wkv_step.cuh",)), dev)
    if kind == "v2":
        return time_v2(names, build(names, "wkv7_v2", V2_VARIANTS), dev)
    if kind == "wkv4":
        return time_wkv4(names, build(names, "wkv4", WKV4_VARIANTS), dev)
    if kind == "wkv6step":
        return time_step(names, build(names, "wkv6", WKV6STEP_VARIANTS, headers=("wkv_step.cuh",)), dev, 6)
    if kind == "wkv7bwd":
        return time_wkv7bwd(names, build(names, "wkv7_train", WKV7BWD_VARIANTS, headers=("wkv7_chunk_bwd.cuh",)),
                            dev)
    libs = build(names)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf, cases = torch.bfloat16, []
    for layout, G, a1, a2, hd, case in chip_ab.K3_CASES:
        scale = hd**-0.5
        if layout == "sam":
            N = a1 * a2
            q, k, v = (torch.randn(G, N, hd, generator=gen, device=dev).to(bf) for _ in range(3))
            rel_h = torch.randn(G, N, a1, generator=gen, device=dev)
            rel_w = torch.randn(G, N, a2, generator=gen, device=dev)
        else:
            q, k, v = (torch.randn(1, a1, G, hd, generator=gen, device=dev).to(bf) for _ in range(3))
            rel_h = rel_w = None
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = cs.cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), reps=50)
            print(f"  {case}: SDPA forward {sdpa:.4f} ms", flush=True)
        args = (q, k, v, rel_h, rel_w, scale, layout)
        # timed as the serving path calls it (no lse)
        if layout == "sam":
            run = lambda a=args: pf.sam_attention(*a[:6])
        else:
            run = lambda a=args: pf.mha(*a[:3])
        cases.append((case, args, run, pf.attention_fwd_plain(*args), 20 if G == 12 else 50))
    times = {n: {c[0]: [] for c in cases} for n in names}
    for name in names + names[::-1]:
        cuda_build._LIBS["attention"] = libs[name]
        for case, args, run, (o_ref, lse_ref), reps in cases:
            o, lse = pf.attention_fwd(*args)
            torch.cuda.synchronize()
            e_o, e_lse = cs.rel_rms(o.float(), o_ref.float()), cs.rel_rms(lse, lse_ref)
            assert e_o <= 1e-2 and e_lse <= 1e-3, (name, case, e_o, e_lse)
            times[name][case].append(cs.cuda_ms(run, reps=reps))
    for name in names:
        print("VARIANT " + json.dumps({"name": name, "ms": times[name]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
