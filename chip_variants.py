#!/usr/bin/env python3
"""Variants of a kernel against each other on one card, in turns: the
attention forward K3 (``visualrwkv_torch/csrc/attention.cu``) or the WKV6
forward K7 / K8 (``csrc/wkv6.cu``).

    python3 chip_variants.py                       # every variant of K3 in VARIANTS
    python3 chip_variants.py base stages2          # some of them
    python3 chip_variants.py --wkv6 [names]        # K7 / K8: WKV6_VARIANTS

A variant is the source with text substitutions (each names the design
choice it undoes, or the part of the work it leaves out). Each is compiled
by ``nvcc`` into ``build/variants/<name>/``, all at once, and ptxas's
registers, spills and wgmma serialisation warnings are printed. Then, with
the loaded library swapped between turns (the variants in order, then in
reverse), K3 runs through the port's own wrappers at ``chip_ab.K3_CASES``,
held against its plain version (out relative RMS <= 1e-2, lse <= 1e-3) and
timed in CUDA graphs as the serving path calls it (``sam_attention``,
``mha``); or K8 and K7 run at ``WKV6_CASES`` through ``wkv6_cuda``, each
exact variant held against the floored scan (y <= 1e-2 with bf16 streams,
1e-3 with fp32, the final state 1e-3). The card's name and power limit come
first, the SDPA forward's time at each no-bias case next (K3), and one
``VARIANT {json}`` line a variant last (its times in turn order).
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
    "no_amatrix": ([("    if (c + 1 < nc) amatrix(c + 1);\n", "")], None, False),
    "no_factors": ([("    if (c + 1 < nc) factors(c + 1);\n", "")], None, False),
    "no_outputs": ([("    outputs(c);\n", "")], None, False),
    "no_update": ([("    update(c);\n", "")], None, False),
}
# K8 and K7 timed: (kernel, B, T, H, stream dtype)
WKV6_CASES = (("wkv6_fwd_res", 2, 2048, 32, "bfloat16"), ("wkv6_fwd_res", 2, 2048, 32, "float32"),
              ("wkv6_fwd", 1, 624, 64, "bfloat16"), ("wkv6_fwd", 4, 624, 64, "bfloat16"))


def build(names, source="attention", variants=VARIANTS):
    """Compile the variants of ``csrc/<source>.cu``, one nvcc each, all
    started together; returns {name: loaded library}."""
    from visualrwkv_torch import cuda_build

    src = open(os.path.join(cuda_build.CSRC_DIR, f"{source}.cu")).read()
    nvcc, procs = cuda_build.find_nvcc(), {}
    for name in names:
        out_dir = os.path.join(cuda_build.BUILD_DIR, "variants", name)
        os.makedirs(out_dir, exist_ok=True)
        s = src
        subs = variants[name][0] if source == "wkv6" else variants[name]
        for old, new in subs:
            assert old in s, (name, old)
            s = s.replace(old, new)
        path = os.path.join(out_dir, f"{source}.cu")
        with open(path, "w") as f:
            f.write(s)
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
        lib = ctypes.CDLL(os.path.join(cuda_build.BUILD_DIR, "variants", name, f"lib{source}.so"))
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


def main(argv) -> int:
    wkv6 = argv[:1] == ["--wkv6"]
    argv = argv[1:] if wkv6 else argv
    known = WKV6_VARIANTS if wkv6 else VARIANTS
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
    if wkv6:
        return time_wkv6(names, build(names, "wkv6", WKV6_VARIANTS), dev)
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
