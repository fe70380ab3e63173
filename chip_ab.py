#!/usr/bin/env python3
"""Two checkouts of the port on one card, in turns: kernels and paths of
their own ``chip_smoke.py``, each side in a fresh process.

    python3 chip_ab.py PARENT_DIR CHANGE_DIR [SECTION ...]   # parent, change, change, parent

Each side builds its kernels into its own ``build/``, then measures the
sections asked for (default: all of ``SECTIONS``), through its own wrappers:

- ``k3``: K3's device time and eager time (``sam_attention``, ``mha``) at
  every timed case of phase 2 (``K3_CASES``: SAM-B global at 1024, 768 and
  512 pixels with the rel-pos bias; DINOv2-L, SigLIP and CLIP-L without),
  then the eager time of a call too small for the card to bound it;
- ``attention_bwd``: K14, K15 and the pair at every case of its
  ``check_attention_bwd`` (with the SDPA backward beside them, and each
  kernel's eager time: device time or the host's cost of a call, whichever
  is larger);
- ``sam_grad``: SAM-B @1024's forward + backward to every parameter (phase
  7's ``run_tower_grad``: times and peak memory);
- ``x070``: on the flagship VisualRWKV-7 1B5 (seeded random bf16 weights,
  full width) the TTFT and decode rate of one request and of four, and the
  step times of the main training run (1 + 3 steps), the packed run (1 + 3)
  and ``grad_cp="wkv"`` (1 + 2);
- ``wkv6``: K7, K8 and K9 at every timed case of ``check_wkv6_fwd`` and
  ``check_wkv6_train``, and at ``chunk_len`` 8, 4 and 1 (``WKV6_CASES``),
  device and eager time (a case a side's wrappers refuse is recorded so);
- ``wkv7``: K5 and K12 at every timed case of ``check_wkv7_train`` and
  ``check_wkv7_packed_train``, with K1 at the same shape, and the
  backwards K6 and K13 there from K5's / K12's states (``WKV7_CASES``),
  device and eager time, and a digest of each call's outputs (equal
  digests on the two sides: bit-equal outputs);
- ``wkv7_prefill``: K1 and K11 at the prefill's shapes of
  ``check_wkv7_fwd`` and ``check_wkv7_fwd_packed`` (B=1 T=1056, bf16
  without and with an initial state, fp32 streams with one; K1 at the
  serving batch B=4) and at a ragged T (1049), ``WKV7_PREFILL_CASES``:
  device and eager time and the outputs' digest;
- ``wkv7_step``: the decode steps K2 and K4 at B = 1, 4 and 32 with fp32
  and bf16 states (``WKV7_STEP_CASES``), on one state a case: device time
  L2-hot and L2-cold (the state cycling over copies larger than the L2),
  eager time, and the outputs' digest (K4's state in the head layout, so
  that K2's and K4's digests are equal when their outputs are);
- ``wkv6_step``: the WKV6 decode step K10 at B = 1, 4 and 32 with fp32 and
  bf16 states at H=64 (``WKV6_STEP_CASES``), timed as ``wkv7_step`` (L2-hot,
  L2-cold, eager) with the outputs' digest;
- ``wkv7_v2``: the chunk-batched forward K16 at ``check_wkv7_v2``'s cases
  (``V2_CASES``): device and eager time, each phase alone where the side's
  wrappers offer ``wkv7_fwd_v2_phase`` (else null), and the outputs' digest;
- ``wkv4``: the RWKV-4 forward K17 at ``chip_smoke.WKV4_CASES`` and its VJP
  K18 at ``chip_smoke.WKV4_BWD_CASES`` (the same inputs on both sides):
  device and eager time and the outputs' digest;
- ``x070_prefill_profile``: the flagship's B=1 prefill (1024 + 32 tokens,
  fp32 state, after one unprofiled prefill) under the profiler: card busy,
  idle share and device ms by kind (``device_breakdown``);
- ``x060_serving``: VisualRWKV-6 7B (``x060_serving_cfg``) TTFT and decode
  rate at B=1 and B=4 (``run_serving``);
- ``x060_training``: VisualRWKV-6 1.6B (``x060_training_cfg``) step times
  and peak memory, 1 + 3 steps (``run_training``), then one profiled step
  of a model built again from its seed (``profile_training``): the
  gradient pass's card busy time, idle share and K8 / K9 device time.

One ``AB {json}`` line a side (with ptxas's registers and spills of its
attention, K7 / K8, K9, K5 / K12, K6 / K13, K2 / K4 / K10, K16, K17 and K18 kernels); the card's name and
power limit first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# K3's timed cases: (layout, groups or heads, grid rows or N, grid columns,
# head dim, name), B=1
K3_CASES = (("sam", 12, 64, 64, 64, "SAM-B global"), ("sam", 2, 48, 48, 64, "SAM-B at 768 px"),
            ("sam", 2, 32, 32, 64, "SAM-B at 512 px"), ("mha", 16, 1029, 0, 64, "DINOv2-L"),
            ("mha", 16, 1024, 0, 72, "SigLIP-so400m"), ("mha", 16, 577, 0, 64, "CLIP-L/336"))


def k3_times(cs, dev) -> list:
    """K3 at every case of ``K3_CASES`` through the tree's own wrappers:
    device time (CUDA graphs) and eager time, ms; then the eager time of a
    call too small for the card to bound it (the host's cost of a call)."""
    import torch

    from visualrwkv_torch.vision import flash as pf

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf, out = torch.bfloat16, []
    for layout, G, a1, a2, hd, name in K3_CASES:
        if layout == "sam":
            N = a1 * a2
            q, k, v = (torch.randn(G, N, hd, generator=gen, device=dev).to(bf) for _ in range(3))
            rel_h = torch.randn(G, N, a1, generator=gen, device=dev)
            rel_w = torch.randn(G, N, a2, generator=gen, device=dev)
            fn = lambda: pf.sam_attention(q, k, v, rel_h, rel_w, hd**-0.5)
        else:
            q, k, v = (torch.randn(1, a1, G, hd, generator=gen, device=dev).to(bf) for _ in range(3))
            fn = lambda: pf.mha(q, k, v)
        reps = 20 if G == 12 else 50
        out.append({"case": name, "ms": cs.cuda_ms(fn, reps=reps), "eager_ms": cs.eager_ms(fn, reps=reps)})
    # the host's cost of a call: back-to-back eager calls at a shape whose
    # kernel takes less (B=1, N=64, one head)
    q, k, v = (torch.randn(1, 64, 1, 64, generator=gen, device=dev).to(bf) for _ in range(3))
    out.append({"case": "host cost: B=1 N=64 h=1 hd=64", "eager_ms": cs.eager_ms(lambda: pf.mha(q, k, v), reps=500)})
    return out


SECTIONS = ("k3", "attention_bwd", "sam_grad", "x070", "wkv6", "wkv7", "wkv7_prefill", "wkv7_step",
            "wkv6_step", "wkv7_v2", "wkv4", "x070_prefill_profile", "x060_serving", "x060_training")
# K7 / K8 / K9 timed: (kernel, B, T, H, stream dtype, initial state,
# chunk_len), the timed cases of chip_smoke's check_wkv6_fwd (the x060 7B
# prefill) and check_wkv6_train (the 1.6B training step; K7 at the same
# shape beside K8; K9 from K8's states with a non-zero final-state
# cotangent), then the bf16 cases at each lower floor: chunk_len 8 (K7 / K8's
# factor form 1), 4 and 1 (the per-pair form)
WKV6_CASES = (("wkv6_fwd", 1, 624, 64, "bfloat16", False, 16), ("wkv6_fwd", 4, 624, 64, "bfloat16", True, 16),
              ("wkv6_fwd", 1, 624, 64, "float32", True, 16), ("wkv6_fwd_res", 2, 2048, 32, "bfloat16", True, 16),
              ("wkv6_fwd", 2, 2048, 32, "bfloat16", True, 16), ("wkv6_fwd_res", 2, 2048, 32, "float32", True, 16),
              ("wkv6_fwd", 2, 2048, 32, "float32", True, 16), ("wkv6_bwd", 2, 2048, 32, "bfloat16", True, 16),
              ("wkv6_bwd", 2, 2048, 32, "float32", True, 16)) + tuple(
    case for L in (8, 4, 1) for case in (("wkv6_fwd", 1, 624, 64, "bfloat16", False, L),
                                         ("wkv6_fwd_res", 2, 2048, 32, "bfloat16", True, L),
                                         ("wkv6_bwd", 2, 2048, 32, "bfloat16", True, L)))


def wkv6_times(cs, dev) -> list:
    """K7 / K8 / K9 at every case of ``WKV6_CASES`` through the tree's own
    wrappers: device time (CUDA graphs) and eager time, ms; a case the
    wrappers refuse (a parent without the floor's factor form) is recorded
    with the refusal."""
    import torch

    from visualrwkv_torch.ops import wkv6_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = []
    for kernel, B, T, H, dname, with_state, L in WKV6_CASES:
        sdt = getattr(torch, dname)
        case = f"{kernel} B={B} T={T} H={H} {dname} chunk_len={L}"
        xs, u = cs._wkv6_streams(gen, (B, T, H, 64), sdt, dev)
        s0 = torch.randn(B, H, 64, 64, generator=gen, device=dev) * 0.3 if with_state else None
        try:
            if kernel == "wkv6_bwd":
                zin = wkv6_cuda.wkv6_fwd_res(*xs, u, s0, L)[2]
                dy = (torch.randn(B, T, H, 64, generator=gen, device=dev) * 0.5).to(sdt)
                dsf = torch.randn(B, H, 64, 64, generator=gen, device=dev) * 0.1
                fn = lambda xs=xs, u=u, zin=zin, dy=dy, dsf=dsf, L=L: wkv6_cuda.wkv6_bwd(*xs, u, zin, dy, dsf, L)
            else:
                fn = lambda kernel=kernel, xs=xs, u=u, s0=s0, L=L: getattr(wkv6_cuda, kernel)(*xs, u, s0, L)
            fn()
        except ValueError as e:
            out.append({"case": case, "refused": str(e)})
            continue
        reps = 3 if kernel == "wkv6_bwd" else 5 if T == 2048 else 20
        out.append({"case": case, "ms": cs.cuda_ms(fn, reps=reps), "eager_ms": cs.eager_ms(fn, reps=reps)})
        del xs, s0, fn
    return out


# K5 / K12, K6 / K13 timed: (kernel, B, T, H, stream dtype), with an initial
# state (and for K6 / K13 a non-zero final-state cotangent): the timed cases
# of chip_smoke's check_wkv7_train and check_wkv7_packed_train (the x070 1B5
# training step), K1 at the same shape beside them
WKV7_CASES = tuple((kernel, 2, 2048, 32, dname) for dname in ("bfloat16", "float32")
                   for kernel in ("wkv7_fwd_res", "wkv7_fwd_res_packed", "wkv7_fwd", "wkv7_bwd",
                                  "wkv7_bwd_packed"))


# K1 / K11 timed: (kernel, B, T, H, stream dtype, initial state)
WKV7_PREFILL_CASES = (("wkv7_fwd", 1, 1056, 32, "bfloat16", False), ("wkv7_fwd", 1, 1056, 32, "bfloat16", True),
                      ("wkv7_fwd", 1, 1056, 32, "float32", True), ("wkv7_fwd", 4, 1056, 32, "bfloat16", True),
                      ("wkv7_fwd_packed", 1, 1056, 32, "bfloat16", True),
                      ("wkv7_fwd_packed", 1, 1056, 32, "float32", True), ("wkv7_fwd", 1, 1049, 32, "bfloat16", True))


def digest(outs) -> str:
    """sha256 of the bytes of a call's output tensors, in order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for x in outs:
        h.update(x.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def wkv7_times(cs, dev, cases=None) -> list:
    """K5 / K12 (and K1), K6 / K13 at every case of ``WKV7_CASES`` (or K1 /
    K11 at ``WKV7_PREFILL_CASES``) through the tree's own wrappers: device
    time (CUDA graphs), eager time, ms, and the digest of the outputs. A
    backward reads the states its forward (K5 / K12) saved."""
    import torch

    from visualrwkv_torch.ops import wkv7_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = []
    for case in cases or WKV7_CASES:
        kernel, B, T, H, dname = case[:5]
        xs = cs._wkv_streams(gen, (B, T, H, 64), getattr(torch, dname), dev)
        s0 = torch.randn(B, H, 64, 64, generator=gen, device=dev) * 0.3
        if len(case) > 5 and not case[5]:
            s0 = None
        if kernel.startswith("wkv7_bwd"):
            _, _, zin = getattr(wkv7_cuda, kernel.replace("bwd", "fwd_res"))(*xs, s0)
            dy = (torch.randn(B, T, H, 64, generator=gen, device=dev) * 0.5).to(xs[0].dtype)
            dsf = torch.randn(B, H, 64, 64, generator=gen, device=dev) * 0.1
            fn = lambda kernel=kernel, xs=xs, zin=zin, dy=dy, dsf=dsf: getattr(wkv7_cuda, kernel)(*xs, zin, dy, dsf)
        else:
            fn = lambda kernel=kernel, xs=xs, s0=s0: getattr(wkv7_cuda, kernel)(*xs, s0)
        out.append({"case": f"{kernel} B={B} T={T} H={H} {dname}{'' if s0 is not None else ' no state'}",
                    "digest": digest(fn()), "ms": cs.cuda_ms(fn, reps=5), "eager_ms": cs.eager_ms(fn, reps=5)})
        del xs, s0, fn
    return out


# K2 / K4 timed: (B, state dtype) at H=32, the cases of chip_smoke's
# check_wkv7_step and check_wkv7_step_flat; an L2-cold time cycles the state
# over copies larger than COLD_BYTES (more than twice the H100's 50 MB L2)
WKV7_STEP_CASES = tuple((B, dname) for B in (1, 4, 32) for dname in ("float32", "bfloat16"))
COLD_BYTES = 128 << 20


def wkv7_step_times(cs, dev) -> list:
    """K2 and K4 at every case of ``WKV7_STEP_CASES`` through the tree's own
    wrappers, on one state (K4's in the flat layout): device time L2-hot
    (``cuda_ms`` on that state), L2-cold (one CUDA graph calling the kernel
    once on each copy of the state), eager time, ms, and the digest of the
    outputs, K4's new state taken back to the head layout (equal K2 and K4
    digests: bit-equal outputs). The cold time is ``chip_smoke.cold_ms``'s,
    written out here because a parent's ``chip_smoke`` may lack it."""
    import itertools

    import torch

    from visualrwkv_torch.ops import wkv7 as pw
    from visualrwkv_torch.ops import wkv7_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out, H = [], 32
    for B, dname in WKV7_STEP_CASES:
        vecs = cs._wkv_streams(gen, (B, H, 64), torch.float32, dev)
        head = (torch.randn(B, H, 64, 64, generator=gen, device=dev) * 0.3).to(getattr(torch, dname))
        for kernel, s0 in (("wkv7_step", head), ("wkv7_step_flat", pw.state_to_flat(head).contiguous())):
            fn = getattr(wkv7_cuda, kernel)
            s, y = fn(s0, *vecs)
            if s.dim() == 3:
                s = pw.state_from_flat(s, H)
            n = max(8, -(-COLD_BYTES // (s0.numel() * s0.element_size())))
            states = itertools.cycle([s0.clone() for _ in range(n)])
            out.append({"case": f"{kernel} B={B} H={H} {dname} state", "digest": digest((s, y)),
                        "ms": cs.cuda_ms(lambda: fn(s0, *vecs), reps=50),
                        "cold_ms": cs.cuda_ms(lambda: fn(next(states), *vecs), reps=n),
                        "eager_ms": cs.eager_ms(lambda: fn(s0, *vecs), reps=50)})
            del states
    return out


# K10 timed: (B, state dtype) at H=64, the cases of chip_smoke's check_wkv6_step
WKV6_STEP_CASES = WKV7_STEP_CASES


def wkv6_step_times(cs, dev) -> list:
    """K10 at every case of ``WKV6_STEP_CASES`` through the tree's own
    wrapper, on one state a case: device time L2-hot, L2-cold (as in
    :func:`wkv7_step_times`), eager time, ms, and the outputs' digest."""
    import itertools

    import torch

    from visualrwkv_torch.ops import wkv6_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out, H = [], 64
    for B, dname in WKV6_STEP_CASES:
        vecs, u = cs._wkv6_streams(gen, (B, H, 64), torch.float32, dev)
        s0 = (torch.randn(B, H, 64, 64, generator=gen, device=dev) * 0.3).to(getattr(torch, dname))
        fn = lambda st: wkv6_cuda.wkv6_step(st, *vecs, u)
        n = max(8, -(-COLD_BYTES // (s0.numel() * s0.element_size())))
        states = itertools.cycle([s0.clone() for _ in range(n)])
        out.append({"case": f"wkv6_step B={B} H={H} {dname} state", "digest": digest(fn(s0)),
                    "ms": cs.cuda_ms(lambda: fn(s0), reps=50),
                    "cold_ms": cs.cuda_ms(lambda: fn(next(states)), reps=n),
                    "eager_ms": cs.eager_ms(lambda: fn(s0), reps=50)})
        del states
    return out


# K16 timed: (B, T, H, stream dtype) with an initial state, chip_smoke's check_wkv7_v2 cases
V2_CASES = ((8, 512, 32, "bfloat16"), (1, 1024, 32, "bfloat16"), (1, 1024, 32, "float32"))


def wkv7_v2_times(cs, dev) -> list:
    """K16 at every case of ``V2_CASES`` through the tree's own wrappers:
    device time (CUDA graphs), eager time, each phase alone where the
    wrappers offer it, ms, and the digest of the outputs."""
    import torch

    from visualrwkv_torch.ops import wkv7_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = []
    for B, T, H, dname in V2_CASES:
        xs = cs._wkv_streams(gen, (B, T, H, 64), getattr(torch, dname), dev)
        s0 = torch.randn(B, H, 64, 64, generator=gen, device=dev) * 0.3
        fn = lambda: wkv7_cuda.wkv7_fwd_v2(*xs, s0)
        rec = {"case": f"wkv7_fwd_v2 B={B} T={T} H={H} {dname}", "digest": digest(fn()),
               "ms": cs.cuda_ms(fn, reps=10), "eager_ms": cs.eager_ms(fn, reps=10),
               "phase1_ms": None, "phase2_ms": None}
        if hasattr(wkv7_cuda, "wkv7_fwd_v2_phase"):
            bufs = wkv7_cuda.v2_buffers(xs[0])
            for p in (1, 2):
                rec[f"phase{p}_ms"] = cs.cuda_ms(lambda p=p: wkv7_cuda.wkv7_fwd_v2_phase(p, *xs, s0, bufs), reps=10)
            del bufs
        out.append(rec)
        del xs, s0, fn
    return out


def wkv4_times(cs, dev) -> list:
    """K17 at every case of ``chip_smoke.WKV4_CASES`` and K18 at every case
    of ``chip_smoke.WKV4_BWD_CASES`` (K18 with cotangents on y and, with an
    initial state, on the final state) through the tree's own wrappers:
    device time (CUDA graphs), eager time, ms, and the outputs' digest."""
    import torch

    from visualrwkv_torch.ops import wkv4_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = []
    for kernel, cases in (("wkv4_fwd", cs.WKV4_CASES), ("wkv4_bwd", cs.WKV4_BWD_CASES)):
        for B, T, C, dname, big_k, with_state in cases:
            w, u, k, v, s0 = cs._wkv4_inputs(gen, B, T, C, dname, big_k, with_state, dev)
            if kernel == "wkv4_bwd":
                dy = torch.randn(B, T, C, generator=gen, device=dev)
                ds = torch.randn(B, C, 3, generator=gen, device=dev) if with_state else None
                fn = lambda w=w, u=u, k=k, v=v, s0=s0, dy=dy, ds=ds: wkv4_cuda.wkv4_bwd(w, u, k, v, s0, dy, ds)
            else:
                fn = lambda w=w, u=u, k=k, v=v, s0=s0: wkv4_cuda.wkv4_fwd(w, u, k, v, s0)
            case = (f"{kernel} B={B} T={T} C={C} {dname}{' k near 80' if big_k else ''}"
                    f"{' with state' if with_state else ''}")
            out.append({"case": case, "digest": digest([x for x in fn() if x is not None]),
                        "ms": cs.cuda_ms(fn, reps=20), "eager_ms": cs.eager_ms(fn, reps=20)})
            del fn
    return out


def x070_prefill_profile(cs, dev) -> dict:
    """The flagship's B=1 prefill under the profiler, after one unprofiled
    prefill of the same request: card busy, idle share, device ms by kind."""
    import torch

    from visualrwkv_torch.infer.engine import InferenceEngine

    cfg = cs.flagship_cfg()
    params = cs.init_model(cfg, 0, dev)
    eng = InferenceEngine(params, cfg, state_dtype="float32", device=dev)
    ids, images = cs.make_request(cfg, 1, 32, 1, dev)
    eng.prefill_ids(ids, images)
    torch.cuda.synchronize()
    prof = cs.device_breakdown(lambda: eng.prefill_ids(ids, images))
    del params, eng
    torch.cuda.empty_cache()
    return prof


def child(tree: str, sections) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from visualrwkv_torch import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, log in cuda_build.build(force=True).items():
        if hasattr(cs, "parse_ptxas"):
            cs.parse_ptxas(name, log)
    dev = torch.device("cuda", 0)
    out = {"tree": tree,
           "ptxas": {f"{kern}{list(args)}": v for (lib, kern, args), v in getattr(cs, "PTXAS", {}).items()
                     if lib.startswith("attention") or kern in (
                         "wkv6_fwd_kernel", "wkv6_bwd_kernel", "wkv6_bwd_state_kernel", "wkv6_bwd_chunk_kernel",
                         "wkv7_fwd_res_kernel", "wkv7_bwd_state_kernel", "wkv7_bwd_chunk_kernel",
                         "wkv7_step_kernel", "wkv_step_kernel", "wkv7_v2_chunk_kernel",
                         "wkv7_v2_chunk_f32_kernel", "wkv7_v2_chunk_bf16_kernel", "wkv7_v2_state_kernel",
                         "wkv4_fwd_kernel", "wkv4_bwd_kernel", "wkv4_chunk_fwd_kernel", "wkv4_chunk_bwd_kernel")}}
    if "k3" in sections:
        out["k3"] = k3_times(cs, dev)
    if "attention_bwd" in sections:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        bwd = cs.check_attention_bwd(gen, dev)
        out["attention_bwd"] = [
            {"case": r14["case"], "k14_ms": r14["kernel_ms"], "k15_ms": r15["kernel_ms"],
             "pair_ms": r14["pair_ms"], "pair_bound_ms": r14["pair_bound_ms"],
             "sdpa_bwd_ms": r14["library_ms"], "k14_eager_ms": r14["kernel_eager_ms"],
             "k15_eager_ms": r15["kernel_eager_ms"]}
            for dq_cases, dkv_cases in bwd.values() for r14, r15 in zip(dq_cases, dkv_cases)]
        torch.cuda.empty_cache()
    if "sam_grad" in sections:
        sam, _ = cs.run_tower_grad("sam", cs.tower_grad_cfgs()["sam"], 0, dev)
        out["sam_grad"] = {k: sam[k] for k in ("fwd_bwd_ms", "peak_gib")}
        torch.cuda.empty_cache()
    if "x070" in sections:
        cfg = cs.flagship_cfg()
        params = cs.build(cfg, 0, dev)
        runs, _, _, _ = cs.run_serving(cfg, params, dev, cs.NEW_TOKENS, 0)
        out["serving"] = [{k: r[k] for k in ("run", "ttft_ms", "decode_tok_per_s")} for r in runs]
        for name, grad_cp, packed, steps in (("main", True, False, 3), ("packed", True, True, 3),
                                             ("wkv", "wkv", False, 2)):
            training, _, _ = cs.run_training(cfg, params, dev, 0, steps=steps, grad_cp=grad_cp,
                                             packed=packed)
            out[name] = [s["step_ms"] for s in training["steps"]]
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
    if "wkv6" in sections:
        out["wkv6"] = wkv6_times(cs, dev)
        torch.cuda.empty_cache()
    if "wkv7" in sections:
        out["wkv7"] = wkv7_times(cs, dev)
        torch.cuda.empty_cache()
    if "wkv7_prefill" in sections:
        out["wkv7_prefill"] = wkv7_times(cs, dev, WKV7_PREFILL_CASES)
        torch.cuda.empty_cache()
    if "wkv7_step" in sections:
        out["wkv7_step"] = wkv7_step_times(cs, dev)
        torch.cuda.empty_cache()
    if "wkv6_step" in sections:
        out["wkv6_step"] = wkv6_step_times(cs, dev)
        torch.cuda.empty_cache()
    if "wkv7_v2" in sections:
        out["wkv7_v2"] = wkv7_v2_times(cs, dev)
        torch.cuda.empty_cache()
    if "wkv4" in sections:
        out["wkv4"] = wkv4_times(cs, dev)
        torch.cuda.empty_cache()
    if "x060_serving" in sections:
        cfg = cs.x060_serving_cfg()
        params = cs.build(cfg, 0, dev)
        runs, _, _, _ = cs.run_serving(cfg, params, dev, cs.NEW_TOKENS, 0)
        out["x060_serving"] = [{k: r[k] for k in ("run", "ttft_ms", "decode_tok_per_s")} for r in runs]
        del params
        torch.cuda.empty_cache()
    if "x060_training" in sections:
        cfg = cs.x060_training_cfg()
        params = cs.build(cfg, 0, dev)
        training, _, _ = cs.run_training(cfg, params, dev, 0, steps=3)
        out["x060_training"] = [s["step_ms"] for s in training["steps"]]
        out["x060_training_peak_gib"] = training["peak_gib"]
        del params
        torch.cuda.empty_cache()
        params = cs.init_model(cfg, 0, dev)
        g = cs.profile_training(cfg, params, dev, 0)["loss and gradients"]
        out["x060_gradient_pass"] = {k: g[k] for k in ("wall_ms", "device_busy_ms", "idle_share", "launches")}
        out["x060_gradient_pass"]["ms_by_kind"] = {k: v for k, v in g["device_ms_by_kind"].items()
                                                   if k.startswith(("K8", "K9", "K3"))}
        del params
        torch.cuda.empty_cache()
    if "x070_prefill_profile" in sections:  # last: the profiler slows every later launch
        out["x070_prefill_profile"] = x070_prefill_profile(cs, dev)
    print("AB " + json.dumps(out), flush=True)


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--child":
        child(argv[1], argv[2:])
        return 0
    sections = argv[2:] or list(SECTIONS)
    if len(argv) < 2 or any(x not in SECTIONS for x in sections):
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = argv[:2]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for tree in (parent, change, change, parent):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree, *sections],
                           capture_output=True, text=True)
        print("\n".join(l for l in r.stdout.splitlines() if l.startswith("AB ")), flush=True)
        if r.returncode:
            print(r.stdout[-4000:], r.stderr[-4000:], flush=True)
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
