#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``visualrwkv_torch``) on one NVIDIA
GPU (written for the H100, ``sm_90a``).

    python3 chip_smoke.py            # all phases, one card

Phases (any failure exits non-zero; nothing is caught):

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every kernel under ``visualrwkv_torch/csrc``
   (one ``nvcc`` per source, all started together, into ``build/``).
2. Each kernel against its plain PyTorch version on the card, at the
   shapes of the flagship serving and training paths, with kernel, plain
   and library (one PyTorch call computing the same function, timed as a
   yardstick only) times and the least time the card could take
   (``bound_ms``).
3. The flagship VisualRWKV-7 1B5 (RWKV-7 L24 D2048, DINOv2-L + SigLIP-so400m
   @448 + SAM-B @1024, gated-MLP projector, 1024 image tokens) on seeded
   random bf16 weights, through ``InferenceEngine.generate``: one image with
   a 1024 + 32 token prompt and 32 greedy tokens (fp32 state), then four
   requests in one batch (bf16 state). The kernels' launch counts over this
   run must be the ones the path implies. Then the prefill logits of the
   kernel path are held against the plain path on the CPU, at a reduced
   LM depth. The four-request batch runs once more with the flat decode
   state (``state_layout="flat"``, kernel K4): the same greedy ids.
4. Training at full width: the same model through ``Trainer`` (bf16
   parameters, fp32 masters, activation checkpointing, chunked head +
   cross-entropy), micro-batch 2 x 2048 tokens with one image a sample, one
   warm-up step and three counted steps; then one step's loss and three
   gradients of the kernel path held against the plain path on the CPU in
   fp32, at a reduced LM depth.

The line before the last is the JSON list of kernels; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

REPLACES = {
    "wkv7_fwd": "visualrwkv_tpu/ops/wkv7_pallas.py:228",
    "wkv7_step": "visualrwkv_tpu/ops/wkv7_pallas.py:638",
    "wkv7_step_flat": "visualrwkv_tpu/ops/wkv7_pallas.py:724",
    "wkv7_fwd_res": "visualrwkv_tpu/ops/wkv7_pallas.py:798",
    "wkv7_bwd": "visualrwkv_tpu/ops/wkv7_pallas.py:984",
    "attention_fwd_relpos": "visualrwkv_tpu/vision/flash.py:219",
    "attention_fwd_mha": "visualrwkv_tpu/vision/flash.py:101",
}
# Greedy tokens a request generates in the counted run.
NEW_TOKENS = 32
# LM depth of the kernel-vs-plain prefill comparison (its plain side runs on
# the CPU), and its limit on the logits' relative RMS: about 16x the reading
# of the committed tree (1.224e-4 on an H100), so that a fault in one kernel
# on the path shows.
PLAIN_LAYERS = 2
PLAIN_CHECK_TOL = 2e-3
# Training run: context length, micro-batch, steps after the warm-up step.
TRAIN_CTX = 2048
TRAIN_MICRO_BSZ = 2
TRAIN_STEPS = 3
# The training plain check (one loss and three gradients, kernels on the card
# against the plain path on the CPU in fp32, same bf16 weights): limits on
# the relative difference of the loss and on each gradient's relative RMS.
# The card computes in bf16 where the CPU side computes in fp32, so the
# limits are a few times the readings on an H100 (loss 2.9e-6; gradients
# 1.25e-2 for the LoRA factor, 6.0e-3 for the head, 1.84e-2 for the projector),
# not rounding-level.
TRAIN_CHECK_LOSS_TOL = 5e-5
TRAIN_CHECK_GRAD_TOL = 6e-2
SOURCES = {
    "wkv7_fwd": "visualrwkv_torch/csrc/wkv7.cu",
    "wkv7_step": "visualrwkv_torch/csrc/wkv7.cu",
    "wkv7_step_flat": "visualrwkv_torch/csrc/wkv7.cu",
    "wkv7_fwd_res": "visualrwkv_torch/csrc/wkv7.cu",
    "wkv7_bwd": "visualrwkv_torch/csrc/wkv7_train.cu",
    "attention_fwd_relpos": "visualrwkv_torch/csrc/attention.cu",
    "attention_fwd_mha": "visualrwkv_torch/csrc/attention.cu",
}


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def eager_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back eager calls (CUDA events
    around the run): the larger of the device time and the host's cost of
    issuing the call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms(fn, reps: int = 20, warmup: int = 2, replays: int = 3) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    cost of issuing the launches is not in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


def rel_rms(x, ref) -> float:
    x, ref = x.double(), ref.double()
    return float(((x - ref) ** 2).sum().sqrt() / (ref**2).sum().sqrt().clamp_min(1e-30))


def max_abs(x, ref) -> float:
    return float((x.double() - ref.double()).abs().max())


def bound(nbytes: float, ops: float, peak: float):
    """(bound_ms, bound_by) for a function moving ``nbytes`` and doing
    ``ops`` operations at ``peak`` operations per second."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class Check:
    """One kernel-vs-plain comparison: errors against a stated tolerance."""

    def __init__(self, name: str, case: str):
        self.name, self.case = name, case
        self.errs = []  # (what, rel_rms, max_abs, tol)

    def compare(self, what, got, ref, tol):
        e = rel_rms(got, ref)
        self.errs.append((what, e, max_abs(got, ref), tol))
        log(f"  {self.name} [{self.case}] {what}: rel_rms={e:.3e} (tol {tol:g}) "
            f"max_abs={self.errs[-1][2]:.3e}")
        if not e <= tol:
            raise AssertionError(f"{self.name} [{self.case}] {what}: rel_rms {e:.3e} > tol {tol:g}")

    def record(self, kernel_ms, plain_ms, library_ms, nbytes, ops, peak, kernel_eager_ms):
        b_ms, b_by = bound(nbytes, ops, peak)
        worst = max(self.errs, key=lambda e: e[1] / e[3])
        rec = {
            "case": self.case, "max_err": worst[1], "max_abs_err": max(e[2] for e in self.errs),
            "tol": worst[3], "kernel_ms": kernel_ms, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "kernel_eager_ms": kernel_eager_ms,
        }
        log(f"  {self.name} [{self.case}] kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms if library_ms is None else round(library_ms, 4)} "
            f"bound_ms={b_ms:.4f} ({b_by}) kernel_eager_ms={kernel_eager_ms:.4f}")
        return rec


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _wkv_streams(gen, shape, dtype, dev):
    """RWKV-7-shaped streams: w_raw soft-clamped below -0.5, a = -kk and
    b = kk * gate with kk unit per head (as tmix_x070 builds them)."""
    import torch
    import torch.nn.functional as F

    rn = lambda: torch.randn(shape, generator=gen, device=dev)
    r, k, v = rn() * 0.5, rn() * 0.5, rn() * 0.5
    w_raw = -F.softplus(-(rn() * 2 - 1)) - 0.5
    kk = F.normalize(rn(), dim=-1)
    gate = torch.rand(shape, generator=gen, device=dev)
    return [x.to(dtype).contiguous() for x in (r, w_raw, k, v, -kk, kk * gate)]


def check_wkv7_fwd(gen, dev):
    import torch

    from visualrwkv_torch.ops import wkv7 as pw
    from visualrwkv_torch.ops import wkv7_cuda

    B, T, H, N = 1, 1056, 32, 64
    out = []
    # bf16 streams are the flagship's; fp32 streams are what an fp32-compute
    # model passes, and that build of K1 is held here too.
    for sdt, with_state in ((torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, True)):
        dname = str(sdt)[6:]
        case = f"B={B} T={T} H={H} N={N} {dname} streams, {'with' if with_state else 'no'} initial state"
        xs = _wkv_streams(gen, (B, T, H, N), sdt, dev)
        s0 = (torch.randn(B, H, N, N, generator=gen, device=dev) * 0.3) if with_state else None
        c = Check("wkv7_fwd", case)
        y, s = wkv7_cuda.wkv7_fwd(*xs, s0)
        y_ref, s_ref = pw.wkv7_reference(*xs, s0)
        torch.cuda.synchronize()
        c.compare(f"y ({dname})", y.float(), y_ref.float(), 1e-2 if sdt == torch.bfloat16 else 1e-3)
        c.compare("final state (fp32)", s, s_ref, 1e-3)
        fn = lambda: wkv7_cuda.wkv7_fwd(*xs, s0)
        k_ms, k_eager = cuda_ms(fn), eager_ms(fn)
        p_ms = cuda_ms(lambda: pw.wkv7_reference(*xs, s0), reps=1, warmup=1)
        nbytes = 7 * B * T * H * N * xs[0].element_size() + B * H * N * N * 4 * (2 if with_state else 1)
        ops = 9 * B * T * H * N * N  # sa (2N), update (5N), y (2N) per state row
        out.append(c.record(k_ms, p_ms, None, nbytes, ops, FP32_FLOPS, k_eager))
    return out


def check_wkv7_step(gen, dev):
    import torch

    from visualrwkv_torch.ops import wkv7 as pw
    from visualrwkv_torch.ops import wkv7_cuda

    H, N = 32, 64
    out = []
    for B in (1, 32):
        for sdt in (torch.float32, torch.bfloat16):
            case = f"B={B} H={H} N={N} {str(sdt)[6:]} state, fp32 vectors"
            vecs = _wkv_streams(gen, (B, H, N), torch.float32, dev)
            s0 = (torch.randn(B, H, N, N, generator=gen, device=dev) * 0.3).to(sdt)
            c = Check("wkv7_step", case)
            s, y = wkv7_cuda.wkv7_step(s0, *vecs)
            s_ref, y_ref = pw.wkv7_step(s0, *vecs)
            torch.cuda.synchronize()
            assert s.dtype == sdt
            c.compare("y (fp32)", y, y_ref, 1e-3)
            c.compare(f"new state ({str(sdt)[6:]})", s.float(), s_ref, 1e-3 if sdt == torch.float32 else 1e-2)
            fn = lambda: wkv7_cuda.wkv7_step(s0, *vecs)
            k_ms, k_eager = cuda_ms(fn, reps=50), eager_ms(fn, reps=50)
            p_ms = cuda_ms(lambda: pw.wkv7_step(s0, *vecs), reps=20)
            nbytes = 2 * B * H * N * N * s0.element_size() + 7 * B * H * N * 4
            out.append(c.record(k_ms, p_ms, None, nbytes, 9 * B * H * N * N, FP32_FLOPS, k_eager))
    return out


def check_wkv7_step_flat(gen, dev):
    """K4 on the flat state [B, 64, H*64] against its plain version, and
    beside K2 (the same step on the head layout) at the same batch."""
    import torch

    from visualrwkv_torch.ops import wkv7 as pw
    from visualrwkv_torch.ops import wkv7_cuda

    H, N = 32, 64
    out = []
    for B in (1, 32):
        for sdt in (torch.float32, torch.bfloat16):
            dname = str(sdt)[6:]
            case = f"B={B} H={H} N={N} {dname} flat state [B, {N}, {H * N}], fp32 vectors"
            vecs = _wkv_streams(gen, (B, H, N), torch.float32, dev)
            head = (torch.randn(B, H, N, N, generator=gen, device=dev) * 0.3).to(sdt)
            s0 = pw.state_to_flat(head).contiguous()
            c = Check("wkv7_step_flat", case)
            s, y = wkv7_cuda.wkv7_step_flat(s0, *vecs)
            s_ref, y_ref = pw.wkv7_step_flat(s0.float(), *vecs)
            torch.cuda.synchronize()
            assert s.dtype == sdt and s.shape == s0.shape
            c.compare("y (fp32)", y, y_ref, 1e-3)
            c.compare(f"new state ({dname})", s.float(), s_ref, 1e-3 if sdt == torch.float32 else 1e-2)
            fn = lambda: wkv7_cuda.wkv7_step_flat(s0, *vecs)
            k_ms, k_eager = cuda_ms(fn, reps=50), eager_ms(fn, reps=50)
            p_ms = cuda_ms(lambda: pw.wkv7_step_flat(s0, *vecs), reps=20)
            k2_ms = cuda_ms(lambda: wkv7_cuda.wkv7_step(head, *vecs), reps=50)
            nbytes = 2 * B * H * N * N * s0.element_size() + 7 * B * H * N * 4
            rec = c.record(k_ms, p_ms, None, nbytes, 9 * B * H * N * N, FP32_FLOPS, k_eager)
            rec["head_layout_k2_ms"] = k2_ms
            log(f"  wkv7_step_flat [{case}] K2 on the head layout at the same B: {k2_ms:.5f} ms")
            out.append(rec)
    return out


def check_wkv7_train(gen, dev):
    """K5 (forward that saves the chunk states) and K6 (backward) at the
    training path's shapes, with a non-zero initial state and a non-zero
    cotangent of the final state. K5 against the sequential plain scan; K6
    against the plain backward (fp32 autograd through the reference, chunk by
    chunk) on the same values in fp32."""
    import torch

    from visualrwkv_torch.ops import wkv7 as pw
    from visualrwkv_torch.ops import wkv7_cuda

    B, T, H, N = 2, 2048, 32, 64
    fwd, bwd = [], []
    names = ("dr", "dw_raw", "dk", "dv", "da", "db")
    for sdt in (torch.bfloat16, torch.float32):
        dname = str(sdt)[6:]
        bf = sdt == torch.bfloat16
        case = f"B={B} T={T} H={H} N={N} {dname} streams, initial state, non-zero final-state cotangent"
        xs = _wkv_streams(gen, (B, T, H, N), sdt, dev)
        s0 = torch.randn(B, H, N, N, generator=gen, device=dev) * 0.3
        dy = (torch.randn(B, T, H, N, generator=gen, device=dev) * 0.5).to(sdt)
        dsf = torch.randn(B, H, N, N, generator=gen, device=dev) * 0.1

        c = Check("wkv7_fwd_res", case)
        y, s, zin = wkv7_cuda.wkv7_fwd_res(*xs, s0)
        t_plain = eager_ms(lambda: pw.wkv7_fwd_res_plain(*xs, s0), reps=1, warmup=0)
        y_ref, s_ref, zin_ref = pw.wkv7_fwd_res_plain(*xs, s0)
        torch.cuda.synchronize()
        c.compare(f"y ({dname})", y.float(), y_ref.float(), 1e-2 if bf else 1e-3)
        c.compare("final state (fp32)", s, s_ref, 1e-3)
        c.compare("saved chunk states zin (fp32)", zin, zin_ref, 1e-3)
        fn = lambda: wkv7_cuda.wkv7_fwd_res(*xs, s0)
        k_ms, k_eager = cuda_ms(fn, reps=5), eager_ms(fn, reps=5)
        k1_ms = cuda_ms(lambda: wkv7_cuda.wkv7_fwd(*xs, s0), reps=5)
        esz = xs[0].element_size()
        nbytes = 7 * B * T * H * N * esz + 2 * B * H * N * N * 4 + zin.numel() * 4
        rec = c.record(k_ms, t_plain, None, nbytes, 9 * B * T * H * N * N, FP32_FLOPS, k_eager)
        rec["k1_same_shape_ms"] = k1_ms
        log(f"  wkv7_fwd_res [{case}] K1 (no saved states) at the same shape: {k1_ms:.4f} ms")
        fwd.append(rec)

        c = Check("wkv7_bwd", case)
        grads = wkv7_cuda.wkv7_bwd(*xs, zin, dy, dsf)
        xs32 = [x.float() for x in xs]
        t_plain = eager_ms(lambda: pw.wkv7_bwd_plain(*xs32, zin_ref, dy.float(), dsf), reps=1, warmup=0)
        ref = pw.wkv7_bwd_plain(*xs32, zin_ref, dy.float(), dsf)
        torch.cuda.synchronize()
        for name, g, g_ref in zip(names, grads, ref):
            assert g.dtype == sdt
            c.compare(f"{name} ({dname}) vs fp32 plain backward", g.float(), g_ref, 2e-2 if bf else 1e-3)
        c.compare("d(initial state) (fp32)", grads[6], ref[6], 2e-2 if bf else 1e-3)
        fn = lambda: wkv7_cuda.wkv7_bwd(*xs, zin, dy, dsf)
        k_ms, k_eager = cuda_ms(fn, reps=3), eager_ms(fn, reps=3)
        # read 6 streams + dy + zin + dsf, write 6 gradients + d(initial state);
        # per state element and step: 7 operations to rebuild the state before
        # the step and 20 for its adjoint
        nbytes = 13 * B * T * H * N * esz + zin.numel() * 4 + 2 * B * H * N * N * 4
        bwd.append(c.record(k_ms, t_plain, None, nbytes, 27 * B * T * H * N * N, FP32_FLOPS, k_eager))
        del xs, xs32, zin, zin_ref, grads, ref
    return fwd, bwd


def check_attention(gen, dev):
    import torch
    import torch.nn.functional as F

    from visualrwkv_torch.vision import flash as pf

    bf = torch.bfloat16
    relpos, mha = [], []

    G, Hk, Wk, hd = 12, 64, 64, 64
    N = Hk * Wk
    q, k, v = (torch.randn(G, N, hd, generator=gen, device=dev).to(bf) for _ in range(3))
    rel_h = torch.randn(G, N, Hk, generator=gen, device=dev)
    rel_w = torch.randn(G, N, Wk, generator=gen, device=dev)
    scale = hd**-0.5
    c = Check("attention_fwd_relpos", f"G={G} N={N} ({Hk}x{Wk} grid) hd={hd} bf16, fp32 rel tables")
    o = pf.sam_attention(q, k, v, rel_h, rel_w, scale)
    o_ref = pf.sam_attend_reference(q, k, v, rel_h, rel_w, scale)
    torch.cuda.synchronize()
    c.compare("out (bf16)", o.float(), o_ref.float(), 1e-2)
    fn = lambda: pf.sam_attention(q, k, v, rel_h, rel_w, scale)
    k_ms, k_eager = cuda_ms(fn), eager_ms(fn)
    p_ms = cuda_ms(lambda: pf.sam_attend_reference(q, k, v, rel_h, rel_w, scale), reps=3, warmup=1)
    mask = (rel_h[:, :, :, None] + rel_w[:, :, None, :]).reshape(G, N, N).to(bf)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale), reps=5)
    del mask
    nbytes = 4 * G * N * hd * 2 + G * N * (Hk + Wk) * 4
    relpos.append(c.record(k_ms, p_ms, lib_ms, nbytes, 4 * G * N * N * hd, BF16_TENSOR_FLOPS, k_eager))

    B, h = 1, 16
    for N, hd, tower in ((1029, 64, "DINOv2-L"), (1024, 72, "SigLIP-so400m")):
        q, k, v = (torch.randn(B, N, h, hd, generator=gen, device=dev).to(bf) for _ in range(3))
        c = Check("attention_fwd_mha", f"{tower}: B={B} N={N} h={h} hd={hd} bf16")
        o = pf.mha(q, k, v)
        o_ref = pf.mha_reference(q, k, v)
        torch.cuda.synchronize()
        c.compare("out (bf16)", o.float(), o_ref.float(), 1e-2)
        fn = lambda: pf.mha(q, k, v)
        k_ms, k_eager = cuda_ms(fn, reps=50), eager_ms(fn, reps=50)
        p_ms = cuda_ms(lambda: pf.mha_reference(q, k, v), reps=20)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=50)
        nbytes = 4 * B * N * h * hd * 2
        mha.append(c.record(k_ms, p_ms, lib_ms, nbytes, 4 * B * h * N * N * hd, BF16_TENSOR_FLOPS, k_eager))
    return relpos, mha


# ---------------------------------------------------------------------------
# phase 3: the flagship serving path
# ---------------------------------------------------------------------------


def flagship_cfg():
    from visualrwkv_torch.config import RWKVConfig, VisionConfig, VLMConfig

    return VLMConfig(
        rwkv=RWKVConfig(n_layer=24, n_embd=2048, vocab_size=65536, head_size=64,
                        compute_dtype="bfloat16", ctx_len=2048),
        vision=VisionConfig(),  # DINOv2-L/14-reg4 @448 + SigLIP-so400m/14 @448 + SAM-B/16 @1024
        proj_type="mlp",
        num_token_per_image=1024,
    )


def init_model(cfg, seed: int, device):
    """Seeded random bf16 weights. SAM's rel-pos tables start at zero in the
    reference init; they get small random values here so that the bias
    path of the attention kernel carries signal, as a checkpoint's would."""
    import torch

    from visualrwkv_torch.models.visualrwkv import init_visualrwkv_params

    params = init_visualrwkv_params(cfg, seed=seed, device=device, dtype=torch.bfloat16)
    if "sam" in params.get("vit", {}):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + 1)
        for blk in params["vit"]["sam"]["blocks"]:
            for name in ("rel_pos_h", "rel_pos_w"):
                t = blk["attn"][name]
                t.copy_(torch.randn(t.shape, generator=gen, device=device) * 0.02)
    return params


def make_request(cfg, batch: int, text_tokens: int, seed: int, device):
    """Token ids [batch, image tokens + text] (the image tokens first, as a
    chat turn starts) and per-tower uint8 images, one image per row."""
    import torch

    from visualrwkv_torch.config import IMAGE_TOKEN_INDEX
    from visualrwkv_torch.vision.backbone import tower_configs

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n_img = cfg.num_token_per_image
    ids = torch.randint(10, 65000, (batch, n_img + text_tokens), generator=gen, device=device)
    ids[:, :n_img] = IMAGE_TOKEN_INDEX
    images = {
        t: torch.randint(0, 256, (batch, c.img_size, c.img_size, 3), generator=gen,
                         device=device, dtype=torch.uint8)
        for t, c in tower_configs(cfg.vision).items()
    }
    return ids, images


def expected_launches(cfg, prefills: int = 0, decode_steps: int = 0, encodes: int = 0,
                      flat_decode_steps: int = 0, train_micro_batches: int = 0,
                      grad_cp: bool = True):
    """Launches of each kernel that a run implies: ``prefills`` stateless
    prompts, ``decode_steps`` / ``flat_decode_steps`` one-token steps on the
    head / flat state, ``encodes`` passes of the vision towers, and
    ``train_micro_batches`` loss-and-gradient passes. Under activation
    checkpointing (non-reentrant: the first pass runs with autograd on) every
    block's forward runs twice, both times through K5; K1 never runs in
    training."""
    from visualrwkv_torch.vision import sam, vit
    from visualrwkv_torch.vision.backbone import tower_configs

    tc = tower_configs(cfg.vision)
    mha_per_encode = sum(vit.blocks_run(c) for c in tc.values() if isinstance(c, vit.ViTConfig)
                         and c.num_patches + c.use_cls + c.num_reg >= vit.MHA_MIN_TOKENS)
    relpos_per_encode = sum(sam.global_blocks(c) for c in tc.values() if isinstance(c, sam.SAMConfig))
    L = cfg.rwkv.n_layer
    return {
        "wkv7_fwd": L * prefills,
        "wkv7_step": L * decode_steps,
        "wkv7_step_flat": L * flat_decode_steps,
        "wkv7_fwd_res": L * train_micro_batches * (2 if grad_cp else 1),
        "wkv7_bwd": L * train_micro_batches,
        "attention_fwd_relpos": relpos_per_encode * encodes,
        "attention_fwd_mha": mha_per_encode * encodes,
    }


def reset_launches():
    from visualrwkv_torch import cuda_build

    for k in list(cuda_build.LAUNCHES):
        cuda_build.LAUNCHES[k] = 0


def assert_launches(what, launches, want):
    """Every kernel was launched exactly as often as the path implies."""
    log(f"  launches ({what}): {launches}; expected: { {k: v for k, v in want.items() if v} }")
    for name, n in want.items():
        assert launches.get(name, 0) == n, (what, name, launches.get(name, 0), n)


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def run_serving(cfg, params, device, new_tokens: int, seed: int):
    """The main path: one request (fp32 state), then four in one batch (bf16
    state), through ``InferenceEngine.generate``. Returns the per-run
    numbers, the launch counts of exactly this run and the counts it implies."""
    import numpy as np
    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.infer.engine import InferenceEngine

    runs = []
    plan = (("1 request, fp32 state", 1, "float32"), ("4 requests, bf16 state", 4, "bfloat16"))
    engines = {sdt: InferenceEngine(params, cfg, state_dtype=sdt, device=device) for _, _, sdt in plan}
    reqs = {b: make_request(cfg, b, 32, seed + b, device) for _, b, _ in plan}

    # warm-up and time to first token (prefill + argmax), outside the counted run
    for name, b, sdt in plan:
        ids, images = reqs[b]
        engines[sdt].generate(ids, images, max_new_tokens=2)
        ttfts = []
        for _ in range(3):
            (logits, _), ms = timed(lambda: engines[sdt].prefill_ids(ids, images))
            ttfts.append(ms)
        assert logits.shape == (b, cfg.rwkv.vocab_size) and torch.isfinite(logits).all()
        runs.append({"run": name, "batch": b, "prompt_tokens": ids.shape[1],
                     "ttft_ms": sorted(ttfts)[1]})

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for run, (name, b, sdt) in zip(runs, plan):
        ids, images = reqs[b]
        res, ms = timed(lambda: engines[sdt].generate(ids, images, max_new_tokens=new_tokens,
                                                      stop_tokens=(-1,)))
        assert res.tokens.shape == (b, new_tokens)
        assert np.isfinite(res.logits).all() and np.isfinite(res.probs).all()
        run.update(generate_ms=ms, decode_tok_per_s=b * new_tokens / ((ms - run["ttft_ms"]) / 1e3),
                   first_ids=res.tokens[0, :8].tolist(), tokens=res.tokens)
    launches = dict(cuda_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    want = expected_launches(cfg, prefills=len(plan), decode_steps=new_tokens * len(plan),
                             encodes=len(plan))
    return runs, launches, want, peak_gib


def profile_serving(cfg, params, device, seed: int):
    """Where the serving time goes: one B=1 prefill, then eight decode steps
    from its state, each under the profiler. Run after every counted run:
    once the profiler has been used, its tracing stays attached to the
    process and slows every later launch of a host-bound loop."""
    from visualrwkv_torch.infer.engine import InferenceEngine

    eng = InferenceEngine(params, cfg, state_dtype="float32", device=device)
    ids, images = make_request(cfg, 1, 32, seed + 1, device)
    out = {}
    prof = {"prefill": device_breakdown(lambda: out.update(st=eng.prefill_ids(ids, images)[1]))}
    prof["decode (9 steps, B=1)"] = device_breakdown(
        lambda: eng.generate(ids[:, -1:], states=out["st"], max_new_tokens=8, stop_tokens=(-1,)))
    return prof


def run_serving_flat(cfg, params, device, new_tokens: int, seed: int, head_tokens):
    """The four-request batch of :func:`run_serving` again with the flat
    decode state (bf16): kernel K4 takes K2's place, and the greedy ids must
    be those of the head layout. The head layout is timed once more right
    after it (outside the counted run), so that the two layouts can be
    compared in turns: the decode loop is bound by the host, whose speed
    drifts over a run."""
    import numpy as np

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.infer.engine import InferenceEngine

    b = 4
    eng = InferenceEngine(params, cfg, state_dtype="bfloat16", state_layout="flat", device=device)
    ids, images = make_request(cfg, b, 32, seed + b, device)
    eng.generate(ids, images, max_new_tokens=2)
    reset_launches()
    res, ms = timed(lambda: eng.generate(ids, images, max_new_tokens=new_tokens, stop_tokens=(-1,)))
    launches = dict(cuda_build.LAUNCHES)
    assert res.tokens.shape == (b, new_tokens) and np.isfinite(res.logits).all()
    assert np.array_equal(res.tokens, head_tokens), "flat-state greedy ids differ from the head layout's"
    want = expected_launches(cfg, prefills=1, flat_decode_steps=new_tokens, encodes=1)
    head = InferenceEngine(params, cfg, state_dtype="bfloat16", device=device)
    _, head_ms = timed(lambda: head.generate(ids, images, max_new_tokens=new_tokens, stop_tokens=(-1,)))
    return {"run": "4 requests, bf16 flat state", "batch": b, "generate_ms": ms,
            "head_layout_again_ms": head_ms, "first_ids": res.tokens[0, :8].tolist()}, launches, want


def _category(kernel_name: str) -> str:
    n = kernel_name.lower()
    # the second template argument tells K5 from K1 and K4 from K2
    flag = "true>" in n.replace(" ", "") or "(bool)1>" in n.replace(" ", "")
    if "wkv7_fwd_kernel" in n:
        return "K5 wkv7_fwd_res" if flag else "K1 wkv7_fwd"
    if "wkv7_step_kernel" in n:
        return "K4 wkv7_step_flat" if flag else "K2 wkv7_step"
    if "wkv7_bwd_kernel" in n:
        return "K6 wkv7_bwd"
    if "attention_fwd_kernel" in n:
        return "K3 attention_fwd"
    if any(t in n for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90_")):
        return "matmul (cuBLAS)"
    if "conv" in n or "cudnn" in n:
        return "convolution"
    if "memcpy" in n or "memset" in n:
        return "copies"
    return "other (elementwise, norms, reductions, sampling)"


def device_breakdown(fn):
    """Run ``fn`` once under ``torch.profiler``: host wall time, the time the
    card was busy (union of its kernels' spans) and device time by kind."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kinds = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        k = _category(e.name)
        kinds[k] = kinds.get(k, 0.0) + (b - a) / 1e3
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / 1e3 / wall_ms, "launches": len(spans),
            "device_ms_by_kind": dict(sorted(kinds.items(), key=lambda kv: -kv[1]))}


def log_breakdown(prefix: str, prof: dict):
    for what, b in prof.items():
        log(f"  {prefix}, {what}: wall {b['wall_ms']:.1f} ms, card busy {b['device_busy_ms']:.1f} ms "
            f"(idle share {b['idle_share']:.3f}), {b['launches']} device events; by kind (ms): "
            + ", ".join(f"{k} {v:.2f}" for k, v in b['device_ms_by_kind'].items()))


def shallow(cfg, params, n_layer: int):
    """The same model cut to its first ``n_layer`` LM blocks (towers whole)."""
    c = cfg.replace(rwkv=dataclasses.replace(cfg.rwkv, n_layer=n_layer))
    p = dict(params)
    p["rwkv"] = dict(params["rwkv"], blocks=params["rwkv"]["blocks"][:n_layer])
    return c, p


def to_device(tree, device, dtype=None, copy=False):
    if isinstance(tree, dict):
        return {k: to_device(v, device, dtype, copy) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device, dtype, copy) for v in tree]
    return tree.detach().to(device=device, dtype=dtype or tree.dtype, copy=copy)


def check_against_plain(cfg, params, n_layer: int, seed: int, device="cuda"):
    """Prefill logits of the kernel path (card) against the plain path (the
    CPU: every wrapper takes its plain version for CPU tensors), same bf16
    weights and inputs, LM cut to ``n_layer`` blocks."""
    import torch

    from visualrwkv_torch.infer.engine import InferenceEngine

    c, p = shallow(cfg, params, n_layer)
    ids, images = make_request(c, 1, 32, seed, device)
    logits_gpu, _ = InferenceEngine(p, c, device=device).prefill_ids(ids, images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_cpu = to_device(p, "cpu")
    logits_cpu, _ = InferenceEngine(p_cpu, c, device="cpu").prefill_ids(
        ids.cpu(), {k: v.cpu() for k, v in images.items()})
    cpu_s = time.perf_counter() - t0
    e = rel_rms(logits_gpu.float().cpu(), logits_cpu.float())
    log(f"  prefill logits, LM cut to {n_layer} of {cfg.rwkv.n_layer} layers, towers whole: "
        f"kernels (card) vs plain (CPU) rel_rms={e:.3e} (tol {PLAIN_CHECK_TOL:g}); CPU run {cpu_s:.1f} s")
    assert torch.isfinite(logits_cpu).all() and torch.isfinite(logits_gpu).all()
    assert e <= PLAIN_CHECK_TOL, e
    return e, cpu_s


# ---------------------------------------------------------------------------
# phase 4: training at full width
# ---------------------------------------------------------------------------


def train_batch(cfg, batch: int, ctx: int, seed: int):
    """A training batch made with numpy from the seed: random token ids with
    the image tokens first (one image a sample), random next-token labels
    masked on the image span, random uint8 images per tower."""
    import numpy as np

    from visualrwkv_torch.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from visualrwkv_torch.vision.backbone import tower_configs

    rng = np.random.default_rng(seed)
    n_img, vocab = cfg.num_token_per_image, cfg.rwkv.vocab_size
    ids = rng.integers(0, vocab - 1, (batch, ctx))
    labels = rng.integers(0, vocab - 1, (batch, ctx))
    ids[:, :n_img] = IMAGE_TOKEN_INDEX
    labels[:, :n_img] = IGNORE_INDEX
    images = {t: rng.integers(0, 256, (batch, c.img_size, c.img_size, 3), dtype=np.uint8)
              for t, c in tower_configs(cfg.vision).items()}
    return {"input_ids": ids, "labels": labels, "images": images}


def train_cfg(steps: int):
    from visualrwkv_torch.config import TrainConfig

    return TrainConfig(param_dtype="bfloat16", optim_precision="master_fp32", grad_cp=True,
                       ce_chunk_t=128, micro_bsz=TRAIN_MICRO_BSZ, accumulate_grad_batches=1,
                       grad_clip=1.0, epoch_steps=steps, epoch_count=1)


def reckon_train_memory(cfg, tcfg, params, trainable) -> dict:
    """The memory a training step should need, in GB, from the shapes."""
    B, T, C, V = tcfg.micro_bsz, TRAIN_CTX, cfg.rwkv.n_embd, cfg.rwkv.vocab_size
    H, N = cfg.rwkv.n_head, cfg.rwkv.head_size
    n_train = sum(p.numel() for p in trainable)
    parts = {
        "bf16 parameters": sum(p.numel() * p.element_size() for p in _leaves(params)),
        "fp32 masters + two moments": 12 * n_train,
        "bf16 gradients": 2 * n_train,
        "fp32 head-gradient accumulator": 4 * V * C,
        "saved block inputs (fp32 x and v_first)": 2 * cfg.rwkv.n_layer * B * T * C * 4,
        "zin of one layer": B * H * (T // 16) * N * N * 4,
        "one fp32 logits chunk": B * tcfg.ce_chunk_t * V * 4,
    }
    parts["sum"] = sum(parts.values())
    return {k: v / 1e9 for k, v in parts.items()}


def _checksums(tree):
    """(sum, sum of absolute values) of every leaf, in float64, as one tensor."""
    import torch

    return torch.stack([torch.stack([p.double().sum(), p.double().abs().sum()])
                        for p in _leaves(tree)]).cpu()


def run_training(cfg, params, device, seed: int):
    """The main path of training: ``Trainer`` on the flagship model for one
    warm-up step and ``TRAIN_STEPS`` counted steps. ``params`` (bf16) are
    updated in place."""
    import numpy as np
    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.train.optim import tree_leaves, tree_leaves_with_path
    from visualrwkv_torch.train.trainer import Trainer, loss_and_grads

    tcfg = train_cfg(TRAIN_STEPS + 1)
    trainer = Trainer(cfg, tcfg, params, device=device, log_every=1)
    reckoned = reckon_train_memory(cfg, tcfg, trainer.params, trainer.leaves)
    log("  memory reckoned from the shapes (GB): "
        + ", ".join(f"{k} {v:.2f}" for k, v in reckoned.items()))
    mask = tree_leaves(trainer.opt.train_mask)
    paths = [p for p, _ in tree_leaves_with_path(trainer.params)]
    masters = lambda: [m if m is not None else p for m, p in
                       zip(tree_leaves(trainer.state.opt_state.master), tree_leaves(trainer.params))]
    sums_before = _checksums(tree_leaves(trainer.params))
    master_before = _checksums(masters())
    batches = [train_batch(cfg, TRAIN_MICRO_BSZ, TRAIN_CTX, seed + 100 + i)
               for i in range(TRAIN_STEPS + 2)]
    tokens = TRAIN_MICRO_BSZ * TRAIN_CTX

    loss, warm_ms = timed(lambda: float(trainer.train_step(batches[0])))
    assert np.isfinite(loss), loss
    log(f"  warm-up step: loss {loss:.4f}, {warm_ms:.0f} ms")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    steps = []
    for i in range(1, TRAIN_STEPS + 1):
        loss, ms = timed(lambda: float(trainer.train_step(batches[i])))
        assert np.isfinite(loss), (i, loss)
        steps.append({"step": i, "loss": loss, "step_ms": ms, "tok_per_s": tokens / (ms / 1e3),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        log(f"  step {i}: loss {loss:.4f}, {ms:.1f} ms, {steps[-1]['tok_per_s']:.0f} tok/s, "
            f"peak {steps[-1]['peak_gib']:.2f} GiB")
    launches = dict(cuda_build.LAUNCHES)
    want = expected_launches(cfg, encodes=TRAIN_STEPS, train_micro_batches=TRAIN_STEPS, grad_cp=True)
    assert trainer.state.step == TRAIN_STEPS + 1

    # frozen leaves are bit for bit what they were; trainable ones moved. The
    # fp32 master is what moves: an update below a bf16 ulp leaves the stored
    # bf16 leaf as it was, and an update below an fp32 ulp (a gradient that is
    # almost zero, as x_w's through two small LoRA factors) leaves the master.
    sums_after, master_after = _checksums(tree_leaves(trainer.params)), _checksums(masters())
    moved = [bool((a != b).any()) for a, b in zip(master_before, master_after)]
    for path, t, a, b in zip(paths, mask, sums_before, sums_after):
        assert t or bool((a == b).all()), f"frozen leaf {path} changed"
    still = [p for p, t, m in zip(paths, mask, moved) if t and not m]
    n_train = sum(mask)
    log(f"  {n_train} trainable leaves, {len(still)} unmoved: {still[:8]}; "
        f"{len(mask) - n_train} frozen leaves unchanged")
    assert len(still) <= 0.05 * n_train, still
    for path in (("rwkv", "head", "weight"), ("rwkv", "emb", "weight"),
                 ("rwkv", "blocks", 0, "att", "output", "weight"), ("proj", "o_proj", "weight")):
        assert moved[paths.index(path)], path

    # where the time goes: one more step, the gradient pass and the optimizer apart
    out = {}
    prof = {"loss and gradients": device_breakdown(lambda: out.update(lg=loss_and_grads(
        trainer.loss_fn, trainer.params, trainer.leaves, batches[-1], 1)))}
    prof["optimizer"] = device_breakdown(lambda: trainer.opt.step(
        trainer.params, out["lg"][1], trainer.state.opt_state, trainer.state.step))
    del out, trainer
    return {"steps": steps, "warmup_ms": warm_ms, "reckoned_gb": reckoned,
            "peak_gib": max(s["peak_gib"] for s in steps), "breakdown": prof}, launches, want


def check_training_against_plain(cfg, params, n_layer: int, seed: int, device="cuda"):
    """One loss and the gradients of three leaves (a LoRA factor,
    ``head.weight`` and the projector's first weight) from the kernel path
    on the card (bf16 compute) against the plain path on the CPU in fp32,
    on the same bf16 weights. The LM is ``n_layer`` fresh blocks with noise on
    every leaf (so that the zero-initialised projections pass gradient), the
    towers and the projector are the flagship's, whole."""
    import torch

    from visualrwkv_torch.models.lm import init_lm_params
    from visualrwkv_torch.models.visualrwkv import training_loss

    c = cfg.replace(rwkv=dataclasses.replace(cfg.rwkv, n_layer=n_layer))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rwkv = init_lm_params(gen, c.rwkv, device)
    for leaf in _leaves(rwkv):
        leaf.add_(torch.randn(leaf.shape, generator=gen, device=device) * 0.02)
    p = {"rwkv": to_device(rwkv, device, torch.bfloat16), "vit": params["vit"],
         "proj": to_device(params["proj"], device, copy=True)}  # the flagship's is left alone
    batch = train_batch(c, 1, TRAIN_CTX, seed)
    named = {"rwkv.blocks[1].att.w1": lambda t: t["rwkv"]["blocks"][1]["att"]["w1"],
             "rwkv.head.weight": lambda t: t["rwkv"]["head"]["weight"],
             "proj.gate.weight": lambda t: t["proj"]["gate"]["weight"]}

    def run(tree, cfg_, dev):
        leaves = [get(tree).requires_grad_(True) for get in named.values()]
        loss = training_loss(tree, cfg_, batch["input_ids"], batch["labels"], batch["images"],
                             grad_cp=True, ce_chunk_t=128, device=dev)
        return loss.detach().float().cpu(), [g.float().cpu() for g in torch.autograd.grad(loss, leaves)]

    loss_gpu, g_gpu = run(p, c, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c32 = c.replace(rwkv=dataclasses.replace(c.rwkv, compute_dtype="float32"))
    loss_cpu, g_cpu = run(to_device(p, "cpu", torch.float32), c32, "cpu")
    cpu_s = time.perf_counter() - t0
    d_loss = abs(float(loss_gpu) - float(loss_cpu)) / abs(float(loss_cpu))
    log(f"  training check, LM cut to {n_layer} layers, towers whole: loss card {float(loss_gpu):.5f} "
        f"vs CPU fp32 {float(loss_cpu):.5f} (relative {d_loss:.2e}, tol {TRAIN_CHECK_LOSS_TOL:g}); "
        f"CPU run {cpu_s:.1f} s")
    errs = {}
    for name, a, b in zip(named, g_gpu, g_cpu):
        assert torch.isfinite(a).all() and float(b.abs().max()) > 0, name
        errs[name] = rel_rms(a, b)
        log(f"    d loss / d {name}: rel_rms={errs[name]:.3e} (tol {TRAIN_CHECK_GRAD_TOL:g})")
    assert d_loss <= TRAIN_CHECK_LOSS_TOL, d_loss
    assert all(e <= TRAIN_CHECK_GRAD_TOL for e in errs.values()), errs
    return {"loss_rel": d_loss, "grad_rel_rms": errs, "cpu_s": cpu_s, "lm_layers": n_layer}


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "visualrwkv_torch", "csrc")):
        print("chip_smoke: visualrwkv_torch/ (with csrc/) must sit beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from visualrwkv_torch import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # phase 1 --------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build_logs = cuda_build.build(force=True)
    build_s = time.perf_counter() - t0
    log(f"phase 1: built {sorted(build_logs)} with nvcc in {build_s:.1f} s (parallel, sm_90a)")
    for name, out in sorted(build_logs.items()):
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  [{name}] {line.strip()}")

    # phase 2 --------------------------------------------------------------
    log("phase 2: kernels against their plain versions on the card")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    kernels = {"wkv7_fwd": check_wkv7_fwd(gen, dev), "wkv7_step": check_wkv7_step(gen, dev),
               "wkv7_step_flat": check_wkv7_step_flat(gen, dev)}
    kernels["wkv7_fwd_res"], kernels["wkv7_bwd"] = check_wkv7_train(gen, dev)
    kernels["attention_fwd_relpos"], kernels["attention_fwd_mha"] = check_attention(gen, dev)
    torch.cuda.empty_cache()

    # phase 3 --------------------------------------------------------------
    log("phase 3: flagship VisualRWKV-7 1B5 serving, full width, seeded random bf16 weights")
    cfg = flagship_cfg()
    params, init_ms = timed(lambda: init_model(cfg, args.seed, dev))
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  init: {n_params / 1e9:.3f} B parameters in {init_ms / 1e3:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    runs, launches, want, peak_gib = run_serving(cfg, params, dev, NEW_TOKENS, args.seed)
    head_tokens = runs[-1].pop("tokens")
    runs[0].pop("tokens")
    for r in runs:
        log(f"  {r['run']}: prompt {r['prompt_tokens']} tokens, TTFT {r['ttft_ms']:.1f} ms, "
            f"generate({NEW_TOKENS}) {r['generate_ms']:.1f} ms, "
            f"decode {r['decode_tok_per_s']:.1f} tok/s, first ids {r['first_ids']}")
    log(f"  peak memory over the counted run: {peak_gib:.2f} GiB")
    assert_launches("serving, head layout", launches, want)
    flat_run, flat_launches, flat_want = run_serving_flat(cfg, params, dev, NEW_TOKENS, args.seed,
                                                          head_tokens)
    log(f"  {flat_run['run']}: generate({NEW_TOKENS}) {flat_run['generate_ms']:.1f} ms (the head "
        f"layout again, right after: {flat_run['head_layout_again_ms']:.1f} ms), greedy ids "
        f"equal to the head layout's, first ids {flat_run['first_ids']}")
    assert_launches("serving, flat layout", flat_launches, flat_want)
    runs.append(flat_run)
    err, cpu_s = check_against_plain(cfg, params, PLAIN_LAYERS, args.seed + 7, dev)
    serving = {"runs": runs, "peak_gib": peak_gib, "plain_check_rel_rms": err,
               "plain_check_lm_layers": PLAIN_LAYERS, "plain_check_cpu_s": cpu_s}
    torch.cuda.empty_cache()

    # phase 4 --------------------------------------------------------------
    log(f"phase 4: flagship VisualRWKV-7 1B5 training, full width, micro-batch {TRAIN_MICRO_BSZ} x "
        f"{TRAIN_CTX} tokens, one image a sample, 1 warm-up + {TRAIN_STEPS} counted steps")
    training, train_launches, train_want = run_training(cfg, params, dev, args.seed)
    log(f"  peak memory over the counted steps: {training['peak_gib']:.2f} GiB "
        f"(reckoned {training['reckoned_gb']['sum']:.2f} GB before activations and temporaries)")
    log_breakdown("one training step", training["breakdown"])
    assert_launches("training", train_launches, train_want)
    torch.cuda.empty_cache()
    # the serving breakdown comes last of the runs: the profiler slows what follows it
    serving["breakdown"] = profile_serving(cfg, params, dev, args.seed)
    log_breakdown("serving", serving["breakdown"])
    training["plain_check"] = check_training_against_plain(cfg, params, PLAIN_LAYERS, args.seed + 11, dev)
    del params
    torch.cuda.empty_cache()

    # results --------------------------------------------------------------
    # launches of each kernel over the counted runs of the three paths
    by_path = {"serving_head": launches, "serving_flat": flat_launches, "training": train_launches}
    rows = []
    for name, cases in kernels.items():
        first = dict(cases[0])
        per_path = {path: counts.get(name, 0) for path, counts in by_path.items()}
        assert sum(per_path.values()) > 0, f"kernel {name} was launched on no path"
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "launches": sum(per_path.values()),
                     "launches_by_path": per_path,
                     **{k: first[k] for k in ("max_abs_err", "max_err", "tol", "ms", "kernel_ms",
                                              "plain_ms", "bound_ms", "bound_by", "library_ms")},
                     "case": first["case"], "cases": cases})
    log(json.dumps({"card": card, "build_s": build_s, "serving": serving, "training": training}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
