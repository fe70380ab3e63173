#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``visualrwkv_torch``) on one NVIDIA
GPU (written for the H100, ``sm_90a``).

    python3 chip_smoke.py            # all phases, one card

Phases (any failure exits non-zero; nothing is caught):

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every kernel under ``visualrwkv_torch/csrc``
   (one ``nvcc`` per source, all started together, into ``build/``).
2. Each kernel against its plain PyTorch version on the card, at the
   shapes of the serving and training paths below, with kernel, plain
   and library (one PyTorch call computing the same function, timed as a
   yardstick only) times and the least time the card could take
   (``bound_ms``). The decode steps K2 / K4 at B = 1, 4 and 32 with fp32
   and bf16 states (``STEP_CASES``), each case logging its plan, timed
   L2-hot, L2-cold (the state cycling over copies larger than L2) and
   beside the launch floor (an empty kernel on K2's grid), K4 equal to K2
   bit for bit. The chunked WKV7 prefill forward K1 at the 1B5
   prefill's shapes (B=1 and the serving batch B=4, T=1056), each case
   logging its plan (no K1 / K11 instantiation may spill), at ragged T
   (0, 1, 8, 24, 1049: ``WKV7_FWD_RAGGED_CASES``), at phase 13's
   no-gradient shapes (``WKV7_FWD_PHASE13_CASES``) and at the thirteen
   inputs of ``WKV7_FWD_RES_PATH_CASES`` against the fp32 sequential scan, with K11
   equal to K1 bit for bit everywhere. The head-pair ("packed") kernels
   K11-K13 are held against their plain versions too, K11 beside K1, and
   K12 must equal K5 bit for bit; the chunked WKV7 training forward K5 /
   K12 at the 1B5 step's shape, each case logging its plan (value rows a block, blocks,
   threads, shared memory held equal to the library's count, registers,
   spills: no K5 / K12 instantiation may spill), and at thirteen more
   inputs (phase 13's training shapes among them) against the fp32
   sequential scan (``WKV7_FWD_RES_PATH_CASES``); the
   two-pass chunked backward K6 / K13 at the 1B5 step's shape (K13 equal
   to K6 bit for bit), each case logging both passes' plans and the
   workspace (no K6 / K13 instantiation may spill), at those thirteen
   inputs against fp32 autograd of the sequential scan, and under autograd
   through ``ops.wkv7.wkv7`` at T = 2040, chunk 8 (identity-padded to 2048)
   against the plain path;
   K3 beside the SDPA forward with the rel-pos bias (SAM-B at 1024, 768
   and 512 pixels) and without (the ViTs), with and without its
   log-sum-exp output, each case logging its plan (path, key tile, block
   rows, registers, spills: none may spill), and at five more geometries
   against the plain version only; the attention backward K14 / K15 with
   the rel-pos bias (SAM-B at 1024, 768 and 512 pixels) and without (the
   ViTs), beside the SDPA backward, each case logging its plan (K14's path
   and key tile, K15's table staging, registers, spills, shared memory),
   and at three more grid geometries against the plain version only; the
   chunk-batched WKV7 forward K16 beside K1 (``check_wkv7_v2``: B=8 T=512 and
   B=1 T=1024 with bf16 streams, B=1 T=1024 fp32), each case logging its two
   launches' plan (held equal to the library's numbers), the scratch bytes
   and each phase's device time alone (no K16 instantiation may spill); the
   WKV6 decode step K10 at B = 1, 4 and 32 with fp32 and bf16 states and
   H=64 (``WKV6_STEP_CASES``), timed as K2 is, beside the launch floor on
   K10's grid, and K10 on the flat state at the same cases, bit-equal to
   K10; the chunked WKV6 forward K7 / K8 at
   the 7B prefill's and the 1.6B step's shapes, each case logging its plan
   (value rows a block, blocks, threads, shared memory held equal to the
   library's count, registers, spills: no K7 / K8 instantiation may spill),
   and at ten more geometries (phase 13's x060 shapes among them) against
   the plain scan only (``WKV6_FWD_PATH_CASES``); the two-pass chunked WKV6 backward K9 at the
   1.6B step's shape, logging both passes' plans and the workspace (no K9
   instantiation may spill), and at ``WKV6_BWD_PATH_CASES`` (phase 13's
   x060 shapes among them) against fp32
   autograd of the floored sequential scan; x060 at ``chunk_len`` 8, 4 and 1
   (the decay floors -10, -20 and -80) through ``ops.wkv6.wkv6``, K7 and, at
   T = 2040 under autograd, K8 + K9, against ``wkv6_plain(..., chunk)``, with
   K7, K8 and K9 timed at each floor; the RWKV-4 sequence forward K17 at
   the x040 prefill's shapes (B = 1 and 4, T = 1056, C = 2048; k near 80 on
   a quarter of the channels; bf16 k, v) against the plain loop
   (``WKV4_CASES``), and its VJP K18 at those shapes and the v4 adapter's
   (B = 8, T = 64) against ``wkv4_bwd_plain``, each case logging its plan
   (``WKV4_BWD_CASES``).
3. The flagship VisualRWKV-7 1B5 (RWKV-7 L24 D2048, DINOv2-L + SigLIP-so400m
   @448 + SAM-B @1024, gated-MLP projector, 1024 image tokens) on seeded
   random bf16 weights, through ``InferenceEngine.generate``: one image with
   a 1024 + 32 token prompt and 32 greedy tokens (fp32 state), then four
   requests in one batch (bf16 state). The kernels' launch counts over this
   run must be the ones the path implies. Then the prefill logits of the
   kernel path are held against the plain path on the CPU, at a reduced
   LM depth. The four-request batch runs once more with the flat decode
   state (``state_layout="flat"``, kernel K4), and once more under
   ``set_wkv_impl("packed")`` (prefill on K11): the same greedy ids.
4. Training at full width: the same model through ``Trainer`` (bf16
   parameters, fp32 masters, activation checkpointing, chunked head +
   cross-entropy), micro-batch 2 x 2048 tokens with one image a sample, one
   warm-up step and three counted steps; then one step's loss and three
   gradients of the kernel path held against the plain path on the CPU in
   fp32, at a reduced LM depth. Then three more runs of the same model
   through ``Trainer``: (a) under ``set_wkv_impl("packed")`` (K12 / K13),
   1 + 3 steps, with its own plain check; (b) ``grad_cp="wkv"`` (K5 once
   a layer), 1 + 2 steps; (c) ``grad_cp="dots"``, 1 + 1 steps.
5. VisualRWKV-6 7B serving: RWKV-6 World 7B (x060 L32 D4096, dim_ffn 14336)
   behind one CLIP-L/14 @336 tower, all 576 patches and the CLS token
   (``grid_size=-1``, 577 image tokens) through a linear projector, on
   seeded random bf16 weights: the runs of phase 3 (head state only) with a
   577 + 32 token prompt, launch counts, and the plain check.
6. VisualRWKV-6 1.6B training: RWKV-6 World 1.6B (x060 L24 D2048) behind
   the towers and projector of phase 3, through ``Trainer`` as in phase 4,
   with its launch counts and plain check.

7. Gradients through the vision towers at full width (SAM-B @1024,
   DINOv2-L/14-reg4 and SigLIP-so400m/14 @448, one image, seeded random
   bf16 weights): forward + backward to every parameter through K3 with
   lse, K14 and K15, with launch counts, time and peak memory, and every
   parameter gradient against the plain path on the CPU at a cut depth.
8. ``ops.wkv7.wkv7_v2``, the chunk-batched WKV7 forward (K16), once through
   its public entry point.
9. Serving a checkpoint, on the models of phases 3 and 5 while they are
   built (9a, 9b, 9d right after phase 3, 9b, 9c right after phase 5, 9e
   after phase 8), each run with its own launch counts: (a) the 1B5
   exported to the reference's combined layout in memory, imported back
   and served through ``make_engine(..., "gpu bf16")`` (phase 3's one-image
   request: prefill logits and greedy ids bit-equal), its LM at 2 layers
   through ``torch.save`` -> ``load_pth`` and one ``train/cli.py
   --model_path`` step; (b) decode tok/s at B = 1, 4, 32 under
   ``"gpu bf16i8"`` beside ``"gpu bf16"`` (1B5 and 7B, text requests) and
   the int8 prefill logits against the plain path on the CPU at 2 LM
   layers; (c) the 7B's four requests on the flat state (K10 on the flat
   layout) with the head layout's greedy ids; (d) ``BatchedServer``, 8
   requests on 4 slots, each request's greedy ids against
   ``generate()`` alone (fp32 at 4 layers, then full width bf16); (e) fault
   C.3: the four WKV dispatchers on bf16, strided and ``[..., H, N]``
   inputs, bit-equal to the same calls on contiguous copies.
10. Speculative decoding (``infer/speculative.py``) with the int8
   self-draft at k = 2 and 4: (a) phase 3's LM cut to 4 layers in fp32
   (a text prompt of the image request's length: the towers run bf16
   only), B = 1 and 4, greedy ids bit-equal to ``generate()``'s; (b)-(d)
   phase 3's model at full width in bf16 on its one-image requests, B = 1
   and 4: ids agreeing with ``generate()``'s, launches of each run (K2
   2 (k + 1) 24 times a round: the draft's k + 1 steps and the verify
   trail's k + 1 positions; no K1 inside the loop), rounds, mean
   acceptance, and decode tok/s in turns against greedy decode; then
   phase 5's x060 7B cut to 4 fp32 layers, lossless, with one verify
   pass alone launching K10 k + 1 times a layer.
11. The legacy families: RWKV-5 World 1.5B (x052) and RWKV-4 World 1.5B
   (x040) behind phase 5's CLIP-L/14 @336 and linear projector, phase 3's
   runs (x052: K7 a prefill, K10 a token, and the flat state with the head
   layout's ids; x040: K17 a prefill, an fp32 state at B = 1 and 4), with
   launch counts, TTFT, decode tok/s, peak memory and the plain check.
12. The published VisualRWKV-6 / HD / UHD paths, v7.03's token compressor,
   v5.1 scanning and the host-offloaded optimizer, on the models of phases
   3, 5 and 6 while they are built (12d after phase 10, 12a and the 7B part
   of 12c after phase 10's x060 run, 12b, 12c and 12e after phase 6):
   (a) phase 5's 7B with ``insertion_mode="leftpad"`` and
   ``bidirectional_image``: one ``vlm_forward_leftpad`` over four one-image
   prompts of 3600 tokens (the image at four positions, row 0 cut by
   tail-keep truncation; T_out 4096): K7 32, K3 one encode, its time, and
   the logits at 2 LM layers against the plain path on the CPU; (b) phase
   6's 1.6B trained so (the dense loss), 1 + 3 ``Trainer`` steps (K8 48 and
   K9 24 a step) and the training check; (c) the host-offloaded optimizer:
   3 steps offloaded and 3 resident from the same parameters on phase 6's
   1.6B, parameters and optimizer state bit-equal, with the host's memory,
   the pinned bytes, the bytes copied each way a step, the last step's copy
   times and peak memory; then phase 5's 7B offloaded (1 + 2 steps, its peak
   under the card's memory), left out with a line that says so when the
   host's MemAvailable is below 1.1 times the pinned bytes it needs; (d)
   phase 3's 1B5 with two compressor blocks copied from its LM, one request
   (K1 24 + 2 a prefill), then with snake scanning too, and the plain
   check; (e) UHD on the 1.6B (a projector of twice the input), five views
   a tower in one batch (K3 as one encode), the fused features and the
   prefill logits at 2 layers against the plain path fed the card's tower
   features.

13. The separate variant models, on the models of phases 3 and 6 while
   they are built (13a-c after phase 4, 13c's x060 and 13d after phase
   12e) and on phase 11's x040 rebuilt from its seed (13e, after phase
   11), on seeded random weights, each
   run with its launch counts asserted and a plain check (the card in
   fp32 against the CPU in fp32, the model cut to ``PLAIN_LAYERS`` noisy
   blocks, the towers' features taken from the card; each loss and
   gradient logged against its limit): (a) v7.10's VRWKV at the 1B5's
   width (6 blocks, 224 px, 256 patches): 32 images through the ImageNet
   step and ``topk_accuracy`` (K1 6), one ``imagenet_loss`` forward +
   backward (K5 6, K6 6); (b) the mixture-FFN on phase 3's LM with
   ``ffn_v`` / ``ln_v`` behind 13a's VRWKV, B = 2 x 1024 (256 image
   positions), trained under ``pretrain_mode_mask`` (K5 30, K6 30; only
   ``vrwkv``, ``ffn_v``, ``ln_v`` take gradients); (c) image-as-state with
   state tuning on the 1B5 (1024 image tokens of its encode, 256 text, B =
   2: K5 48, K6 48, every layer's ``time_states`` gradient nonzero), a
   ``mean_multi_image`` forward over 3 images (K1 48), and the same on
   phase 6's x060 1.6B (K8 48, K9 48; K7 48); (d) v6.23's hybrid on the
   1.6B, 6 cross blocks every 4 from the end, the flagship towers' 1024
   features, B = 2 x 512: a forward (K7 24), a forward + backward (K8 24,
   K9 24); (e) the v4 adapter (32 queries, 256 features, 2 blocks) behind
   phase 11's RWKV-4 World 1.5B and CLIP-L/14 @336, B = 8, 32-token
   captions: the losses and their gradients (K17 24, K18 24), no LM weight
   taking one.
14. The evaluation suite (``visualrwkv_torch.evals``), on phase 3's model
   while it is built (after phase 12d), each part with its launch counts
   asserted: (a) ``EVAL_QUESTIONS`` one-image questions written in memory
   (numpy images: no PIL) through the runner's per-batch step
   ``eval_batch`` at ``EVAL_BATCHES``, ``NEW_TOKENS`` greedy tokens: the
   records in the reference's schema, each batch's ids equal to a direct
   ``generate()`` on it, questions/s and decode tok/s; then batched against
   single on 4 noisy fp32 LM layers (equal ids); (b) ``rank_candidates``
   over ``RANK_CANDIDATES`` at k = ``RANK_K`` (K2 ``max_len`` x 24 at
   B = k), and at ``PLAIN_LAYERS`` noisy fp32 layers against the CPU's
   plain path (first-token probabilities and CEs within
   ``EVAL_PLAIN_TOL``); (c) ``perplexity`` of ~``PPL_TOKENS`` tokens at
   stride ``PPL_STRIDE`` (K1 24 a window, the last ragged) and one
   ``RWKVLoglikelihood.loglikelihood``, both held the same way; (d) (a)
   on the flat state (K4 in K2's place, ids equal to (a)'s).

15. The tooling (after every timed phase: its trace leaves the profiler
   attached), each part with its launch counts: (a) ``ops.kernel_bench``
   at the JAX bench's default shapes (B=8, T=512, H=32, N=64, bf16
   streams): K1, K7 and the dispatch gradients (K5 + K6, K8 + K9) against
   the fp32 sequential scan, within phase 2's limits (``KBENCH_*_TOL``);
   (b) the 1B5 rebuilt from its seed through ``Trainer.run_epoch`` for
   ``TOOLING_STEPS`` steps, its ``train_log.txt`` (under ``chiprun_out/``)
   read back, ``device_memory()``'s peaks, one more step under
   ``profile_trace`` whose Chrome trace names K5's and K6's launches; (c)
   the CUDA allocator recording every allocation from that build on: the
   live bytes at the peak of those steps grouped by the innermost frame
   inside ``visualrwkv_torch/``, the ``MEMORY_TOP`` largest printed beside
   the reckoning of phase 4.

16. Multi-GPU training on the one card (before phase 15), over a one-rank
   NCCL process group (``nccl_group``: ``parallel.distributed.initialize``
   on a free localhost port): (a) the flagship 1B5 rebuilt from its seed,
   ``PHASE16_STEPS`` steps on phase 4's batches of the plain ``Trainer``,
   then of ``Trainer(mesh=make_mesh(n_data=1))`` at ``zero_stage`` 1 and 3
   from the same parameters (the fp32 bucketed gradient reduction, the
   one-rank ZeRO parts and gathers): their losses and parameters equal
   the plain run's, launches as phase 4's; ``training_loss_seq`` on one
   seq rank (the WKV ring of one shard: K5 from zero, from the identity and
   from the entry state, twice under ``grad_cp``) against
   ``training_loss`` on phase 4's batch, the loss within ``SEQ1_LOSS_TOL``,
   each trainable leaf's gradient within ``SEQ1_GRAD_TOL``; the ring of
   ``RING_SHARDS`` shards on the card (``_ring_on_one_card``: the port's
   ``_ring_entry_states`` over the shards stacked along B, a roll for the
   exchange; fp32 streams, an initial state) against the whole sequence,
   so that K6 differentiates the identity runs; then the x060 1.6B of phase 6 the
   same way (K8 / K9). Two gloo processes on the one card are not run: gloo
   takes CUDA tensors in its all-reduce, all-gather and reduce-scatter, but
   its send / receive (the ring's and the halos' ``ppermute``) aborts the
   process (``PERF.md`` §6, multi-GPU).

The profiler breakdowns of phases 3-6 (and of a ``grad_cp="wkv"`` step;
with K2's and K10's device time a B=1 decode step) come after all counted
runs, each model built again from its seed: once the profiler has been used in a
process it slows every later launch of a host-bound loop.

The whole run's time is logged before the card's name; the line before
the last is the JSON list of kernels; the last line is
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
# Every Trainer of this script writes its train_log.txt here (git-ignored).
TRAIN_LOG_DIR = os.path.join(HERE, "chiprun_out", "train_logs")

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
    "wkv6_fwd": "visualrwkv_tpu/ops/wkv6_pallas.py:72",
    "wkv6_fwd_res": "visualrwkv_tpu/ops/wkv6_pallas.py:134",
    "wkv6_bwd": "visualrwkv_tpu/ops/wkv6_pallas.py:281",
    "wkv6_step": "visualrwkv_tpu/ops/wkv6_pallas.py:370",
    "wkv7_fwd_packed": "visualrwkv_tpu/ops/wkv7_pallas.py:374",
    "wkv7_fwd_res_packed": "visualrwkv_tpu/ops/wkv7_pallas.py:461",
    "wkv7_bwd_packed": "visualrwkv_tpu/ops/wkv7_pallas.py:565",
    "attention_bwd_dq_relpos": "visualrwkv_tpu/vision/flash.py:419",
    "attention_bwd_dkv_relpos": "visualrwkv_tpu/vision/flash.py:442",
    "attention_bwd_dq_mha": "visualrwkv_tpu/vision/flash.py:101",
    "attention_bwd_dkv_mha": "visualrwkv_tpu/vision/flash.py:101",
    "wkv7_fwd_v2": "visualrwkv_tpu/ops/wkv7_pallas.py:1142",
    # jnp in the JAX package, not a pallas_call: x060's decode step on the flat state
    "wkv6_step_flat": "visualrwkv_tpu/ops/wkv6.py:50",
    # a lax.scan in the JAX package, not a pallas_call: x040's sequence form,
    # and its gradient (autodiff of that scan)
    "wkv4_fwd": "visualrwkv_tpu/ops/wkv4.py:41",
    "wkv4_bwd": "visualrwkv_tpu/ops/wkv4.py:41",
}
# the WKV kernels each LM family launches: (prefill, decode step, training
# forward, training backward); "x070 packed" under set_wkv_impl("packed")
WKV_KERNELS = {"x070": ("wkv7_fwd", "wkv7_step", "wkv7_fwd_res", "wkv7_bwd"),
               "x070 packed": ("wkv7_fwd_packed", "wkv7_step", "wkv7_fwd_res_packed", "wkv7_bwd_packed"),
               "x060": ("wkv6_fwd", "wkv6_step", "wkv6_fwd_res", "wkv6_bwd"),
               "x052": ("wkv6_fwd", "wkv6_step", "wkv6_fwd_res", "wkv6_bwd"),
               # x040's decode step is elementwise torch, and its LM is not trained here
               "x040": ("wkv4_fwd", None, None, None)}
# the decode step each LM family launches on the flat state
FLAT_STEP = {"x070": "wkv7_step_flat", "x060": "wkv6_step_flat", "x052": "wkv6_step_flat"}
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
# The kernel-option runs of phase 4 after the main one: (name, grad_cp,
# packed, counted steps after the warm-up step).
TRAIN_OPTION_RUNS = (("training_packed", True, True, 3), ("training_remat_wkv", "wkv", False, 2),
                     ("training_remat_dots", "dots", False, 1))
# The training plain check (one loss and three gradients, kernels on the card
# against the plain path on the CPU in fp32, same bf16 weights): limits on
# the relative difference of the loss and on each gradient's relative RMS.
# The card computes in bf16 where the CPU side computes in fp32, so the
# limits are a few times the readings on an H100, not rounding-level: x070
# loss 2.9e-6 and 6.0e-6, gradients 1.25e-2 (LoRA factor), 6.0e-3 (head),
# 1.89e-2 (projector); x060 loss 1.55e-5, gradients 6.4e-2 (decay LoRA
# factor), 6.3e-3 (head), 9.0e-2 (projector). x060 reads more: its sequence
# path rounds w_raw to bf16 before the double exponential of the decay, as
# the JAX package's does (an ulp of 2^-5 at |w_raw| in [4, 8)), where the fp32
# side does not. So the kernels' own share is held apart, tighter: the LM
# alone (no tower: K3 takes bf16 only), fp32 on the card and on the CPU. It
# reads loss 0 and 8.2e-8, head gradient 2.0e-6 and 8.4e-6, and for the
# decay LoRA factor, whose gradient sums over 2048 tokens with much
# cancellation, 2.5e-4 (x070) and 1.07e-3 (x060): the limits are about ten
# times those readings.
TRAIN_CHECK_LOSS_TOL = 5e-5
TRAIN_CHECK_GRAD_TOL = {"x070": 6e-2, "x060": 2.5e-1}
# Phase 7: timed forward + backward passes a tower, and the limit on each
# parameter gradient's relative RMS, kernel path (card, bf16) against the
# plain path (CPU, fp32) on the tower cut to its first blocks: about four
# times the worst readings on an H100 (SAM-B 1.35e-2, a global block's
# rel_pos_w; DINOv2-L 9.1e-3 and SigLIP 9.9e-3, an attention projection),
# which are bf16 rounding, as in the training check above.
TOWER_GRAD_REPS = 3
TOWER_GRAD_TOL = 5e-2
TRAIN_CHECK_FP32_LOSS_TOL = 1e-6
TRAIN_CHECK_FP32_GRAD_TOL = 1e-2
SOURCES = {
    "wkv7_fwd": "visualrwkv_torch/csrc/wkv7_chunk.cuh",
    "wkv7_step": "visualrwkv_torch/csrc/wkv7.cu",
    "wkv7_step_flat": "visualrwkv_torch/csrc/wkv7.cu",
    "wkv7_fwd_res": "visualrwkv_torch/csrc/wkv7_chunk.cuh",
    "wkv7_bwd": "visualrwkv_torch/csrc/wkv7_chunk_bwd.cuh",
    "attention_fwd_relpos": "visualrwkv_torch/csrc/attention.cu",
    "attention_fwd_mha": "visualrwkv_torch/csrc/attention.cu",
    "wkv6_fwd": "visualrwkv_torch/csrc/wkv6.cu",
    "wkv6_fwd_res": "visualrwkv_torch/csrc/wkv6.cu",
    "wkv6_bwd": "visualrwkv_torch/csrc/wkv6_chunk_bwd.cuh",
    "wkv6_step": "visualrwkv_torch/csrc/wkv6.cu",
    "wkv7_fwd_packed": "visualrwkv_torch/csrc/wkv7_chunk.cuh",
    "wkv7_fwd_res_packed": "visualrwkv_torch/csrc/wkv7_chunk.cuh",
    "wkv7_bwd_packed": "visualrwkv_torch/csrc/wkv7_chunk_bwd.cuh",
    "attention_bwd_dq_relpos": "visualrwkv_torch/csrc/attention_bwd.cu",
    "attention_bwd_dkv_relpos": "visualrwkv_torch/csrc/attention_bwd.cu",
    "attention_bwd_dq_mha": "visualrwkv_torch/csrc/attention_bwd.cu",
    "attention_bwd_dkv_mha": "visualrwkv_torch/csrc/attention_bwd.cu",
    "wkv7_fwd_v2": "visualrwkv_torch/csrc/wkv7_v2.cu",
    "wkv6_step_flat": "visualrwkv_torch/csrc/wkv6.cu",
    "wkv4_fwd": "visualrwkv_torch/csrc/wkv4.cu",
    "wkv4_bwd": "visualrwkv_torch/csrc/wkv4.cu",
}


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def eager_ms(fn, **kw) -> float:
    """``visualrwkv_torch.utils.timing.eager_ms``: back-to-back eager calls
    between CUDA events, the host's cost of issuing them included."""
    from visualrwkv_torch.utils import timing

    return timing.eager_ms(fn, **kw)


def cuda_ms(fn, **kw) -> float:
    """``visualrwkv_torch.utils.timing.cuda_ms``: the device time of one call,
    replayed from a CUDA graph between CUDA events."""
    from visualrwkv_torch.utils import timing

    return timing.cuda_ms(fn, **kw)


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
    """K1 at the prefill's shapes (B=1 T=1056 H=32: bf16 streams without and
    with an initial state, fp32 streams with one; the serving batch B=4 in
    bf16) against the fp32 sequential scan, each case logging its plan
    (:func:`wkv7_fwd_res_plan`), timed."""
    import torch

    from visualrwkv_torch.ops import wkv7 as pw
    from visualrwkv_torch.ops import wkv7_cuda

    T, H, N = 1056, 32, 64
    out = []
    # bf16 streams are the flagship's; fp32 streams are what an fp32-compute
    # model passes, and that build of K1 is held here too.
    for B, sdt, with_state in ((1, torch.bfloat16, False), (1, torch.bfloat16, True), (1, torch.float32, True),
                               (4, torch.bfloat16, True)):
        dname = str(sdt)[6:]
        case = f"B={B} T={T} H={H} N={N} {dname} streams, {'with' if with_state else 'no'} initial state"
        plan = wkv7_fwd_res_plan(case, B, H, sdt, save=False)
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
        rec = c.record(k_ms, p_ms, None, nbytes, ops, FP32_FLOPS, k_eager)
        rec["plan"] = plan
        out.append(rec)
        del xs
    return out


# K1 / K11 at lengths no timed case takes, held against the fp32 sequential
# scan but not timed: (B, T, H, stream dtype, initial state). T = 0 returns
# the initial state (zeros without one); T = 1, 8, 24 and 1049 end in a
# partial 16-step chunk whose steps past T the kernel masks (1049: 65 whole
# chunks before it, a prefill of 1024 image tokens and a 25-token prompt).
WKV7_FWD_RAGGED_CASES = tuple((1, T, 32, dname, with_state) for T in (0, 1, 8, 24, 1049)
                              for dname in ("bfloat16", "float32") for with_state in (False, True))
# K1 at phase 13's no-gradient shapes, held as the ragged cases are: (what,
# B, T, H, stream dtype, initial state). 13a's ImageNet step (32 images of
# 256 patches); 13c's mean_multi_image forward (3 images of 1024 tokens,
# from a zero state and from tuned states) and its text pass (B=2, 256
# tokens from the image state).
WKV7_FWD_PHASE13_CASES = (
    ("13a ImageNet step", 32, 256, 32, "bfloat16", False),
    ("13c mean of three images", 3, 1024, 32, "bfloat16", False),
    ("13c mean of three images", 3, 1024, 32, "bfloat16", True),
    ("13c text pass", 2, 256, 32, "bfloat16", True),
)


def check_wkv7_fwd_paths(gen, dev):
    """K1 at ``WKV7_FWD_RAGGED_CASES``, ``WKV7_FWD_PHASE13_CASES`` and the
    inputs of ``WKV7_FWD_RES_PATH_CASES`` (the chunk solve's stability
    constructions, w_raw = -0.5 and 2.0 on every channel, B*H = 18 and 128,
    phase 13's training shapes) against the
    fp32 sequential scan, under the limits of the timed cases: y 1e-2 (bf16
    streams) or 1e-3 (fp32), the final state 1e-3; K11 equal to K1 bit for
    bit everywhere, and at T = 0 the state returned unchanged."""
    import torch

    from visualrwkv_torch.ops import wkv7 as pw
    from visualrwkv_torch.ops import wkv7_cuda

    N = 64
    cases = [(f"ragged T={T}", B, T, H, dname, with_state)
             for B, T, H, dname, with_state in WKV7_FWD_RAGGED_CASES]
    cases += list(WKV7_FWD_PHASE13_CASES)
    cases += [(what, B, T, H, dname, True) for what, B, T, H, dname in WKV7_FWD_RES_PATH_CASES]
    for what, B, T, H, dname, with_state in cases:
        sdt = getattr(torch, dname)
        case = f"{what}: B={B} T={T} H={H} {dname} streams, {'with' if with_state else 'no'} initial state"
        wkv7_fwd_res_plan(case, B, H, sdt, save=False)
        xs = [x.to(sdt).contiguous() for x in _wkv7_path_streams(gen, what, (B, T, H, N), dev)]
        s0 = torch.randn(B, H, N, N, generator=gen, device=dev) * 0.3 if with_state else None
        y, s = wkv7_cuda.wkv7_fwd(*xs, s0)
        y_ref, s_ref = pw.wkv7_reference(*[x.float() for x in xs], s0)
        torch.cuda.synchronize()
        assert y.shape == xs[0].shape and y.dtype == sdt, (case, y.shape, y.dtype)
        if T == 0:
            want = s0 if with_state else torch.zeros_like(s)
            assert torch.equal(s, want), f"K1 changed the state at T = 0 [{case}]"
            log(f"  wkv7_fwd [{case}] final state equal to the initial one")
        else:
            c = Check("wkv7_fwd", case)
            c.compare(f"y ({dname}) vs fp32 sequential scan", y.float(), y_ref.float(),
                      1e-2 if sdt == torch.bfloat16 else 1e-3)
            c.compare("final state (fp32)", s, s_ref, 1e-3)
        yp, sp = wkv7_cuda.wkv7_fwd_packed(*xs, s0)
        diff = max(max_abs(yp, y) if T else 0.0, max_abs(sp, s))
        log(f"  wkv7_fwd_packed [{case}] largest difference from K1: {diff:.3e}")
        assert diff == 0, f"K11 differs from K1 by {diff:.3e} [{case}]"
        del xs


# K2 / K4's cases: (B, state dtype) at H=32, the flagship's heads: the
# serving path's B=1 (fp32 state) and its batch of four (bf16), the other
# dtype of each, and B=32, where the grid fills the card
STEP_CASES = tuple((B, dname) for B in (1, 4, 32) for dname in ("float32", "bfloat16"))
# Bytes of distinct states an L2-cold timing cycles through: more than twice
# the H100's 50 MB L2, so that each call reads its state from device memory,
# as a decode step does once the other layers' weights have streamed through
COLD_BYTES = 128 << 20


def cold_ms(fn, state, reps: int = 0) -> float:
    """Device time of ``fn(s)`` with ``s`` cycling over copies of ``state``
    (at least ``reps``, and more than ``COLD_BYTES`` in all): one CUDA graph
    calls ``fn`` once on each copy, replayed as in :func:`cuda_ms`, so no
    call finds its state in L2."""
    import itertools

    n = max(reps, 8, -(-COLD_BYTES // (state.numel() * state.element_size())))
    states = itertools.cycle([state.clone() for _ in range(n)])
    return cuda_ms(lambda: fn(next(states)), reps=n, warmup=2)


def _step_inputs(gen, B, H, sdt, dev):
    """Decode-step vectors (fp32 [B, H, 64]) and a head-layout state in ``sdt``."""
    import torch

    vecs = _wkv_streams(gen, (B, H, 64), torch.float32, dev)
    return vecs, (torch.randn(B, H, 64, 64, generator=gen, device=dev) * 0.3).to(sdt)


def check_wkv7_step(gen, dev):
    """K2 at ``STEP_CASES`` against the plain step (y 1e-3; the new state
    1e-3 fp32, 1e-2 bf16: one bf16 rounding), each case logging its plan
    (``wkv7_cuda.step_plan``). Timed L2-hot (:func:`cuda_ms` calls it on one
    state), L2-cold (:func:`cold_ms`) and eagerly, beside the launch floor:
    an empty kernel on the same grid with the same arguments
    (``wkv7_cuda.step_floor``), timed by :func:`cuda_ms` too."""
    import torch

    from visualrwkv_torch.ops import wkv7 as pw
    from visualrwkv_torch.ops import wkv7_cuda

    H, N = 32, 64
    out = []
    for B, dname in STEP_CASES:
        sdt = getattr(torch, dname)
        case = f"B={B} H={H} N={N} {dname} state, fp32 vectors"
        plan = wkv7_cuda.step_plan(B, H, sdt)
        log(f"  wkv7_step [{case}] plan: {plan}")
        vecs, s0 = _step_inputs(gen, B, H, sdt, dev)
        c = Check("wkv7_step", case)
        s, y = wkv7_cuda.wkv7_step(s0, *vecs)
        s_ref, y_ref = pw.wkv7_step(s0, *vecs)
        torch.cuda.synchronize()
        assert s.dtype == sdt
        c.compare("y (fp32)", y, y_ref, 1e-3)
        c.compare(f"new state ({dname})", s.float(), s_ref, 1e-3 if sdt == torch.float32 else 1e-2)
        fn = lambda: wkv7_cuda.wkv7_step(s0, *vecs)
        k_ms, k_eager = cuda_ms(fn, reps=50), eager_ms(fn, reps=50)
        k_cold = cold_ms(lambda st: wkv7_cuda.wkv7_step(st, *vecs), s0)
        floor_ms = cuda_ms(lambda: wkv7_cuda.step_floor(s0, *vecs), reps=50)
        p_ms = cuda_ms(lambda: pw.wkv7_step(s0, *vecs), reps=20)
        nbytes = 2 * B * H * N * N * s0.element_size() + 7 * B * H * N * 4
        rec = c.record(k_ms, p_ms, None, nbytes, 9 * B * H * N * N, FP32_FLOPS, k_eager)
        rec.update(plan=plan, cold_ms=k_cold, launch_floor_ms=floor_ms)
        log(f"  wkv7_step [{case}] L2-cold {k_cold:.5f} ms, launch floor (empty kernel, same grid) "
            f"{floor_ms:.5f} ms")
        if B == 1 and sdt == torch.float32:
            goal = max(0.0018, floor_ms + 0.0006)
            log(f"  wkv7_step [{case}] goal: at most max(0.0018, floor + 0.0006) = {goal:.5f} ms: "
                f"{'met' if k_ms <= goal else 'missed'} ({k_ms:.5f} ms)")
        out.append(rec)
    return out


def check_wkv7_step_flat(gen, dev):
    """K4 on the flat state [B, 64, H*64] at ``STEP_CASES`` against its plain
    version, timed as K2 is in :func:`check_wkv7_step`, and beside K2 on the
    same state in the head layout: K4's y and new state must equal K2's bit
    for bit (one template, only the row stride differs)."""
    import torch

    from visualrwkv_torch.ops import wkv7 as pw
    from visualrwkv_torch.ops import wkv7_cuda

    H, N = 32, 64
    out = []
    for B, dname in STEP_CASES:
        sdt = getattr(torch, dname)
        case = f"B={B} H={H} N={N} {dname} flat state [B, {N}, {H * N}], fp32 vectors"
        plan = wkv7_cuda.step_plan(B, H, sdt, flat=True)
        log(f"  wkv7_step_flat [{case}] plan: {plan}")
        vecs, head = _step_inputs(gen, B, H, sdt, dev)
        s0 = pw.state_to_flat(head).contiguous()
        c = Check("wkv7_step_flat", case)
        s, y = wkv7_cuda.wkv7_step_flat(s0, *vecs)
        s_ref, y_ref = pw.wkv7_step_flat(s0.float(), *vecs)
        s2, y2 = wkv7_cuda.wkv7_step(head, *vecs)
        torch.cuda.synchronize()
        assert s.dtype == sdt and s.shape == s0.shape
        c.compare("y (fp32)", y, y_ref, 1e-3)
        c.compare(f"new state ({dname})", s.float(), s_ref, 1e-3 if sdt == torch.float32 else 1e-2)
        assert torch.equal(y, y2) and torch.equal(pw.state_from_flat(s, H), s2), \
            f"K4 differs from K2 on the same state [{case}]"
        log(f"  wkv7_step_flat [{case}] y and new state equal to K2's on the same state, bit for bit")
        fn = lambda: wkv7_cuda.wkv7_step_flat(s0, *vecs)
        k_ms, k_eager = cuda_ms(fn, reps=50), eager_ms(fn, reps=50)
        k_cold = cold_ms(lambda st: wkv7_cuda.wkv7_step_flat(st, *vecs), s0)
        p_ms = cuda_ms(lambda: pw.wkv7_step_flat(s0, *vecs), reps=20)
        k2_ms = cuda_ms(lambda: wkv7_cuda.wkv7_step(head, *vecs), reps=50)
        nbytes = 2 * B * H * N * N * s0.element_size() + 7 * B * H * N * 4
        rec = c.record(k_ms, p_ms, None, nbytes, 9 * B * H * N * N, FP32_FLOPS, k_eager)
        rec.update(plan=plan, cold_ms=k_cold, head_layout_k2_ms=k2_ms)
        log(f"  wkv7_step_flat [{case}] L2-cold {k_cold:.5f} ms; K2 on the head layout at the same B: "
            f"{k2_ms:.5f} ms")
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
        plan = wkv7_fwd_res_plan(case, B, H, sdt)
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
        rec.update(k1_same_shape_ms=k1_ms, plan=plan)
        log(f"  wkv7_fwd_res [{case}] K1 (no saved states) at the same shape: {k1_ms:.4f} ms")
        fwd.append(rec)

        c = Check("wkv7_bwd", case)
        bplan = wkv7_bwd_plan(case, B, T, H, sdt)
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
        # the work's own bound (the workspace's traffic is the design's, logged
        # apart in the plan): read 6 streams + dy + zin + dsf, write 6
        # gradients + d(initial state); per state element and step: 7
        # operations to rebuild the state before the step and 20 for its adjoint
        nbytes = 13 * B * T * H * N * esz + zin.numel() * 4 + 2 * B * H * N * N * 4
        rec = c.record(k_ms, t_plain, None, nbytes, 27 * B * T * H * N * N, FP32_FLOPS, k_eager)
        rec["plan"] = bplan
        bwd.append(rec)
        del xs, xs32, zin, zin_ref, grads, ref
    return fwd, bwd


def check_wkv7_fwd_packed(gen, dev):
    """K11 at the prefill's shapes (B=1 T=1056 H=32) with an initial state,
    in bf16 and with fp32 streams, each case logging its plan, against its
    plain version on the same values in fp32 (the plain version run in bf16
    rounds intermediates of its chunked form to bf16, which the kernel does
    not), and beside K1 on the same inputs: K1's kernel with the head-pair
    instantiation, so its outputs must equal K1's bit for bit."""
    import torch

    from visualrwkv_torch.ops import wkv7 as pw
    from visualrwkv_torch.ops import wkv7_cuda

    B, T, H, N = 1, 1056, 32, 64
    out = []
    for sdt in (torch.bfloat16, torch.float32):
        dname = str(sdt)[6:]
        case = f"B={B} T={T} H={H} N={N} {dname} streams, with initial state"
        plan = wkv7_fwd_res_plan(case, B, H, sdt, save=False)
        xs = _wkv_streams(gen, (B, T, H, N), sdt, dev)
        s0 = torch.randn(B, H, N, N, generator=gen, device=dev) * 0.3
        c = Check("wkv7_fwd_packed", case)
        y, s = wkv7_cuda.wkv7_fwd_packed(*xs, s0)
        y_ref, s_ref = pw.wkv7_packed_plain(*[x.float() for x in xs], s0)
        y1, s1 = wkv7_cuda.wkv7_fwd(*xs, s0)
        torch.cuda.synchronize()
        c.compare(f"y ({dname}) vs fp32 plain", y.float(), y_ref, 1e-2 if sdt == torch.bfloat16 else 1e-3)
        c.compare("final state (fp32)", s, s_ref, 1e-3)
        k1_diff = max(max_abs(y, y1), max_abs(s, s1))
        log(f"  wkv7_fwd_packed [{case}] largest difference from K1: {k1_diff:.3e}")
        assert k1_diff == 0, f"K11 differs from K1 by {k1_diff:.3e} [{case}]"
        fn = lambda: wkv7_cuda.wkv7_fwd_packed(*xs, s0)
        k_ms, k_eager = cuda_ms(fn), eager_ms(fn)
        p_ms = cuda_ms(lambda: pw.wkv7_packed_plain(*xs, s0), reps=1, warmup=1)
        k1_ms = cuda_ms(lambda: wkv7_cuda.wkv7_fwd(*xs, s0))
        nbytes = 7 * B * T * H * N * xs[0].element_size() + 2 * B * H * N * N * 4
        rec = c.record(k_ms, p_ms, None, nbytes, 9 * B * T * H * N * N, FP32_FLOPS, k_eager)
        rec.update(k1_same_inputs_ms=k1_ms, max_abs_diff_from_k1=k1_diff, plan=plan)
        log(f"  wkv7_fwd_packed [{case}] K1 on the same inputs: {k1_ms:.4f} ms")
        out.append(rec)
    return out


def check_wkv7_packed_train(gen, dev):
    """K12 (forward saving the packed chunk states) and K13 (backward from
    them) at the training path's shapes, as :func:`check_wkv7_train` holds
    K5 and K6: K12 against the packed plain scan, K13 against the packed
    plain backward on the same values in fp32. K12 is K5's kernel with the
    packed ``zin`` addressing: its y, final state and ``zin`` must equal K5's
    (repacked) bit for bit; its time stands beside K5's. K13 is K6's two
    kernels with the same addressing: its seven gradients must equal K6's on
    K5's states bit for bit; its time stands beside K6's."""
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

        c = Check("wkv7_fwd_res_packed", case)
        plan = wkv7_fwd_res_plan(case, B, H, sdt)
        y, s, zin = wkv7_cuda.wkv7_fwd_res_packed(*xs, s0)
        (y_ref, s_ref, zin_ref), t_plain = timed_once(lambda: pw.wkv7_fwd_res_packed_plain(*xs, s0))
        c.compare(f"y ({dname})", y.float(), y_ref.float(), 1e-2 if bf else 1e-3)
        c.compare("final state (fp32)", s, s_ref, 1e-3)
        c.compare("saved packed chunk states zin (fp32)", zin, zin_ref, 1e-3)
        y5, s5, zin5 = wkv7_cuda.wkv7_fwd_res(*xs, s0)
        k5_diff = max(max_abs(zin, pw._pack_zin(zin5, B, H)), max_abs(y, y5), max_abs(s, s5))
        log(f"  wkv7_fwd_res_packed [{case}] largest difference from K5 (y, final state, zin "
            f"repacked): {k5_diff:.3e}")
        assert k5_diff == 0, f"K12 differs from K5 by {k5_diff:.3e} [{case}]"
        del y5, s5
        fn = lambda: wkv7_cuda.wkv7_fwd_res_packed(*xs, s0)
        k_ms, k_eager = cuda_ms(fn, reps=5), eager_ms(fn, reps=5)
        k5_ms = cuda_ms(lambda: wkv7_cuda.wkv7_fwd_res(*xs, s0), reps=5)
        esz = xs[0].element_size()
        nbytes = 7 * B * T * H * N * esz + 2 * B * H * N * N * 4 + zin.numel() * 4
        rec = c.record(k_ms, t_plain, None, nbytes, 9 * B * T * H * N * N, FP32_FLOPS, k_eager)
        rec.update(k5_same_inputs_ms=k5_ms, max_abs_diff_from_k5=k5_diff, plan=plan)
        log(f"  wkv7_fwd_res_packed [{case}] K5 on the same inputs: {k5_ms:.4f} ms")
        fwd.append(rec)

        c = Check("wkv7_bwd_packed", case)
        bplan = wkv7_bwd_plan(case, B, T, H, sdt)
        grads = wkv7_cuda.wkv7_bwd_packed(*xs, zin, dy, dsf)
        xs32 = [x.float() for x in xs]
        ref, t_plain = timed_once(lambda: pw.wkv7_bwd_packed_plain(*xs32, zin_ref, dy.float(), dsf))
        for name, g, g_ref in zip(names, grads, ref):
            assert g.dtype == sdt
            c.compare(f"{name} ({dname}) vs fp32 plain backward", g.float(), g_ref, 2e-2 if bf else 1e-3)
        c.compare("d(initial state) (fp32)", grads[6], ref[6], 2e-2 if bf else 1e-3)
        k6_diff = max(max_abs(g, g6) for g, g6 in zip(grads, wkv7_cuda.wkv7_bwd(*xs, zin5, dy, dsf)))
        log(f"  wkv7_bwd_packed [{case}] largest difference from K6 on the same states: {k6_diff:.3e}")
        assert k6_diff == 0, f"K13 differs from K6 by {k6_diff:.3e} [{case}]"
        fn = lambda: wkv7_cuda.wkv7_bwd_packed(*xs, zin, dy, dsf)
        k_ms, k_eager = cuda_ms(fn, reps=3), eager_ms(fn, reps=3)
        k6_ms = cuda_ms(lambda: wkv7_cuda.wkv7_bwd(*xs, zin5, dy, dsf), reps=3)
        log(f"  wkv7_bwd_packed [{case}] K6 on the same inputs: {k6_ms:.4f} ms")
        nbytes = 13 * B * T * H * N * esz + zin.numel() * 4 + 2 * B * H * N * N * 4
        rec = c.record(k_ms, t_plain, None, nbytes, 27 * B * T * H * N * N, FP32_FLOPS, k_eager)
        rec.update(k6_same_inputs_ms=k6_ms, max_abs_diff_from_k6=k6_diff, plan=bplan)
        bwd.append(rec)
        del xs, xs32, zin, zin5, zin_ref, grads, ref
    return fwd, bwd


def wkv7_fwd_res_plan(case, B, H, dtype, save=True):
    """The chunked WKV7 forward's plan for B * H heads
    (``wkv7_cuda.fwd_res_plan``: value rows a block, blocks, threads, shared
    memory, held equal to the library's own count), logged with ptxas's
    registers and spills of the instantiations it launches: K5 and K12
    (``save``), or K1 and K11."""
    import torch

    from visualrwkv_torch.ops import wkv7_cuda

    plan = wkv7_cuda.fwd_res_plan(B, H, dtype)
    assert plan["smem_bytes"] == wkv7_cuda.kernel_smem_bytes(dtype, plan["rows"]), plan
    code = int(dtype == torch.bfloat16)
    names = ("k5", "k12") if save else ("k1", "k11")
    for lib, zheads, name in zip(("wkv7", "wkv7_packed"), (1, 2), names):
        plan[f"{name}_ptxas"] = PTXAS.get((lib, "wkv7_fwd_res_kernel", (code, plan["rows"], zheads, int(save))))
    regs = lambda p: "not parsed" if p is None else (f"{p.get('registers')} registers, "
                                                     f"{p.get('spill_bytes', 0)} B spilled")
    log(f"  wkv7 {'training' if save else 'prefill'} forward [{case}] plan: {plan['rows']} value rows a block, "
        f"{plan['blocks']} blocks of {plan['threads']} threads, {plan['smem_bytes']} B shared; "
        f"{names[0].upper()} {regs(plan[names[0] + '_ptxas'])}, {names[1].upper()} {regs(plan[names[1] + '_ptxas'])}")
    return plan


def wkv7_bwd_plan(case, B, T, H, dtype):
    """K6 / K13's two launches for B * H heads of T steps
    (``wkv7_cuda.bwd_plan``: the first pass laid out as K5, the second a
    block of 256 threads a (b, h, chunk), its shared memory held equal to
    the library's own count) and the workspace, logged with ptxas's
    registers and spills of the four instantiations they launch."""
    import torch

    from visualrwkv_torch.ops import wkv7_cuda

    plan = wkv7_cuda.bwd_plan(B, T, H, dtype)
    assert plan["chunk"]["smem_bytes"] == wkv7_cuda.kernel_bwd_chunk_smem_bytes(dtype), plan
    code, rows = int(dtype == torch.bfloat16), plan["state"]["rows"]
    for lib, zheads, name in (("wkv7_train", 1, "k6"), ("wkv7_packed", 2, "k13")):
        plan[f"{name}_ptxas"] = {"state": PTXAS.get((lib, "wkv7_bwd_state_kernel", (code, rows, zheads))),
                                 "chunk": PTXAS.get((lib, "wkv7_bwd_chunk_kernel", (code, zheads)))}
    regs = lambda p: "not parsed" if p is None else (f"{p.get('registers')} registers, "
                                                     f"{p.get('spill_bytes', 0)} B spilled")
    p1, p2 = plan["state"], plan["chunk"]
    log(f"  wkv7 backward [{case}] plan: pass 1 {p1['rows']} value rows a block, {p1['blocks']} blocks of "
        f"{p1['threads']} threads, {p1['smem_bytes']} B shared (K6 {regs(plan['k6_ptxas']['state'])}, K13 "
        f"{regs(plan['k13_ptxas']['state'])}); pass 2 {p2['blocks']} blocks of {p2['threads']} threads, "
        f"{p2['smem_bytes']} B shared (K6 {regs(plan['k6_ptxas']['chunk'])}, K13 "
        f"{regs(plan['k13_ptxas']['chunk'])}); workspace {plan['workspace_bytes']} B")
    return plan


# K5 / K12 inputs held against the fp32 sequential scan but not timed: (what,
# B, T, H, stream dtype). The chunk solve's adversarial construction
# (sign-alternating unit kk, a gate 0.9, slow decay) and the first optimizer
# step's (kk correlated over t with random sign flips, gate 0.85) of
# tests/test_wkv7_stability.py; the models' strongest decay (w_raw = -0.5)
# on every channel with |r| <= 1e-3 on a quarter of them; w_raw = 2.0 on
# every channel (a decay of e^{-7.4} a step: the factors of a chunk reach
# e^{+-59}); B * H = 18 (16 value rows a block, 72 blocks) and B * H = 128
# (64 rows, 128 blocks), which no timed case takes; and phase 13's training
# shapes on RWKV-7-shaped streams: 13a's 32 images of 256 patches, 13b's LM
# and 13c's image pass (B=2, 1024 tokens), 13b's VRWKV and 13c's text pass
# (B=2, 256).
WKV7_FWD_RES_PATH_CASES = (
    ("adversarial", 1, 256, 2, "float32"),
    ("adversarial", 1, 256, 2, "bfloat16"),
    ("first optimizer step", 1, 256, 2, "float32"),
    ("first optimizer step", 1, 256, 2, "bfloat16"),
    ("w_raw = -0.5 on every channel, |r| <= 1e-3 on a quarter", 2, 256, 32, "float32"),
    ("w_raw = -0.5 on every channel, |r| <= 1e-3 on a quarter", 2, 256, 32, "bfloat16"),
    ("w_raw = 2.0 on every channel", 2, 256, 32, "float32"),
    ("w_raw = 2.0 on every channel", 2, 256, 32, "bfloat16"),
    ("B*H = 18", 3, 96, 6, "float32"),
    ("B*H = 128", 2, 96, 64, "bfloat16"),
    ("13a imagenet_loss", 32, 256, 32, "bfloat16"),
    ("13b LM, 13c image pass", 2, 1024, 32, "bfloat16"),
    ("13b VRWKV, 13c text pass", 2, 256, 32, "bfloat16"),
)


def _wkv7_path_streams(gen, what, shape, dev):
    """fp32 streams for a case of ``WKV7_FWD_RES_PATH_CASES``."""
    import torch
    import torch.nn.functional as F

    B, T, H, N = shape
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    if what == "adversarial":
        sign = (-1.0) ** torch.arange(T, device=dev).view(1, T, 1, 1)
        kk = F.normalize(rn(1, 1, H, N), dim=-1) * sign
        kk = kk.expand(B, T, H, N)
        w_raw = torch.full(shape, -7.0, device=dev)
        return [rn(*shape) * 0.5, w_raw, rn(*shape) * 0.05, rn(*shape) * 0.5, -kk, kk * 0.9]
    if what == "first optimizer step":
        kk = F.normalize(rn(1, 1, H, N) + 0.15 * rn(*shape), dim=-1)
        flip = torch.where(torch.rand(B, T, 1, 1, generator=gen, device=dev) < 0.35, -1.0, 1.0)
        kk = kk * flip
        w_raw = torch.full(shape, -6.0, device=dev)
        return [rn(*shape) * 0.5, w_raw, rn(*shape) * 0.05, rn(*shape) * 0.5, -kk, kk * 0.85]
    xs = _wkv_streams(gen, shape, torch.float32, dev)
    if what.startswith("w_raw = -0.5"):
        xs[1] = torch.full(shape, -0.5, device=dev)
        xs[0][..., ::4] = (torch.rand(xs[0][..., ::4].shape, generator=gen, device=dev) * 2 - 1) * 1e-3
    elif what.startswith("w_raw = 2.0"):
        xs[1] = torch.full(shape, 2.0, device=dev)
    return xs


def _reference_with_states(xs, s0):
    """The fp32 sequential scan (``wkv7_reference``) run chunk by chunk:
    (y, final state, zin ``[B*H, T/16, 64, 64]``, the transposed state
    entering every 16-step chunk)."""
    import torch

    from visualrwkv_torch.ops import wkv7 as pw

    B, T, H, N = xs[0].shape
    s, ys, zs = s0, [], []
    for t in range(0, T, 16):
        zs.append(s.transpose(-1, -2).reshape(B * H, 1, N, N))
        y, s = pw.wkv7_reference(*(x[:, t:t + 16] for x in xs), s)
        ys.append(y)
    return torch.cat(ys, 1), s, torch.cat(zs, 1)


def check_wkv7_fwd_res_paths(gen, dev):
    """K5 and K12 at ``WKV7_FWD_RES_PATH_CASES`` against the fp32 sequential
    scan, with an initial state, under the limits of the timed cases: y 1e-2
    (bf16 streams) or 1e-3 (fp32), the final state and ``zin`` 1e-3; K12
    equal to K5 bit for bit."""
    import torch

    from visualrwkv_torch.ops import wkv7 as pw
    from visualrwkv_torch.ops import wkv7_cuda

    N = 64
    for what, B, T, H, dname in WKV7_FWD_RES_PATH_CASES:
        sdt = getattr(torch, dname)
        case = f"{what}: B={B} T={T} H={H} {dname} streams, with initial state"
        wkv7_fwd_res_plan(case, B, H, sdt)
        xs = [x.to(sdt).contiguous() for x in _wkv7_path_streams(gen, what, (B, T, H, N), dev)]
        s0 = torch.randn(B, H, N, N, generator=gen, device=dev) * 0.3
        y_ref, s_ref, zin_ref = _reference_with_states([x.float() for x in xs], s0)
        ytol = 1e-2 if sdt == torch.bfloat16 else 1e-3
        c = Check("wkv7_fwd_res", case)
        y, s, zin = wkv7_cuda.wkv7_fwd_res(*xs, s0)
        c.compare(f"y ({dname}) vs fp32 sequential scan", y.float(), y_ref, ytol)
        c.compare("final state (fp32)", s, s_ref, 1e-3)
        c.compare("saved chunk states zin (fp32)", zin, zin_ref, 1e-3)
        yp, sp, zinp = wkv7_cuda.wkv7_fwd_res_packed(*xs, s0)
        diff = max(max_abs(yp, y), max_abs(sp, s), max_abs(zinp, pw._pack_zin(zin, B, H)))
        log(f"  wkv7_fwd_res_packed [{case}] largest difference from K5: {diff:.3e}")
        assert diff == 0, f"K12 differs from K5 by {diff:.3e} [{case}]"


def check_wkv7_bwd_paths(gen, dev):
    """K6 at ``WKV7_FWD_RES_PATH_CASES`` from K5's states, with an initial
    state and a non-zero cotangent of the final state, against fp32 autograd
    of the sequential scan (the chunked plain backward overflows at w_raw =
    2.0, where the kernels' step-7-referenced factors do not), under the
    limits of the timed cases: the seven gradients 2e-2 (bf16 streams) or
    1e-3 (fp32); K13 from K12's states equal to K6 bit for bit."""
    import torch

    from visualrwkv_torch.ops import wkv7 as pw
    from visualrwkv_torch.ops import wkv7_cuda

    N = 64
    names = ("dr", "dw_raw", "dk", "dv", "da", "db", "d(initial state)")
    for what, B, T, H, dname in WKV7_FWD_RES_PATH_CASES:
        sdt = getattr(torch, dname)
        case = f"{what}: B={B} T={T} H={H} {dname} streams, initial state, non-zero final-state cotangent"
        wkv7_bwd_plan(case, B, T, H, sdt)
        xs = [x.to(sdt).contiguous() for x in _wkv7_path_streams(gen, what, (B, T, H, N), dev)]
        s0 = torch.randn(B, H, N, N, generator=gen, device=dev) * 0.3
        dy = (torch.randn(B, T, H, N, generator=gen, device=dev) * 0.5).to(sdt)
        dsf = torch.randn(B, H, N, N, generator=gen, device=dev) * 0.1
        leaves = [x.float().requires_grad_(True) for x in xs] + [s0.clone().requires_grad_(True)]
        with torch.enable_grad():
            y, s = pw.wkv7_reference(*leaves[:6], leaves[6])
            ref = torch.autograd.grad((y, s), leaves, (dy.float(), dsf))
        _, _, zin = wkv7_cuda.wkv7_fwd_res(*xs, s0)
        grads = wkv7_cuda.wkv7_bwd(*xs, zin, dy, dsf)
        c = Check("wkv7_bwd", case)
        tol = 2e-2 if sdt == torch.bfloat16 else 1e-3
        for name, g, g_ref in zip(names, grads, ref):
            assert torch.isfinite(g).all(), (case, name)
            c.compare(f"{name} vs fp32 autograd of the sequential scan", g.float(), g_ref, tol)
        _, _, zinp = wkv7_cuda.wkv7_fwd_res_packed(*xs, s0)
        diff = max(max_abs(g, g6) for g, g6 in zip(wkv7_cuda.wkv7_bwd_packed(*xs, zinp, dy, dsf), grads))
        log(f"  wkv7_bwd_packed [{case}] largest difference from K6: {diff:.3e}")
        assert diff == 0, f"K13 differs from K6 by {diff:.3e} [{case}]"
        del xs, leaves, ref, zin, zinp, grads


def check_wkv7_function_ragged(gen, dev):
    """``ops.wkv7.wkv7`` under autograd at T = 2040 with ``chunk=8`` (a T the
    models reach at ``--chunk_len 8``, not a multiple of 16): one K5 and one
    K6 launch on the identity-padded 2048 steps, y, the final state and the
    seven gradients against autograd of the plain path at chunk 8 on the
    same values in fp32 (y 1e-2 and the gradients 2e-2 with bf16 streams,
    the final state 1e-3)."""
    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.ops import wkv7 as pw

    B, T, H, N = 2, 2040, 32, 64
    case = f"B={B} T={T} H={H} bf16 streams, chunk=8, initial state, through ops.wkv7.wkv7"
    xs = _wkv_streams(gen, (B, T, H, N), torch.bfloat16, dev)
    s0 = torch.randn(B, H, N, N, generator=gen, device=dev) * 0.3
    dy = (torch.randn(B, T, H, N, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    dsf = torch.randn(B, H, N, N, generator=gen, device=dev) * 0.1
    leaves = [x.clone().requires_grad_(True) for x in xs] + [s0.clone().requires_grad_(True)]
    reset_launches()
    with torch.enable_grad():
        y, s = pw.wkv7(*leaves[:6], leaves[6], chunk=8)
        grads = torch.autograd.grad((y, s), leaves, (dy, dsf))
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    log(f"  wkv7 [{case}] launches: {launches}")
    assert launches == {"wkv7_fwd_res": 1, "wkv7_bwd": 1}, launches
    ref_leaves = [x.float().requires_grad_(True) for x in xs] + [s0.clone().requires_grad_(True)]
    with torch.enable_grad():
        y_ref, s_ref = pw.wkv7_plain(*ref_leaves[:6], ref_leaves[6], chunk=8)
        ref = torch.autograd.grad((y_ref, s_ref), ref_leaves, (dy.float(), dsf))
    c = Check("wkv7_fwd_res + wkv7_bwd", case)
    assert y.shape == (B, T, H, N)
    c.compare("y (bf16) vs fp32 plain path at chunk 8", y.float(), y_ref.detach(), 1e-2)
    c.compare("final state (fp32)", s, s_ref.detach(), 1e-3)
    for name, g, g_ref in zip(("dr", "dw_raw", "dk", "dv", "da", "db", "d(initial state)"), grads, ref):
        c.compare(f"{name} vs fp32 plain path at chunk 8", g.float(), g_ref, 2e-2)


# model chunk_len below 16 held on the card through ops.wkv6.wkv6: their
# decay floors -80 / L are -10 (K7 / K8's factor form 1) and -20, -80 (form 2)
WKV6_LOW_CHUNKS = (8, 4, 1)


def check_wkv6_low_floors(gen, dev):
    """x060 at ``chunk_len`` 8, 4 and 1 through ``ops.wkv6.wkv6``, with two
    decays: w_raw = 3 on every channel (exp(3) = 20.1: the floor binds at
    chunk 8 and 4; at chunk 1 a decay of e^-20 a step, off the floor -80),
    and w_raw drawn uniform in [-3, ln(80 / L) + 0.5] (the floor binds on
    about 6-9 % of the channels, the rest carry a w_raw gradient). Without a
    gradient K7, under autograd at T = 2040 K8 and K9 on the identity-padded
    2048 steps: y, the final state and the six gradients against autograd of
    ``wkv6_plain(..., chunk=8)`` at chunk 8 and of the floored sequential scan
    ``wkv6_reference(..., chunk)`` below it, on the same values in fp32 (y
    1e-2 and the gradients 2e-2 with bf16 streams, states 1e-3; dw_raw
    exactly 0 where the floor binds). Then K7 at the 7B
    prefill's shape and K8, K9 at the 1.6B step's, timed at each floor (and
    at chunk 16): {chunk: {kernel: ms}}."""
    import math

    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.ops import wkv6 as pw
    from visualrwkv_torch.ops import wkv6_cuda

    B, T, H, N = 2, 2040, 32, 64
    # the reference: the plain path at chunk 8; below it the sequential scan,
    # as the chunked plain backward's fp32 dw cancels there (e^{+-g} factors
    # of a chunk: at chunk 1 and e^-20 a step it reads 0 on 99 % of the entries)
    ref_fn = lambda L: pw.wkv6_plain if L == 8 else pw.wkv6_reference
    for L in WKV6_LOW_CHUNKS:
        for floored in (True, False):
            decay = "w_raw = 3 on every channel" if floored else f"w_raw uniform in [-3, ln(80/{L}) + 0.5]"
            case = f"B={B} T={T} H={H} bf16 streams, chunk={L}, {decay}, initial state"
            xs, u = _wkv6_streams(gen, (B, T, H, N), torch.bfloat16, dev)
            if floored:
                xs[1] = torch.full_like(xs[1], 3.0)
            else:
                hi = math.log(80.0 / L) + 0.5
                xs[1] = (torch.rand(xs[1].shape, generator=gen, device=dev) * (hi + 3.0) - 3.0).to(xs[1].dtype)
            s0 = torch.randn(B, H, N, N, generator=gen, device=dev) * 0.3
            dy = (torch.randn(B, T, H, N, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
            dsf = torch.randn(B, H, N, N, generator=gen, device=dev) * 0.1
            ref_leaves = [x.float().requires_grad_(True) for x in xs] + [u.clone().requires_grad_(True),
                                                                         s0.clone().requires_grad_(True)]
            with torch.enable_grad():
                y_ref, s_ref = ref_fn(L)(*ref_leaves[:5], ref_leaves[5], chunk=L)
                ref = torch.autograd.grad((y_ref, s_ref), ref_leaves, (dy.float(), dsf))
            binds = -torch.exp(xs[1].float()) <= -80.0 / L
            floor_share = float(binds.float().mean())
            reset_launches()
            with torch.no_grad():
                y, s = pw.wkv6(*xs, u, s0, chunk=L)
            torch.cuda.synchronize()
            c = Check("wkv6_fwd", case)
            c.compare(f"y (bf16) vs fp32 {ref_fn(L).__name__} at chunk {L}", y.float(), y_ref.detach(), 1e-2)
            c.compare("final state (fp32)", s, s_ref.detach(), 1e-3)
            leaves = [x.clone().requires_grad_(True) for x in xs] + [u.clone().requires_grad_(True),
                                                                     s0.clone().requires_grad_(True)]
            with torch.enable_grad():
                y, s = pw.wkv6(*leaves[:5], leaves[5], chunk=L)
                grads = torch.autograd.grad((y, s), leaves, (dy, dsf))
            torch.cuda.synchronize()
            launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
            log(f"  wkv6 [{case}] path: the kernels (K7 without a gradient; K8, K9 under autograd); "
                f"launches {launches}; the floor binds on {floor_share:.4f} of the entries")
            assert launches == {"wkv6_fwd": 1, "wkv6_fwd_res": 1, "wkv6_bwd": 1}, launches
            if floored:
                assert floor_share == (0.0 if L == 1 else 1.0), floor_share
            else:
                assert 0.0 < floor_share < 0.5, floor_share
            assert bool((grads[1][binds] == 0).all()), f"dw_raw is not 0 where the floor binds [{case}]"
            c = Check("wkv6_fwd_res + wkv6_bwd", case)
            c.compare(f"y (bf16) vs fp32 {ref_fn(L).__name__} at chunk {L}", y.float(), y_ref.detach(), 1e-2)
            c.compare("final state (fp32)", s, s_ref.detach(), 1e-3)
            for name, g, g_ref in zip(("dr", "dw_raw", "dk", "dv", "du", "d(initial state)"), grads, ref):
                assert torch.isfinite(g).all(), (case, name)
                c.compare(f"{name} vs autograd of {ref_fn(L).__name__} at chunk {L}", g.float(), g_ref, 2e-2)
            del xs, leaves, ref_leaves, ref, grads
    # each factor form's time: K7 at the 7B prefill, K8 and K9 at the 1.6B step
    xs7, u7 = _wkv6_streams(gen, (1, 624, 64, N), torch.bfloat16, dev)
    xs, u = _wkv6_streams(gen, (B, 2048, H, N), torch.bfloat16, dev)
    s0 = torch.randn(B, H, N, N, generator=gen, device=dev) * 0.3
    dy = (torch.randn(B, 2048, H, N, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    dsf = torch.randn(B, H, N, N, generator=gen, device=dev) * 0.1
    times = {}
    for L in (16,) + WKV6_LOW_CHUNKS:
        zin = wkv6_cuda.wkv6_fwd_res(*xs, u, s0, L)[2]
        times[L] = {"wkv6_fwd": cuda_ms(lambda: wkv6_cuda.wkv6_fwd(*xs7, u7, None, L)),
                    "wkv6_fwd_res": cuda_ms(lambda: wkv6_cuda.wkv6_fwd_res(*xs, u, s0, L), reps=5),
                    "wkv6_bwd": cuda_ms(lambda: wkv6_cuda.wkv6_bwd(*xs, u, zin, dy, dsf, L), reps=3)}
        log(f"  wkv6 at chunk_len {L} (decay floor {-80 / L:g}): K7 B=1 T=624 H=64 bf16 "
            f"{times[L]['wkv6_fwd']:.4f} ms, K8 B=2 T=2048 H=32 bf16 {times[L]['wkv6_fwd_res']:.4f} ms, "
            f"K9 there {times[L]['wkv6_bwd']:.4f} ms")
    return times


def _wkv6_streams(gen, shape, dtype, dev):
    """RWKV-6-shaped streams (r, w_raw, k, v) and the bonus u [H, 64] fp32.
    w_raw is uniform in [-3, 2.5], so that exp(w_raw) crosses the decay floor
    80 / 16 = 5 of the sequence kernels on about a fifth of the channels."""
    import torch

    rn = lambda: torch.randn(shape, generator=gen, device=dev) * 0.5
    w_raw = torch.rand(shape, generator=gen, device=dev) * 5.5 - 3.0
    u = torch.randn(shape[-2:], generator=gen, device=dev) * 0.3
    return [x.to(dtype).contiguous() for x in (rn(), w_raw, rn(), rn())], u


def timed_once(fn):
    """(fn(), its time in ms) for one call between CUDA events."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_wkv6_fwd(gen, dev):
    """K7 at the 7B prefill's shapes (H=64, T = 577 + 32 left-padded to 624)
    against the floored sequential scan."""
    import torch

    from visualrwkv_torch.ops import wkv6 as pw
    from visualrwkv_torch.ops import wkv6_cuda

    T, H, N = 624, 64, 64
    out = []
    for B, sdt, with_state in ((1, torch.bfloat16, False), (4, torch.bfloat16, True),
                               (1, torch.float32, True)):
        dname = str(sdt)[6:]
        case = f"B={B} T={T} H={H} N={N} {dname} streams, {'with' if with_state else 'no'} initial state"
        xs, u = _wkv6_streams(gen, (B, T, H, N), sdt, dev)
        s0 = (torch.randn(B, H, N, N, generator=gen, device=dev) * 0.3) if with_state else None
        c = Check("wkv6_fwd", case)
        plan = wkv6_fwd_plan(case, B, H, sdt)
        y, s = wkv6_cuda.wkv6_fwd(*xs, u, s0, 16)
        y_ref, s_ref = pw.wkv6_reference(*xs, u, s0, chunk=16)
        torch.cuda.synchronize()
        c.compare(f"y ({dname})", y.float(), y_ref.float(), 1e-2 if sdt == torch.bfloat16 else 1e-3)
        c.compare("final state (fp32)", s, s_ref, 1e-3)
        fn = lambda: wkv6_cuda.wkv6_fwd(*xs, u, s0, 16)
        k_ms, k_eager = cuda_ms(fn), eager_ms(fn)
        p_ms = cuda_ms(lambda: pw.wkv6_reference(*xs, u, s0, chunk=16), reps=1, warmup=1)
        nbytes = 5 * B * T * H * N * xs[0].element_size() + H * N * 4 + B * H * N * N * 4 * (2 if with_state else 1)
        ops = 5 * B * T * H * N * N  # y (2) and the update (3) per state element
        out.append(dict(c.record(k_ms, p_ms, None, nbytes, ops, FP32_FLOPS, k_eager), plan=plan))
    return out


# K7 / K8 geometries held against the fp32 plain scan but not timed: (what,
# B, T, H, stream dtype, initial state, K8 too). The decay floor binding on
# every channel with |r| <= 1e-3 on a quarter of them (the factors of a
# chunk reach 2^+-58 there), a T that is not a multiple of 16 (K7 only: the
# last chunk is masked), B * H = 15 heads (16 value rows a block, 60 blocks,
# which no timed case takes), B * H = 128 (64 rows, 128 blocks), and phase
# 13's x060 shapes on the 1.6B's 32 heads: 13c's image pass (B=2, 1024
# tokens, from tuned states; K7 alone from zero, as its forward without
# them runs) and text pass (B=2, 256, from the image state), and 13d's
# hybrid (B=2, 512, from zero).
WKV6_FWD_PATH_CASES = (
    ("floor on every channel, |r| <= 1e-3 on a quarter", 2, 256, 32, "bfloat16", True, True),
    ("floor on every channel, |r| <= 1e-3 on a quarter", 2, 256, 32, "float32", True, True),
    ("ragged T", 1, 601, 64, "bfloat16", False, False),
    ("ragged T", 1, 601, 64, "bfloat16", True, False),
    ("B*H = 15", 3, 96, 5, "float32", True, True),
    ("B*H = 128", 2, 96, 64, "bfloat16", False, True),
    ("13c x060 image pass", 2, 1024, 32, "bfloat16", True, True),
    ("13c x060 forward's image pass", 2, 1024, 32, "bfloat16", False, False),
    ("13c x060 text pass", 2, 256, 32, "bfloat16", True, True),
    ("13d hybrid", 2, 512, 32, "bfloat16", False, True),
)


def wkv6_fwd_plan(case, B, H, dtype):
    """K7 / K8's plan for B * H heads (``wkv6_cuda.fwd_plan``: value rows a
    block, blocks, threads, shared memory, held equal to the library's own
    count), logged with ptxas's registers and spills of the K7 and K8
    instantiations it launches at ``chunk_len`` 16."""
    import torch

    from visualrwkv_torch.ops import wkv6_cuda

    plan = wkv6_cuda.fwd_plan(B, H, dtype)
    assert plan["smem_bytes"] == wkv6_cuda.kernel_smem_bytes(dtype, plan["rows"]), plan
    code = int(dtype == torch.bfloat16)
    for save, name in ((0, "k7"), (1, "k8")):
        plan[f"{name}_ptxas"] = PTXAS.get(("wkv6", "wkv6_fwd_kernel", (code, save, plan["rows"], 0)))
    regs = lambda p: "not parsed" if p is None else (f"{p.get('registers')} registers, "
                                                     f"{p.get('spill_bytes', 0)} B spilled")
    log(f"  wkv6 forward [{case}] plan: {plan['rows']} value rows a block, {plan['blocks']} blocks "
        f"of {plan['threads']} threads, {plan['smem_bytes']} B shared; K7 {regs(plan['k7_ptxas'])}, "
        f"K8 {regs(plan['k8_ptxas'])}")
    return plan


def check_wkv6_paths(gen, dev):
    """K7 and K8 at ``WKV6_FWD_PATH_CASES`` against the fp32 floored scan
    (K8's saved states against ``wkv6_fwd_res_plain``), under the limits of
    the timed cases: y 1e-2 (bf16 streams) or 1e-3 (fp32), states 1e-3."""
    import torch

    from visualrwkv_torch.ops import wkv6 as pw
    from visualrwkv_torch.ops import wkv6_cuda

    N = 64
    for what, B, T, H, dname, with_state, k8 in WKV6_FWD_PATH_CASES:
        sdt = getattr(torch, dname)
        case = f"{what}: B={B} T={T} H={H} {dname} streams, {'with' if with_state else 'no'} initial state"
        wkv6_fwd_plan(case, B, H, sdt)
        xs, u = _wkv6_streams(gen, (B, T, H, N), torch.float32, dev)
        if what.startswith("floor"):
            xs[1] = torch.rand(xs[1].shape, generator=gen, device=dev) * 0.5 + 2.0  # exp > 7.4 > 5
            xs[0][..., ::4] = (torch.rand(xs[0][..., ::4].shape, generator=gen, device=dev) * 2 - 1) * 1e-3
        xs = [x.to(sdt).contiguous() for x in xs]
        s0 = (torch.randn(B, H, N, N, generator=gen, device=dev) * 0.3) if with_state else None
        ytol = 1e-2 if sdt == torch.bfloat16 else 1e-3
        c = Check("wkv6_fwd", case)
        y, s = wkv6_cuda.wkv6_fwd(*xs, u, s0, 16)
        y_ref, s_ref = pw.wkv6_reference(*xs, u, s0, chunk=16)
        c.compare(f"y ({dname})", y.float(), y_ref.float(), ytol)
        c.compare("final state (fp32)", s, s_ref, 1e-3)
        if k8:
            c = Check("wkv6_fwd_res", case)
            y, s, zin = wkv6_cuda.wkv6_fwd_res(*xs, u, s0, 16)
            y_ref, s_ref, zin_ref = pw.wkv6_fwd_res_plain(*xs, u, s0, chunk=16)
            c.compare(f"y ({dname})", y.float(), y_ref.float(), ytol)
            c.compare("final state (fp32)", s, s_ref, 1e-3)
            c.compare("saved chunk states zin (fp32)", zin, zin_ref, 1e-3)


def wkv6_bwd_plan(case, B, T, H, dtype):
    """K9's two launches for B * H heads of T steps (``wkv6_cuda.bwd_plan``:
    the first pass laid out as K8, the second a block of 256 threads a (b, h,
    chunk), its shared memory held equal to the library's own count) and the
    workspace, logged with ptxas's registers and spills of the instantiations
    they launch at ``chunk_len`` 16."""
    import torch

    from visualrwkv_torch.ops import wkv6_cuda

    plan = wkv6_cuda.bwd_plan(B, T, H, dtype)
    assert plan["chunk"]["smem_bytes"] == wkv6_cuda.kernel_bwd_chunk_smem_bytes(dtype), plan
    code, rows = int(dtype == torch.bfloat16), plan["state"]["rows"]
    plan["ptxas"] = {"state": PTXAS.get(("wkv6_train", "wkv6_bwd_state_kernel", (code, rows, 0))),
                     "chunk": PTXAS.get(("wkv6_train", "wkv6_bwd_chunk_kernel", (code,)))}
    regs = lambda p: "not parsed" if p is None else (f"{p.get('registers')} registers, "
                                                     f"{p.get('spill_bytes', 0)} B spilled")
    p1, p2 = plan["state"], plan["chunk"]
    log(f"  wkv6 backward [{case}] plan: pass 1 {p1['rows']} value rows a block, {p1['blocks']} blocks of "
        f"{p1['threads']} threads, {p1['smem_bytes']} B shared ({regs(plan['ptxas']['state'])}); pass 2 "
        f"{p2['blocks']} blocks of {p2['threads']} threads, {p2['smem_bytes']} B shared "
        f"({regs(plan['ptxas']['chunk'])}); workspace {plan['workspace_bytes']} B, du partials "
        f"{plan['du_bytes']} B")
    return plan


# K9 inputs held against fp32 autograd of the floored sequential scan but not
# timed: (what, B, T, H, stream dtype, chunk_len, initial state, zero
# final-state cotangent). The floor binding on every channel at chunk 16
# (exp(w_raw) in [7.4, 12.2] > 5: dw_raw is 0 everywhere); w_raw = 2.0 on
# every channel off the floor at chunk 8 and 4 (a decay of e^-7.4 a step:
# factor forms 1 and 2 with dw_raw non-zero); |r| <= 1e-3 on every fourth
# channel; one head (B=1 H=1: 16 value rows a block, 4 blocks); B*H = 15,
# which fills no slice plan but 16 rows; B*H = 128 (64 rows); no initial
# state; a zero cotangent of the final state; phase 13's x060 shapes on the
# 1.6B's 32 heads: 13c's image pass (B=2, 1024 tokens) and text pass (B=2,
# 256) from a state, and 13d's hybrid (B=2, 512, from zero, its final state
# unused).
WKV6_BWD_PATH_CASES = (
    ("floor on every channel", 2, 256, 32, "float32", 16, True, False),
    ("floor on every channel", 2, 256, 32, "bfloat16", 16, True, False),
    ("w_raw = 2.0 on every channel", 2, 256, 32, "float32", 8, True, False),
    ("w_raw = 2.0 on every channel", 2, 256, 32, "bfloat16", 4, True, False),
    ("|r| <= 1e-3 on every fourth channel", 2, 256, 32, "bfloat16", 16, True, False),
    ("B=1 H=1", 1, 256, 1, "float32", 16, True, False),
    ("B*H = 15", 3, 96, 5, "float32", 16, True, False),
    ("B*H = 128", 2, 96, 64, "bfloat16", 16, True, False),
    ("no initial state", 1, 128, 8, "bfloat16", 16, False, False),
    ("zero final-state cotangent", 1, 128, 8, "float32", 16, True, True),
    ("13c x060 image pass", 2, 1024, 32, "bfloat16", 16, True, False),
    ("13c x060 text pass", 2, 256, 32, "bfloat16", 16, True, False),
    ("13d hybrid", 2, 512, 32, "bfloat16", 16, False, True),
)


def check_wkv6_bwd_paths(gen, dev):
    """K9 at ``WKV6_BWD_PATH_CASES`` from K8's states against fp32 autograd
    of the floored sequential scan (``wkv6_reference`` at the case's
    chunk_len), under the limits of the timed cases: the six gradients 2e-2
    (bf16 streams) or 1e-3 (fp32), finite, dw_raw exactly 0 where the floor
    binds."""
    import torch

    from visualrwkv_torch.ops import wkv6 as pw
    from visualrwkv_torch.ops import wkv6_cuda

    N = 64
    names = ("dr", "dw_raw", "dk", "dv", "du", "d(initial state)")
    for what, B, T, H, dname, L, with_state, zero_dsf in WKV6_BWD_PATH_CASES:
        sdt = getattr(torch, dname)
        case = (f"{what}: B={B} T={T} H={H} {dname} streams, chunk={L}, "
                f"{'initial state' if with_state else 'no initial state'}, "
                f"{'zero' if zero_dsf else 'non-zero'} final-state cotangent")
        wkv6_bwd_plan(case, B, T, H, sdt)
        xs, u = _wkv6_streams(gen, (B, T, H, N), torch.float32, dev)
        if what.startswith("floor"):
            xs[1] = torch.rand(xs[1].shape, generator=gen, device=dev) * 0.5 + 2.0
        elif what.startswith("w_raw = 2.0"):
            xs[1] = torch.full_like(xs[1], 2.0)
        elif what.startswith("|r|"):
            xs[0][..., ::4] = (torch.rand(xs[0][..., ::4].shape, generator=gen, device=dev) * 2 - 1) * 1e-3
        xs = [x.to(sdt).contiguous() for x in xs]
        s0 = torch.randn(B, H, N, N, generator=gen, device=dev) * 0.3 if with_state else None
        dy = (torch.randn(B, T, H, N, generator=gen, device=dev) * 0.5).to(sdt)
        dsf = torch.zeros(B, H, N, N, device=dev) if zero_dsf else torch.randn(B, H, N, N, generator=gen,
                                                                                device=dev) * 0.1
        leaves = [x.float().requires_grad_(True) for x in xs] + [u.clone().requires_grad_(True)]
        if with_state:
            leaves.append(s0.clone().requires_grad_(True))
        with torch.enable_grad():
            y, s = pw.wkv6_reference(*leaves[:5], leaves[5] if with_state else None, chunk=L)
            ref = list(torch.autograd.grad((y, s), leaves, (dy.float(), dsf)))
        _, _, zin = wkv6_cuda.wkv6_fwd_res(*xs, u, s0, L)
        grads = wkv6_cuda.wkv6_bwd(*xs, u, zin, dy, dsf, L)
        c = Check("wkv6_bwd", case)
        tol = 2e-2 if sdt == torch.bfloat16 else 1e-3
        for name, g, g_ref in zip(names, grads, ref):
            assert torch.isfinite(g).all(), (case, name)
            c.compare(f"{name} vs fp32 autograd of the floored scan", g.float(), g_ref, tol)
        floored = ref[1] == 0
        assert bool((grads[1][floored] == 0).all()), f"K9 dw_raw is not 0 where the floor binds [{case}]"
        if what.startswith("floor"):
            assert bool(floored.all()), case
        del xs, leaves, ref, zin, grads


# K10's cases: (B, state dtype) at H=64, the 7B's heads: the serving path's
# B=1 (fp32 state) and its batch of four (bf16), the other dtype of each, and
# B=32
WKV6_STEP_CASES = STEP_CASES


def check_wkv6_step(gen, dev):
    """K10 at ``WKV6_STEP_CASES`` (H=64, the 7B decode's heads), fp32 vectors,
    against the plain step (y 1e-3; the new state 1e-3 fp32, 1e-2 bf16),
    each case logging its plan (``wkv6_cuda.step_plan``). Timed as K2 is in
    :func:`check_wkv7_step`: L2-hot, L2-cold, eagerly, and beside the launch
    floor on K10's grid (``wkv6_cuda.step_floor``)."""
    import torch

    from visualrwkv_torch.ops import wkv6 as pw
    from visualrwkv_torch.ops import wkv6_cuda

    H, N = 64, 64
    out = []
    for B, dname in WKV6_STEP_CASES:
        sdt = getattr(torch, dname)
        case = f"B={B} H={H} N={N} {dname} state, fp32 vectors"
        plan = wkv6_cuda.step_plan(B, H, sdt)
        log(f"  wkv6_step [{case}] plan: {plan}")
        vecs, u = _wkv6_streams(gen, (B, H, N), torch.float32, dev)
        s0 = (torch.randn(B, H, N, N, generator=gen, device=dev) * 0.3).to(sdt)
        c = Check("wkv6_step", case)
        s, y = wkv6_cuda.wkv6_step(s0, *vecs, u)
        s_ref, y_ref = pw.wkv6_step(s0, *vecs, u)
        torch.cuda.synchronize()
        assert s.dtype == sdt
        c.compare("y (fp32)", y, y_ref, 1e-3)
        c.compare(f"new state ({dname})", s.float(), s_ref, 1e-3 if sdt == torch.float32 else 1e-2)
        fn = lambda: wkv6_cuda.wkv6_step(s0, *vecs, u)
        k_ms, k_eager = cuda_ms(fn, reps=50), eager_ms(fn, reps=50)
        k_cold = cold_ms(lambda st: wkv6_cuda.wkv6_step(st, *vecs, u), s0)
        floor_ms = cuda_ms(lambda: wkv6_cuda.step_floor(s0, *vecs, u), reps=50)
        p_ms = cuda_ms(lambda: pw.wkv6_step(s0, *vecs, u), reps=20)
        nbytes = 2 * B * H * N * N * s0.element_size() + 5 * B * H * N * 4 + H * N * 4
        rec = c.record(k_ms, p_ms, None, nbytes, 5 * B * H * N * N, FP32_FLOPS, k_eager)
        rec.update(plan=plan, cold_ms=k_cold, launch_floor_ms=floor_ms)
        log(f"  wkv6_step [{case}] L2-cold {k_cold:.5f} ms, launch floor (empty kernel, same grid) "
            f"{floor_ms:.5f} ms")
        if B == 1 and sdt == torch.float32:
            goal = max(0.0024, floor_ms + 0.0012)
            log(f"  wkv6_step [{case}] goal: L2-cold at most max(0.0024, floor + 0.0012) = {goal:.5f} ms: "
                f"{'met' if k_cold <= goal else 'missed'} ({k_cold:.5f} ms)")
        out.append(rec)
    return out


def check_wkv6_step_flat(gen, dev):
    """K10 on the flat state [B, 64, H*64] (``wkv6_cuda.wkv6_step_flat``, the
    step x060 decodes with under ``state_layout="flat"``) at
    ``WKV6_STEP_CASES``, against its plain version (``ops.wkv6.
    wkv6_step_flat``, the JAX package's jnp step), timed as K10 is in
    :func:`check_wkv6_step` (hot, cold, eagerly, beside the launch floor on
    its own grid), and beside K10 on the same state in the head layout: its
    y and new state must equal K10's bit for bit."""
    import torch

    from visualrwkv_torch.ops import wkv6 as pw
    from visualrwkv_torch.ops import wkv6_cuda
    from visualrwkv_torch.ops.wkv7 import state_from_flat, state_to_flat

    H, N = 64, 64
    out = []
    for B, dname in WKV6_STEP_CASES:
        sdt = getattr(torch, dname)
        case = f"B={B} H={H} N={N} {dname} flat state [B, {N}, {H * N}], fp32 vectors"
        plan = wkv6_cuda.step_plan(B, H, sdt, flat=True)
        log(f"  wkv6_step_flat [{case}] plan: {plan}")
        vecs, u = _wkv6_streams(gen, (B, H, N), torch.float32, dev)
        head = (torch.randn(B, H, N, N, generator=gen, device=dev) * 0.3).to(sdt)
        s0 = state_to_flat(head).contiguous()
        c = Check("wkv6_step_flat", case)
        s, y = wkv6_cuda.wkv6_step_flat(s0, *vecs, u)
        s_ref, y_ref = pw.wkv6_step_flat(s0.float(), *vecs, u)
        s2, y2 = wkv6_cuda.wkv6_step(head, *vecs, u)
        torch.cuda.synchronize()
        assert s.dtype == sdt and s.shape == s0.shape
        c.compare("y (fp32)", y, y_ref, 1e-3)
        c.compare(f"new state ({dname})", s.float(), s_ref, 1e-3 if sdt == torch.float32 else 1e-2)
        assert torch.equal(y, y2) and torch.equal(state_from_flat(s, H), s2), \
            f"the flat K10 differs from K10 on the same state [{case}]"
        log(f"  wkv6_step_flat [{case}] y and new state equal to K10's on the same state, bit for bit")
        fn = lambda: wkv6_cuda.wkv6_step_flat(s0, *vecs, u)
        k_ms, k_eager = cuda_ms(fn, reps=50), eager_ms(fn, reps=50)
        k_cold = cold_ms(lambda st: wkv6_cuda.wkv6_step_flat(st, *vecs, u), s0)
        floor_ms = cuda_ms(lambda: wkv6_cuda.step_floor(s0, *vecs, u, flat=True), reps=50)
        p_ms = cuda_ms(lambda: pw.wkv6_step_flat(s0, *vecs, u), reps=20)
        k10_ms = cuda_ms(lambda: wkv6_cuda.wkv6_step(head, *vecs, u), reps=50)
        nbytes = 2 * B * H * N * N * s0.element_size() + 5 * B * H * N * 4 + H * N * 4
        rec = c.record(k_ms, p_ms, None, nbytes, 5 * B * H * N * N, FP32_FLOPS, k_eager)
        rec.update(plan=plan, cold_ms=k_cold, launch_floor_ms=floor_ms, head_layout_k10_ms=k10_ms)
        log(f"  wkv6_step_flat [{case}] L2-cold {k_cold:.5f} ms, launch floor (empty kernel, same grid) "
            f"{floor_ms:.5f} ms; K10 on the head layout at the same B: {k10_ms:.5f} ms")
        out.append(rec)
    return out


# K17's cases: (B, T, C, k/v dtype, k near 80 on a quarter of the channels,
# initial state). x040 1B5's prefill (577 image tokens + 32, or the 1024 +
# 32 of the flagship's prompt length) at B=1 and B=4 with fp32 k, v (the
# model passes fp32); k in [78, 82] on every fourth channel, where e^k
# summed over the steps would overflow fp32 without the max tracking; bf16
# k, v. Tolerance: relative RMS 1e-5 on y and on the final state, both
# sides fp32 arithmetic.
WKV4_CASES = ((1, 1056, 2048, "float32", False, False), (4, 1056, 2048, "float32", False, True),
              (1, 1056, 2048, "float32", True, True), (1, 1056, 2048, "bfloat16", False, True))
WKV4_TOL = 1e-5


def check_wkv4(gen, dev):
    """K17 (``wkv4_cuda.wkv4_fwd``) against ``ops.wkv4.wkv4_plain`` (the
    reference's loop over T, on the card) at ``WKV4_CASES``, with its plan
    logged."""
    import torch

    from visualrwkv_torch.ops import wkv4 as pw
    from visualrwkv_torch.ops import wkv4_cuda

    out = []
    for B, T, C, dname, big_k, with_state in WKV4_CASES:
        case = (f"B={B} T={T} C={C} {dname} k, v{', k near 80 on every 4th channel' if big_k else ''}, "
                f"{'with' if with_state else 'no'} initial state")
        w, u, k, v, s0 = _wkv4_inputs(gen, B, T, C, dname, big_k, with_state, dev)
        plan = wkv4_cuda.fwd_plan(B, C)
        log(f"  wkv4_fwd [{case}] plan: {plan['blocks']} blocks of {plan['threads']} threads, one a (b, c); "
            f"ptxas {[v for key, v in PTXAS.items() if key[:2] == ('wkv4', 'wkv4_fwd_kernel')]}")
        c = Check("wkv4_fwd", case)
        y, s = wkv4_cuda.wkv4_fwd(w, u, k, v, s0)
        y_ref, s_ref = pw.wkv4_plain(w, u, k, v, s0)
        torch.cuda.synchronize()
        assert torch.isfinite(y).all() and torch.isfinite(s).all()
        c.compare("y (fp32)", y, y_ref, WKV4_TOL)
        c.compare("final state (fp32)", s, s_ref, WKV4_TOL)
        fn = lambda: wkv4_cuda.wkv4_fwd(w, u, k, v, s0)
        k_ms, k_eager = cuda_ms(fn), eager_ms(fn)
        p_ms = cuda_ms(lambda: pw.wkv4_plain(w, u, k, v, s0), reps=1, warmup=1)
        # k, v read and y written once, w and u, the states in and out
        nbytes = 2 * B * T * C * k.element_size() + B * T * C * 4 + 2 * C * 4 + B * C * 12 * (2 if with_state else 1)
        ops = 24 * B * T * C  # a step: 4 exp (~4 operations each), a divide, 3 max, ~6 multiply-adds
        out.append(dict(c.record(k_ms, p_ms, None, nbytes, ops, FP32_FLOPS, k_eager), plan=plan))
    return out


# K18's cases: WKV4_CASES (the x040 prefill's shapes) and the v4 adapter's
# LM input (phase 13e: B=8, 32 queries + 32 caption tokens, fp32 k, v as the
# model passes them). Tolerance: relative RMS of each gradient against
# wkv4_bwd_plain on the card, both fp32 arithmetic in the same order; the
# kernel may contract a product and a sum into one fma, and dw / du sum
# B * T terms with cancellation, so the limit is 1e-4, not K17's 1e-5.
WKV4_BWD_CASES = WKV4_CASES + ((8, 64, 2048, "float32", False, False),)
WKV4_BWD_TOL = 1e-4


def _wkv4_inputs(gen, B, T, C, dname, big_k, with_state, dev):
    import torch

    w = -torch.exp(torch.rand(C, generator=gen, device=dev) * 8 - 5)
    u = torch.randn(C, generator=gen, device=dev) * 0.5
    k = torch.randn(B, T, C, generator=gen, device=dev)
    v = torch.randn(B, T, C, generator=gen, device=dev)
    if big_k:
        k[..., ::4] = 78 + 4 * torch.rand(B, T, C // 4, generator=gen, device=dev)
    dt = getattr(torch, dname)
    k, v = k.to(dt), v.to(dt)
    s0 = None
    if with_state:
        s0 = torch.stack([torch.randn(B, C, generator=gen, device=dev),
                          torch.rand(B, C, generator=gen, device=dev) + 0.5,
                          torch.randn(B, C, generator=gen, device=dev)], -1).contiguous()
    return w, u, k, v, s0


def check_wkv4_bwd(gen, dev):
    """K18 (``wkv4_cuda.wkv4_bwd``) against ``ops.wkv4.wkv4_bwd_plain`` (the
    same reverse walk in torch, on the card) at ``WKV4_BWD_CASES``, with
    cotangents on y and, with an initial state, on the final state too; its
    plan logged. The bound counts k, v and dy read and dk, dv written once
    (w, u, the states and the dw / du partials besides); the workspace of
    recomputed states is the kernel's own traffic, not the function's."""
    import torch

    from visualrwkv_torch.ops import wkv4 as pw
    from visualrwkv_torch.ops import wkv4_cuda

    out = []
    for B, T, C, dname, big_k, with_state in WKV4_BWD_CASES:
        case = (f"B={B} T={T} C={C} {dname} k, v{', k near 80 on every 4th channel' if big_k else ''}, "
                f"{'with' if with_state else 'no'} initial state")
        w, u, k, v, s0 = _wkv4_inputs(gen, B, T, C, dname, big_k, with_state, dev)
        dy = torch.randn(B, T, C, generator=gen, device=dev)
        ds = torch.randn(B, C, 3, generator=gen, device=dev) if with_state else None
        plan = wkv4_cuda.fwd_plan(B, C)
        log(f"  wkv4_bwd [{case}] plan: {plan['blocks']} blocks of {plan['threads']} threads, one a (b, c), "
            f"workspace {B * T * 3 * C * 4 / 2**20:.1f} MiB; ptxas "
            f"{[v for key, v in PTXAS.items() if key[:2] == ('wkv4', 'wkv4_bwd_kernel')]}")
        c = Check("wkv4_bwd", case)
        got = wkv4_cuda.wkv4_bwd(w, u, k, v, s0, dy, ds)
        ref = pw.wkv4_bwd_plain(w, u, k, v, s0, dy, ds)
        torch.cuda.synchronize()
        for name, g, r in zip(("dw", "du", "dk", "dv", "d initial state"), got, ref):
            if r is None:
                assert g is None
                continue
            assert torch.isfinite(g).all(), name
            c.compare(f"{name} (fp32)", g, r, WKV4_BWD_TOL)
        fn = lambda: wkv4_cuda.wkv4_bwd(w, u, k, v, s0, dy, ds)
        k_ms, k_eager = cuda_ms(fn), eager_ms(fn)
        p_ms = cuda_ms(lambda: pw.wkv4_bwd_plain(w, u, k, v, s0, dy, ds), reps=1, warmup=1)
        # k, v read; dy read and dk, dv written (fp32); w, u read and dw, du
        # written; with a state, s0 and ds read and ds0 written
        nbytes = 2 * B * T * C * k.element_size() + 3 * B * T * C * 4 + 4 * C * 4 + (36 * B * C if with_state else 0)
        ops = 60 * B * T * C  # a step: the update again, then 6 exp (~4 operations each), 2 divides, ~30 others
        out.append(dict(c.record(k_ms, p_ms, None, nbytes, ops, FP32_FLOPS, k_eager), plan=plan))
    return out


def check_wkv6_train(gen, dev):
    """K8 (forward that saves the chunk states) and K9 (backward) at the
    1.6B training path's shapes, with a non-zero initial state and a non-zero
    cotangent of the final state, the decay floor binding on some channels.
    K8 against the floored sequential scan; K9 against the plain backward
    (fp32 autograd through that scan, chunk by chunk) on the same values in
    fp32. The plain versions are timed by their one call."""
    import torch

    from visualrwkv_torch.ops import wkv6 as pw
    from visualrwkv_torch.ops import wkv6_cuda

    B, T, H, N = 2, 2048, 32, 64
    fwd, bwd = [], []
    names = ("dr", "dw_raw", "dk", "dv")
    for sdt in (torch.bfloat16, torch.float32):
        dname = str(sdt)[6:]
        bf = sdt == torch.bfloat16
        case = f"B={B} T={T} H={H} N={N} {dname} streams, initial state, non-zero final-state cotangent"
        xs, u = _wkv6_streams(gen, (B, T, H, N), sdt, dev)
        s0 = torch.randn(B, H, N, N, generator=gen, device=dev) * 0.3
        dy = (torch.randn(B, T, H, N, generator=gen, device=dev) * 0.5).to(sdt)
        dsf = torch.randn(B, H, N, N, generator=gen, device=dev) * 0.1

        c = Check("wkv6_fwd_res", case)
        plan = wkv6_fwd_plan(case, B, H, sdt)
        y, s, zin = wkv6_cuda.wkv6_fwd_res(*xs, u, s0, 16)
        (y_ref, s_ref, zin_ref), t_plain = timed_once(lambda: pw.wkv6_fwd_res_plain(*xs, u, s0, chunk=16))
        c.compare(f"y ({dname})", y.float(), y_ref.float(), 1e-2 if bf else 1e-3)
        c.compare("final state (fp32)", s, s_ref, 1e-3)
        c.compare("saved chunk states zin (fp32)", zin, zin_ref, 1e-3)
        fn = lambda: wkv6_cuda.wkv6_fwd_res(*xs, u, s0, 16)
        k_ms, k_eager = cuda_ms(fn, reps=5), eager_ms(fn, reps=5)
        k7_ms = cuda_ms(lambda: wkv6_cuda.wkv6_fwd(*xs, u, s0, 16), reps=5)
        esz = xs[0].element_size()
        nbytes = 5 * B * T * H * N * esz + H * N * 4 + 2 * B * H * N * N * 4 + zin.numel() * 4
        rec = c.record(k_ms, t_plain, None, nbytes, 5 * B * T * H * N * N, FP32_FLOPS, k_eager)
        rec["k7_same_shape_ms"], rec["plan"] = k7_ms, plan
        log(f"  wkv6_fwd_res [{case}] K7 (no saved states) at the same shape: {k7_ms:.4f} ms")
        fwd.append(rec)

        c = Check("wkv6_bwd", case)
        bplan = wkv6_bwd_plan(case, B, T, H, sdt)
        grads = wkv6_cuda.wkv6_bwd(*xs, u, zin, dy, dsf, 16)
        xs32 = [x.float() for x in xs]
        ref, t_plain = timed_once(lambda: pw.wkv6_bwd_plain(*xs32, u, zin_ref, dy.float(), dsf, chunk=16))
        for name, g, g_ref in zip(names, grads, ref):
            assert g.dtype == sdt
            c.compare(f"{name} ({dname}) vs fp32 plain backward", g.float(), g_ref, 2e-2 if bf else 1e-3)
        c.compare("du (fp32, summed over B)", grads[4], ref[4], 2e-2 if bf else 1e-3)
        c.compare("d(initial state) (fp32)", grads[5], ref[5], 2e-2 if bf else 1e-3)
        fn = lambda: wkv6_cuda.wkv6_bwd(*xs, u, zin, dy, dsf, 16)
        k_ms, k_eager = cuda_ms(fn, reps=3), eager_ms(fn, reps=3)
        # read 4 streams + dy + u + zin + dsf, write 4 gradients + du + d(initial
        # state); per state element and step: 2 operations to rebuild the state
        # before the step and 11 for its adjoint (dv, dr, dk, dw 2 each, dS 3),
        # the count of the sequential form, which the two passes do not exceed
        nbytes = 9 * B * T * H * N * esz + zin.numel() * 4 + 2 * B * H * N * N * 4 + 2 * H * N * 4
        rec = c.record(k_ms, t_plain, None, nbytes, 13 * B * T * H * N * N, FP32_FLOPS, k_eager)
        rec["plan"] = bplan
        bwd.append(rec)
        del xs, xs32, zin, zin_ref, grads, ref
    return fwd, bwd


# Geometries of K14 / K15 held against the plain version but not timed: the
# paths no tower at its published size takes (a grid width that is not a
# multiple of 16, tables staged by plain loads, a grid wider than 64).
ATTN_BWD_PATH_CASES = ((2, 12, 12), (2, 6, 9), (1, 80, 80))
# Geometries of K3 held against the plain version but not timed, (G, Hk, Wk,
# hd): those of ATTN_BWD_PATH_CASES (the "rows" path with a 16-key tile, and
# "general" past 64 columns), a bias with hd 72 and a grid taller than
# flash.FWD_ROWS_MAX_HK (both "general").
ATTN_FWD_PATH_CASES = tuple((G, Hk, Wk, 64) for G, Hk, Wk in ATTN_BWD_PATH_CASES) + (
    (2, 16, 16, 72), (1, 300, 4, 64))


def attention_fwd_plan(hd, Hk, Wk, case):
    """K3's plan for a geometry as the library reports it, held equal to
    ``flash.fwd_plan`` (the Python side that tests reach), with ptxas's
    registers and spills of the instantiation it launches; logged."""
    from visualrwkv_torch.vision import flash as pf

    plan, kplan = pf.fwd_plan(hd, Hk, Wk), pf.fwd_plan_kernel(hd, Hk, Wk)
    for key in ("path", "key_tile", "block_rows"):
        assert plan[key] == kplan[key], (hd, Hk, Wk, plan, kplan)
    plan["smem"] = kplan["smem"]
    p = PTXAS.get(("attention", "attention_fwd_kernel",
                   (hd, plan["key_tile"], pf.PATHS.index(plan["path"]), plan["block_rows"] // 64)))
    plan["ptxas"] = p
    regs = "not parsed" if p is None else (f"{p.get('registers')} registers at entry, "
                                           f"{p.get('spill_bytes', 0)} B spilled")
    log(f"  attention forward [{case}] K3 path {plan['path']} (key tile {plan['key_tile']}, "
        f"{plan['block_rows']} query rows a block), {regs}, {plan['smem']} B shared")
    return plan


def check_attention(gen, dev):
    """K3 against its plain version on the card, and timed beside the SDPA
    forward (with the rel-pos bias as its mask): SAM-B's global shape (G=12,
    N=4096 = 64 x 64 grid, hd 64, bf16, fp32 tables), with and without the
    lse output; SAM-B at 768 and 512 pixels (G=2, 48 x 48 and 32 x 32 grids:
    the "rows" path with 48- and 32-key tiles); the no-bias MHA of the ViT
    towers (DINOv2-L N=1029 hd 64, SigLIP N=1024 hd 72, CLIP-L N=577 hd 64,
    B=1, 16 heads), without and with the lse output (as AttentionFunction
    runs them). Then the geometries of ``ATTN_FWD_PATH_CASES``, held against
    the plain version only. Each case logs its plan; no K3 instantiation
    may spill (ptxas's report of phase 1)."""
    import torch
    import torch.nn.functional as F

    from visualrwkv_torch.vision import flash as pf

    k3 = {k: v for k, v in PTXAS.items() if k[:2] == ("attention", "attention_fwd_kernel")}
    assert all(v.get("spill_bytes", 0) == 0 for v in k3.values()), f"K3 spills: {k3}"
    bf = torch.bfloat16
    relpos, mha = [], []

    def sam_inputs(G, Hk, Wk, hd):
        N = Hk * Wk
        q, k, v = (torch.randn(G, N, hd, generator=gen, device=dev).to(bf) for _ in range(3))
        rel_h = torch.randn(G, N, Hk, generator=gen, device=dev)
        rel_w = torch.randn(G, N, Wk, generator=gen, device=dev)
        return N, q, k, v, rel_h, rel_w, hd**-0.5

    for G, Hk, Wk, tower in ((12, 64, 64, "SAM-B global"), (2, 48, 48, "SAM-B global at 768 pixels"),
                             (2, 32, 32, "SAM-B global at 512 pixels")):
        hd = 64
        N, q, k, v, rel_h, rel_w, scale = sam_inputs(G, Hk, Wk, hd)
        case = f"{tower}: G={G} N={N} ({Hk}x{Wk} grid) hd={hd} bf16, fp32 rel tables"
        attention_fwd_plan(hd, Hk, Wk, case)
        c = Check("attention_fwd_relpos", case)
        o = pf.sam_attention(q, k, v, rel_h, rel_w, scale)
        o_ref = pf.sam_attend_reference(q, k, v, rel_h, rel_w, scale)
        torch.cuda.synchronize()
        c.compare("out (bf16)", o.float(), o_ref.float(), 1e-2)
        fn = lambda: pf.sam_attention(q, k, v, rel_h, rel_w, scale)
        reps = 20 if G == 12 else 50
        k_ms, k_eager = cuda_ms(fn, reps=reps), eager_ms(fn, reps=reps)
        p_ms = cuda_ms(lambda: pf.sam_attend_reference(q, k, v, rel_h, rel_w, scale), reps=3, warmup=1)
        mask = (rel_h[:, :, :, None] + rel_w[:, :, None, :]).reshape(G, N, N).to(bf)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale),
                         reps=5 if G == 12 else 20)
        del mask
        nbytes = 4 * G * N * hd * 2 + G * N * (Hk + Wk) * 4
        relpos.append(c.record(k_ms, p_ms, lib_ms, nbytes, 4 * G * N * N * hd, BF16_TENSOR_FLOPS, k_eager))
        if G != 12:
            continue
        # K3 with its lse output, as AttentionFunction runs it under autograd
        c = Check("attention_fwd_relpos", f"G={G} N={N} hd={hd} bf16, with the lse output")
        o, lse = pf.attention_fwd(q, k, v, rel_h, rel_w, scale, "sam")
        o_ref, lse_ref = pf.attention_fwd_plain(q, k, v, rel_h, rel_w, scale, "sam")
        torch.cuda.synchronize()
        c.compare("out (bf16)", o.float(), o_ref.float(), 1e-2)
        c.compare("lse (fp32)", lse, lse_ref, 1e-3)
        fn = lambda: pf.attention_fwd(q, k, v, rel_h, rel_w, scale, "sam")
        k_ms, k_eager = cuda_ms(fn), eager_ms(fn)
        p_ms = cuda_ms(lambda: pf.attention_fwd_plain(q, k, v, rel_h, rel_w, scale, "sam"), reps=3,
                       warmup=1)
        relpos.append(c.record(k_ms, p_ms, None, nbytes + G * N * 4, 4 * G * N * N * hd,
                               BF16_TENSOR_FLOPS, k_eager))

    B, h = 1, 16
    vits = ((1029, 64, "DINOv2-L"), (1024, 72, "SigLIP-so400m"), (577, 64, "CLIP-L/336"))
    lse_cases = []
    for N, hd, tower in vits:
        q, k, v = (torch.randn(B, N, h, hd, generator=gen, device=dev).to(bf) for _ in range(3))
        case = f"{tower}: B={B} N={N} h={h} hd={hd} bf16"
        attention_fwd_plan(hd, 0, 0, case)
        c = Check("attention_fwd_mha", case)
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
        # with the lse output, as AttentionFunction runs it under autograd
        scale = hd**-0.5
        c = Check("attention_fwd_mha", f"{case}, with the lse output")
        o, lse = pf.attention_fwd(q, k, v, None, None, scale, "mha")
        o_ref, lse_ref = pf.attention_fwd_plain(q, k, v, None, None, scale, "mha")
        torch.cuda.synchronize()
        c.compare("out (bf16)", o.float(), o_ref.float(), 1e-2)
        c.compare("lse (fp32)", lse, lse_ref, 1e-3)
        fn = lambda: pf.attention_fwd(q, k, v, None, None, scale, "mha")
        k_ms, k_eager = cuda_ms(fn, reps=50), eager_ms(fn, reps=50)
        p_ms = cuda_ms(lambda: pf.attention_fwd_plain(q, k, v, None, None, scale, "mha"), reps=20)
        lse_cases.append(c.record(k_ms, p_ms, None, nbytes + B * h * N * 4, 4 * B * h * N * N * hd,
                                  BF16_TENSOR_FLOPS, k_eager))
    mha += lse_cases

    for G, Hk, Wk, hd in ATTN_FWD_PATH_CASES:
        N, q, k, v, rel_h, rel_w, scale = sam_inputs(G, Hk, Wk, hd)
        case = f"path check: G={G} N={N} ({Hk}x{Wk} grid) hd={hd} bf16, fp32 rel tables"
        attention_fwd_plan(hd, Hk, Wk, case)
        c = Check("attention_fwd_relpos", case)
        o, lse = pf.attention_fwd(q, k, v, rel_h, rel_w, scale, "sam")
        o_ref, lse_ref = pf.attention_fwd_plain(q, k, v, rel_h, rel_w, scale, "sam")
        torch.cuda.synchronize()
        c.compare("out (bf16)", o.float(), o_ref.float(), 1e-2)
        c.compare("lse (fp32)", lse, lse_ref, 1e-3)
        del q, k, v, rel_h, rel_w, o, o_ref, lse, lse_ref
    return relpos, mha


def _sdpa_bwd_ms(q, k, v, do, mask=None, scale=None, reps=5):
    """Device time of the backward of one ``scaled_dot_product_attention``
    call ([B, h, N, d]; the mask added to the logits): its forward and
    backward captured together in a CUDA graph, less its forward alone.
    Returns (backward, forward + backward, forward) in ms."""
    import torch
    import torch.nn.functional as F

    qs, ks, vs = (x.detach().requires_grad_(True) for x in (q, k, v))
    fwd = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=scale)
    both_ms = cuda_ms(lambda: torch.autograd.grad(fwd(), (qs, ks, vs), do), reps=reps)
    fwd_ms = cuda_ms(fwd, reps=reps)
    return both_ms - fwd_ms, both_ms, fwd_ms


# ptxas's report of each kernel instantiation built in phase 1, by
# (library, kernel, template arguments): {"registers": n, "spill_bytes": n}
PTXAS = {}


def parse_ptxas(name: str, out: str) -> None:
    """Fill :data:`PTXAS` from one library's ``-Xptxas -v`` output."""
    import re

    key = None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:  # Itanium mangling: <length><identifier>, then I<template args>E
            key, mangled, i = None, m.group(1), 0
            while key is None:
                part = re.compile(r"(\d+)[A-Za-z_]").search(mangled, i)
                if part is None:
                    break
                start = part.start() + len(part.group(1))
                ident = mangled[start:start + int(part.group(1))]
                i = start + len(ident)
                if ident.endswith("_kernel"):
                    targs = re.match(r"I((?:Li-?\d+E)+)E", mangled[i:])
                    args = tuple(int(x) for x in re.findall(r"Li(-?\d+)E", targs.group(1))) if targs else ()
                    key = (name, ident, args)
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            PTXAS.setdefault(key, {})["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            PTXAS.setdefault(key, {})["registers"] = int(m.group(1))


def _attention_bwd_inputs(gen, dev, layout, G, a1, a2, hd):
    import torch

    from visualrwkv_torch.vision import flash as pf

    bf = torch.bfloat16
    if layout == "sam":
        Hk, Wk = a1, a2
        N = Hk * Wk
        shape = (G, N, hd)
        rel_h = torch.randn(G, N, Hk, generator=gen, device=dev)
        rel_w = torch.randn(G, N, Wk, generator=gen, device=dev)
    else:
        N, Hk, Wk = a1, 0, 0
        shape = (1, N, G, hd)
        rel_h = rel_w = None
    scale = hd**-0.5
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(bf) for _ in range(3))
    do = torch.randn(shape, generator=gen, device=dev).to(bf)
    o, lse = pf.attention_fwd(q, k, v, rel_h, rel_w, scale, layout)
    return N, Hk, Wk, scale, q, k, v, do, rel_h, rel_w, o, lse


def attention_bwd_plan(hd, Hk, Wk):
    """K14 / K15's plan for a geometry as the library reports it, held equal
    to ``flash.bwd_plan`` (the Python side that tests reach), with ptxas's
    registers and spills of the two instantiations it launches."""
    from visualrwkv_torch.vision import flash as pf

    plan, kplan = pf.bwd_plan(hd, Hk, Wk), pf.bwd_plan_kernel(hd, Hk, Wk)
    for key in ("dq_path", "dq_key_tile", "dkv_hspan", "dkv_tables"):
        assert plan[key] == kplan[key], (hd, Hk, Wk, plan, kplan)
    plan.update(dq_smem=kplan["dq_smem"], dkv_smem=kplan["dkv_smem"])
    dq_args = (hd, plan["dq_key_tile"], pf.PATHS.index(plan["dq_path"]))
    dkv_args = (hd, pf.BWD_TABLES.index(plan["dkv_tables"]))
    plan["dq_ptxas"] = PTXAS.get(("attention_bwd", "attention_bwd_dq_kernel", dq_args))
    plan["dkv_ptxas"] = PTXAS.get(("attention_bwd", "attention_bwd_dkv_kernel", dkv_args))
    return plan


def _log_plan(case, plan):
    def regs(p):
        return "not parsed" if p is None else (f"{p.get('registers')} registers at entry, "
                                               f"{p.get('spill_bytes', 0)} B spilled")

    log(f"  attention backward [{case}] K14 path {plan['dq_path']} (key tile "
        f"{plan['dq_key_tile']}), {regs(plan['dq_ptxas'])}, {plan['dq_smem']} B shared; K15 tables "
        f"{plan['dkv_tables']} (rel_h columns {plan['dkv_hspan']}, {plan['dkv_table_bytes']} B a "
        f"query tile), {regs(plan['dkv_ptxas'])}, {plan['dkv_smem']} B shared")


def check_attention_bwd(gen, dev):
    """K14 (dq and the rel-pos tables' gradients) and K15 (dk, dv) against
    ``attention_bwd_plain`` on the same inputs on the card: o and lse from
    K3, a random output cotangent. SAM's global shape (G=12 heads, N=4096 =
    64 x 64 grid, hd 64, bf16, fp32 tables), SAM at 768 and 512 pixels (48
    and 32 wide grids, G=2) and the no-bias MHA of the ViT towers (DINOv2-L
    N=1029 hd 64, SigLIP N=1024 hd 72, CLIP-L N=577 hd 64). Each kernel
    timed alone (K15 from K14's delta) and beside the SDPA backward (row 5:
    the bias as a mask), which computes dq, dk and dv together: its time is
    the pair's yardstick. Then the geometries of ``ATTN_BWD_PATH_CASES``,
    held against the plain version only. Each case logs its plan: K14's
    path and key tile, K15's table staging, registers, spills and shared
    memory."""
    import torch

    from visualrwkv_torch.vision import flash as pf

    bf = torch.bfloat16
    out = {"relpos": ([], []), "mha": ([], [])}
    cases = [("sam", 12, 64, 64, 64, "SAM-B global"),
             # grids narrower than 64: a key tile of K14 is one grid row of 48 / 32
             ("sam", 2, 48, 48, 64, "SAM-B global at 768 pixels"),
             ("sam", 2, 32, 32, 64, "SAM-B global at 512 pixels")]
    cases += [("mha", 16, N, 0, hd, tower) for N, hd, tower in
              ((1029, 64, "DINOv2-L"), (1024, 72, "SigLIP-so400m"), (577, 64, "CLIP-L/336"))]
    for G, Hk, Wk in ATTN_BWD_PATH_CASES:
        N, Hk, Wk, scale, q, k, v, do, rel_h, rel_w, o, lse = _attention_bwd_inputs(
            gen, dev, "sam", G, Hk, Wk, 64)
        case = f"path check: G={G} N={N} ({Hk}x{Wk} grid) hd=64 bf16, fp32 rel tables"
        _log_plan(case, attention_bwd_plan(64, Hk, Wk))
        dq, drh, drw, delta = pf.attention_bwd_dq_cuda(q, k, v, rel_h, rel_w, o, lse, do, scale, "sam")
        dk, dv = pf.attention_bwd_dkv_cuda(q, k, v, rel_h, rel_w, do, lse, delta, scale, "sam")
        ref = pf.attention_bwd_plain(q, k, v, rel_h, rel_w, o, lse, do, scale, "sam")
        torch.cuda.synchronize()
        c = Check("attention_bwd_dq_relpos + attention_bwd_dkv_relpos", case)
        for what, got, want, tol in (("dq (bf16)", dq, ref[0], 1e-2), ("d rel_h (fp32)", drh, ref[3], 1e-3),
                                     ("d rel_w (fp32)", drw, ref[4], 1e-3), ("dk (bf16)", dk, ref[1], 1e-2),
                                     ("dv (bf16)", dv, ref[2], 1e-2)):
            c.compare(what, got.float(), want.float(), tol)
        del q, k, v, do, o, lse, dq, dk, dv, ref
    for layout, G, a1, a2, hd, tower in cases:
        N, Hk, Wk, scale, q, k, v, do, rel_h, rel_w, o, lse = _attention_bwd_inputs(
            gen, dev, layout, G, a1, a2, hd)
        if layout == "sam":
            case = f"{tower}: G={G} N={N} ({Hk}x{Wk} grid) hd={hd} bf16, fp32 rel tables"
        else:
            case = f"{tower}: B=1 N={N} h={G} hd={hd} bf16, no bias"
        plan = attention_bwd_plan(hd, Hk, Wk)
        _log_plan(case, plan)
        dq, drh, drw, delta = pf.attention_bwd_dq_cuda(q, k, v, rel_h, rel_w, o, lse, do, scale, layout)
        dk, dv = pf.attention_bwd_dkv_cuda(q, k, v, rel_h, rel_w, do, lse, delta, scale, layout)
        t_plain = cuda_ms(lambda: pf.attention_bwd_plain(q, k, v, rel_h, rel_w, o, lse, do, scale,
                                                         layout), reps=1, warmup=1)
        ref = pf.attention_bwd_plain(q, k, v, rel_h, rel_w, o, lse, do, scale, layout)
        torch.cuda.synchronize()
        key = "relpos" if layout == "sam" else "mha"
        c14 = Check(f"attention_bwd_dq_{key}", case)
        c14.compare("dq (bf16)", dq.float(), ref[0].float(), 1e-2)
        if drh is not None:
            c14.compare("d rel_h (fp32)", drh, ref[3], 1e-3)
            c14.compare("d rel_w (fp32)", drw, ref[4], 1e-3)
        c15 = Check(f"attention_bwd_dkv_{key}", case)
        c15.compare("dk (bf16)", dk.float(), ref[1].float(), 1e-2)
        c15.compare("dv (bf16)", dv.float(), ref[2].float(), 1e-2)
        reps = 5 if layout == "sam" else 30
        f14 = lambda: pf.attention_bwd_dq_cuda(q, k, v, rel_h, rel_w, o, lse, do, scale, layout)
        f15 = lambda: pf.attention_bwd_dkv_cuda(q, k, v, rel_h, rel_w, do, lse, delta, scale, layout)
        ms14, ms15 = cuda_ms(f14, reps=reps), cuda_ms(f15, reps=reps)
        e14, e15 = eager_ms(f14, reps=reps), eager_ms(f15, reps=reps)
        if layout == "sam":
            mask = (rel_h[:, :, :, None] + rel_w[:, :, None, :]).reshape(1, G, N, N).to(bf)
            lib_ms, lib_both, lib_fwd = _sdpa_bwd_ms(*(x[None] for x in (q, k, v, do)), mask=mask,
                                                     scale=scale)
            del mask
        else:
            lib_ms, lib_both, lib_fwd = _sdpa_bwd_ms(*(x.transpose(1, 2) for x in (q, k, v, do)),
                                                     reps=20)
        tables = G * N * (Hk + Wk) * 4
        elt = G * N * hd * 2  # one bf16 [G, N, hd] tensor
        # K14: read q, k, v, o, dO, lse (and the tables), write dq, delta (and
        # the tables' gradients); S, dP and dq are 3 products. K15: read q, k,
        # v, dO, lse, delta (and the tables), write dk, dv; S, dP, dv and dk
        # are 4. The function as a whole needs 5 (S, dP, dq, dk, dv).
        b14 = 6 * elt + 2 * G * N * 4 + 2 * tables
        b15 = 6 * elt + 2 * G * N * 4 + tables
        mn = 2 * G * N * N * hd  # operations of one N x N x hd product
        r14 = c14.record(ms14, t_plain, lib_ms, b14, 3 * mn, BF16_TENSOR_FLOPS, e14)
        r15 = c15.record(ms15, t_plain, lib_ms, b15, 4 * mn, BF16_TENSOR_FLOPS, e15)
        pair_bound, pair_by = bound(8 * elt + G * N * 4 + 2 * tables, 5 * mn, BF16_TENSOR_FLOPS)
        for rec in (r14, r15):
            rec.update(pair_ms=ms14 + ms15, pair_bound_ms=pair_bound, pair_bound_by=pair_by,
                       pair_share_of_bound=pair_bound / (ms14 + ms15), plan=plan,
                       library_fwd_bwd_ms=lib_both, library_fwd_ms=lib_fwd,
                       library_is="SDPA backward (its forward + backward less its forward, "
                       "CUDA graphs): dq, dk and dv together (K14 + K15)",
                       plain_is="attention_bwd_plain: all five gradients (K14 + K15)")
        log(f"  attention backward [{case}] K14 + K15 {ms14 + ms15:.4f} ms, bound "
            f"{pair_bound:.4f} ms ({pair_by}; share of bound {pair_bound / (ms14 + ms15):.3f}), "
            f"SDPA backward {lib_ms:.4f} ms")
        out[key][0].append(r14)
        out[key][1].append(r15)
        del q, k, v, do, o, lse, dq, dk, dv, ref
    return out


def check_wkv7_v2(gen, dev):
    """K16 against its plain version (the fp32 chunked form at chunk 32 with
    length-16 block solves) on the same values, and beside K1 on the same
    inputs: the reference kernel's own shape (B=8 T=512 H=32 bf16) and one
    prefill's (B=1 T=1024 H=32), with an initial state, in bf16 and with
    fp32 streams. y is held at the convention's limits (bf16 1e-2, fp32
    1e-3). The final state is fp32; with bf16 streams its products take bf16
    tensor-core operands (Z, bta, h_loc), as the reference's v2 kernel rounds
    them, so it is held at the bf16 limit, and at 1e-3 with fp32 streams
    (all FMA). Each case logs the two launches' plan
    (``wkv7_cuda.v2_plan``, held equal to the library's own numbers), the
    scratch bytes, and each phase's device time alone
    (``wkv7_cuda.wkv7_fwd_v2_phase``)."""
    import torch

    from visualrwkv_torch.ops import wkv7 as pw
    from visualrwkv_torch.ops import wkv7_cuda

    N = 64
    out = []
    for B, T, H, sdt in ((8, 512, 32, torch.bfloat16), (1, 1024, 32, torch.bfloat16),
                         (1, 1024, 32, torch.float32)):
        dname = str(sdt)[6:]
        bf = sdt == torch.bfloat16
        case = f"B={B} T={T} H={H} N={N} {dname} streams, with initial state"
        plan, lib_plan = wkv7_cuda.v2_plan(B, T, H, sdt), wkv7_cuda.kernel_v2_plan(B, H, sdt)
        log(f"  wkv7_fwd_v2 [{case}] plan: {plan}")
        assert (lib_plan["chunk_smem_bytes"], lib_plan["cols"], lib_plan["stages"], lib_plan["state_smem_bytes"],
                lib_plan["scratch_bytes_a_chunk"] * B * H * (T // 32)) == (
            plan["chunk"]["smem_bytes"], plan["state"]["cols"], plan["state"]["stages"],
            plan["state"]["smem_bytes"], plan["scratch_bytes"]), (lib_plan, plan)
        xs = _wkv_streams(gen, (B, T, H, N), sdt, dev)
        s0 = torch.randn(B, H, N, N, generator=gen, device=dev) * 0.3
        c = Check("wkv7_fwd_v2", case)
        y, s = wkv7_cuda.wkv7_fwd_v2(*xs, s0)
        y_ref, s_ref = pw.wkv7_v2_plain(*[x.float() for x in xs], s0)
        y1, s1 = wkv7_cuda.wkv7_fwd(*xs, s0)
        torch.cuda.synchronize()
        c.compare(f"y ({dname}) vs fp32 plain", y.float(), y_ref, 1e-2 if bf else 1e-3)
        c.compare("final state (fp32)", s, s_ref, 1e-2 if bf else 1e-3)
        k1_err = {"y": rel_rms(y.float(), y1.float()), "state": rel_rms(s, s1)}
        log(f"  wkv7_fwd_v2 [{case}] relative RMS from K1: y {k1_err['y']:.3e}, "
            f"state {k1_err['state']:.3e}")
        fn = lambda: wkv7_cuda.wkv7_fwd_v2(*xs, s0)
        k_ms, k_eager = cuda_ms(fn), eager_ms(fn)
        bufs = wkv7_cuda.v2_buffers(xs[0])
        phase_ms = [cuda_ms(lambda p=p: wkv7_cuda.wkv7_fwd_v2_phase(p, *xs, s0, bufs)) for p in (1, 2)]
        p_ms = cuda_ms(lambda: pw.wkv7_v2_plain(*xs, s0), reps=1, warmup=1)
        k1_ms = cuda_ms(lambda: wkv7_cuda.wkv7_fwd(*xs, s0))
        nbytes = 7 * B * T * H * N * xs[0].element_size() + 2 * B * H * N * N * 4
        rec = c.record(k_ms, p_ms, None, nbytes, 9 * B * T * H * N * N, FP32_FLOPS, k_eager)
        rec.update(k1_same_inputs_ms=k1_ms, rel_rms_from_k1=k1_err, plan=plan, phase1_ms=phase_ms[0],
                   phase2_ms=phase_ms[1])
        log(f"  wkv7_fwd_v2 [{case}] phase 1 alone {phase_ms[0]:.4f} ms, phase 2 alone {phase_ms[1]:.4f} ms, "
            f"scratch {plan['scratch_bytes'] / 2**20:.1f} MiB written once and read once; K1 on the same "
            f"inputs: {k1_ms:.4f} ms")
        out.append(rec)
        del xs, bufs
    return out


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


def x060_serving_cfg():
    """VisualRWKV-6 7B (CLIP): the RWKV-6 World 7B geometry of
    ``bench.py:162-163`` behind one CLIP-L/14 @336 tower, every patch and the
    CLS token kept (``grid_size=-1``: 577 image tokens), linear projector."""
    from visualrwkv_torch.config import RWKVConfig, VisionConfig, VLMConfig

    return VLMConfig(
        rwkv=RWKVConfig(n_layer=32, n_embd=4096, vocab_size=65536, head_size=64, version="x060",
                        compute_dtype="bfloat16", ctx_len=4096),
        vision=VisionConfig(towers=("clip",)),
        proj_type="linear",
        num_token_per_image=577,
        grid_size=-1,
    )


def x060_training_cfg():
    """VisualRWKV-6 1.6B: RWKV-6 World 1.6B (x060 L24 D2048, dim_ffn 7168)
    behind the flagship's three towers, gated-MLP projector, 1024 image tokens."""
    from visualrwkv_torch.config import RWKVConfig

    cfg = flagship_cfg()
    return cfg.replace(rwkv=RWKVConfig(n_layer=24, n_embd=2048, vocab_size=65536, head_size=64,
                                       version="x060", compute_dtype="bfloat16", ctx_len=2048))


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
                      grad_cp=True, packed: bool = False):
    """Launches of each kernel that a run implies: ``prefills`` stateless
    prompts, ``decode_steps`` / ``flat_decode_steps`` one-token steps on the
    head / flat state, ``encodes`` passes of the vision towers, and
    ``train_micro_batches`` loss-and-gradient passes; every other kernel 0.
    The WKV kernels are those of the model's family (``WKV_KERNELS``; the
    head-pair kernels of x070 when ``packed``). Under activation
    checkpointing (non-reentrant: the first pass runs with autograd on)
    every block's forward runs twice, both times through the training
    forward (K5, K12 or K8), but once under ``grad_cp="wkv"``, which keeps
    its outputs; the prefill kernel (K1, K11 or K7) never runs in training."""
    from visualrwkv_torch.vision import sam, vit
    from visualrwkv_torch.vision.backbone import tower_configs

    tc = tower_configs(cfg.vision)
    mha_per_encode = sum(vit.blocks_run(c) for c in tc.values() if isinstance(c, vit.ViTConfig)
                         and c.num_patches + c.use_cls + c.num_reg >= vit.MHA_MIN_TOKENS)
    relpos_per_encode = sum(sam.global_blocks(c) for c in tc.values() if isinstance(c, sam.SAMConfig))
    L = cfg.rwkv.n_layer
    family = cfg.rwkv.version + (" packed" if packed else "")
    fwd, step, fwd_res, bwd = WKV_KERNELS[family]
    fwd_res_per_block = 2 if grad_cp and grad_cp != "wkv" else 1
    want = dict.fromkeys(REPLACES, 0)
    for name, n in ((fwd, L * prefills), (step, L * decode_steps),
                    (fwd_res, L * train_micro_batches * fwd_res_per_block), (bwd, L * train_micro_batches)):
        if name is not None:  # None: no kernel there (x040's decode step is elementwise torch)
            want[name] = n
    want["attention_fwd_relpos"] = relpos_per_encode * encodes
    want["attention_fwd_mha"] = mha_per_encode * encodes
    if flat_decode_steps:
        want[FLAT_STEP[cfg.rwkv.version]] = L * flat_decode_steps
    return want


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


SERVING_PLAN = (("1 request, fp32 state", 1, "float32"), ("4 requests, bf16 state", 4, "bfloat16"))


def run_serving(cfg, params, device, new_tokens: int, seed: int, plan=SERVING_PLAN):
    """The main path: one request (fp32 state), then four in one batch (bf16
    state; ``plan`` may say otherwise), through ``InferenceEngine.generate``.
    Returns the per-run numbers, the launch counts of exactly this run and
    the counts it implies."""
    import numpy as np
    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.infer.engine import InferenceEngine

    runs = []
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


def run_serving_packed(cfg, params, device, new_tokens: int, seed: int, head_tokens):
    """The four-request batch of :func:`run_serving` again under
    ``set_wkv_impl("packed")``: the prefill runs on K11 (one block per head
    pair) in K1's place, and the greedy ids must be those of the head
    layout. The mode is set back to "auto" before returning."""
    import numpy as np

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.infer.engine import InferenceEngine
    from visualrwkv_torch.ops.wkv7 import set_wkv_impl

    b = 4
    eng = InferenceEngine(params, cfg, state_dtype="bfloat16", device=device)
    ids, images = make_request(cfg, b, 32, seed + b, device)
    set_wkv_impl("packed")
    try:
        eng.generate(ids, images, max_new_tokens=2)
        ttft = sorted(timed(lambda: eng.prefill_ids(ids, images))[1] for _ in range(3))[1]
        reset_launches()
        res, ms = timed(lambda: eng.generate(ids, images, max_new_tokens=new_tokens, stop_tokens=(-1,)))
        launches = dict(cuda_build.LAUNCHES)
    finally:
        set_wkv_impl("auto")
    assert res.tokens.shape == (b, new_tokens) and np.isfinite(res.logits).all()
    assert np.array_equal(res.tokens, head_tokens), "packed greedy ids differ from the head layout's"
    want = expected_launches(cfg, prefills=1, decode_steps=new_tokens, encodes=1, packed=True)
    assert launches["wkv7_fwd_packed"] == cfg.rwkv.n_layer and launches.get("wkv7_fwd", 0) == 0
    _, head_ttft = timed(lambda: InferenceEngine(params, cfg, state_dtype="bfloat16", device=device)
                         .prefill_ids(ids, images))
    return {"run": "4 requests, bf16 state, set_wkv_impl('packed')", "batch": b, "ttft_ms": ttft,
            "head_layout_ttft_again_ms": head_ttft, "generate_ms": ms,
            "first_ids": res.tokens[0, :8].tolist()}, launches, want


def _template_flags(name: str, kernel: str):
    """The template arguments after the type of ``kernel<T, ...>`` in a
    profiler's kernel name, as booleans or integers."""
    args = name.split(kernel + "<", 1)[1].split(">", 1)[0].split(",")[1:]
    out = []
    for a in args:
        a = a.strip().replace("(bool)", "").replace("(int)", "")
        out.append({"true": 1, "false": 0}.get(a, int(a) if a.isdigit() else a))
    return out


def _category(kernel_name: str) -> str:
    n = kernel_name.lower()
    if "wkv7_fwd_res_kernel<" in n:  # <DT, ROWS, ZHEADS, SAVE>: K1 / K11 without SAVE
        _, zheads, save = _template_flags(n, "wkv7_fwd_res_kernel")
        if save:
            return "K12 wkv7_fwd_res_packed" if zheads == 2 else "K5 wkv7_fwd_res"
        return "K11 wkv7_fwd_packed" if zheads == 2 else "K1 wkv7_fwd"
    if "wkv7_bwd_state_kernel<" in n:  # <DT, ROWS, ZHEADS>: K6 / K13's first pass
        return "K13 wkv7_bwd_packed" if _template_flags(n, "wkv7_bwd_state_kernel")[1] == 2 \
            else "K6 wkv7_bwd"
    if "wkv7_bwd_chunk_kernel<" in n:  # <DT, ZHEADS>: K6 / K13's second pass
        return "K13 wkv7_bwd_packed" if _template_flags(n, "wkv7_bwd_chunk_kernel")[0] == 2 \
            else "K6 wkv7_bwd"
    if "wkv6_fwd_kernel<" in n:  # <DT, SAVE, ROWS, FORM>
        return "K8 wkv6_fwd_res" if _template_flags(n, "wkv6_fwd_kernel")[0] else "K7 wkv6_fwd"
    if "wkv_step_kernel<" in n:  # <FAM, DT, FLAT, ROWS>: K2 / K4 (FAM 7), K10 (FAM 6)
        fam = n.split("wkv_step_kernel<", 1)[1].split(",", 1)[0].replace("(int)", "").strip()
        if fam == "6":
            return "K10 wkv6_step_flat" if _template_flags(n, "wkv_step_kernel")[1] else "K10 wkv6_step"
        return "K4 wkv7_step_flat" if _template_flags(n, "wkv_step_kernel")[1] else "K2 wkv7_step"
    if "wkv6_bwd_" in n:  # both passes of K9
        return "K9 wkv6_bwd"
    if "attention_fwd_kernel" in n:
        return "K3 attention_fwd"
    if "attention_bwd_dq_kernel" in n:
        return "K14 attention_bwd_dq"
    if "attention_bwd_dkv_kernel" in n:
        return "K15 attention_bwd_dkv"
    if "wkv7_v2_" in n:  # both launches of K16
        return "K16 wkv7_fwd_v2"
    if "wkv4_fwd_kernel" in n:
        return "K17 wkv4_fwd"
    if "wkv4_bwd_kernel" in n:
        return "K18 wkv4_bwd"
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
    spans, kinds, counts = [], {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        k = _category(e.name)
        kinds[k] = kinds.get(k, 0.0) + (b - a) / 1e3
        counts[k] = counts.get(k, 0) + 1
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / 1e3 / wall_ms, "launches": len(spans),
            "device_ms_by_kind": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
            "events_by_kind": counts}


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


def train_cfg(steps: int, grad_cp=True):
    from visualrwkv_torch.config import TrainConfig

    return TrainConfig(param_dtype="bfloat16", optim_precision="master_fp32", grad_cp=grad_cp,
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
        # x070 also saves v_first at every block
        "saved block inputs (fp32)": (2 if cfg.rwkv.version == "x070" else 1) * cfg.rwkv.n_layer * B * T * C * 4,
        "zin of one layer": B * H * (T // 16) * N * N * 4,
        "one fp32 logits chunk": B * tcfg.ce_chunk_t * V * 4,
    }
    parts["sum"] = sum(parts.values())
    return {k: v / 1e9 for k, v in parts.items()}


def _checksums(tree):
    """(sum, sum of absolute values) of every leaf, in float64, as one
    tensor. Without autograd: on leaves that require a gradient, ``abs``
    would save its float64 input in a graph that the result keeps alive
    (12.4 GB for the 1B5's trainable leaves, through the counted steps)."""
    import torch

    with torch.no_grad():
        return torch.stack([torch.stack([p.double().sum(), p.double().abs().sum()])
                            for p in _leaves(tree)]).cpu()


# Mixing vectors whose only gradient runs through a zero-initialised LoRA
# factor: over four steps their Adam update can stay below an fp32 ulp.
SLOW_LEAVES = {"x070": ("x_w",), "x060": ("time_maa_x", "time_maa_w")}


def run_training(cfg, params, device, seed: int, steps: int = TRAIN_STEPS, grad_cp=True,
                 packed: bool = False, make_batch=None):
    """The main path of training: ``Trainer`` on ``cfg`` for one warm-up
    step and ``steps`` counted steps, under the checkpoint policy
    ``grad_cp`` and, when ``packed``, ``set_wkv_impl("packed")`` (set back
    to "auto" before returning), on batches of ``make_batch`` (default
    :func:`train_batch`). ``params`` (bf16) are updated in place."""
    from visualrwkv_torch.ops.wkv7 import set_wkv_impl

    set_wkv_impl("packed" if packed else "auto")
    try:
        return _run_training(cfg, params, device, seed, steps, grad_cp, packed, make_batch or train_batch)
    finally:
        set_wkv_impl("auto")


def _run_training(cfg, params, device, seed, steps, grad_cp, packed, make_batch):
    import numpy as np
    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.train.optim import tree_leaves, tree_leaves_with_path
    from visualrwkv_torch.train.trainer import Trainer

    tcfg = train_cfg(steps + 1, grad_cp)
    held_gb = torch.cuda.memory_allocated() / 1e9
    log(f"  held on the card before the Trainer: {held_gb:.2f} GB (the model's parameters and what the "
        f"earlier phases keep)")
    trainer = Trainer(cfg, tcfg, params, device=device, proj_dir=TRAIN_LOG_DIR, log_every=1)
    reckoned = reckon_train_memory(cfg, tcfg, trainer.params, trainer.leaves)
    log("  memory reckoned from the shapes (GB): "
        + ", ".join(f"{k} {v:.2f}" for k, v in reckoned.items()))
    mask = tree_leaves(trainer.opt.train_mask)
    paths = [p for p, _ in tree_leaves_with_path(trainer.params)]
    masters = lambda: [m if m is not None else p for m, p in
                       zip(tree_leaves(trainer.state.opt_state.master), tree_leaves(trainer.params))]
    sums_before = _checksums(tree_leaves(trainer.params))
    master_before = _checksums(masters())
    batches = [make_batch(cfg, TRAIN_MICRO_BSZ, TRAIN_CTX, seed + 100 + i)
               for i in range(steps + 2)]
    tokens = TRAIN_MICRO_BSZ * TRAIN_CTX

    loss, warm_ms = timed(lambda: float(trainer.train_step(batches[0])))
    assert np.isfinite(loss), loss
    log(f"  warm-up step: loss {loss:.4f}, {warm_ms:.0f} ms")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    counted = []
    for i in range(1, steps + 1):
        loss, ms = timed(lambda: float(trainer.train_step(batches[i])))
        assert np.isfinite(loss), (i, loss)
        counted.append({"step": i, "loss": loss, "step_ms": ms, "tok_per_s": tokens / (ms / 1e3),
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        log(f"  step {i}: loss {loss:.4f}, {ms:.1f} ms, {counted[-1]['tok_per_s']:.0f} tok/s, "
            f"peak {counted[-1]['peak_gib']:.2f} GiB")
    launches = dict(cuda_build.LAUNCHES)
    want = expected_launches(cfg, encodes=steps, train_micro_batches=steps, grad_cp=grad_cp,
                             packed=packed)
    assert trainer.state.step == steps + 1

    # frozen leaves are bit for bit what they were; trainable ones moved. The
    # fp32 master is what moves: an update below a bf16 ulp leaves the stored
    # bf16 leaf as it was, and an update below an fp32 ulp (a gradient that is
    # almost zero, through two small LoRA factors: SLOW_LEAVES) leaves the master.
    sums_after, master_after = _checksums(tree_leaves(trainer.params)), _checksums(masters())
    moved = [bool((a != b).any()) for a, b in zip(master_before, master_after)]
    for path, t, a, b in zip(paths, mask, sums_before, sums_after):
        assert t or bool((a == b).all()), f"frozen leaf {path} changed"
    still = [p for p, t, m in zip(paths, mask, moved) if t and not m]
    n_train = sum(mask)
    odd = [p for p in still if p[-1] not in SLOW_LEAVES[cfg.rwkv.version]]
    log(f"  {n_train} trainable leaves, {len(still)} unmoved ({len(odd)} other than "
        f"{SLOW_LEAVES[cfg.rwkv.version]}): {(odd or still)[:8]}; "
        f"{len(mask) - n_train} frozen leaves unchanged")
    assert len(odd) <= 0.05 * n_train, odd
    for path in (("rwkv", "head", "weight"), ("rwkv", "emb", "weight"),
                 ("rwkv", "blocks", 0, "att", "output", "weight"), ("proj", "o_proj", "weight")):
        assert moved[paths.index(path)], path
    del trainer
    return {"grad_cp": grad_cp, "packed": packed, "steps": counted, "warmup_ms": warm_ms,
            "reckoned_gb": reckoned, "held_before_gb": held_gb,
            "peak_gib": max(s["peak_gib"] for s in counted)}, launches, want


def profile_training(cfg, params, device, seed: int, grad_cp=True):
    """Where the training time goes: a fresh ``Trainer`` takes one step, then
    one more step runs under the profiler, the gradient pass and the
    optimizer apart."""
    from visualrwkv_torch.train.trainer import Trainer, loss_and_grads

    trainer = Trainer(cfg, train_cfg(2, grad_cp), params, device=device, proj_dir=TRAIN_LOG_DIR, log_every=1)
    batch = train_batch(cfg, TRAIN_MICRO_BSZ, TRAIN_CTX, seed + 100)
    trainer.train_step(batch)
    out = {}
    prof = {"loss and gradients": device_breakdown(lambda: out.update(lg=loss_and_grads(
        trainer.loss_fn, trainer.params, trainer.leaves, batch, 1)))}
    prof["optimizer"] = device_breakdown(lambda: trainer.opt.step(
        trainer.params, out["lg"][1], trainer.state.opt_state, trainer.state.step))
    return prof


def noisy(tree, gen, scale: float = 0.02, dtype: str = "bfloat16"):
    """A copy of ``tree`` on the generator's device with seeded noise added
    in fp32 on every leaf, so that the zero-initialised projections pass
    signal and gradient; in ``dtype``."""
    import torch

    out = to_device(tree, gen.device, torch.float32, copy=True)
    for leaf in _leaves(out):
        leaf.add_(torch.randn(leaf.shape, generator=gen, device=leaf.device) * scale)
    return to_device(out, gen.device, getattr(torch, dtype))


def noisy_lm(cfg, params, n_layer: int, seed: int, device):
    """The model with its LM replaced by ``n_layer`` fresh blocks with noise
    on every leaf (bf16), the rest of ``params`` as it is: at its random
    init an RWKV block is the identity, so a check on it would not see the
    image path."""
    import torch

    from visualrwkv_torch.models.lm import init_lm_params

    c = cfg.replace(rwkv=dataclasses.replace(cfg.rwkv, n_layer=n_layer))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return c, dict(params, rwkv=noisy(init_lm_params(gen, c.rwkv, device), gen))


def check_training_against_plain(cfg, params, n_layer: int, seed: int, device="cuda", make_batch=None,
                                 lm_alone: bool = True):
    """One loss and the gradients of three leaves (a decay LoRA factor,
    ``head.weight`` and the projector's first weight) from the kernel path
    on the card (bf16 compute) against the plain path on the CPU in fp32,
    on the same bf16 weights and one sample of ``make_batch`` (default
    :func:`train_batch`; the leftpad loss under ``insertion_mode="leftpad"``);
    then, with ``lm_alone``, the LM alone (text only) in fp32 on both sides,
    the loss and the first two gradients. The LM is ``n_layer`` fresh
    blocks with noise on every leaf (so that the zero-initialised
    projections pass gradient), the towers and the projector are the
    model's, whole."""
    import torch

    from visualrwkv_torch.models.visualrwkv import training_loss, training_loss_leftpad

    c, p = noisy_lm(cfg, params, n_layer, seed, device)
    p["proj"] = to_device(params["proj"], device, copy=True)  # the model's is left alone
    batch = (make_batch or train_batch)(c, 1, TRAIN_CTX, seed)
    lora = "w1" if c.rwkv.version == "x070" else "time_decay_w1"
    named = {f"rwkv.blocks[1].att.{lora}": lambda t: t["rwkv"]["blocks"][1]["att"][lora],
             "rwkv.head.weight": lambda t: t["rwkv"]["head"]["weight"],
             "proj.gate.weight": lambda t: t["proj"]["gate"]["weight"]}

    def run(tree, cfg_, dev, images=batch["images"]):
        gets = [get for name, get in named.items() if name.split(".")[0] in tree]
        leaves = [get(tree).requires_grad_(True) for get in gets]
        if cfg_.insertion_mode == "leftpad":
            loss = training_loss_leftpad(tree, cfg_, batch["input_ids"], batch["labels"], images,
                                         grad_cp=True, device=dev)
        else:
            loss = training_loss(tree, cfg_, batch["input_ids"], batch["labels"], images,
                                 grad_cp=True, ce_chunk_t=128, device=dev)
        return loss.detach().float().cpu(), [g.float().cpu() for g in torch.autograd.grad(loss, leaves)]

    def compare(what, a, b, loss_tol, grad_tol):
        d_loss = abs(float(a[0]) - float(b[0])) / abs(float(b[0]))
        log(f"  training check, {what}: loss {float(a[0]):.5f} vs {float(b[0]):.5f} "
            f"(relative {d_loss:.2e}, tol {loss_tol:g})")
        errs = {}
        for name, x, y in zip(named, a[1], b[1]):
            assert torch.isfinite(x).all() and float(y.abs().max()) > 0, name
            errs[name] = rel_rms(x, y)
            log(f"    d loss / d {name}: rel_rms={errs[name]:.3e} (tol {grad_tol:g})")
        assert d_loss <= loss_tol, d_loss
        assert all(e <= grad_tol for e in errs.values()), errs
        return {"loss_rel": d_loss, "grad_rel_rms": errs}

    c32 = c.replace(rwkv=dataclasses.replace(c.rwkv, compute_dtype="float32"))
    card = run(p, c, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cpu = run(to_device(p, "cpu", torch.float32), c32, "cpu")
    cpu_s = time.perf_counter() - t0
    out = compare(f"LM cut to {n_layer} layers, towers whole, card bf16 vs CPU fp32 "
                  f"(CPU run {cpu_s:.1f} s)", card, cpu, TRAIN_CHECK_LOSS_TOL,
                  TRAIN_CHECK_GRAD_TOL[c.rwkv.version])
    if lm_alone:
        txt = c32.replace(vision=dataclasses.replace(c32.vision, towers=()))
        p32 = {"rwkv": to_device(p["rwkv"], device, torch.float32)}
        out["lm_fp32"] = compare("the LM alone, card fp32 vs CPU fp32",
                                 run(p32, txt, device, None),
                                 run(to_device(p32, "cpu"), txt, "cpu", None),
                                 TRAIN_CHECK_FP32_LOSS_TOL, TRAIN_CHECK_FP32_GRAD_TOL)
    out.update(cpu_s=cpu_s, lm_layers=n_layer)
    return out


# ---------------------------------------------------------------------------
# phase 7: gradients through the vision towers; phase 8: wkv7_v2
# ---------------------------------------------------------------------------


def tower_grad_cfgs():
    """The flagship's towers at their full geometry (bf16 compute)."""
    from visualrwkv_torch.vision.sam import SAM_VIT_B
    from visualrwkv_torch.vision.vit import DINOV2_L_REG4, SIGLIP_SO400M

    return {"sam": SAM_VIT_B, "dino": DINOV2_L_REG4, "siglip": SIGLIP_SO400M}


def _tower_fns(cfg):
    from visualrwkv_torch.vision import sam, vit

    if isinstance(cfg, sam.SAMConfig):
        return sam.init_sam_params, sam.sam_features
    return vit.init_vit_params, vit.vit_features


def tower_grad_launches(name, cfg, passes: int = 1):
    """Launches of a tower's forward + backward: K3, K14 and K15 once for
    every attention that runs the kernels (SAM's global blocks, every block
    of a ViT); every other kernel 0."""
    from visualrwkv_torch.vision import sam, vit

    n, key = (sam.global_blocks(cfg), "relpos") if name == "sam" else (vit.blocks_run(cfg), "mha")
    want = dict.fromkeys(REPLACES, 0)
    for kernel in ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkv"):
        want[f"{kernel}_{key}"] = n * passes
    return want


def cut_tower(name, cfg, params):
    """The tower cut to its first blocks for the plain comparison: SAM's
    first three (the third is global), a ViT's first two."""
    if name == "sam":
        c = dataclasses.replace(cfg, depth=3, global_attn_indexes=(2,))
    else:
        c = dataclasses.replace(cfg, depth=2, feature_layer=-1)
    return c, dict(params, blocks=params["blocks"][:c.depth])


def tower_grads(fn, params, cfg, pixels, seed: int):
    """(features, d <features, cotangent> / d every parameter leaf): the
    cotangent is seeded normal noise of the features' shape."""
    import torch

    leaves = list(_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    feats = fn(params, cfg, pixels)
    gen = torch.Generator()  # on the CPU, so that the card and the CPU draw the same cotangent
    gen.manual_seed(seed)
    cot = torch.randn(feats.shape, generator=gen).to(feats.device)
    grads = torch.autograd.grad((feats.float() * cot).sum(), leaves, allow_unused=True)
    for t in leaves:
        t.requires_grad_(False)
    return feats.detach(), grads


def tower_setup(cfg, seed: int, device):
    """(features function, seeded bf16 parameters with noise on every leaf,
    so that the zero-initialised ones carry signal, one image's pixels)."""
    import torch

    init, fn = _tower_fns(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = init(gen, cfg, device=device, dtype=torch.bfloat16)
    for leaf in _leaves(params):
        leaf.add_(torch.randn(leaf.shape, generator=gen, device=device).to(leaf.dtype) * 0.02)
    S = cfg.img_size
    return fn, params, torch.randn(1, S, S, 3, generator=gen, device=device)


def profile_tower_grad(cfg, seed: int, device):
    """Where a tower's gradient pass goes: one pass after a warm-up pass,
    under the profiler."""
    fn, params, pixels = tower_setup(cfg, seed, device)
    tower_grads(fn, params, cfg, pixels, seed + 1)
    return {"forward + backward": device_breakdown(lambda: tower_grads(fn, params, cfg, pixels,
                                                                        seed + 1))}


def run_tower_grad(name, cfg, seed: int, device):
    """One tower's forward + backward to its parameters at full width, B=1:
    launch counts over one counted pass, time (median of TOWER_GRAD_REPS)
    and peak memory, then the gradients of the kernel path (card, bf16)
    against the plain path (CPU, fp32) on the tower cut by :func:`cut_tower`."""
    import torch

    from visualrwkv_torch import cuda_build

    fn, params, pixels = tower_setup(cfg, seed, device)
    n_params = sum(t.numel() for t in _leaves(params))

    reset_launches()
    feats, grads = tower_grads(fn, params, cfg, pixels, seed + 1)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    assert torch.isfinite(feats).all()
    # leaves past the feature layer (a ViT's last block and final norm) get none
    assert all(g is None or torch.isfinite(g).all() for g in grads), name
    del feats, grads
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = [timed(lambda: tower_grads(fn, params, cfg, pixels, seed + 1))[1]
             for _ in range(TOWER_GRAD_REPS)]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    c, p = cut_tower(name, cfg, params)
    c32 = dataclasses.replace(c, compute_dtype="float32")
    _, g_card = tower_grads(fn, p, c, pixels, seed + 1)
    t0 = time.perf_counter()
    p_cpu = to_device(p, "cpu", torch.float32)
    _, g_cpu = tower_grads(fn, p_cpu, c32, pixels.cpu(), seed + 1)
    cpu_s = time.perf_counter() - t0
    names = [f"{path}" for path, _ in _named_leaves(p)]
    errs = {}
    for n, a, b in zip(names, g_card, g_cpu):
        if b is None or not float(b.abs().max()) > 0:
            assert a is None or not float(a.abs().max()) > 0, n
            continue
        errs[n] = rel_rms(a.float().cpu(), b)
    worst = max(errs, key=errs.get)
    rec = {"tower": name, "params": n_params, "fwd_bwd_ms": times, "peak_gib": peak_gib,
           "base_gib": base / 2**30, "launches": launches,
           "plain_check": {"blocks": c.depth, "cpu_s": cpu_s, "leaves": len(errs),
                           "worst_leaf": worst, "worst_rel_rms": errs[worst],
                           "tol": TOWER_GRAD_TOL}}
    log(f"  {name}: {n_params / 1e6:.1f} M parameters, forward + backward "
        f"{sorted(times)[len(times) // 2]:.1f} ms (runs {[round(t, 1) for t in times]}), peak "
        f"{peak_gib:.2f} GiB; gradients of {len(errs)} leaves, tower cut to {c.depth} blocks, card "
        f"bf16 vs CPU fp32 (CPU {cpu_s:.1f} s): worst rel_rms {errs[worst]:.3e} ({worst}), "
        f"tol {TOWER_GRAD_TOL:g}")
    assert errs[worst] <= TOWER_GRAD_TOL, (name, worst, errs[worst])
    del params, p, g_card, g_cpu
    torch.cuda.empty_cache()
    return rec, launches


def run_wkv7_v2_path(seed: int, device):
    """``ops.wkv7.wkv7_v2``, the public entry point of the chunk-batched
    forward (no dispatcher calls it, as in the JAX package), on one
    flagship-width prefill's streams (B=1, T=1024, H=32, bf16, with a
    state): K16 once, y and state beside K1's on the same inputs."""
    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.ops import wkv7 as pw
    from visualrwkv_torch.ops import wkv7_cuda

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    xs = _wkv_streams(gen, (1, 1024, 32, 64), torch.bfloat16, device)
    s0 = torch.randn(1, 32, 64, 64, generator=gen, device=device) * 0.3
    reset_launches()
    y, s = pw.wkv7_v2(*xs, s0)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    y1, s1 = wkv7_cuda.wkv7_fwd(*xs, s0)
    err = {"y": rel_rms(y.float(), y1.float()), "state": rel_rms(s, s1)}
    log(f"  wkv7_v2 (B=1 T=1024 H=32 bf16): relative RMS from K1 y {err['y']:.3e}, "
        f"state {err['state']:.3e}")
    assert torch.isfinite(y).all() and err["y"] <= 1e-2 and err["state"] <= 1e-2, err
    return {"rel_rms_from_k1": err}, launches


# ---------------------------------------------------------------------------
# phase 9: serving a checkpoint
# ---------------------------------------------------------------------------

# 9a: LM depth of the .pth that the training CLI loads; the CLI step's context
CKPT_LM_LAYERS = 2
CKPT_CLI_CTX = 512
# 9b: batches and greedy tokens of the int8 / bf16 decode rates
INT8_BATCHES = (1, 4, 32)
INT8_TOKENS = 16
# 9d: the server's model depth (fp32), requests, slots and token budgets (the
# slots retire at their budgets and refill); a parting of its ids from a
# request's own generate() must be a tie: top-2 logits within this share
SERVER_LM_LAYERS = 4
SERVER_SLOTS = 4
SERVER_BUDGETS = (12, 5, 16, 7, 10, 3, 14, 8)
SERVER_TIE_TOL = 1e-4


def text_ids(batch: int, tokens: int, seed: int, device):
    """Random text token ids [batch, tokens] from the seed (no image)."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(10, 65000, (batch, tokens), generator=gen, device=device)


def run_checkpoint_round_trip(cfg, params, device, seed: int, phase3_ids, cli_argv=None):
    """9a: the flagship's parameters exported to the reference's combined
    layout in memory (``export_visualrwkv_checkpoint``: ``rwkv.`` /
    ``proj.`` / ``vit.*_featurizer.``), imported back with
    ``import_visualrwkv_checkpoint`` and served through
    ``make_engine(..., "gpu bf16")``: phase 3's one-image request must give
    the same prefill logits and greedy ids, bit for bit. Then the LM at
    ``CKPT_LM_LAYERS`` layers goes through ``torch.save`` -> ``load_pth`` in
    a temporary directory, and ``train/cli.py --model_path`` takes one step
    on it (text records, no towers: the file holds the LM only)."""
    import tempfile

    import numpy as np
    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.convert.pth_import import (
        export_rwkv_state_dict,
        export_visualrwkv_checkpoint,
        import_visualrwkv_checkpoint,
        load_pth,
    )
    from visualrwkv_torch.infer.engine import InferenceEngine
    from visualrwkv_torch.infer.strategy import make_engine
    from visualrwkv_torch.train import cli
    from visualrwkv_torch.vision.backbone import tower_configs

    ids, images = make_request(cfg, 1, 32, seed + 1, device)  # phase 3's one-image request
    ref = InferenceEngine(params, cfg, state_dtype="float32", device=device)
    ref_logits, _ = ref.prefill_ids(ids, images)
    ref_ids = ref.generate(ids, images, max_new_tokens=NEW_TOKENS, stop_tokens=(-1,)).tokens
    if phase3_ids is not None:
        assert np.array_equal(ref_ids, phase3_ids), "the rebuilt model's ids differ from phase 3's"
    del ref
    sd, export_ms = timed(lambda: export_visualrwkv_checkpoint(params))
    n_keys, sd_gb = len(sd), sum(t.numel() * t.element_size() for t in sd.values()) / 1e9
    grid = next(iter(tower_configs(cfg.vision).values())).grid
    loaded, import_ms = timed(lambda: import_visualrwkv_checkpoint(sd, dst_grid=grid))
    del sd
    eng = make_engine(loaded, cfg, "gpu bf16")
    del loaded
    reset_launches()
    logits, _ = eng.prefill_ids(ids, images)
    res = eng.generate(ids, images, max_new_tokens=NEW_TOKENS, stop_tokens=(-1,))
    launches = dict(cuda_build.LAUNCHES)
    same_logits = torch.equal(logits, ref_logits)
    same_ids = np.array_equal(res.tokens, ref_ids)
    log(f"  9a combined checkpoint: {n_keys} keys, {sd_gb:.2f} GB fp32, export {export_ms:.0f} ms, "
        f"import {import_ms:.0f} ms; through make_engine('gpu bf16'): prefill logits bit-equal "
        f"{same_logits}, greedy ids equal {same_ids} (first {res.tokens[0, :8].tolist()})")
    assert same_logits and same_ids, "the imported checkpoint does not serve phase 3's request bit for bit"
    del eng
    want = expected_launches(cfg, prefills=2, decode_steps=NEW_TOKENS, encodes=2)

    c, p = shallow(cfg, params, CKPT_LM_LAYERS)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"rwkv_L{CKPT_LM_LAYERS}.pth")
        lm_sd = {k: v.cpu() for k, v in export_rwkv_state_dict(p["rwkv"]).items()}
        _, save_ms = timed(lambda: torch.save(lm_sd, path))
        back, load_ms = timed(lambda: load_pth(path))
        assert set(back) == set(lm_sd) and all(torch.equal(back[k], v) for k, v in lm_sd.items())
        mb = os.path.getsize(path) / 1e6
        del back, lm_sd
        data = os.path.join(tmp, "text.json")
        with open(data, "w") as f:
            json.dump([{"id": f"t{i}", "conversations": [
                {"from": "human", "value": f"Count to {i + 3}, please."},
                {"from": "gpt", "value": ", ".join(str(j) for j in range(1, i + 4)) + "."}]}
                for i in range(4)], f)
        argv = ["--model_path", path, "--n_layer", str(CKPT_LM_LAYERS), "--n_embd", str(c.rwkv.n_embd),
                "--vocab_size", str(c.rwkv.vocab_size), "--ctx_len", str(CKPT_CLI_CTX), "--micro_bsz", "1",
                "--epoch_steps", "1", "--epoch_count", "1", "--vision_towers", "", "--data_file", data,
                "--proj_dir", tmp] + (cli_argv or [])
        trainer, cli_ms = timed(lambda: cli.main(argv))
        loss = trainer.history[-1]["loss"]
        del trainer
    log(f"  9a LM at {CKPT_LM_LAYERS} layers: torch.save {mb:.0f} MB in {save_ms:.0f} ms, load_pth "
        f"{load_ms:.0f} ms (every tensor equal); train/cli.py --model_path, one step at ctx "
        f"{CKPT_CLI_CTX}: loss {loss:.4f} in {cli_ms / 1e3:.1f} s (the run, its checkpoint included)")
    assert np.isfinite(loss)
    return {"keys": n_keys, "gb": sd_gb, "export_ms": export_ms, "import_ms": import_ms,
            "logits_bit_equal": same_logits, "ids_equal": same_ids, "pth_mb": mb, "save_ms": save_ms,
            "load_ms": load_ms, "cli_loss": loss, "cli_ms": cli_ms}, launches, want


def decode_rates(cfg, params, device, seed: int, what: str):
    """9b: decode tok/s of text requests at ``INT8_BATCHES`` under
    ``"gpu bf16"`` and ``"gpu bf16i8"`` (int8 weights: every large 2-D
    linear, dequantised to bf16 before its product), in turns (bf16, int8,
    int8, bf16) at each batch: ``(generate time - prefill time)`` over the
    ``INT8_TOKENS`` greedy tokens of each row."""
    import numpy as np
    import torch

    from visualrwkv_torch.infer.strategy import make_engine

    engines = {s: make_engine(params, cfg, s) for s in ("gpu bf16", "gpu bf16i8")}
    q = engines["gpu bf16i8"].params["rwkv"]
    n_q = sum(1 for _, t in _named_leaves(q) if t.dtype == torch.int8)
    out = {}
    for B in INT8_BATCHES:
        ids = text_ids(B, 32, seed + B, device)
        rates = {s: [] for s in engines}
        for s in ("gpu bf16", "gpu bf16i8", "gpu bf16i8", "gpu bf16"):
            eng = engines[s]
            eng.generate(ids, max_new_tokens=2, stop_tokens=(-1,))
            prefill_ms = sorted(timed(lambda: eng.prefill_ids(ids))[1] for _ in range(3))[1]
            res, ms = timed(lambda: eng.generate(ids, max_new_tokens=INT8_TOKENS, stop_tokens=(-1,)))
            assert np.isfinite(res.logits).all()
            rates[s].append(B * INT8_TOKENS / ((ms - prefill_ms) / 1e3))
        out[B] = {s: r for s, r in rates.items()}
        log(f"  9b {what} decode B={B}: bf16 {rates['gpu bf16'][0]:.1f} / {rates['gpu bf16'][1]:.1f} "
            f"tok/s, int8 weights {rates['gpu bf16i8'][0]:.1f} / {rates['gpu bf16i8'][1]:.1f} tok/s "
            f"(in turns bf16, int8, int8, bf16)")
    log(f"  9b {what}: {n_q} int8 linears in the LM")
    del engines
    torch.cuda.empty_cache()
    return {"tok_per_s": out, "int8_linears": n_q}


def check_int8_against_plain(cfg, params, device, seed: int):
    """9b: prefill logits of a text request through the LM at
    ``PLAIN_LAYERS`` layers with int8 weights (``apply_strategy`` of
    ``"gpu bf16i8"``): the card's path against the plain path on the CPU
    with the same quantized tree; relative RMS <= ``PLAIN_CHECK_TOL``."""
    import torch

    from visualrwkv_torch.infer.engine import InferenceEngine
    from visualrwkv_torch.infer.strategy import apply_strategy, parse_strategy

    c, p = shallow(cfg, params, PLAIN_LAYERS)
    q = apply_strategy({"rwkv": p["rwkv"]}, parse_strategy("gpu bf16i8"))
    ids = text_ids(1, 64, seed, device)
    logits_gpu, _ = InferenceEngine(q, c, device=device).prefill_ids(ids)
    t0 = time.perf_counter()
    logits_cpu, _ = InferenceEngine(to_device(q, "cpu"), c, device="cpu").prefill_ids(ids.cpu())
    cpu_s = time.perf_counter() - t0
    e = rel_rms(logits_gpu.float().cpu(), logits_cpu.float())
    log(f"  9b int8 prefill logits, LM cut to {PLAIN_LAYERS} layers: kernels (card) vs plain (CPU) "
        f"rel_rms={e:.3e} (tol {PLAIN_CHECK_TOL:g}); CPU run {cpu_s:.1f} s")
    assert torch.isfinite(logits_gpu).all() and e <= PLAIN_CHECK_TOL, e
    return e


def run_x060_flat(cfg, params, device, seed: int, new_tokens: int):
    """9c: phase 5's four-request batch under ``"gpu bf16 flat"`` (the flat
    decode state: K10 on the flat layout, one launch a layer a token), the
    greedy ids equal to those under ``"gpu bf16"`` (the head layout)."""
    import numpy as np

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.infer.strategy import make_engine

    b = 4
    ids, images = make_request(cfg, b, 32, seed + b, device)
    head, flat = make_engine(params, cfg, "gpu bf16"), make_engine(params, cfg, "gpu bf16 flat")
    head_res, head_ms = timed(lambda: head.generate(ids, images, max_new_tokens=new_tokens, stop_tokens=(-1,)))
    flat.generate(ids, images, max_new_tokens=2)
    reset_launches()
    res, ms = timed(lambda: flat.generate(ids, images, max_new_tokens=new_tokens, stop_tokens=(-1,)))
    launches = dict(cuda_build.LAUNCHES)
    same = np.array_equal(res.tokens, head_res.tokens)
    log(f"  9c x060 7B, 4 requests, 'gpu bf16 flat': generate({new_tokens}) {ms:.1f} ms (head layout "
        f"{head_ms:.1f} ms), greedy ids equal to the head layout's {same}, first {res.tokens[0, :8].tolist()}")
    assert same, "x060 flat-state greedy ids differ from the head layout's"
    want = expected_launches(cfg, prefills=1, flat_decode_steps=new_tokens, encodes=1)
    return {"generate_ms": ms, "head_generate_ms": head_ms}, launches, want


def server_steps(budgets, slots: int) -> int:
    """Decode steps the server takes for requests of these token budgets
    (no stop token): each step admits into free slots, then advances all."""
    queue, active, steps = list(budgets), [], 0
    while queue or active:
        while queue and len(active) < slots:
            active.append(queue.pop(0))
        steps += 1
        active = [n - 1 for n in active if n > 1]
    return steps


def _server_run(eng, prompts, slots):
    from visualrwkv_torch.infer.server import BatchedServer

    server = BatchedServer(eng, max_batch=slots, stop_tokens=(-1,))
    rids = [server.submit(p, max_new_tokens=n) for p, n in zip(prompts, SERVER_BUDGETS)]
    out, ms = timed(server.run)
    assert sorted(out) == rids and [len(out[r]) for r in rids] == list(SERVER_BUDGETS), out
    return [out[r] for r in rids], ms


def run_server(cfg, params, device, seed: int):
    """9d: ``BatchedServer`` with ``SERVER_SLOTS`` slots serving the
    ``len(SERVER_BUDGETS)`` text requests (slots retire at their budgets and
    refill). Under ``"gpu fp32"`` with the LM cut to ``SERVER_LM_LAYERS``
    layers of full width (compute fp32), each request's greedy ids must be
    those of ``engine.generate`` for it alone; where they part, the
    position is logged and its two top logits must be within
    ``SERVER_TIE_TOL`` of the top one (a tie broken by rounding). Then at
    full width in bf16: agreement logged, and the server's tok/s."""
    import numpy as np

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.infer.strategy import make_engine

    prompts = [text_ids(1, 12 + 3 * i, seed + 50 + i, device)[0].tolist() for i in range(len(SERVER_BUDGETS))]
    c, p = shallow(cfg, params, SERVER_LM_LAYERS)
    c = c.replace(rwkv=dataclasses.replace(c.rwkv, compute_dtype="float32"))
    eng = make_engine({"rwkv": p["rwkv"]}, c, "gpu fp32")
    _server_run(eng, prompts, SERVER_SLOTS)  # warm-up
    reset_launches()
    outs, ms = _server_run(eng, prompts, SERVER_SLOTS)
    launches = dict(cuda_build.LAUNCHES)
    want = expected_launches(c, prefills=len(prompts), decode_steps=server_steps(SERVER_BUDGETS, SERVER_SLOTS))
    partings = []
    for i, (prompt, got, n) in enumerate(zip(prompts, outs, SERVER_BUDGETS)):
        alone = eng.generate(np.asarray([prompt]), max_new_tokens=n, stop_tokens=(-1,)).tokens[0].tolist()
        if got == alone:
            continue
        j = next(k for k in range(n) if got[k] != alone[k])
        logits, _ = eng.prefill_ids(np.asarray([prompt + alone[:j]]))
        top = logits[0].float().topk(2).values
        gap = float((top[0] - top[1]).abs() / top[0].abs())
        partings.append({"request": i, "position": j, "top2_gap": gap})
        log(f"  9d request {i}: server and generate() part at token {j} ({got[j]} / {alone[j]}); "
            f"top-2 logits {float(top[0]):.6f} / {float(top[1]):.6f}, gap {gap:.2e} of the top "
            f"(tol {SERVER_TIE_TOL:g})")
        assert gap < SERVER_TIE_TOL, (i, j, gap)
    n_tok = sum(SERVER_BUDGETS)
    log(f"  9d server, LM {SERVER_LM_LAYERS} layers fp32, {len(prompts)} requests on {SERVER_SLOTS} slots: "
        f"{n_tok} tokens in {ms:.1f} ms; {len(prompts) - len(partings)} of {len(prompts)} requests "
        f"equal to generate() alone, partings {partings}")
    del eng
    eng = make_engine({"rwkv": params["rwkv"]}, cfg, "gpu bf16")
    _server_run(eng, prompts, SERVER_SLOTS)  # warm-up
    outs16, ms16 = _server_run(eng, prompts, SERVER_SLOTS)
    agree16 = sum(got == eng.generate(np.asarray([pr]), max_new_tokens=n, stop_tokens=(-1,)).tokens[0].tolist()
                  for pr, got, n in zip(prompts, outs16, SERVER_BUDGETS))
    log(f"  9d server, full width bf16: {n_tok} tokens in {ms16:.1f} ms, {n_tok / (ms16 / 1e3):.1f} tok/s "
        f"(prefills included); {agree16} of {len(prompts)} requests equal to generate() alone")
    return {"fp32_ms": ms, "fp32_partings": partings, "bf16_ms": ms16,
            "bf16_tok_per_s": n_tok / (ms16 / 1e3), "bf16_agree": agree16}, launches, want


def check_dispatch_narrow(seed: int, device):
    """9e (fault C.3): the dispatchers ``wkv7_step_auto``, ``wkv6_step_auto``
    (head and flat state), ``wkv7`` and ``wkv6`` on CUDA with bf16 inputs and
    with inputs sliced from a wider tensor along the last axis (and the steps
    with two leading dimensions). Each must be bit-equal to the same call on
    contiguous copies (fp32 copies of bf16 step vectors: the step kernels
    take fp32; bf16 copies of bf16 streams, which the sequence kernels run in
    bf16), and within tolerance of the plain path on the CPU."""
    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.ops import wkv6 as p6
    from visualrwkv_torch.ops import wkv7 as p7

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def strided(x):  # the same values, every other element of a wider tensor
        wide = torch.zeros(*x.shape[:-1], 2 * x.shape[-1], dtype=x.dtype, device=x.device)
        wide[..., ::2] = x
        return wide[..., ::2]

    def cpu(xs):
        return [x.cpu() for x in xs]

    reset_launches()
    rows = []
    for family, H in (("x070", 32), ("x060", 64)):
        step = p7.wkv7_step_auto if family == "x070" else p6.wkv6_step_auto
        seq = p7.wkv7 if family == "x070" else p6.wkv6
        if family == "x070":
            vecs, extra = _wkv_streams(gen, (2, 2, H, 64), torch.float32, device), ()
            streams = _wkv_streams(gen, (2, 64, H, 64), torch.float32, device)
        else:
            vecs, u = _wkv6_streams(gen, (2, 2, H, 64), torch.float32, device)
            streams, _ = _wkv6_streams(gen, (2, 64, H, 64), torch.float32, device)
            extra = (u,)
        s0 = torch.randn(2, 2, H, 64, 64, generator=gen, device=device) * 0.3
        flat0 = p7.state_to_flat(s0[0]).contiguous()
        vb = [x.bfloat16() for x in vecs]
        # steps: bf16 vectors against their fp32 copies, strided against contiguous
        s, y = step(s0, *vb, *extra)
        s_f, y_f = step(s0, *(x.float() for x in vb), *extra)
        assert y.dtype == torch.bfloat16 and torch.equal(y, y_f.bfloat16()) and torch.equal(s, s_f), family
        s_x, y_x = step(s0, *(strided(x) for x in vecs), *extra)
        s_c, y_c = step(s0, *vecs, *extra)
        assert torch.equal(y_x, y_c) and torch.equal(s_x, s_c), family
        s_p, y_p = step(s0.cpu(), *cpu(vecs), *cpu(extra))
        e_step = max(rel_rms(y_c.cpu(), y_p), rel_rms(s_c.float().cpu(), s_p))
        fs, fy = step(flat0, *(strided(x[0]).bfloat16() for x in vecs), *extra)
        fs_c, fy_c = step(flat0, *(x[0].bfloat16().float() for x in vecs), *extra)
        assert torch.equal(fs, fs_c) and torch.equal(fy, fy_c.bfloat16()), family
        # sequences: bf16 strided streams against contiguous bf16 copies, fp32 strided against contiguous
        sb = [strided(x.bfloat16()) for x in streams]
        y1, st1 = seq(*sb, *extra)
        y2, st2 = seq(*(x.contiguous() for x in sb), *extra)
        assert y1.dtype == torch.bfloat16 and torch.equal(y1, y2) and torch.equal(st1, st2), family
        y3, st3 = seq(*(strided(x) for x in streams), *extra)
        y4, st4 = seq(*streams, *extra)
        assert torch.equal(y3, y4) and torch.equal(st3, st4), family
        mixed = [streams[0].bfloat16()] + list(streams[1:])  # mixed dtypes run in fp32
        y5, _ = seq(*mixed, *extra)
        y6, _ = seq(*(x.float() for x in mixed), *extra)
        assert y5.dtype == torch.bfloat16 and torch.equal(y5, y6.bfloat16()), family
        y_plain, st_plain = seq(*cpu(streams), *cpu(extra))
        e_seq = max(rel_rms(y4.cpu(), y_plain), rel_rms(st4.cpu(), st_plain))
        y_plain16, _ = seq(*(x.float().cpu() for x in sb), *cpu(extra))  # the same bf16 values
        e_bf16 = rel_rms(y1.float().cpu(), y_plain16)
        log(f"  9e {family}: bf16 / strided / [2, 2, H, 64] step vectors and bf16 / strided / mixed "
            f"streams bit-equal to the calls on contiguous copies; against the plain path: step "
            f"{e_step:.3e} (tol 1e-3), sequence fp32 {e_seq:.3e} (tol 1e-3), bf16 streams {e_bf16:.3e} "
            f"(tol 1e-2)")
        assert e_step <= 1e-3 and e_seq <= 1e-3 and e_bf16 <= 1e-2, (family, e_step, e_seq, e_bf16)
        rows.append({"family": family, "step_rel_rms": e_step, "seq_rel_rms": e_seq, "bf16_rel_rms": e_bf16})
    launches = dict(cuda_build.LAUNCHES)
    for name in ("wkv7_step", "wkv7_fwd", "wkv6_step", "wkv6_step_flat", "wkv6_fwd", "wkv7_step_flat"):
        assert launches.get(name, 0) > 0, (name, launches)
    return rows, launches


# ---------------------------------------------------------------------------
# the phases' steps
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 10: speculative decoding; phase 11: the legacy families
# ---------------------------------------------------------------------------

# proposal windows, batches, and the LM depth of the fp32 lossless checks
SPEC_KS = (2, 4)
SPEC_BATCHES = (1, 4)
SPEC_FP32_LAYERS = 4


def expected_spec_launches(cfg, rounds: int, k: int, encodes: int):
    """Launches of one ``SpeculativeEngine.generate`` with a draft of the
    target's family and depth (the int8 self-draft): the target's and the
    draft's prefills, ``encodes`` tower passes, and each round k + 1 draft
    decode steps (``lm_decode_step``: K2 / K10 once a layer) and a verify
    pass whose trail takes k + 1 more step launches a layer
    (``wkv*_scan_states``); no prefill kernel inside the loop."""
    want = expected_launches(cfg, prefills=2, encodes=encodes)
    want[WKV_KERNELS[cfg.rwkv.version][1]] = 2 * rounds * (k + 1) * cfg.rwkv.n_layer
    return want


def int8_self_draft(params):
    """The int8 self-draft of a VLM tree: its LM through
    ``quantize_self_draft``, the towers and projector the target's (the
    towers serve bf16 only: ``models/visualrwkv.py::encode_images``)."""
    from visualrwkv_torch.infer.speculative import quantize_self_draft

    return dict(params, rwkv=quantize_self_draft(params["rwkv"]))


def spec_fp32_check(cfg, params, device, seed: int, what: str, batches=SPEC_BATCHES, ks=SPEC_KS):
    """10(a), and x060's check: the LM cut to ``SPEC_FP32_LAYERS`` layers of
    full width in fp32 with its int8 self-draft; at each batch and k the
    greedy ids of ``SpeculativeEngine.generate`` must equal
    ``InferenceEngine.generate``'s bit for bit, and the launches of each run
    the loop's (:func:`expected_spec_launches`). A verify pass alone
    (``forward_states`` over k + 1 tokens) must launch the step kernel
    k + 1 times a layer and nothing else. The prompt is text of the image
    request's length: the towers run bf16 only (K3), so an fp32 model has
    none; the image's bf16 run is :func:`run_spec_full`'s."""
    import numpy as np
    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.config import VisionConfig
    from visualrwkv_torch.infer.engine import InferenceEngine
    from visualrwkv_torch.infer.speculative import SpeculativeEngine, forward_states
    from visualrwkv_torch.models.rwkv7 import embed

    c, p = shallow(cfg, params, SPEC_FP32_LAYERS)
    c = c.replace(rwkv=dataclasses.replace(c.rwkv, compute_dtype="float32"), vision=VisionConfig(towers=()))
    p = {"rwkv": to_device(p["rwkv"], device, torch.float32)}
    draft = int8_self_draft(p)
    eng = InferenceEngine(p, c, device=device)
    step = WKV_KERNELS[c.rwkv.version][1]
    recs, launches = [], {}
    for B in batches:
        ids = text_ids(B, cfg.num_token_per_image + 32, seed + 60 + B, device)
        ref = eng.generate(ids, max_new_tokens=NEW_TOKENS, stop_tokens=(-1,))
        for k in ks:
            spec = SpeculativeEngine(p, c, draft, c, k=k, device=device)
            reset_launches()
            res = spec.generate(ids, max_new_tokens=NEW_TOKENS, stop_tokens=(-1,))
            launches = dict(cuda_build.LAUNCHES)
            assert_launches(f"{what} speculative B={B} k={k}", launches,
                            expected_spec_launches(c, res.rounds, k, encodes=0))
            equal = bool(np.array_equal(res.tokens, ref.tokens))
            acc = float(res.accepted.sum()) / (res.rounds * k * B)
            log(f"  {what}, LM {SPEC_FP32_LAYERS} layers fp32, B={B} k={k}: {res.rounds} rounds, "
                f"mean acceptance {acc:.3f}, ids bit-equal to generate()'s: {equal}")
            assert equal, f"{what} B={B} k={k}: speculative ids differ from greedy decode's"
            recs.append({"batch": B, "k": k, "rounds": res.rounds, "acceptance": acc, "ids_equal": equal})
    _, st = eng.prefill_ids(ids)
    for k in ks:
        window = ids[:, -(k + 1):]
        reset_launches()
        with torch.no_grad():
            logits, trail = forward_states(p["rwkv"], c.rwkv, embed(p["rwkv"], window), st)
        torch.cuda.synchronize()
        verify = dict(cuda_build.LAUNCHES)
        want = dict.fromkeys(REPLACES, 0)
        want[step] = (k + 1) * c.rwkv.n_layer
        assert_launches(f"{what} one verify pass, k={k}", verify, want)
        assert trail[0].wkv.shape[:2] == (ids.shape[0], k + 1) and torch.isfinite(logits).all()
    return recs, launches


def run_spec_full(cfg, params, device, seed: int):
    """10(b)-(d): phase 3's model at full width in bf16 with its int8
    self-draft, phase 3's one-image requests (B = 1 and 4, ``NEW_TOKENS``
    greedy tokens, fp32 state as the engine's default): (b) how many ids
    agree with ``generate()``'s; (d) the launches of one counted run at each
    k (:func:`expected_spec_launches`); (c) decode tok/s in turns (greedy,
    k = 2, k = 4, k = 4, k = 2, greedy), each run's prefills taken out:
    ``(generate time - prefill time) / tokens``, with the target's and the
    draft's prefill each timed alone (median of 3)."""
    import numpy as np

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.infer.engine import InferenceEngine
    from visualrwkv_torch.infer.speculative import SpeculativeEngine

    draft = int8_self_draft(params)
    eng = InferenceEngine(params, cfg, device=device)
    deng = InferenceEngine(draft, cfg, device=device)
    specs = {k: SpeculativeEngine(params, cfg, draft, cfg, k=k, device=device) for k in SPEC_KS}
    out, launches = {}, {}
    for B in SPEC_BATCHES:
        ids, images = make_request(cfg, B, 32, seed + B, device)
        ref = eng.generate(ids, images, max_new_tokens=NEW_TOKENS, stop_tokens=(-1,))
        ttft = sorted(timed(lambda: eng.prefill_ids(ids, images))[1] for _ in range(3))[1]
        dttft = sorted(timed(lambda: deng.prefill_ids(ids, images))[1] for _ in range(3))[1]
        rec = {"ttft_ms": ttft, "draft_prefill_ms": dttft, "runs": {}}
        for k, spec in specs.items():
            spec.generate(ids, images, max_new_tokens=2, stop_tokens=(-1,))  # warm-up
            reset_launches()
            res = spec.generate(ids, images, max_new_tokens=NEW_TOKENS, stop_tokens=(-1,))
            launches[f"B={B} k={k}"] = dict(cuda_build.LAUNCHES)
            assert_launches(f"10(d) speculative B={B} k={k}", launches[f"B={B} k={k}"],
                            expected_spec_launches(cfg, res.rounds, k, encodes=2))
            agree = int((res.tokens == ref.tokens).sum())
            rows = int((res.tokens == ref.tokens).all(1).sum())
            acc = float(res.accepted.sum()) / (res.rounds * k * B)
            rec["runs"][f"k={k}"] = {"rounds": res.rounds, "acceptance": acc, "ids_agree": agree,
                                     "rows_equal": rows, "k2_per_round": 2 * (k + 1) * cfg.rwkv.n_layer,
                                     "ms": []}
            log(f"  10(b) B={B} k={k}: {res.rounds} rounds, mean acceptance {acc:.3f}, {agree} of "
                f"{res.tokens.size} ids equal to generate()'s ({rows} of {B} rows whole); first "
                f"{res.tokens[0, :8].tolist()} / {ref.tokens[0, :8].tolist()}")
            assert np.isfinite(res.tokens).all() and res.tokens.shape == (B, NEW_TOKENS)
        greedy_ms = []
        for what in ("greedy", *(f"k={k}" for k in SPEC_KS), *(f"k={k}" for k in reversed(SPEC_KS)), "greedy"):
            if what == "greedy":
                greedy_ms.append(timed(lambda: eng.generate(ids, images, max_new_tokens=NEW_TOKENS,
                                                            stop_tokens=(-1,)))[1])
            else:
                k = int(what[2:])
                rec["runs"][what]["ms"].append(timed(lambda: specs[k].generate(
                    ids, images, max_new_tokens=NEW_TOKENS, stop_tokens=(-1,)))[1])
        rec["greedy_ms"] = greedy_ms
        rec["greedy_tok_per_s"] = [B * NEW_TOKENS / ((ms - ttft) / 1e3) for ms in greedy_ms]
        for k in SPEC_KS:
            r = rec["runs"][f"k={k}"]
            r["tok_per_s"] = [B * NEW_TOKENS / ((ms - ttft - dttft) / 1e3) for ms in r["ms"]]
        log(f"  10(c) B={B}: TTFT {ttft:.1f} ms, draft prefill {dttft:.1f} ms; decode tok/s in turns: greedy "
            + ", ".join(f"{v:.1f}" for v in rec["greedy_tok_per_s"]) + "; "
            + "; ".join(f"k={k} " + ", ".join(f"{v:.1f}" for v in rec["runs"][f"k={k}"]["tok_per_s"])
                        for k in SPEC_KS))
        out[f"B={B}"] = rec
    return out, launches


def legacy_cfg(version: str):
    """RWKV-5 World 1.5B ("x052", head size 64) or RWKV-4 World 1.5B ("x040"):
    L24 D2048, vocabulary 65536, behind phase 5's CLIP-L/14 @336 tower (every
    patch and the CLS token: 577 image tokens) and linear projector."""
    from visualrwkv_torch.config import RWKVConfig

    return x060_serving_cfg().replace(rwkv=RWKVConfig(
        n_layer=24, n_embd=2048, vocab_size=65536, head_size=64, version=version,
        compute_dtype="bfloat16", ctx_len=2048))


def run_legacy(version: str, seed: int, device):
    """Phase 11 for one family: the model built from ``seed``, phase 3's runs
    (one image request with an fp32 state, then four in a batch: a bf16
    state for x052, fp32 for x040, which refuses bf16), each with its
    launch counts; x052's four requests again on the flat state (K10 FLAT
    1) with the head layout's ids; the prefill logits against the plain path
    on the CPU at ``PLAIN_LAYERS`` layers."""
    import torch

    cfg = legacy_cfg(version)
    params = build(cfg, seed, device)
    plan = SERVING_PLAN if version == "x052" else (
        ("1 request, fp32 state", 1, "float32"), ("4 requests, fp32 state", 4, "float32"))
    serving, launches, want, head_tokens, _ = serve(cfg, params, device, seed, plan)
    assert_launches(f"{version} serving", launches, want)
    paths = {f"serving_{version}": launches}
    if version == "x052":
        flat_run, flat_launches, flat_want = run_serving_flat(cfg, params, device, NEW_TOKENS, seed,
                                                              head_tokens)
        log(f"  {flat_run['run']}: generate({NEW_TOKENS}) {flat_run['generate_ms']:.1f} ms (the head "
            f"layout again, right after: {flat_run['head_layout_again_ms']:.1f} ms), greedy ids equal "
            f"to the head layout's")
        assert_launches("x052 serving, flat layout", flat_launches, flat_want)
        serving["runs"].append(flat_run)
        paths["serving_x052_flat"] = flat_launches
    plain_check_serving(serving, cfg, params, seed, device)
    del params
    torch.cuda.empty_cache()
    return serving, paths


# ---------------------------------------------------------------------------
# phase 12: the published VisualRWKV-6 / HD / UHD paths, the v7.03 token
# compressor, v5.1 scanning and the host-offloaded optimizer
# ---------------------------------------------------------------------------

# 12a: four one-image prompts of LEFTPAD_T_IN tokens, the image token at
# these positions; every row passes ctx_len (4096), row 0 (no valid label
# in its head) is cut by tail-keep truncation, the others keep their heads.
# Row 0's cut stays before its image (T_in - 100 <= ctx_len - 577 + 1), so
# that its span, flipped at max_idx - off, is its image.
LEFTPAD_POSITIONS = (100, 300, 1200, 2400)
LEFTPAD_T_IN = 3600
# the plain check's two rows under this ctx_len, row 0 tail-kept, row 1 head-kept
LEFTPAD_CHECK = ((20, 40), 80, 640)
VTC_LAYERS = 2  # the least depth that runs both directions
OFFLOAD_STEPS = 3
OFFLOAD_7B_STEPS = 2
RAM_MARGIN = 1.1  # the 7B offloaded run needs this many times its pinned bytes available


def leftpad_request(cfg, positions, t_in: int, seed: int, device, tail_row: int = 0):
    """Token ids ``[B, t_in]`` with one image token a row at ``positions``,
    labels (the text, and for ``tail_row`` only its last 16 tokens: its head
    holds no valid label, so a cut keeps its tail) and one image a row."""
    import torch

    from visualrwkv_torch.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from visualrwkv_torch.vision.backbone import tower_configs

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    B = len(positions)
    ids = torch.randint(10, 65000, (B, t_in), generator=gen, device=device)
    for b, pos in enumerate(positions):
        ids[b, pos] = IMAGE_TOKEN_INDEX
    labels = torch.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids)
    labels[tail_row, :t_in - 16] = IGNORE_INDEX
    images = {t: torch.randint(0, 256, (B, c.img_size, c.img_size, 3), generator=gen, device=device,
                               dtype=torch.uint8)
              for t, c in tower_configs(cfg.vision).items()}
    return ids, labels, images


def leftpad_train_batch(cfg, batch: int, ctx: int, seed: int):
    """A leftpad training batch made with numpy from the seed: one image
    token a sample at a position below 64, the prompt before it and the
    image token masked in the labels, text long enough that every sample
    passes ``ctx`` (head-keep truncation: the plan's T_out is ``ctx``)."""
    import numpy as np

    from visualrwkv_torch.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from visualrwkv_torch.vision.backbone import tower_configs

    rng = np.random.default_rng(seed)
    vocab, t_in = cfg.rwkv.vocab_size, ctx - cfg.num_token_per_image + 64
    ids = rng.integers(0, vocab - 1, (batch, t_in))
    labels = rng.integers(0, vocab - 1, (batch, t_in))
    for b, pos in enumerate(rng.integers(0, 64, batch)):
        ids[b, pos] = IMAGE_TOKEN_INDEX
        labels[b, :pos + 1] = IGNORE_INDEX
    images = {t: rng.integers(0, 256, (batch, c.img_size, c.img_size, 3), dtype=np.uint8)
              for t, c in tower_configs(cfg.vision).items()}
    return {"input_ids": ids, "labels": labels, "images": images}


def tail_offsets(cfg, params, ids, labels, plan):
    """The rows' tail-keep offsets under ``plan`` (``leftpad_insert``'s
    ``off``), on the host."""
    import torch

    from visualrwkv_torch.multimodal.insertion import leftpad_insert

    emb = params["rwkv"]["emb"]["weight"]
    feats = torch.zeros(ids.shape[0], plan.img_len, emb.shape[1], device=ids.device, dtype=emb.dtype)
    return leftpad_insert(emb, ids, labels, feats, plan)[2].tolist()


def run_leftpad_serving(cfg6, params, device, seed: int):
    """12a: VisualRWKV-6 7B as published: the leftpad insertion and the
    image span reversed on odd blocks, one ``vlm_forward_leftpad`` over four
    one-image prompts (the image at four positions, row 0 tail-kept): K7 a
    block, K3 as one encode; then the logits at ``PLAIN_LAYERS`` layers
    against the plain path on the CPU."""
    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.models.visualrwkv import vlm_forward_leftpad
    from visualrwkv_torch.multimodal.insertion import leftpad_plan

    cfg = cfg6.replace(insertion_mode="leftpad", bidirectional_image=True)
    ids, labels, images = leftpad_request(cfg, LEFTPAD_POSITIONS, LEFTPAD_T_IN, seed + 41, device)
    plan = leftpad_plan(ids, cfg.num_token_per_image, cfg.rwkv.ctx_len)
    off = tail_offsets(cfg, params, ids, labels, plan)
    log(f"  12a plan: {plan}; tail-keep offsets {off}")
    assert off[0] > 0 and not any(off[1:]) and plan.T_out == cfg.rwkv.ctx_len
    assert all(plan.max_idx >= o for o in off), "a cut fell inside an image span"
    fwd = lambda: vlm_forward_leftpad(params, cfg, ids, labels, images, plan=plan, device=device)
    with torch.no_grad():
        fwd()  # warm-up
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        (logits, new_labels, _), ms = timed(fwd)
        launches = dict(cuda_build.LAUNCHES)
    want = expected_launches(cfg, prefills=1, encodes=1)
    assert logits.shape == (len(LEFTPAD_POSITIONS), plan.T_out, cfg.rwkv.vocab_size)
    assert torch.isfinite(logits).all()
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = logits.shape[0] * logits.shape[1]
    log(f"  12a vlm_forward_leftpad, B={logits.shape[0]} x T_out={plan.T_out}: {ms:.1f} ms "
        f"({tokens / (ms / 1e3):.0f} tok/s), peak {peak:.2f} GiB")
    del logits
    out = {"ms": ms, "tokens": tokens, "peak_gib": peak, "plan": dataclasses.asdict(plan), "off": off}
    out["plain_check_rel_rms"], out["plain_check_cpu_s"] = check_leftpad_against_plain(
        cfg, params, PLAIN_LAYERS, seed + 43, device)
    torch.cuda.empty_cache()
    return out, launches, want


def check_on_tower_features(what: str, cfg, p, images, run, device):
    """``run(params, cfg, tower_features, device)`` (logits) of the kernel
    path on the card against the plain path on the CPU, both in fp32 on the
    same weights and both fed the towers' features computed once on the
    card (bf16): the check holds what follows the towers (whose kernels
    phases 2, 3, 5 and 7 hold), and the CPU runs no tower. In bf16 the two
    sides round apart, and through noisy blocks their logits drift further
    apart than ``PLAIN_CHECK_TOL``, which would hide a fault."""
    import torch

    from visualrwkv_torch.vision.backbone import backbone_tower_features

    c32 = cfg.replace(rwkv=dataclasses.replace(cfg.rwkv, compute_dtype="float32"))
    body = {k: v for k, v in p.items() if k != "vit"}
    with torch.no_grad():
        tower = backbone_tower_features(p["vit"], cfg.vision, images, cfg.rwkv.compute_dtype)
        card = run(to_device(body, device, torch.float32), c32, tower, device).float().cpu()
        t0 = time.perf_counter()
        cpu = run(to_device(body, "cpu", torch.float32), c32, {k: v.cpu() for k, v in tower.items()},
                  torch.device("cpu")).float()
        cpu_s = time.perf_counter() - t0
    e = rel_rms(card, cpu)
    log(f"  {what} {tuple(cpu.shape)}, LM cut to {cfg.rwkv.n_layer} noisy layers, fp32, on the card's tower "
        f"features: kernels (card) vs plain (CPU) rel_rms={e:.3e} (tol {PLAIN_CHECK_TOL:g}); CPU run {cpu_s:.1f} s")
    assert torch.isfinite(card).all() and torch.isfinite(cpu).all()
    assert e <= PLAIN_CHECK_TOL, e
    return e, cpu_s


def check_leftpad_against_plain(cfg, params, n_layer: int, seed: int, device):
    """12a's check: ``vlm_forward_leftpad`` logits at every position, the LM
    cut to ``n_layer`` noisy blocks, two rows under ``LEFTPAD_CHECK``'s
    ctx_len (row 0 tail-kept, its span flipped at ``max_idx - off``; row 1
    head-kept)."""
    from visualrwkv_torch.models.visualrwkv import encode_images, vlm_forward_leftpad

    positions, t_in, ctx = LEFTPAD_CHECK
    c, p = noisy_lm(cfg, params, n_layer, seed, device)
    c = c.replace(rwkv=dataclasses.replace(c.rwkv, ctx_len=ctx))
    ids, labels, images = leftpad_request(c, positions, t_in, seed, device)

    def run(tree, cfg_, tower, dev):
        feats = encode_images(tree, cfg_, None, tower_features=tower)
        return vlm_forward_leftpad(tree, cfg_, ids.to(dev), labels.to(dev), image_features=feats,
                                   device=dev)[0]

    return check_on_tower_features("leftpad + bidirectional logits", c, p, images, run, device)


def prefill_logits_run(ids):
    """``run`` for :func:`check_on_tower_features`: the logits of a
    stateless forward over ``ids`` with the image features of
    ``encode_images`` scattered in."""
    from visualrwkv_torch.models import lm
    from visualrwkv_torch.models.visualrwkv import encode_images, prepare_embeddings

    def run(tree, cfg_, tower, dev):
        feats = encode_images(tree, cfg_, None, tower_features=tower)
        x = prepare_embeddings(tree, cfg_, ids.to(dev), image_features=feats)
        return lm.lm_forward(tree["rwkv"], cfg_.rwkv, x)[0]

    return run


def ttft_ms(eng, ids, images) -> float:
    """The median of three timed prefills (after the caller's warm-up)."""
    return sorted(timed(lambda: eng.prefill_ids(ids, images))[1] for _ in range(3))[1]


def run_vtc_serving(cfg, params, device, seed: int):
    """12d: the flagship 1B5 with v7.03's token compressor (``VTC_LAYERS``
    blocks copied from its LM by ``init_vtc_from_lm``), one one-image
    request through ``InferenceEngine.generate``: K1 24 + 2 times a
    prefill; then the same with ``image_scanning="snake"``; the snake
    configuration's logits against the plain path at ``PLAIN_LAYERS``
    noisy layers, the compressor copied from them, on the card's tower
    features. The model's TTFT without the compressor is timed right
    after, on the same request."""
    import numpy as np
    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.infer.engine import InferenceEngine
    from visualrwkv_torch.multimodal.vtc import init_vtc_from_lm

    p = dict(params, vtc=init_vtc_from_lm(params["rwkv"], VTC_LAYERS))
    runs, paths = {}, {}
    for name, c in (("vtc", cfg.replace(n_vtc_layer=VTC_LAYERS)),
                    ("vtc_snake", cfg.replace(n_vtc_layer=VTC_LAYERS, image_scanning="snake"))):
        eng = InferenceEngine(p, c, state_dtype="float32", device=device)
        ids, images = make_request(c, 1, 32, seed + 1, device)
        eng.generate(ids, images, max_new_tokens=2)
        ttft = ttft_ms(eng, ids, images)
        reset_launches()
        res, ms = timed(lambda: eng.generate(ids, images, max_new_tokens=NEW_TOKENS, stop_tokens=(-1,)))
        launches = dict(cuda_build.LAUNCHES)
        assert res.tokens.shape == (1, NEW_TOKENS) and np.isfinite(res.logits).all()
        want = expected_launches(c, prefills=1, decode_steps=NEW_TOKENS, encodes=1)
        want["wkv7_fwd"] += VTC_LAYERS
        assert_launches(f"12d {name}", launches, want)
        runs[name] = {"ttft_ms": ttft, "generate_ms": ms, "first_ids": res.tokens[0, :8].tolist()}
        paths[f"serving_x070_{name}"] = launches
        log(f"  12d {name}: TTFT {ttft:.1f} ms, generate({NEW_TOKENS}) {ms:.1f} ms, first ids "
            f"{runs[name]['first_ids']}")
    runs["ttft_without_ms"] = ttft_ms(InferenceEngine(params, cfg, state_dtype="float32", device=device),
                                      ids, images)
    log(f"  12d the same request without the compressor: TTFT {runs['ttft_without_ms']:.1f} ms")
    # the check: the LM cut to noisy blocks, the compressor copied from them
    c2, p2 = noisy_lm(c, params, PLAIN_LAYERS, seed + 7, device)
    p2["vtc"] = init_vtc_from_lm(p2["rwkv"], VTC_LAYERS)
    ids, images = make_request(c2, 1, 32, seed + 7, device)
    runs["plain_check_rel_rms"], runs["plain_check_cpu_s"] = check_on_tower_features(
        "compressor + snake, logits", c2, p2, images, prefill_logits_run(ids), device)
    torch.cuda.empty_cache()
    return runs, paths


def run_leftpad_training(cfg6t, params, device, seed: int):
    """12b: VisualRWKV-6 1.6B trained as published (leftpad insertion, the
    bidirectional span, the dense loss): ``Trainer`` for 1 + 3 steps (K8 48
    and K9 24 a step), then the loss and three gradients against the plain
    path on the CPU at ``PLAIN_LAYERS`` layers."""
    cfg = cfg6t.replace(insertion_mode="leftpad", bidirectional_image=True)
    training, launches, want = train(cfg, params, device, seed + 50, make_batch=leftpad_train_batch)
    assert_launches("12b leftpad + bidirectional training", launches, want)
    training["plain_check"] = check_training_against_plain(cfg, params, PLAIN_LAYERS, seed + 51, device,
                                                           make_batch=leftpad_train_batch, lm_alone=False)
    return training, launches


def host_memory() -> dict:
    """MemTotal and MemAvailable of ``/proc/meminfo``, bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(value.split()[0]) * 1024
    return out


def run_offload(cfg, params, device, seed: int):
    """12c on phase 6's 1.6B: ``OFFLOAD_STEPS`` ``Trainer`` steps with
    ``offload_optimizer`` and as many resident, each from a copy of the
    same parameters on the same batches: parameters and optimizer state
    bit-equal. Logs the host's memory, the pinned bytes, the bytes copied
    each way a step, the last step's copy times against its step time, and
    peak device memory of both runs."""
    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.train.optim import tree_leaves
    from visualrwkv_torch.train.trainer import Trainer

    mem = host_memory()
    log(f"  12c host memory: MemTotal {mem['MemTotal'] / 1e9:.1f} GB, MemAvailable "
        f"{mem['MemAvailable'] / 1e9:.1f} GB")
    tcfg = train_cfg(OFFLOAD_STEPS)
    batches = [train_batch(cfg, TRAIN_MICRO_BSZ, TRAIN_CTX, seed + 60 + i) for i in range(OFFLOAD_STEPS)]
    runs, trainers = {}, {}
    for name, off in (("offloaded", True), ("resident", False)):
        tc = dataclasses.replace(tcfg, offload_optimizer=off)
        (tr, build_ms) = timed(lambda: Trainer(cfg, tc, to_device(params, device, copy=True), device=device,
                                               proj_dir=TRAIN_LOG_DIR, log_every=1))
        st = tr._streamed
        assert (st is not None) == off
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        steps = []
        for i, b in enumerate(batches):
            if st is not None:
                st.copy_timing = i == len(batches) - 1
            loss, ms = timed(lambda: float(tr.train_step(b)))
            steps.append({"loss": loss, "step_ms": ms})
        launches = dict(cuda_build.LAUNCHES)
        assert_launches(f"12c {name}", launches, expected_launches(cfg, encodes=OFFLOAD_STEPS,
                                                                   train_micro_batches=OFFLOAD_STEPS))
        run = {"build_ms": build_ms, "steps": steps, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": launches}
        if st is not None:
            run.update(pinned_bytes=st.pinned_bytes, stage_bytes=st.stage_bytes,
                       copy_bytes_each_way=st.pinned_bytes, groups=len(st.groups),
                       last_step_copy_ms=st.copy_ms())
            c = run["last_step_copy_ms"]
            rate = lambda ms: f"{st.pinned_bytes / 1e6 / ms:.1f} GB/s" if ms > 0 else "not timed"
            log(f"  12c offloaded: {run['groups']} groups, pinned {st.pinned_bytes / 1e9:.2f} GB (Trainer "
                f"built in {build_ms / 1e3:.1f} s), device slots {st.stage_bytes / 1e9:.2f} GB, copied "
                f"{st.pinned_bytes / 1e9:.2f} GB each way a step; last step {steps[-1]['step_ms']:.1f} ms, "
                f"its copies in {c['in']:.1f} ms ({rate(c['in'])}) and back {c['out']:.1f} ms "
                f"({rate(c['out'])}) of device time")
        log(f"  12c {name}: steps " + ", ".join(f"{s['step_ms']:.1f} ms (loss {s['loss']:.4f})" for s in steps)
            + f"; peak {run['peak_gib']:.2f} GiB")
        runs[name], trainers[name] = run, tr
    a, b = trainers["offloaded"], trainers["resident"]
    assert [s["loss"] for s in runs["offloaded"]["steps"]] == [s["loss"] for s in runs["resident"]["steps"]]
    same = all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)))
    st = a._streamed.opt_state
    for name in ("mu", "nu", "master"):
        for x, y in zip(tree_leaves(getattr(st, name)), tree_leaves(getattr(b.state.opt_state, name))):
            same = same and ((x is None and y is None) or torch.equal(x.to(device), y))
    log(f"  12c parameters, moments and masters after {OFFLOAD_STEPS} steps, offloaded vs resident: "
        f"{'bit-equal' if same else 'DIFFERENT'}")
    assert same, "the offloaded optimizer's state differs from the resident one's"
    runs["bit_equal"] = same
    runs["host_memory"] = mem
    del a, b, trainers
    torch.cuda.empty_cache()
    return runs


def run_offload_7b(cfg6, params, device, seed: int):
    """12c on phase 5's VisualRWKV-6 7B (bf16 parameters, micro-batch 2 x
    2048): ``Trainer`` with ``offload_optimizer`` for 1 + ``OFFLOAD_7B_STEPS``
    steps, its peak under the card's memory. Left out, with a line that says
    so, when the host's MemAvailable is below ``RAM_MARGIN`` times the
    pinned bytes the state needs (reckoned from the shapes first).
    ``params`` are trained in place."""
    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.train.offload import group_layout
    from visualrwkv_torch.train.optim import Optimizer
    from visualrwkv_torch.train.trainer import Trainer

    tcfg = dataclasses.replace(train_cfg(OFFLOAD_7B_STEPS + 1), offload_optimizer=True)
    need = 4 * sum(group_layout(Optimizer(tcfg, params, 1, cfg6.rwkv.n_layer), params)[2])
    mem = host_memory()
    out = {"pinned_bytes_needed": need, "host_memory": mem}
    log(f"  12c 7B: the offloaded state needs {need / 1e9:.2f} GB pinned; MemTotal "
        f"{mem['MemTotal'] / 1e9:.1f} GB, MemAvailable {mem['MemAvailable'] / 1e9:.1f} GB")
    if mem["MemAvailable"] < RAM_MARGIN * need:
        log(f"  12c 7B: MemAvailable {mem['MemAvailable'] / 1e9:.1f} GB is below {RAM_MARGIN} x the "
            f"{need / 1e9:.2f} GB of pinned optimizer state: the 7B offloaded run is left out on this machine")
        return dict(out, ran=False), None
    tr, build_ms = timed(lambda: Trainer(cfg6, tcfg, params, device=device, proj_dir=TRAIN_LOG_DIR,
                                         log_every=1))
    batches = [train_batch(cfg6, TRAIN_MICRO_BSZ, TRAIN_CTX, seed + 70 + i) for i in range(OFFLOAD_7B_STEPS + 1)]
    loss, warm_ms = timed(lambda: float(tr.train_step(batches[0])))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    steps = []
    for b in batches[1:]:
        loss, ms = timed(lambda: float(tr.train_step(b)))
        assert loss == loss, loss
        steps.append({"loss": loss, "step_ms": ms})
    launches = dict(cuda_build.LAUNCHES)
    assert_launches("12c 7B offloaded", launches, expected_launches(
        cfg6, encodes=OFFLOAD_7B_STEPS, train_micro_batches=OFFLOAD_7B_STEPS))
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(device).total_memory
    log(f"  12c 7B offloaded: Trainer built in {build_ms / 1e3:.1f} s, warm-up step {warm_ms:.0f} ms, steps "
        + ", ".join(f"{s['step_ms']:.1f} ms (loss {s['loss']:.4f})" for s in steps)
        + f"; peak {peak / 2**30:.2f} GiB of the card's {total / 2**30:.2f} GiB")
    assert peak < total
    del tr
    torch.cuda.empty_cache()
    return dict(out, ran=True, build_ms=build_ms, warmup_ms=warm_ms, steps=steps, peak_gib=peak / 2**30), launches


def run_uhd_serving(cfg6t, params, device, seed: int):
    """12e: UHD on phase 6's 1.6B: ``uhd_fusion`` doubles the projector's
    input (a new gated-MLP projector from the seed, 2 x 3200 -> 2048); one
    request whose towers each take five views (the global view and 2x2
    tiles) in one batch, through ``InferenceEngine.generate``: K3 as one
    encode (the five views are one batch), K7 24 a prefill. Then the logits
    at ``PLAIN_LAYERS`` noisy layers against the plain path, on the card's
    tower features (the fusion, the projector and the LM)."""
    import numpy as np
    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.infer.engine import InferenceEngine
    from visualrwkv_torch.multimodal.projector import init_projector_params

    c = cfg6t.replace(uhd_fusion=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 80)
    p = dict(params, proj=init_projector_params(gen, c.proj_type, c.projector_in_dim, c.rwkv.n_embd, device,
                                                torch.bfloat16))
    ids, images = make_request(c, 5, 32, seed + 81, device)  # five views of one image
    ids = ids[:1]
    eng = InferenceEngine(p, c, state_dtype="float32", device=device)
    eng.generate(ids, images, max_new_tokens=2)
    ttft = ttft_ms(eng, ids, images)
    reset_launches()
    res, ms = timed(lambda: eng.generate(ids, images, max_new_tokens=NEW_TOKENS, stop_tokens=(-1,)))
    launches = dict(cuda_build.LAUNCHES)
    assert res.tokens.shape == (1, NEW_TOKENS) and np.isfinite(res.logits).all()
    assert_launches("12e UHD serving", launches, expected_launches(c, prefills=1, decode_steps=NEW_TOKENS,
                                                                   encodes=1))
    one_view = {t: v[:1] for t, v in images.items()}
    base = InferenceEngine(params, cfg6t, state_dtype="float32", device=device)
    base.generate(ids, one_view, max_new_tokens=2)
    ttft_without = ttft_ms(base, ids, one_view)
    log(f"  12e UHD, projector {c.projector_in_dim} -> {c.rwkv.n_embd}, five views a tower: TTFT {ttft:.1f} ms "
        f"(the model without UHD on the global view alone: {ttft_without:.1f} ms), generate({NEW_TOKENS}) "
        f"{ms:.1f} ms")

    c2, p2 = noisy_lm(c, p, PLAIN_LAYERS, seed + 82, device)
    e, cpu_s = check_on_tower_features("UHD logits", c2, p2, images, prefill_logits_run(ids), device)
    torch.cuda.empty_cache()
    return {"ttft_ms": ttft, "ttft_without_ms": ttft_without, "generate_ms": ms,
            "plain_check_rel_rms": e, "plain_check_cpu_s": cpu_s}, launches


# ---------------------------------------------------------------------------
# phase 13: the separate variant models (v7.10 VRWKV and the mixture-FFN LM,
# v6.xx image-as-state with state tuning, the v6.23 hybrid, the v4 adapter)
# ---------------------------------------------------------------------------

VRWKV_PATCH = 14
VRWKV_PX = 224  # 16 x 16 = 256 patches
VRWKV_IMAGES = 32
MIX_T = 1024  # 13b: 256 image positions (VRWKV's patches) and 768 text tokens
STATE_TEXT = 256  # 13c: text tokens after the image state
STATE_MEAN_IMAGES = 3
HYBRID_CROSS, HYBRID_INTERVAL, HYBRID_T = 6, 4, 512  # 13d: no published setting exists; chosen for the 1.6B's 24 blocks
ADAPTER_B, ADAPTER_CAPTION = 8, 32
# The plain checks of phase 13: the card in fp32 against the CPU in fp32, on
# the model cut to PLAIN_LAYERS noisy blocks (the towers' features taken
# from the card, as phase 12 does): the limits of phase 4's fp32 LM check.
PHASE13_LOSS_TOL = TRAIN_CHECK_FP32_LOSS_TOL
PHASE13_GRAD_TOL = TRAIN_CHECK_FP32_GRAD_TOL


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _name(path) -> str:
    return ".".join(str(k) for k in path)


def hold_against_cpu(what: str, run, tree, paths, device, per_layer=()):
    """``run(tree, device) -> loss`` on the card and on the CPU, fp32 both,
    same ``tree`` (fp32 leaves): the loss and the gradients of the leaves at
    ``paths`` (those in ``per_layer`` held a leading index at a time), each
    nonzero and within ``PHASE13_GRAD_TOL`` (relative RMS) of the CPU's,
    the loss within ``PHASE13_LOSS_TOL``. Logs every reading against its
    limit; returns them."""
    import torch

    def once(t, dev):
        leaves = [_get(t, p).requires_grad_(True) for p in paths]
        loss = run(t, dev)
        grads = torch.autograd.grad(loss, leaves)
        for leaf in leaves:
            leaf.requires_grad_(False)
        return float(loss.detach()), [g.float().cpu() for g in grads]

    card = once(tree, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cpu = once(to_device(tree, "cpu"), torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    d_loss = abs(card[0] - cpu[0]) / abs(cpu[0])
    log(f"  {what}: card fp32 vs CPU fp32 (CPU run {cpu_s:.1f} s): loss {card[0]:.6f} vs {cpu[0]:.6f} "
        f"(relative {d_loss:.2e}, tol {PHASE13_LOSS_TOL:g})")
    errs = {}
    for path, g, r in zip(paths, card[1], cpu[1]):
        parts = [(f"[{i}]", g[i], r[i]) for i in range(g.shape[0])] if path in per_layer else [("", g, r)]
        for suffix, gi, ri in parts:
            name = _name(path) + suffix
            assert torch.isfinite(gi).all() and float(ri.abs().max()) > 0, name
            errs[name] = rel_rms(gi, ri)
            log(f"    d loss / d {name}: rel_rms={errs[name]:.3e} (tol {PHASE13_GRAD_TOL:g})")
    assert d_loss <= PHASE13_LOSS_TOL, (what, d_loss)
    assert all(e <= PHASE13_GRAD_TOL for e in errs.values()), (what, errs)
    return {"loss_rel": d_loss, "grad_rel_rms": errs, "cpu_s": cpu_s}


def want_only(**counts):
    want = dict.fromkeys(REPLACES, 0)
    want.update(counts)
    return want


def _launches():
    from visualrwkv_torch import cuda_build

    return dict(cuda_build.LAUNCHES)


def _text_ce(logits, ids):
    """Next-token cross-entropy of ``logits`` ``[B, T, V]`` on ``ids``."""
    import torch.nn.functional as F

    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]).float(), ids[:, 1:].reshape(-1))


def run_vrwkv(seed: int, device):
    """13a: v7.10's VRWKV at the 1B5's width (C 2048, ``VRWKV_DEPTH``
    blocks, patch 14, 224 px: 256 patches) on seeded random bf16 weights:
    ``VRWKV_IMAGES`` uint8 images through the ImageNet step and
    ``topk_accuracy`` (K1 once a block), then one forward + backward of
    ``imagenet_loss`` on them (K5, K6 once a block), and the gradients
    against the plain path on the CPU at ``PLAIN_LAYERS`` blocks in fp32.
    Returns (numbers, {path: launches}, the parameters, the images,
    labels)."""
    import torch

    from visualrwkv_torch.data.transforms import normalize_uint8
    from visualrwkv_torch.evals.imagenet import imagenet_logits, topk_accuracy
    from visualrwkv_torch.models.vrwkv import VRWKV_DEPTH, imagenet_loss, init_vrwkv_params, vrwkv_forward

    rc = flagship_cfg().rwkv
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 31)
    params = init_vrwkv_params(gen, rc, VRWKV_PATCH, device, dtype=torch.bfloat16)
    pixels = torch.randint(0, 256, (VRWKV_IMAGES, VRWKV_PX, VRWKV_PX, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    labels = torch.randint(0, 1000, (VRWKV_IMAGES,), generator=gen, device=device)
    out, paths = {}, {}
    reset_launches()
    logits, out["eval_ms"] = timed(lambda: imagenet_logits(params, rc, pixels, VRWKV_PATCH))
    paths["vrwkv_imagenet_eval"] = _launches()
    assert_launches("13a ImageNet step", paths["vrwkv_imagenet_eval"], want_only(wkv7_fwd=VRWKV_DEPTH))
    assert logits.shape == (VRWKV_IMAGES, 1000) and torch.isfinite(logits).all()
    out["accuracy"] = topk_accuracy(logits.float().cpu().numpy(), labels.cpu().numpy())

    leaves = list(_leaves(params))
    for leaf in leaves:
        leaf.requires_grad_(True)

    def step():
        _, cls = vrwkv_forward(params, rc, normalize_uint8(pixels, "dino", rc.dtype), VRWKV_PATCH)
        loss = imagenet_loss(cls, labels)
        return loss, torch.autograd.grad(loss, leaves)

    reset_launches()
    (loss, grads), out["train_step_ms"] = timed(step)
    paths["vrwkv_imagenet_train"] = _launches()
    for leaf in leaves:
        leaf.requires_grad_(False)
    assert_launches("13a imagenet_loss forward + backward", paths["vrwkv_imagenet_train"],
                    want_only(wkv7_fwd_res=VRWKV_DEPTH, wkv7_bwd=VRWKV_DEPTH))
    assert all(torch.isfinite(g).all() for g in grads)
    out["loss"] = float(loss.detach())
    log(f"  13a: ImageNet step over {VRWKV_IMAGES} images {out['eval_ms']:.1f} ms, accuracy {out['accuracy']} "
        f"(random weights); imagenet_loss {out['loss']:.4f}, forward + backward {out['train_step_ms']:.1f} ms")
    del grads

    # the plain check: 2 noisy blocks, 2 images cut to 112 px (64 patches)
    c32 = dataclasses.replace(rc, compute_dtype="float32")
    tree = noisy({"vrwkv": dict(params, blocks=params["blocks"][:PLAIN_LAYERS])}, gen, dtype="float32")
    px, lb = pixels[:2, :112, :112], labels[:2]

    def run(t, dev):
        _, cls = vrwkv_forward(t["vrwkv"], c32, normalize_uint8(px.to(dev), "dino", torch.float32), VRWKV_PATCH)
        return imagenet_loss(cls, lb.to(dev))

    out["plain_check"] = hold_against_cpu(
        f"13a VRWKV cut to {PLAIN_LAYERS} blocks", run, tree,
        [("vrwkv", "emb", "weight"), ("vrwkv", "blocks", 1, "att", "w1"), ("vrwkv", "head", "weight")], device)
    return out, paths, params, pixels, labels


def perturb_zero_projections(lm_params, gen, scale: float = 1e-3):
    """Seeded noise, in place, on the LM's zero-initialised output and value
    projections: at its random init a block adds nothing to the stream, so
    no gradient would reach a state or an earlier block through it."""
    import torch

    for blk in lm_params["blocks"]:
        for part, name in (("att", "output"), ("ffn", "value")):
            w = blk[part][name]["weight"]
            w.add_((torch.randn(w.shape, generator=gen, device=w.device) * scale).to(w.dtype))


def run_mixffn(cfg, params, vparams, pixels, labels, seed: int, device):
    """13b: v7.10's mixture-FFN on phase 3's 1B5 LM with ``ffn_v`` / ``ln_v``
    added (seeded, bf16), behind 13a's VRWKV: B = 2, T = ``MIX_T`` with the
    first 256 positions VRWKV's patch features (``ffn_v``) and the rest text
    (``ffn``); one forward + backward of the LM loss plus ``imagenet_loss``
    with ``requires_grad`` set by ``pretrain_mode_mask``: only ``vrwkv``,
    ``ffn_v`` and ``ln_v`` take gradients (K5, K6 once a VRWKV block and
    once an LM block). Then the plain check at ``PLAIN_LAYERS``."""
    import torch

    from visualrwkv_torch.data.transforms import normalize_uint8
    from visualrwkv_torch.models.lm import init_lm_params
    from visualrwkv_torch.models.rwkv7 import embed
    from visualrwkv_torch.models.vrwkv import (VRWKV_DEPTH, add_mixture_ffn, imagenet_loss, pretrain_mode_mask,
                                               rwkv7_mixffn_forward, vrwkv_forward)
    from visualrwkv_torch.train.optim import tree_leaves_with_path

    rc = cfg.rwkv
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 32)
    add_mixture_ffn(gen, params["rwkv"], rc, dtype=torch.bfloat16)
    tree = {"rwkv": params["rwkv"], "vrwkv": vparams}
    mask = dict(tree_leaves_with_path(pretrain_mode_mask(tree)))
    named = tree_leaves_with_path(tree)
    for path, leaf in named:
        leaf.requires_grad_(mask[path])
    n_img = (VRWKV_PX // VRWKV_PATCH) ** 2
    ids = torch.randint(10, 65000, (2, MIX_T - n_img), generator=gen, device=device)
    pos = torch.zeros(2, MIX_T, dtype=torch.bool, device=device)
    pos[:, :n_img] = True

    def loss_of(t, c, px, ids, pos, lb):
        feats, cls = vrwkv_forward(t["vrwkv"], c, normalize_uint8(px, "dino", c.dtype), VRWKV_PATCH)
        x = torch.cat([feats.to(c.dtype), embed(t["rwkv"], ids).to(c.dtype)], dim=1)
        logits = rwkv7_mixffn_forward(t["rwkv"], c, x, pos)
        return _text_ce(logits[:, feats.shape[1]:], ids) + imagenet_loss(cls, lb)

    out = {}
    reset_launches()

    def step():
        loss = loss_of(tree, rc, pixels[:2], ids, pos, labels[:2])
        loss.backward()
        return loss

    loss, out["train_step_ms"] = timed(step)
    launches = _launches()
    n_trained = sum(1 for path, leaf in named if mask[path])
    for path, leaf in named:
        assert (leaf.grad is not None) == mask[path], (_name(path), mask[path])
        if leaf.grad is not None:
            assert torch.isfinite(leaf.grad).all(), _name(path)
        leaf.grad = None
        leaf.requires_grad_(False)
    L = rc.n_layer
    assert_launches("13b mixture-FFN forward + backward", launches,
                    want_only(wkv7_fwd_res=VRWKV_DEPTH + L, wkv7_bwd=VRWKV_DEPTH + L))
    out.update(loss=float(loss.detach()), trained_leaves=n_trained, frozen_leaves=len(named) - n_trained)
    log(f"  13b: B=2 x {MIX_T} ({n_img} image positions), loss {out['loss']:.4f}, forward + backward "
        f"{out['train_step_ms']:.1f} ms; {n_trained} leaves took gradients (vrwkv, ffn_v, ln_v), "
        f"{len(named) - n_trained} none")

    # the plain check: 2 noisy LM blocks with ffn_v, 2 noisy VRWKV blocks, 112 px (64 patches) + 48 text
    c = dataclasses.replace(rc, n_layer=PLAIN_LAYERS, compute_dtype="float32")
    lm = add_mixture_ffn(gen, init_lm_params(gen, c, device), c)
    t32 = noisy({"rwkv": lm, "vrwkv": dict(vparams, blocks=vparams["blocks"][:PLAIN_LAYERS])}, gen,
                dtype="float32")
    px, lb, ids_s = pixels[:1, :112, :112], labels[:1], ids[:1, :48]
    pos_s = torch.zeros(1, 64 + 48, dtype=torch.bool, device=device)
    pos_s[:, :64] = True
    out["plain_check"] = hold_against_cpu(
        f"13b mixture-FFN, LM and VRWKV cut to {PLAIN_LAYERS} blocks",
        lambda t, dev: loss_of(t, c, px.to(dev), ids_s.to(dev), pos_s.to(dev), lb.to(dev)), t32,
        # block 0's: the last block's ffn_v acts on image positions only, which the text loss does not read
        [("vrwkv", "emb", "weight"), ("rwkv", "blocks", 0, "ffn_v", "key", "weight"),
         ("rwkv", "blocks", 0, "ln_v", "weight")], device)
    return out, {"mixffn_train": launches}


def run_state_tuning(cfg, params, seed: int, device, what: str, mean_images: bool):
    """13c on a serving model (x070 or x060): image-as-state with state
    tuning, B = 2, the images' tokens from the model's encode (towers and
    projector), a ``STATE_TEXT``-token text; the loss's gradient with
    respect to ``time_states`` ``[L, H, N, N]`` (the LM frozen: K5 / K8
    twice a layer, the image pass and the text pass, and K6 / K9 as often),
    every layer's nonzero; a forward without a gradient (K1 / K7 twice a
    layer), with ``mean_multi_image`` over ``STATE_MEAN_IMAGES`` images
    when ``mean_images``; then the plain check at ``PLAIN_LAYERS``."""
    import torch

    from visualrwkv_torch.models.lm import init_lm_params
    from visualrwkv_torch.models.rwkv7 import embed
    from visualrwkv_torch.models.visualrwkv import encode_images
    from visualrwkv_torch.multimodal.image_as_state import image_as_state_forward, init_time_states

    rc = cfg.rwkv
    L = rc.n_layer
    fwd, _, fwd_res, bwd = WKV_KERNELS[rc.version]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 33)
    n_images = STATE_MEAN_IMAGES if mean_images else 2
    _, images = make_request(cfg, n_images, 0, seed + 33, device)
    img = encode_images(params, cfg, images)
    ids = torch.randint(10, 65000, (2, STATE_TEXT), generator=gen, device=device)
    text = embed(params["rwkv"], ids)
    out, paths = {"image_tokens": img.shape[1]}, {}
    ts = init_time_states(cfg, device).requires_grad_(True)

    def step():
        loss = _text_ce(image_as_state_forward(params, cfg, text, img[:2], time_states=ts), ids)
        return loss, torch.autograd.grad(loss, [ts])[0]

    reset_launches()
    (loss, g), out["state_tuning_ms"] = timed(step)
    paths[f"state_tuning_{rc.version}"] = _launches()
    assert_launches(f"13c {what} state tuning", paths[f"state_tuning_{rc.version}"],
                    want_only(**{fwd_res: 2 * L, bwd: 2 * L}))
    assert torch.isfinite(g).all()
    per_layer = g.abs().amax(dim=(1, 2, 3))
    assert (per_layer > 0).all(), f"a layer's time_states gradient is zero: {per_layer.tolist()}"
    out.update(loss=float(loss.detach()), grad_max_by_layer=[float(x) for x in per_layer])

    n_fwd = n_images if mean_images else 2
    reset_launches()
    with torch.no_grad():
        logits, out["forward_ms"] = timed(lambda: image_as_state_forward(
            params, cfg, text, img[:n_fwd], mean_multi_image=mean_images))
    paths[f"image_as_state_{rc.version}"] = _launches()
    assert_launches(f"13c {what} forward{', mean of 3 images' if mean_images else ''}",
                    paths[f"image_as_state_{rc.version}"], want_only(**{fwd: 2 * L}))
    assert logits.shape == (2, STATE_TEXT, rc.vocab_size) and torch.isfinite(logits).all()
    log(f"  13c {what}: {img.shape[1]} image tokens, {STATE_TEXT} text, B=2: state tuning loss {out['loss']:.4f}, "
        f"forward + backward {out['state_tuning_ms']:.1f} ms, time_states gradient nonzero in all {L} layers "
        f"(max {min(out['grad_max_by_layer']):.2e}..{max(out['grad_max_by_layer']):.2e}); forward "
        f"{'(mean of ' + str(n_images) + ' images) ' if mean_images else ''}{out['forward_ms']:.1f} ms")
    del g, logits

    # the plain check: 2 noisy LM blocks, the card's image tokens (256 of one image), 64 text, random time_states
    c = cfg.replace(rwkv=dataclasses.replace(rc, n_layer=PLAIN_LAYERS, compute_dtype="float32"))
    ts32 = torch.randn(PLAIN_LAYERS, *ts.shape[1:], generator=gen, device=device) * 0.1
    t32 = {"rwkv": noisy(init_lm_params(gen, c.rwkv, device), gen, dtype="float32"), "time_states": ts32}
    img_s, ids_s = img[:1, :256].float(), ids[:1, :64]
    run = lambda t, dev: _text_ce(image_as_state_forward(t, c, embed(t["rwkv"], ids_s.to(dev)), img_s.to(dev),
                                                         time_states=t["time_states"]), ids_s.to(dev))
    out["plain_check"] = hold_against_cpu(f"13c {what} state tuning, LM cut to {PLAIN_LAYERS} layers", run, t32,
                                          [("time_states",)], device, per_layer=(("time_states",),))
    return out, paths, img


def run_hybrid(cfg, params, seed: int, device):
    """13d: v6.23's hybrid on phase 6's 1.6B (x060): ``HYBRID_CROSS`` cross
    blocks every ``HYBRID_INTERVAL`` from the end (seeded fp32, their zero
    output projections given small noise), fed the flagship towers'
    projected features (1024 tokens), B = 2, T = ``HYBRID_T``: a forward
    without a gradient (K7 once a block), then one forward + backward to
    every parameter (K8, K9 once a block); then the plain check at
    ``PLAIN_LAYERS`` RWKV blocks and 2 cross blocks at interval 2."""
    import torch

    from visualrwkv_torch.models.lm import init_lm_params
    from visualrwkv_torch.models.rwkv7 import embed
    from visualrwkv_torch.models.visualrwkv import encode_images
    from visualrwkv_torch.multimodal.hybrid import get_cross_block_indices, hybrid_rwkv_forward, init_cross_block_params

    rc = cfg.rwkv
    L = rc.n_layer
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 34)
    cross = [init_cross_block_params(gen, rc, device) for _ in range(HYBRID_CROSS)]
    for blk in cross:
        for w in (blk["att"]["output"]["weight"], blk["ffn"]["c_proj"]["weight"]):
            w.add_(torch.randn(w.shape, generator=gen, device=device) * 1e-3)
    hyb = dict(params["rwkv"], cross_blocks=to_device(cross, device, torch.bfloat16))
    _, images = make_request(cfg, 2, 0, seed + 34, device)
    feats = encode_images(params, cfg, images)
    ids = torch.randint(10, 65000, (2, HYBRID_T), generator=gen, device=device)
    out, paths = {"cross_at": get_cross_block_indices(L, HYBRID_CROSS, HYBRID_INTERVAL),
                  "image_tokens": feats.shape[1]}, {}
    fwd = lambda t: hybrid_rwkv_forward(t, rc, embed(t, ids), feats, cross_layer_interval=HYBRID_INTERVAL)
    reset_launches()
    with torch.no_grad():
        logits, out["forward_ms"] = timed(lambda: fwd(hyb))
    paths["hybrid_forward"] = _launches()
    assert_launches("13d hybrid forward", paths["hybrid_forward"], want_only(wkv6_fwd=L))
    assert torch.isfinite(logits).all()
    del logits
    leaves = list(_leaves(hyb))
    for leaf in leaves:
        leaf.requires_grad_(True)

    def step():
        loss = _text_ce(fwd(hyb), ids)
        return loss, torch.autograd.grad(loss, leaves)

    reset_launches()
    (loss, grads), out["train_step_ms"] = timed(step)
    paths["hybrid_train"] = _launches()
    for leaf in leaves:
        leaf.requires_grad_(False)
    assert_launches("13d hybrid forward + backward", paths["hybrid_train"], want_only(wkv6_fwd_res=L, wkv6_bwd=L))
    assert all(torch.isfinite(g).all() for g in grads)
    out["loss"] = float(loss.detach())
    del grads
    log(f"  13d: {L} RWKV-6 blocks + {HYBRID_CROSS} cross blocks at {sorted(out['cross_at'])}, {feats.shape[1]} "
        f"image features, B=2 x {HYBRID_T}: forward {out['forward_ms']:.1f} ms; loss {out['loss']:.4f}, "
        f"forward + backward {out['train_step_ms']:.1f} ms")

    # the plain check: 2 noisy RWKV blocks, 2 noisy cross blocks at interval 2, one row, the card's features
    c = dataclasses.replace(rc, n_layer=PLAIN_LAYERS, compute_dtype="float32")
    lm = init_lm_params(gen, c, device)
    lm["cross_blocks"] = [init_cross_block_params(gen, c, device) for _ in range(2)]
    t32 = {"rwkv": noisy(lm, gen, dtype="float32")}
    f_s, ids_s = feats[:1].float(), ids[:1, :64]
    run = lambda t, dev: _text_ce(hybrid_rwkv_forward(t["rwkv"], c, embed(t["rwkv"], ids_s.to(dev)), f_s.to(dev),
                                                      cross_layer_interval=2), ids_s.to(dev))
    out["plain_check"] = hold_against_cpu(
        f"13d hybrid, {PLAIN_LAYERS} RWKV blocks + 2 cross blocks", run, t32,
        [("rwkv", "cross_blocks", 0, "att", "query", "weight"), ("rwkv", "cross_blocks", 1, "ffn", "c_fc", "weight"),
         ("rwkv", "blocks", 1, "att", "time_decay_w1"), ("rwkv", "head", "weight")], device)
    return out, paths


def run_adapter(cfg, params, seed: int, device):
    """13e: the v4 adapter (``AdapterConfig()``: 32 queries, 256 features, 2
    blocks) behind phase 11's RWKV-4 World 1.5B (x040) and its CLIP-L/14
    @336 + linear projector: B = ``ADAPTER_B`` images, ``ADAPTER_CAPTION``
    -token captions of seeded lengths; the ITC + ITM + LM losses and their
    gradients to every adapter leaf (K17 once an LM block forward, K18 once
    backward), no LM weight taking one; then the adapter's gradients against
    the plain path on the CPU at ``PLAIN_LAYERS`` LM layers."""
    import torch

    from visualrwkv_torch.models.lm import init_lm_params
    from visualrwkv_torch.models.visualrwkv import encode_images
    from visualrwkv_torch.multimodal.adapter_v4 import AdapterConfig, adapter_pretrain_losses, init_adapter_params

    rc = cfg.rwkv
    L = rc.n_layer
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 35)
    _, images = make_request(cfg, ADAPTER_B, 0, seed + 35, device)
    feats = encode_images(params, cfg, images)
    adapter = init_adapter_params(gen, rc, AdapterConfig(), device)
    ids = torch.randint(10, 65000, (ADAPTER_B, ADAPTER_CAPTION), generator=gen, device=device)
    lengths = torch.randint(1, ADAPTER_CAPTION + 1, (ADAPTER_B,), generator=gen, device=device)
    mask = torch.arange(ADAPTER_CAPTION, device=device)[None, :] < lengths[:, None]
    ids = torch.where(mask, ids, 0)
    a_leaves, lm_leaves = list(_leaves(adapter)), list(_leaves(params["rwkv"]))
    for leaf in a_leaves + lm_leaves:  # the LM's marked too: none may take a gradient
        leaf.requires_grad_(True)

    def step():
        total, parts = adapter_pretrain_losses(adapter, params["rwkv"], rc, feats, ids, mask)
        return total, parts, torch.autograd.grad(total, a_leaves + lm_leaves, allow_unused=True)

    out = {"image_tokens": feats.shape[1]}
    reset_launches()
    (total, parts, grads), out["train_step_ms"] = timed(step)
    launches = _launches()
    for leaf in a_leaves + lm_leaves:
        leaf.requires_grad_(False)
    assert_launches("13e adapter losses + backward", launches, want_only(wkv4_fwd=L, wkv4_bwd=L))
    assert all(g is None for g in grads[len(a_leaves):]), "an LM weight took a gradient"
    got = [g for g in grads[:len(a_leaves)] if g is not None]
    assert len(got) == len(a_leaves) - 1 and all(torch.isfinite(g).all() for g in got)  # the ITM bias is not added
    out.update(loss=float(total.detach()), **{k: float(v.detach()) for k, v in parts.items()})
    log(f"  13e: adapter over {feats.shape[1]} CLIP features, B={ADAPTER_B}, {ADAPTER_CAPTION}-token captions: "
        f"loss {out['loss']:.4f} (itc {out['loss_itc']:.4f}, itm {out['loss_itm']:.4f}, lm {out['loss_lm']:.4f}), "
        f"forward + backward {out['train_step_ms']:.1f} ms; {len(got)} adapter leaves took gradients, no LM weight")
    del grads, got

    # the plain check: 2 noisy x040 blocks, a noisy adapter (its temperature kept), 2 rows, the card's features
    c = dataclasses.replace(rc, n_layer=PLAIN_LAYERS, compute_dtype="float32")
    t32 = {"rwkv": noisy(init_lm_params(gen, c, device), gen, dtype="float32"),
           "adapter": noisy(adapter, gen, dtype="float32")}
    t32["adapter"]["temperature"].fill_(AdapterConfig.temperature_init)
    f_s, ids_s, m_s = feats[:2].float(), ids[:2], mask[:2]
    run = lambda t, dev: adapter_pretrain_losses(t["adapter"], t["rwkv"], c, f_s.to(dev), ids_s.to(dev),
                                                 m_s.to(dev))[0]
    out["plain_check"] = hold_against_cpu(
        f"13e adapter, x040 LM cut to {PLAIN_LAYERS} layers", run, t32,
        [("adapter", "task_embs"), ("adapter", "blocks", 0, "att", "query", "weight"),
         ("adapter", "blocks", 1, "ffn", "c_proj", "weight"), ("adapter", "ln_vision", "weight"),
         ("adapter", "vision_proj", "weight"), ("adapter", "text_proj", "weight"),
         ("adapter", "itm_head", "weight"), ("adapter", "temperature")], device)
    return out, {"adapter_train": launches}


# ---------------------------------------------------------------------------
# phase 14: the evaluation suite on phase 3's model
# ---------------------------------------------------------------------------


EVAL_QUESTIONS = 8
EVAL_BATCHES = (1, 4)
EVAL_BUCKET = 64  # one length bucket holds every question of the phase
EVAL_TEXTS = ("What is in the image?", "Describe this image in detail.", "What color is the object?",
              "How many people are there?", "Is there a dog in the picture?", "What is written on the sign?",
              "Where was this photo taken?", "What is the man holding in his hand?")
RANK_CANDIDATES = ("cat", "dog", "a red bird", "two small fish", "green car")
RANK_K = 3
PPL_TOKENS = 2100  # about: the text's words are seeded, its tokens counted after encoding
PPL_STRIDE = 1024
PPL_WORDS = ("the", "cat", "sat", "on", "a", "mat", "and", "then", "ran", "to", "house", "river", "under",
             "bright", "sky", "with", "two", "small", "dogs", "near", "old", "tree", "while", "birds", "sang")
# the fp32 holds of phase 14 against the CPU's plain path (b, c): relative
EVAL_PLAIN_TOL = 1e-4


def eval_questions(cfg, tok, seed: int):
    """Phase 14's questions, written in memory: one image each (uint8 arrays
    a tower from the seed), prompts of one length bucket. Returns (lines,
    prompts, ids [N, T], images by tower [N, S, S, 3])."""
    import numpy as np

    from visualrwkv_torch.evals.runner import bucket_pad_ids, prepare_question, tower_image_sizes

    rng = np.random.default_rng(seed)
    lines = [{"question_id": i, "image": f"q{i}.jpg", "text": "<image>\n" + EVAL_TEXTS[i % len(EVAL_TEXTS)]}
             for i in range(EVAL_QUESTIONS)]
    items = [prepare_question(line, tok, cfg, 1) for line in lines]
    ids = [bucket_pad_ids(it["input_ids"], EVAL_BUCKET) for it in items]
    assert len({x.shape[-1] for x in ids}) == 1, [x.shape for x in ids]
    images = {t: rng.integers(0, 256, (EVAL_QUESTIONS, s, s, 3), dtype=np.uint8)
              for t, s in tower_image_sizes(cfg).items()}
    return lines, [it["input_text"] for it in items], np.stack(ids), images


def _eval_run(eng, tok, qs, B: int):
    """Every question through ``eval_batch`` B at a time: (records, ids,
    lengths, per-batch ms)."""
    import numpy as np

    from visualrwkv_torch.evals.runner import eval_batch

    lines, prompts, ids, images = qs
    recs, toks, lens, ms = [], [], [], []
    for s in range(0, len(lines), B):
        imgs = None if images is None else {t: v[s:s + B] for t, v in images.items()}
        (r, res), t = timed(lambda: eval_batch(eng, tok, ids[s:s + B], imgs, lines[s:s + B], prompts[s:s + B],
                                                max_new_tokens=NEW_TOKENS))
        recs += r
        toks.append(res.tokens)
        lens.append(res.lengths)
        ms.append(t)
    return recs, np.concatenate(toks), np.concatenate(lens), ms


def _check_records(recs, lines):
    import math

    keys = {"question_id", "prompt", "text", "avg_logit", "avg_prob", "model_id", "metadata"}
    assert [r["question_id"] for r in recs] == [q["question_id"] for q in lines]
    for r in recs:
        assert set(r) == keys, sorted(r)
        assert math.isfinite(float(r["avg_logit"])) and 0.0 <= float(r["avg_prob"]) <= 1.0, r


def run_eval_runner(cfg, params, device, seed: int, layout: str = "head", head_ids=None):
    """14(a), and (d) with ``layout="flat"``: the runner's per-batch step
    ``evals.runner.eval_batch`` over phase 14's questions at each of
    ``EVAL_BATCHES``, greedy, ``NEW_TOKENS`` tokens: the records in the
    reference's schema with finite averages, each batch's ids equal to a
    direct ``engine.generate`` on it (head layout) or to the head layout's
    (flat), and each batch size's launches (prefill, encode and decode
    steps a batch; K4 in K2's place on the flat state). Logs questions/s
    and decode tok/s (the batch's time less a prefill of it, timed alone)."""
    import numpy as np

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.data.tokenizer import get_tokenizer
    from visualrwkv_torch.infer.engine import InferenceEngine

    tok = get_tokenizer()
    qs = eval_questions(cfg, tok, seed + 140)
    lines, _, ids, images = qs
    eng = InferenceEngine(params, cfg, state_layout=layout, device=device)
    eng.generate(ids[:1], {t: v[:1] for t, v in images.items()}, max_new_tokens=2)  # warm-up
    out, launches, all_ids = {}, {}, {}
    for B in EVAL_BATCHES:
        reset_launches()
        recs, toks, lens, ms = _eval_run(eng, tok, qs, B)
        launches[B] = dict(cuda_build.LAUNCHES)
        n_batch = len(lines) // B
        steps = dict(flat_decode_steps=NEW_TOKENS * n_batch) if layout == "flat" \
            else dict(decode_steps=NEW_TOKENS * n_batch)
        assert_launches(f"14{'d' if layout == 'flat' else 'a'} runner, {layout} state, B={B}", launches[B],
                        expected_launches(cfg, prefills=n_batch, encodes=n_batch, **steps))
        _check_records(recs, lines)
        all_ids[B] = (toks, lens)
        if layout == "head":
            for s in range(0, len(lines), B):
                ref = eng.generate(ids[s:s + B], {t: v[s:s + B] for t, v in images.items()},
                                   max_new_tokens=NEW_TOKENS, do_sample=False, stop_tokens=(0, 261))
                assert np.array_equal(ref.tokens, toks[s:s + B]) and np.array_equal(ref.lengths, lens[s:s + B]), \
                    f"14(a) B={B}: eval_batch's ids differ from generate()'s on the same batch"
        else:
            assert np.array_equal(toks, head_ids[B][0]), f"14(d) B={B}: flat-state ids differ from the head layout's"
        prefill_ms = sorted(timed(lambda: eng.prefill_ids(ids[:B], {t: v[:B] for t, v in images.items()}))[1]
                            for _ in range(3))[1]
        total_s = sum(ms) / 1e3
        per_q = {k: v / len(lines) for k, v in launches[B].items() if v}
        out[B] = {"batch_ms": ms, "questions_per_s": len(lines) / total_s, "prefill_ms": prefill_ms,
                  "decode_tok_per_s": B * NEW_TOKENS / ((np.median(ms) - prefill_ms) / 1e3),
                  "launches_per_question": per_q, "first_text": recs[0]["text"][:40],
                  "mean_avg_prob": float(np.mean([float(r["avg_prob"]) for r in recs]))}
        log(f"  14{'d' if layout == 'flat' else 'a'} {layout} state, eval_batch={B}: {len(lines)} questions in "
            f"{total_s:.2f} s ({out[B]['questions_per_s']:.2f} questions/s), median batch "
            f"{np.median(ms):.1f} ms, prefill alone {prefill_ms:.1f} ms, decode "
            f"{out[B]['decode_tok_per_s']:.1f} tok/s; launches a question {per_q}"
            + ("; ids equal to generate()'s" if layout == "head" else "; ids equal to the head layout's"))
    return out, launches, all_ids


def fp32_lm(cfg, params, n_layer: int, seed: int, device):
    """An LM of the model's width with ``n_layer`` fresh noisy blocks
    (:func:`noisy_lm`: at its random init a block adds nothing to the
    stream, so its kernels would not show), in fp32 and without towers
    (they take bf16 only: K3), on ``device``."""
    import torch

    from visualrwkv_torch.config import VisionConfig

    c, p = noisy_lm(cfg, params, n_layer, seed, device)
    c = c.replace(rwkv=dataclasses.replace(c.rwkv, compute_dtype="float32"), vision=VisionConfig(towers=()))
    return c, {"rwkv": to_device(p["rwkv"], device, torch.float32)}


def check_eval_batched_fp32(cfg, params, device, seed: int):
    """14(a)'s hold: ``SPEC_FP32_LAYERS`` noisy LM layers in fp32 (:func:`fp32_lm`),
    phase 14's questions as text of their length (no towers), through
    ``eval_batch`` at each batch size: equal ids."""
    import numpy as np

    from visualrwkv_torch.data.tokenizer import get_tokenizer
    from visualrwkv_torch.infer.engine import InferenceEngine

    c, p = fp32_lm(cfg, params, SPEC_FP32_LAYERS, seed + 145, device)
    tok = get_tokenizer()
    lines, prompts, ids, _ = eval_questions(cfg, tok, seed + 140)
    text = text_ids(len(lines), ids.shape[1], seed + 141, device).cpu().numpy()
    eng = InferenceEngine(p, c, device=device)
    runs = {B: _eval_run(eng, tok, (lines, prompts, text, None), B) for B in EVAL_BATCHES}
    (_, t1, l1, _), (_, t4, l4, _) = runs[EVAL_BATCHES[0]], runs[EVAL_BATCHES[1]]
    equal = bool(np.array_equal(t1, t4) and np.array_equal(l1, l4))
    log(f"  14(a) noisy LM {SPEC_FP32_LAYERS} layers fp32, text prompts of {ids.shape[1]} tokens: eval_batch={EVAL_BATCHES[1]} "
        f"ids equal to eval_batch={EVAL_BATCHES[0]}'s: {equal}")
    assert equal, "14(a): batched ids differ from single ones in fp32"
    return equal


def _rel(x, ref):
    return abs(x - ref) / abs(ref)


def run_rank(cfg, params, device, seed: int):
    """14(b): ``rank_candidates`` on one image question with
    ``RANK_CANDIDATES``, k = ``RANK_K``, on the full model (timed, its
    launches: one prefill and encode, then K2 ``max_len`` x n_layer at B = k);
    then at ``PLAIN_LAYERS`` LM layers in fp32 on a text prompt, the card
    against the plain path on the CPU: first-token probabilities and CEs
    within ``EVAL_PLAIN_TOL`` relative, the same best candidate."""
    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.data.tokenizer import get_tokenizer
    from visualrwkv_torch.evals.rank import normalize_candidates, rank_candidates
    from visualrwkv_torch.infer.engine import InferenceEngine

    tok = get_tokenizer()
    lines, _, ids, images = eval_questions(cfg, tok, seed + 142)
    ids, images = ids[:1], {t: v[:1] for t, v in images.items()}
    eng = InferenceEngine(params, cfg, device=device)
    rank_candidates(eng, tok, ids, images, RANK_CANDIDATES, k=RANK_K)  # warm-up
    reset_launches()
    (best, ranked), ms = timed(lambda: rank_candidates(eng, tok, ids, images, RANK_CANDIDATES, k=RANK_K))
    launches = dict(cuda_build.LAUNCHES)
    max_len = max(len(tok.encode(c)) for c in normalize_candidates(RANK_CANDIDATES))
    want = expected_launches(cfg, prefills=1, encodes=1, decode_steps=max_len)
    assert_launches(f"14b rank, k={RANK_K}", launches, want)
    prefill_ms = sorted(timed(lambda: eng.prefill_ids(ids, images))[1] for _ in range(3))[1]
    log(f"  14(b) rank_candidates, {len(RANK_CANDIDATES)} candidates, k={RANK_K}, longest {max_len} tokens: "
        f"{ms:.1f} ms (the prefill alone {prefill_ms:.1f} ms); best {best!r}; K2 {launches.get('wkv7_step', 0)} launches "
        f"at B={RANK_K}; " + ", ".join(f"{c!r} p={p:.3e} ce={ce:.3f}" for c, p, ce in ranked))
    c, p = fp32_lm(cfg, params, PLAIN_LAYERS, seed + 146, device)
    prompt = text_ids(1, 64, seed + 143, device)
    got = rank_candidates(InferenceEngine(p, c, device=device), tok, prompt, None, RANK_CANDIDATES, k=RANK_K)
    ref = rank_candidates(InferenceEngine(to_device(p, "cpu"), c, device="cpu"), tok, prompt.cpu(), None,
                          RANK_CANDIDATES, k=RANK_K)
    errs = [max(_rel(a[1], b[1]), _rel(a[2], b[2])) for a, b in zip(got[1], ref[1])]
    log(f"  14(b) noisy LM {PLAIN_LAYERS} layers fp32, 64-token text prompt: card vs plain (CPU) first_prob / ce "
        f"max rel {max(errs):.3e} (tol {EVAL_PLAIN_TOL:g}); best {got[0]!r} and {ref[0]!r}")
    assert got[0] == ref[0] and [a[0] for a in got[1]] == [b[0] for b in ref[1]], (got, ref)
    assert max(errs) <= EVAL_PLAIN_TOL, (got, ref)
    return {"ms": ms, "prefill_ms": prefill_ms, "max_len": max_len, "best": best,
            "ranked": [list(r) for r in ranked], "plain_max_rel": max(errs)}, launches


def ppl_text(seed: int) -> str:
    import numpy as np

    rng = np.random.default_rng(seed)
    return " ".join(PPL_WORDS[i] for i in rng.integers(0, len(PPL_WORDS), PPL_TOKENS))


def run_text_evals(cfg, params, device, seed: int):
    """14(c): ``perplexity`` of a seeded text of about ``PPL_TOKENS`` tokens
    at ``PPL_STRIDE`` (the last window ragged) and one
    ``RWKVLoglikelihood.loglikelihood`` on the full LM, each one stateless
    prefill (K1 a layer) a window; then at ``PLAIN_LAYERS`` LM layers in
    fp32, both within ``EVAL_PLAIN_TOL`` relative of the plain path on the
    CPU."""
    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.data.tokenizer import get_tokenizer
    from visualrwkv_torch.evals.lm_harness import RWKVLoglikelihood, perplexity

    tok = get_tokenizer()
    text = ppl_text(seed + 144)
    n_tok = len(tok.encode(text)) + 1
    windows = -(-(n_tok - 1) // PPL_STRIDE)
    assert (n_tok - 1) % PPL_STRIDE, "the last window must be ragged"
    ctx, cont = "The capital of France is", " Paris, a city on the river Seine."
    lm_p = params["rwkv"]
    perplexity(lm_p, cfg.rwkv, tok, text[:200], stride=PPL_STRIDE)  # warm-up
    reset_launches()
    ppl, ms = timed(lambda: perplexity(lm_p, cfg.rwkv, tok, text, stride=PPL_STRIDE))
    launches = {"perplexity": dict(cuda_build.LAUNCHES)}
    assert_launches("14c perplexity", launches["perplexity"], expected_launches(cfg, prefills=windows))
    scorer = RWKVLoglikelihood(lm_p, cfg.rwkv, tok)
    reset_launches()
    (ll, greedy), ll_ms = timed(lambda: scorer.loglikelihood(ctx, cont))
    launches["loglikelihood"] = dict(cuda_build.LAUNCHES)
    assert_launches("14c loglikelihood", launches["loglikelihood"], expected_launches(cfg, prefills=1))
    log(f"  14(c) perplexity over {n_tok} tokens at stride {PPL_STRIDE} ({windows} windows, the last "
        f"{(n_tok - 1) % PPL_STRIDE}): {ppl:.2f} in {ms:.1f} ms ({(n_tok - 1) / (ms / 1e3):.0f} tok/s), K1 "
        f"{launches['perplexity'].get('wkv7_fwd', 0)} launches; loglikelihood {ll:.3f} (greedy {greedy}) in {ll_ms:.1f} ms")
    c, p = fp32_lm(cfg, params, PLAIN_LAYERS, seed + 146, device)
    p_cpu = to_device(p["rwkv"], "cpu")
    got = (perplexity(p["rwkv"], c.rwkv, tok, text, stride=PPL_STRIDE),
           RWKVLoglikelihood(p["rwkv"], c.rwkv, tok).loglikelihood(ctx, cont))
    ref = (perplexity(p_cpu, c.rwkv, tok, text, stride=PPL_STRIDE),
           RWKVLoglikelihood(p_cpu, c.rwkv, tok).loglikelihood(ctx, cont))
    errs = (_rel(got[0], ref[0]), _rel(got[1][0], ref[1][0]))
    log(f"  14(c) noisy LM {PLAIN_LAYERS} layers fp32: card vs plain (CPU) perplexity {got[0]:.4f} / {ref[0]:.4f} "
        f"(rel {errs[0]:.3e}), loglikelihood {got[1][0]:.5f} / {ref[1][0]:.5f} (rel {errs[1]:.3e}), tol "
        f"{EVAL_PLAIN_TOL:g}; greedy flags {got[1][1]} / {ref[1][1]}")
    assert max(errs) <= EVAL_PLAIN_TOL and got[1][1] == ref[1][1], (got, ref)
    return {"tokens": n_tok, "windows": windows, "perplexity": ppl, "ms": ms,
            "tok_per_s": (n_tok - 1) / (ms / 1e3), "loglikelihood": ll, "loglikelihood_ms": ll_ms,
            "plain_rel": list(errs)}, launches


def run_evals(cfg, params, device, seed: int):
    """Phase 14, (a) to (d), on phase 3's model. Returns (numbers, launches by path, seconds by part)."""
    out, by_path, secs = {}, {}, {}
    t = time.perf_counter()
    out["14a"], runner_launches, head_ids = run_eval_runner(cfg, params, device, seed)
    out["14a"]["fp32_batched_equal"] = check_eval_batched_fp32(cfg, params, device, seed)
    by_path.update({f"eval_runner B={B}": v for B, v in runner_launches.items()})
    secs["14a"] = time.perf_counter() - t
    t = time.perf_counter()
    out["14b"], by_path["eval_rank"] = run_rank(cfg, params, device, seed)
    secs["14b"] = time.perf_counter() - t
    t = time.perf_counter()
    out["14c"], text_launches = run_text_evals(cfg, params, device, seed)
    by_path.update({f"eval_{k}": v for k, v in text_launches.items()})
    secs["14c"] = time.perf_counter() - t
    t = time.perf_counter()
    out["14d"], flat_launches, _ = run_eval_runner(cfg, params, device, seed, layout="flat", head_ids=head_ids)
    by_path.update({f"eval_runner_flat B={B}": v for B, v in flat_launches.items()})
    secs["14d"] = time.perf_counter() - t
    out["seconds"] = secs
    log(f"  phase 14 took {sum(secs.values()):.1f} s: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return out, by_path


# Phase 15: the tooling on the card. (a) the kernel bench at the JAX bench's
# default shapes; its CUDA rows are held to phase 2's limits for the same
# kernels: y 1e-2 (bf16 streams), the final state 1e-3, the gradients of
# fp32 streams 1e-3.
KBENCH_ARGV = ("all", "--B", "8", "--T", "512")
KBENCH_Y_TOL, KBENCH_S_TOL, KBENCH_GRAD_TOL = 1e-2, 1e-3, 1e-3
# (b) Trainer.run_epoch steps; (c) the memory holders printed at the peak.
TOOLING_STEPS = 2
MEMORY_TOP = 10
# 15(c) records every allocation from the model's build on; the trace must
# hold them all (a replay of a trace that wrapped would miss live blocks).
MEMORY_MAX_ENTRIES = 2_000_000


def run_kernel_bench(device):
    """Phase 15(a): ``kernel_bench.main`` on the card. Every CUDA row (K1,
    K7, and the dispatch gradients: K5 + K6, K8 + K9) within the limits of
    phase 2; a failed CUDA row exits the bench non-zero, and so this run."""
    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.ops import kernel_bench

    reset_launches()
    rows = kernel_bench.main(list(KBENCH_ARGV))
    launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    checked = 0
    for r in rows:
        assert "error" not in r or r["impl"] not in ("cuda", "dispatch grads"), r
        if r["impl"] == "cuda":
            assert r["y_err"] <= KBENCH_Y_TOL and r["s_err"] <= KBENCH_S_TOL, r
            checked += 1
        elif r["impl"] == "dispatch grads":
            assert all(e <= KBENCH_GRAD_TOL for e in r["grad_err"].values()), r
            checked += 1
    assert checked == 4, rows
    log(f"  kernel bench: CUDA rows within y {KBENCH_Y_TOL:g}, state {KBENCH_S_TOL:g}, gradients "
        f"{KBENCH_GRAD_TOL:g}; launches {launches}")
    for name in ("wkv7_fwd", "wkv7_fwd_res", "wkv7_bwd", "wkv6_fwd", "wkv6_fwd_res", "wkv6_bwd"):
        assert launches.get(name, 0) > 0, (name, launches)
    return {"rows": rows}, launches


def _memory_holders(snapshot, device_index: int, top: int):
    """Replays the allocator's trace (every allocation since the recording
    began) and returns the peak of live bytes, the number of events, and
    the live blocks at that peak grouped by the innermost frame inside
    ``visualrwkv_torch/`` (else the innermost frame of this script), the
    ``top`` largest first."""
    trace = snapshot["device_traces"][device_index]
    live, total, peak, at_peak = {}, 0, 0, {}
    for e in trace:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], e.get("frames", []))
            total += e["size"]
            if total > peak:
                peak, at_peak = total, dict(live)
        elif e["action"] in ("free_requested", "free_completed") and e["addr"] in live:
            total -= live.pop(e["addr"])[0]

    def site(frames):
        for want in ("visualrwkv_torch" + os.sep, os.path.basename(__file__)):
            for f in frames:
                if want in f["filename"]:
                    path = f["filename"]
                    path = path[path.index("visualrwkv_torch"):] if "visualrwkv_torch" in path else os.path.basename(path)
                    return f"{path}:{f['line']} {f['name']}"
        return "(no frame of the port or this script)"

    holders = {}
    for size, frames in at_peak.values():
        h = holders.setdefault(site(frames), [0, 0])
        h[0] += size
        h[1] += 1
    ranked = sorted(holders.items(), key=lambda kv: -kv[1][0])
    return peak, len(trace), [{"site": s, "gb": b / 1e9, "blocks": n} for s, (b, n) in ranked[:top]]


def run_tooling_training(cfg, seed: int, device):
    """Phase 15(b) and (c) on the 1B5 rebuilt from its seed, with the CUDA
    allocator recording every allocation from the build on (Python
    stacks). (b) ``Trainer.run_epoch`` for ``TOOLING_STEPS`` steps, its
    ``train_log.txt`` under ``chiprun_out/`` read back (the header, the
    configuration line, one epoch line whose loss is the last logged one),
    ``device_memory()``'s peaks, and one more step under ``profile_trace``
    (its Chrome trace, written under ``build/``, names K5's and K6's
    launches). (c) the peak of those steps by allocation site, from the
    allocator's trace, beside the reckoning of phase 4."""
    import shutil

    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.train.trainer import Trainer
    from visualrwkv_torch.utils.observability import device_memory, profile_trace

    proj_dir = os.path.join(HERE, "chiprun_out", "phase15_train")
    trace_dir = os.path.join(HERE, "build", "phase15_trace")
    for d in (proj_dir, trace_dir):
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(context="alloc", stacks="python", max_entries=MEMORY_MAX_ENTRIES)
    try:
        params = init_model(cfg, seed, device)
        tcfg = train_cfg(TOOLING_STEPS)
        trainer = Trainer(cfg, tcfg, params, device=device, proj_dir=proj_dir, log_every=1)
        batches = [train_batch(cfg, TRAIN_MICRO_BSZ, TRAIN_CTX, seed + 100 + i) for i in range(TOOLING_STEPS + 1)]
        reset_launches()
        t0 = time.perf_counter()
        last = trainer.run_epoch(lambda s: batches[s], epoch=0)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
        assert_launches("Trainer.run_epoch", launches, expected_launches(
            cfg, encodes=TOOLING_STEPS, train_micro_batches=TOOLING_STEPS))
        lines = open(os.path.join(proj_dir, "train_log.txt")).read().splitlines()
        fields = lines[2].split() if len(lines) == 3 else []
        log(f"  train_log.txt: {lines[0]!r}, a configuration line of {len(lines[1])} characters, {lines[2:]!r}")
        assert lines[0].startswith("NEW RUN ") and json.loads(lines[1])["train"]["epoch_steps"] == TOOLING_STEPS
        assert fields[0] == "0" and fields[1] == f"{trainer.history[-1]['loss']:.6f}" == f"{last:.6f}", lines
        mem = device_memory()
        log(f"  device_memory(): allocated peak {mem['allocated_bytes.all.peak'] / 1e9:.3f} GB, reserved peak "
            f"{mem['reserved_bytes.all.peak'] / 1e9:.3f} GB, {len(mem)} byte counters; {TOOLING_STEPS} steps in "
            f"{epoch_s:.1f} s under memory recording")

        with profile_trace(trace_dir):
            trainer.train_step(batches[-1])
            torch.cuda.synchronize()
        (trace,) = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir) if f.endswith(".json")]
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        named = {k: sum(k in n for n in kernels) for k in ("wkv7_fwd_res_kernel", "wkv7_bwd_state_kernel",
                                                           "wkv7_bwd_chunk_kernel")}
        log(f"  profile_trace: {os.path.getsize(trace) / 1e6:.1f} MB Chrome trace, {len(kernels)} kernel events, "
            f"K5 / K6 launches named: {named}")
        assert all(named.values()), named
        shutil.rmtree(trace_dir)

        torch.cuda.synchronize()
        snapshot = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    allocator_peak = torch.cuda.max_memory_allocated() - base_bytes
    peak, n_events, top = _memory_holders(snapshot, torch.cuda.current_device(), MEMORY_TOP)
    del snapshot
    assert n_events < MEMORY_MAX_ENTRIES, f"the allocator's trace wrapped at {n_events} events"
    reckoned = reckon_train_memory(cfg, tcfg, trainer.params, trainer.leaves)
    log(f"  memory at the peak of the steps: {peak / 1e9:.3f} GB live by the replay of {n_events} events "
        f"(the allocator's own peak {allocator_peak / 1e9:.3f} GB above the {base_bytes / 1e9:.3f} GB held "
        f"before the build; reckoned {reckoned['sum']:.2f} GB before activations and temporaries); the "
        f"{MEMORY_TOP} largest holders by allocation site:")
    for h in top:
        log(f"    {h['gb']:8.3f} GB in {h['blocks']:5d} blocks  {h['site']}")
    del trainer, params, batches
    torch.cuda.empty_cache()
    return {"train_log": lines[2:], "loss": last, "epoch_s_recording": epoch_s,
            "allocated_peak_bytes": mem["allocated_bytes.all.peak"],
            "reserved_peak_bytes": mem["reserved_bytes.all.peak"], "profile_kernels_named": named,
            "memory_peak_gb": peak / 1e9, "allocator_peak_gb": allocator_peak / 1e9, "trace_events": n_events,
            "reckoned_gb": reckoned, "top_holders": top}, launches


def run_tooling(cfg, seed: int, device):
    """Phase 15, (a) to (c). Returns (numbers, launches by path)."""
    out, by_path, secs = {}, {}, {}
    t = time.perf_counter()
    out["15a"], by_path["kernel_bench"] = run_kernel_bench(device)
    secs["15a"] = time.perf_counter() - t
    t = time.perf_counter()
    out["15bc"], by_path["tooling_run_epoch"] = run_tooling_training(cfg, seed, device)
    secs["15bc"] = time.perf_counter() - t
    out["seconds"] = secs
    log(f"  phase 15 took {sum(secs.values()):.1f} s: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return out, by_path


# ---------------------------------------------------------------------------
# phase 16: multi-GPU training (process groups, ZeRO, context parallelism)
# ---------------------------------------------------------------------------

PHASE16_STEPS = 2
# the ring composed on one card (the exchanges of its ranks done in place):
# fp32 streams at the training shape, against the whole sequence; 16 shards
# of 128 steps, so that a shard's entry state still carries its initial
# state (over 1024 steps the transition R underflows to 0)
RING_SHARDS = 16
RING_TOL = 1e-4
# training_loss_seq on a seq group of one against training_loss: the same
# kernels on the same inputs, so equal is expected; held at these limits
SEQ1_LOSS_TOL = 1e-6
SEQ1_GRAD_TOL = 1e-3


def nccl_group(device):
    """This process as rank 0 of a one-rank NCCL group (tcp rendezvous on a
    free localhost port): the path of ``train/cli.py`` under torchrun on one
    card."""
    import socket

    import torch.distributed as dist

    from visualrwkv_torch.parallel import distributed

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert distributed.initialize(coordinator_address=f"localhost:{port}", num_processes=1, process_id=0,
                                  device=device)
    assert dist.get_backend() == "nccl", dist.get_backend()


def _clone(tree):
    import torch

    from visualrwkv_torch.train.optim import tree_map

    with torch.no_grad():
        return tree_map(lambda t: t.clone(), tree)


def _mesh_steps(cfg, params, device, seed: int, zero_stage: int, mesh):
    """``PHASE16_STEPS`` steps of a ``Trainer`` (on ``mesh``, or plain when
    None) on phase 4's batches from a copy of ``params``: (losses, step ms,
    the parameters after them, launches, peak GiB above what was held
    before the ``Trainer``: the model and the earlier runs' parameters)."""
    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.train.trainer import Trainer

    tcfg = dataclasses.replace(train_cfg(PHASE16_STEPS), zero_stage=zero_stage)
    held = torch.cuda.memory_allocated()
    trainer = Trainer(cfg, tcfg, _clone(params), device=device, proj_dir=TRAIN_LOG_DIR, log_every=1, mesh=mesh)
    batches = [train_batch(cfg, TRAIN_MICRO_BSZ, TRAIN_CTX, seed + 100 + i) for i in range(PHASE16_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, ms = [], []
    for b in batches:
        loss, t = timed(lambda: float(trainer.train_step(b)))
        losses.append(loss)
        ms.append(t)
    launches = dict(cuda_build.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30  # above what the phase held before
    final = trainer.full_params()
    del trainer
    torch.cuda.empty_cache()
    return losses, ms, final, launches, peak


def _ring_on_one_card(family: str, xs, extra, s0, group_size: int):
    """The context-parallel ring of ``ops/wkv_sp.py`` for ``group_size``
    ranks on one card: the shards stacked along B, so that the port's own
    ``_ring_entry_states`` runs every shard at once from zero and from the
    identity (K5 / K8 through the dispatcher), relaxes the entry states in
    its ``group_size - 1`` sweeps with a roll over the shards in place of the
    ring's ``ppermute``, and the shards run again from their entry states.
    Returns y and the final state (the last shard's), differentiable through
    every run (the identity runs get a cotangent through ``s0 @ R``)."""
    import torch

    from visualrwkv_torch.ops.wkv6 import wkv6
    from visualrwkv_torch.ops.wkv7 import wkv7
    from visualrwkv_torch.ops.wkv_sp import _ring_entry_states

    D = group_size
    B, T, H, N = xs[0].shape
    # [B, T, ...] -> [D * B, T / D, ...], shard-major
    stacked = [x.reshape(B, D, T // D, *x.shape[2:]).transpose(0, 1).reshape(D * B, T // D, *x.shape[2:])
               for x in xs]
    if family == "x070":
        call = lambda S_in: wkv7(*stacked, initial_state=S_in)
    else:
        call = lambda S_in: wkv6(*stacked, *extra, initial_state=S_in)
    z0 = torch.cat([s0.float(), s0.new_zeros((D - 1) * B, H, N, N, dtype=torch.float32)])
    is_first = (torch.arange(D * B, device=s0.device) < B).view(-1, 1, 1, 1)
    roll = lambda S: S.view(D, B, H, N, N).roll(1, 0).view(D * B, H, N, N)
    y, s = call(_ring_entry_states(call, z0, D, is_first, roll))
    return y.reshape(D, B, T // D, H, N).transpose(0, 1).reshape(B, T, H, N), s[-B:]


def check_ring_one_card(family: str, gen, device):
    """16(a): the ring's arithmetic with its identity-state runs on the card,
    fp32 streams at the training shape (B=2, T=2048, H=32) from an initial
    state, against the whole sequence through the same dispatcher: y, the
    final state and the gradients of sum(y * cy) + sum(s * cs) with respect
    to the streams and the initial state (through the identity and zero
    runs' final-state cotangents and the entry states' gradients) within
    ``RING_TOL`` relative rms. Returns (numbers, launches)."""
    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.ops.wkv6 import wkv6
    from visualrwkv_torch.ops.wkv7 import wkv7

    shape = (2, TRAIN_CTX, 32, 64)
    if family == "x070":
        xs, extra = _wkv_streams(gen, shape, torch.float32, device), ()
        whole = lambda *s, initial_state: wkv7(*s, initial_state=initial_state)
    else:
        xs, u = _wkv6_streams(gen, shape, torch.float32, device)
        extra = (u,)
        whole = lambda *s, initial_state: wkv6(*s, u, initial_state=initial_state)
    s0 = torch.randn(shape[0], shape[2], 64, 64, generator=gen, device=device) * 0.3
    xs = [x.requires_grad_(True) for x in xs + [s0]]
    cy = torch.randn(shape, generator=gen, device=device)
    cs = torch.randn(shape[0], shape[2], 64, 64, generator=gen, device=device)
    y, s = whole(*xs[:-1], initial_state=xs[-1])
    ref = torch.autograd.grad((y * cy).sum() + (s * cs).sum(), xs)
    reset_launches()
    (y_r, s_r), ms = timed(lambda: _ring_on_one_card(family, xs[:-1], extra, xs[-1], RING_SHARDS))
    grads = torch.autograd.grad((y_r * cy).sum() + (s_r * cs).sum(), xs)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    errs = {"y": rel_rms(y_r.detach(), y.detach()), "final state": rel_rms(s_r.detach(), s.detach())}
    errs.update({f"d{i}": rel_rms(g, g_ref) for i, (g, g_ref) in enumerate(zip(grads, ref))})
    log(f"  ring of {RING_SHARDS} shards on one card, {family}, fp32 streams {shape}: rel rms {errs} "
        f"(limit {RING_TOL}); forward {ms:.1f} ms; launches {launches}")
    assert max(errs.values()) < RING_TOL, errs
    fwd_res, bwd = WKV_KERNELS[family][2:]
    want = dict.fromkeys(REPLACES, 0)
    want[fwd_res] = want[bwd] = 3  # every shard at once from 0, from I and from its entry
    assert_launches(f"ring of {RING_SHARDS} shards, {family}", launches, want)
    return {"rel_rms": errs, "forward_ms": ms}, launches


def check_seq_loss_one_rank(cfg, params, device, seed: int, mesh, what: str):
    """16(a): ``training_loss_seq`` on a seq group of one rank (the ring of
    one shard: K5 / K8 from zero, from the identity and from the entry
    state, each again in the recompute of ``grad_cp``; the halos a copy)
    against ``training_loss`` on phase 4's batch: the loss within
    ``SEQ1_LOSS_TOL`` and each trainable leaf's gradient within
    ``SEQ1_GRAD_TOL`` relative rms (equal expected). Returns (numbers,
    launches of the seq loss and gradient)."""
    import torch

    from visualrwkv_torch import cuda_build
    from visualrwkv_torch.models.visualrwkv import _on_device, prepare_embeddings, training_loss, training_loss_seq
    from visualrwkv_torch.parallel.mesh import axis_group
    from visualrwkv_torch.train.trainer import Trainer, shift_labels

    trainer = Trainer(cfg, train_cfg(1), params, device=device, proj_dir=TRAIN_LOG_DIR, log_every=1)
    b = train_batch(cfg, TRAIN_MICRO_BSZ, TRAIN_CTX, seed + 100)
    ids, images = _on_device(b["input_ids"], b["images"], device)
    labels = torch.as_tensor(b["labels"], device=device)
    p = trainer.params

    def plain():
        loss = training_loss(p, cfg, ids, labels, images, grad_cp=True, ce_chunk_t=128, device=device)
        return loss, torch.autograd.grad(loss, trainer.leaves)

    def seq():
        emb = prepare_embeddings(p, cfg, ids, images)
        loss = training_loss_seq(p, cfg, None, shift_labels(labels), grad_cp=True, ce_chunk_t=128,
                                 seq_group=axis_group(mesh, "seq"), data_group=axis_group(mesh, "data"),
                                 embeds=emb, device=device)
        return loss, torch.autograd.grad(loss, trainer.leaves)

    for fn in (plain, seq):  # once each to warm up (the seq group's first collective makes its communicator)
        fn()
    (loss_p, g_p), plain_ms = timed(plain)
    reset_launches()
    (loss_s, g_s), seq_ms = timed(seq)
    launches = dict(cuda_build.LAUNCHES)
    loss_err = abs(float(loss_s) - float(loss_p)) / abs(float(loss_p))
    errs = [rel_rms(a, b_) for a, b_ in zip(g_s, g_p)]
    equal = float(loss_s) == float(loss_p) and all(torch.equal(a, b_) for a, b_ in zip(g_s, g_p))
    log(f"  {what}: training_loss_seq on one seq rank {float(loss_s):.6f} against training_loss "
        f"{float(loss_p):.6f} (rel {loss_err:.2e}, limit {SEQ1_LOSS_TOL}); gradients worst rel rms "
        f"{max(errs):.2e} over {len(errs)} leaves (limit {SEQ1_GRAD_TOL}); bit-equal: {equal}; loss + "
        f"gradients {seq_ms:.1f} ms against {plain_ms:.1f} ms")
    assert loss_err <= SEQ1_LOSS_TOL and max(errs) <= SEQ1_GRAD_TOL, (loss_err, max(errs))
    want = expected_launches(cfg, encodes=1, train_micro_batches=1)
    fwd_res, bwd = WKV_KERNELS[cfg.rwkv.version][2:]
    want[fwd_res] = 6 * cfg.rwkv.n_layer  # 3 runs a block, twice under grad_cp
    want[bwd] = cfg.rwkv.n_layer  # one shard: only the run from the entry state gets a cotangent
    assert_launches(f"{what} training_loss_seq", launches, want)
    del trainer, g_p, g_s
    torch.cuda.empty_cache()
    return {"loss": float(loss_s), "loss_rel_err": loss_err, "grad_rel_rms_max": max(errs),
            "bit_equal": equal, "seq_ms": seq_ms, "plain_ms": plain_ms}, launches


def run_multigpu(seed: int, device):
    """Phase 16(a): the multi-process training path on the one card, over a
    one-rank NCCL group. On the flagship 1B5 (phase 4's configuration and
    batches): ``PHASE16_STEPS`` steps of the plain ``Trainer``, then of
    ``Trainer(mesh=make_mesh(n_data=1))`` at ``zero_stage`` 1 and 3 from the
    same parameters, whose losses and parameters must equal the plain
    run's (the collectives of one rank copy; ZeRO's parts are whole leaves);
    ``training_loss_seq`` on one seq rank against ``training_loss``; the
    ring of ``RING_SHARDS`` shards on the card. Then the x060 1.6B of phase 6
    through ``wkv6_seq_shard`` the same way. Returns (numbers, launches by
    path)."""
    import torch

    from visualrwkv_torch.parallel.mesh import make_mesh

    nccl_group(device)
    out, by_path, secs = {}, {}, {}
    cfg = flagship_cfg()
    t = time.perf_counter()
    params = init_model(cfg, seed, device)
    mesh = make_mesh(n_data=1)
    runs = {"plain": _mesh_steps(cfg, params, device, seed, 1, None)}
    for zero in (1, 3):
        runs[f"zero{zero}"] = _mesh_steps(cfg, params, device, seed, zero, mesh)
    plain_losses, plain_ms, plain_final, plain_launches, plain_peak = runs["plain"]
    want = expected_launches(cfg, encodes=PHASE16_STEPS, train_micro_batches=PHASE16_STEPS)
    assert_launches("16(a) plain Trainer", plain_launches, want)
    out["trainer"] = {"plain": {"losses": plain_losses, "step_ms": plain_ms, "peak_gib": plain_peak}}
    for name in ("zero1", "zero3"):
        losses, ms, final, launches, peak = runs[name]
        assert_launches(f"16(a) Trainer(mesh=make_mesh(n_data=1)), {name}", launches, want)
        by_path[f"multigpu_{name}"] = launches
        equal_losses = losses == plain_losses
        diff = [max_abs(a, b) for a, b in zip(_leaves(final), _leaves(plain_final))]
        log(f"  {name}: losses {losses} (plain {plain_losses}), step ms {[f'{m:.1f}' for m in ms]} (plain "
            f"{[f'{m:.1f}' for m in plain_ms]}), peak {peak:.2f} GiB (plain {plain_peak:.2f}); parameters "
            f"after {PHASE16_STEPS} steps: max |delta| {max(diff):.3e} over {len(diff)} leaves")
        assert equal_losses and max(diff) == 0.0, f"{name} differs from the plain Trainer on one rank"
        out["trainer"][name] = {"losses": losses, "step_ms": ms, "peak_gib": peak, "bit_equal": True}
    del runs, plain_final
    torch.cuda.empty_cache()
    secs["16a trainer"] = time.perf_counter() - t
    t = time.perf_counter()
    out["seq_x070"], by_path["multigpu_seq_x070"] = check_seq_loss_one_rank(
        cfg, params, device, seed, make_mesh(n_data=1, n_seq=1), "x070 1B5")
    del params
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 16)
    out["ring_x070"], by_path["multigpu_ring_x070"] = check_ring_one_card("x070", gen, device)
    secs["16a seq x070"] = time.perf_counter() - t
    t = time.perf_counter()
    cfg6 = x060_training_cfg()
    params = init_model(cfg6, seed, device)
    out["seq_x060"], by_path["multigpu_seq_x060"] = check_seq_loss_one_rank(
        cfg6, params, device, seed, make_mesh(n_data=1, n_seq=1), "x060 1.6B")
    del params
    torch.cuda.empty_cache()
    out["ring_x060"], by_path["multigpu_ring_x060"] = check_ring_one_card("x060", gen, device)
    secs["16a seq x060"] = time.perf_counter() - t
    out["seconds"] = secs
    log(f"  phase 16 took {sum(secs.values()):.1f} s: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return out, by_path


def build(cfg, seed: int, device):
    import torch

    params, init_ms = timed(lambda: init_model(cfg, seed, device))
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  init: {n_params / 1e9:.3f} B parameters in {init_ms / 1e3:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return params


def serve(cfg, params, device, seed: int, plan=SERVING_PLAN):
    """:func:`run_serving`, logged. Returns (its numbers, launches, the
    launches it implies, the greedy ids of the four-request batch, those of
    the one request)."""
    runs, launches, want, peak_gib = run_serving(cfg, params, device, NEW_TOKENS, seed, plan)
    head_tokens = runs[-1].pop("tokens")
    one_tokens = runs[0].pop("tokens")
    for r in runs:
        log(f"  {r['run']}: prompt {r['prompt_tokens']} tokens, TTFT {r['ttft_ms']:.1f} ms, "
            f"generate({NEW_TOKENS}) {r['generate_ms']:.1f} ms, "
            f"decode {r['decode_tok_per_s']:.1f} tok/s, first ids {r['first_ids']}")
    log(f"  peak memory over the counted run: {peak_gib:.2f} GiB")
    return {"runs": runs, "peak_gib": peak_gib}, launches, want, head_tokens, one_tokens


def plain_check_serving(serving, cfg, params, seed: int, device):
    import torch

    err, cpu_s = check_against_plain(cfg, params, PLAIN_LAYERS, seed + 7, device)
    serving.update(plain_check_rel_rms=err, plain_check_lm_layers=PLAIN_LAYERS, plain_check_cpu_s=cpu_s)
    torch.cuda.empty_cache()


def train(cfg, params, device, seed: int, **kw):
    import torch

    training, launches, want = run_training(cfg, params, device, seed, **kw)
    log(f"  peak memory over the counted steps: {training['peak_gib']:.2f} GiB "
        f"(reckoned {training['reckoned_gb']['sum']:.2f} GB before activations and temporaries)")
    torch.cuda.empty_cache()
    return training, launches, want


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
    from visualrwkv_torch.ops.wkv7 import set_wkv_impl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_run = time.perf_counter()

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
        parse_ptxas(name, out)
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  [{name}] {line.strip()}")
    k78 = {key: v for key, v in PTXAS.items() if key[:2] == ("wkv6", "wkv6_fwd_kernel")}
    assert len(k78) == 36, (f"K7 / K8: ptxas reported {sorted(k78)}, not 2 dtypes x 2 x 3 row counts x 3 "
                            f"factor forms")
    assert not any(v.get("spill_bytes", 0) for v in k78.values()), f"a K7 / K8 instantiation spills: {k78}"
    k512 = {key: v for key, v in PTXAS.items() if key[1] == "wkv7_fwd_res_kernel"}
    want512 = {(lib, "wkv7_fwd_res_kernel", (dt, rows, zh, save)) for lib, zh in (("wkv7", 1), ("wkv7_packed", 2))
               for dt in (0, 1) for rows in (16, 32, 64) for save in (0, 1)}
    assert set(k512) == want512, f"K1 / K5 / K11 / K12: ptxas reported {sorted(k512)}, not {sorted(want512)}"
    assert not any(v.get("spill_bytes", 0) for v in k512.values()), \
        f"a K1 / K5 / K11 / K12 instantiation spills: {k512}"
    k613 = {key: v for key, v in PTXAS.items() if key[1] in ("wkv7_bwd_state_kernel", "wkv7_bwd_chunk_kernel")}
    want613 = {(lib, "wkv7_bwd_state_kernel", (dt, rows, zh)) for lib, zh in (("wkv7_train", 1), ("wkv7_packed", 2))
               for dt in (0, 1) for rows in (16, 32, 64)}
    want613 |= {(lib, "wkv7_bwd_chunk_kernel", (dt, zh)) for lib, zh in (("wkv7_train", 1), ("wkv7_packed", 2))
                for dt in (0, 1)}
    assert set(k613) == want613, f"K6 / K13: ptxas reported {sorted(k613)}, not {sorted(want613)}"
    assert not any(v.get("spill_bytes", 0) for v in k613.values()), f"a K6 / K13 instantiation spills: {k613}"
    k9 = {key: v for key, v in PTXAS.items() if key[1] in ("wkv6_bwd_state_kernel", "wkv6_bwd_chunk_kernel")}
    want9 = {("wkv6_train", "wkv6_bwd_state_kernel", (dt, rows, form)) for dt in (0, 1) for rows in (16, 32, 64)
             for form in (0, 1, 2)} | {("wkv6_train", "wkv6_bwd_chunk_kernel", (dt,)) for dt in (0, 1)}
    assert set(k9) == want9, f"K9: ptxas reported {sorted(k9)}, not {sorted(want9)}"
    assert not any(v.get("spill_bytes", 0) for v in k9.values()), f"a K9 instantiation spills: {k9}"
    k24 = {key: v for key, v in PTXAS.items() if key[1] == "wkv_step_kernel"}
    want24 = {("wkv7", "wkv_step_kernel", (7, dt, flat, rows)) for dt in (0, 1) for flat in (0, 1)
              for rows in (8, 16, 32, 64)}
    want24 |= {("wkv6", "wkv_step_kernel", (6, dt, flat, rows)) for dt in (0, 1) for flat in (0, 1)
               for rows in (8, 16, 32, 64)}
    assert set(k24) == want24, f"K2 / K4 / K10: ptxas reported {sorted(k24)}, not {sorted(want24)}"
    assert not any(v.get("spill_bytes", 0) for v in k24.values()), \
        f"a K2 / K4 / K10 instantiation spills: {k24}"
    k16 = {key: v for key, v in PTXAS.items() if key[0] == "wkv7_v2"}
    want16 = {("wkv7_v2", "wkv7_v2_chunk_f32_kernel", ()), ("wkv7_v2", "wkv7_v2_chunk_bf16_kernel", (1,)),
              ("wkv7_v2", "wkv7_v2_state_kernel", (0, 0, 8, 3))}
    want16 |= {("wkv7_v2", "wkv7_v2_state_kernel", (1, 1, cols, 3)) for cols in (16, 32, 64)}
    assert set(k16) == want16, f"K16: ptxas reported {sorted(k16)}, not {sorted(want16)}"
    assert not any(v.get("spill_bytes", 0) for v in k16.values()), f"a K16 instantiation spills: {k16}"
    for kname, kernel in (("K17", "wkv4_fwd_kernel"), ("K18", "wkv4_bwd_kernel")):
        k4 = {key: v for key, v in PTXAS.items() if key[:2] == ("wkv4", kernel)}
        assert len(k4) == 2, f"{kname}: ptxas reported {sorted(k4)}, not 2 dtypes"
        assert not any(v.get("spill_bytes", 0) for v in k4.values()), f"a {kname} instantiation spills: {k4}"

    # phase 2 --------------------------------------------------------------
    log("phase 2: kernels against their plain versions on the card")
    t2 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    kernels = {"wkv7_fwd": check_wkv7_fwd(gen, dev), "wkv7_step": check_wkv7_step(gen, dev),
               "wkv7_step_flat": check_wkv7_step_flat(gen, dev)}
    kernels["wkv7_fwd_res"], kernels["wkv7_bwd"] = check_wkv7_train(gen, dev)
    kernels["wkv7_fwd_packed"] = check_wkv7_fwd_packed(gen, dev)
    kernels["wkv7_fwd_res_packed"], kernels["wkv7_bwd_packed"] = check_wkv7_packed_train(gen, dev)
    check_wkv7_fwd_paths(gen, dev)
    check_wkv7_fwd_res_paths(gen, dev)
    check_wkv7_bwd_paths(gen, dev)
    check_wkv7_function_ragged(gen, dev)
    kernels["attention_fwd_relpos"], kernels["attention_fwd_mha"] = check_attention(gen, dev)
    kernels["wkv6_fwd"], kernels["wkv6_step"] = check_wkv6_fwd(gen, dev), check_wkv6_step(gen, dev)
    kernels["wkv6_step_flat"] = check_wkv6_step_flat(gen, dev)
    kernels["wkv6_fwd_res"], kernels["wkv6_bwd"] = check_wkv6_train(gen, dev)
    check_wkv6_paths(gen, dev)
    check_wkv6_bwd_paths(gen, dev)
    wkv6_floor_times = check_wkv6_low_floors(gen, dev)
    bwd = check_attention_bwd(gen, dev)
    for key, (dq_cases, dkv_cases) in bwd.items():
        kernels[f"attention_bwd_dq_{key}"], kernels[f"attention_bwd_dkv_{key}"] = dq_cases, dkv_cases
    kernels["wkv7_fwd_v2"] = check_wkv7_v2(gen, dev)
    kernels["wkv4_fwd"] = check_wkv4(gen, dev)
    kernels["wkv4_bwd"] = check_wkv4_bwd(gen, dev)
    torch.cuda.empty_cache()
    log(f"  phase 2 took {time.perf_counter() - t2:.1f} s")

    # phase 3 --------------------------------------------------------------
    log("phase 3: flagship VisualRWKV-7 1B5 serving, full width, seeded random bf16 weights")
    cfg = flagship_cfg()
    params = build(cfg, args.seed, dev)
    serving, launches, want, head_tokens, one_tokens = serve(cfg, params, dev, args.seed)
    assert_launches("serving, head layout", launches, want)
    flat_run, flat_launches, flat_want = run_serving_flat(cfg, params, dev, NEW_TOKENS, args.seed,
                                                          head_tokens)
    log(f"  {flat_run['run']}: generate({NEW_TOKENS}) {flat_run['generate_ms']:.1f} ms (the head "
        f"layout again, right after: {flat_run['head_layout_again_ms']:.1f} ms), greedy ids "
        f"equal to the head layout's, first ids {flat_run['first_ids']}")
    assert_launches("serving, flat layout", flat_launches, flat_want)
    serving["runs"].append(flat_run)
    packed_run, packed_launches, packed_want = run_serving_packed(cfg, params, dev, NEW_TOKENS,
                                                                  args.seed, head_tokens)
    log(f"  {packed_run['run']}: TTFT {packed_run['ttft_ms']:.1f} ms (the head layout again, right "
        f"after: {packed_run['head_layout_ttft_again_ms']:.1f} ms), generate({NEW_TOKENS}) "
        f"{packed_run['generate_ms']:.1f} ms, greedy ids equal to the head layout's, first ids "
        f"{packed_run['first_ids']}")
    assert_launches("serving, packed", packed_launches, packed_want)
    serving["runs"].append(packed_run)
    plain_check_serving(serving, cfg, params, args.seed, dev)

    # phase 9, on phase 3's model (before training touches anything) -------
    log("phase 9a/9b/9d: serving a checkpoint, on phase 3's model")
    phase9, phase9_s = {}, {}
    t9 = time.perf_counter()
    phase9["checkpoint"], ckpt_launches, ckpt_want = run_checkpoint_round_trip(cfg, params, dev, args.seed,
                                                                               one_tokens)
    assert_launches("9a checkpoint round trip", ckpt_launches, ckpt_want)
    phase9_s["9a"] = time.perf_counter() - t9
    t9 = time.perf_counter()
    phase9["decode_tok_per_s"] = {"x070": decode_rates(cfg, params, dev, args.seed, "x070 1B5")}
    phase9["int8_plain_rel_rms"] = {"x070": check_int8_against_plain(cfg, params, dev, args.seed + 13)}
    phase9_s["9b x070"] = time.perf_counter() - t9
    t9 = time.perf_counter()
    phase9["server"], server_launches, server_want = run_server(cfg, params, dev, args.seed)
    assert_launches("9d server", server_launches, server_want)
    phase9_s["9d"] = time.perf_counter() - t9
    torch.cuda.empty_cache()

    # phase 10, on phase 3's model ------------------------------------------
    log(f"phase 10: speculative decoding with the int8 self-draft, k in {SPEC_KS}, on phase 3's model")
    phase10, phase10_s = {}, {}
    t10 = time.perf_counter()
    phase10["x070_fp32"], spec_fp32_launches = spec_fp32_check(cfg, params, dev, args.seed, "10(a) x070 1B5")
    phase10_s["10a"] = time.perf_counter() - t10
    t10 = time.perf_counter()
    phase10["x070_bf16"], spec_launches = run_spec_full(cfg, params, dev, args.seed)
    phase10_s["10b-d"] = time.perf_counter() - t10
    torch.cuda.empty_cache()

    # phase 12d, on phase 3's model (before training touches it) ----------
    log(f"phase 12d: the flagship 1B5 with v7.03's visual token compressor ({VTC_LAYERS} blocks copied "
        f"from its LM), then with snake scanning too, one one-image request each")
    phase12, phase12_s = {}, {}
    t12 = time.perf_counter()
    phase12["12d"], vtc_launches = run_vtc_serving(cfg, params, dev, args.seed)
    phase12_s["12d"] = time.perf_counter() - t12

    # phase 14, on phase 3's model (before training touches it) -----------
    log(f"phase 14: the evaluation suite on phase 3's 1B5: the runner's per-batch step over {EVAL_QUESTIONS} "
        f"one-image questions at eval_batch {EVAL_BATCHES}, answer ranking, perplexity and loglikelihood, the "
        f"runner on the flat state")
    phase14, eval_launches = run_evals(cfg, params, dev, args.seed)
    torch.cuda.empty_cache()

    # phase 4 --------------------------------------------------------------
    log(f"phase 4: flagship VisualRWKV-7 1B5 training, full width, micro-batch {TRAIN_MICRO_BSZ} x "
        f"{TRAIN_CTX} tokens, one image a sample, 1 warm-up + {TRAIN_STEPS} counted steps")
    training, train_launches, train_want = train(cfg, params, dev, args.seed)
    assert_launches("training", train_launches, train_want)
    training["plain_check"] = check_training_against_plain(cfg, params, PLAIN_LAYERS, args.seed + 11, dev)
    # the training CLI's kernel options on the same model: --wkv_impl packed, --remat wkv|dots
    option_runs, option_launches = {}, {}
    for name, grad_cp, packed, steps in TRAIN_OPTION_RUNS:
        log(f"  {name}: grad_cp={grad_cp!r}, set_wkv_impl({'packed' if packed else 'auto'!r}), "
            f"1 warm-up + {steps} counted steps")
        option_runs[name], option_launches[name], want_opt = train(
            cfg, params, dev, args.seed, steps=steps, grad_cp=grad_cp, packed=packed)
        assert_launches(name, option_launches[name], want_opt)
        if packed:
            set_wkv_impl("packed")
            try:
                option_runs[name]["plain_check"] = check_training_against_plain(
                    cfg, params, PLAIN_LAYERS, args.seed + 11, dev)
            finally:
                set_wkv_impl("auto")
    training["option_runs"] = option_runs

    # phase 13a-c, on phase 3's model (its last use) ------------------------
    log(f"phase 13a: v7.10 VRWKV at the 1B5's width (C 2048, 6 blocks, patch {VRWKV_PATCH}, {VRWKV_PX} px), seeded "
        f"random bf16 weights: {VRWKV_IMAGES} images through the ImageNet step, then imagenet_loss forward + backward")
    phase13, phase13_s, phase13_launches = {}, {}, {}
    t13 = time.perf_counter()
    phase13["13a"], p13, vparams, vpixels, vlabels = run_vrwkv(args.seed, dev)
    phase13_launches.update(p13)
    phase13_s["13a"] = time.perf_counter() - t13
    gen13 = torch.Generator(device=dev)
    gen13.manual_seed(args.seed + 30)
    perturb_zero_projections(params["rwkv"], gen13)
    log(f"phase 13b: v7.10's mixture-FFN on phase 3's 1B5 LM with ffn_v / ln_v, behind 13a's VRWKV, B=2 x {MIX_T}, "
        f"trained under pretrain_mode_mask")
    t13 = time.perf_counter()
    phase13["13b"], p13 = run_mixffn(cfg, params, vparams, vpixels, vlabels, args.seed, dev)
    phase13_launches.update(p13)
    phase13_s["13b"] = time.perf_counter() - t13
    del vparams, vpixels, vlabels
    torch.cuda.empty_cache()
    log(f"phase 13c, x070: image-as-state with state tuning on phase 3's 1B5 (1024 image tokens, {STATE_TEXT} text, "
        f"B=2), then mean_multi_image over {STATE_MEAN_IMAGES} images")
    t13 = time.perf_counter()
    phase13["13c_x070"], p13, _ = run_state_tuning(cfg, params, args.seed, dev, "x070 1B5", mean_images=True)
    phase13_launches.update(p13)
    phase13_s["13c x070"] = time.perf_counter() - t13
    del params
    torch.cuda.empty_cache()

    # phase 5 --------------------------------------------------------------
    log("phase 5: VisualRWKV-6 7B (RWKV-6 World 7B, CLIP-L/14 @336, grid_size=-1: 577 image "
        "tokens, linear projector) serving, full width, seeded random bf16 weights")
    cfg6 = x060_serving_cfg()
    params = build(cfg6, args.seed, dev)
    serving6, launches6, want6, _, _ = serve(cfg6, params, dev, args.seed)
    assert_launches("x060 serving", launches6, want6)
    plain_check_serving(serving6, cfg6, params, args.seed, dev)
    log("phase 9b/9c: serving a checkpoint, on phase 5's model")
    t9 = time.perf_counter()
    phase9["decode_tok_per_s"]["x060"] = decode_rates(cfg6, params, dev, args.seed, "x060 7B")
    phase9["int8_plain_rel_rms"]["x060"] = check_int8_against_plain(cfg6, params, dev, args.seed + 13)
    phase9_s["9b x060"] = time.perf_counter() - t9
    t9 = time.perf_counter()
    phase9["x060_flat"], flat6_launches, flat6_want = run_x060_flat(cfg6, params, dev, args.seed, NEW_TOKENS)
    assert_launches("9c x060 flat state", flat6_launches, flat6_want)
    phase9_s["9c"] = time.perf_counter() - t9
    log("phase 10, x060: speculative decoding on phase 5's model, LM cut to fp32 layers")
    t10 = time.perf_counter()
    phase10["x060_fp32"], spec6_launches = spec_fp32_check(cfg6, params, dev, args.seed, "10 x060 7B",
                                                           batches=(1,))
    phase10_s["10 x060"] = time.perf_counter() - t10
    log("phase 12a: VisualRWKV-6 7B as published, leftpad insertion and the image span reversed on odd "
        f"blocks: one vlm_forward_leftpad over {len(LEFTPAD_POSITIONS)} one-image prompts of "
        f"{LEFTPAD_T_IN} tokens, the image at {LEFTPAD_POSITIONS}")
    t12 = time.perf_counter()
    phase12["12a"], leftpad_launches, leftpad_want = run_leftpad_serving(cfg6, params, dev, args.seed)
    assert_launches("12a leftpad + bidirectional serving", leftpad_launches, leftpad_want)
    phase12_s["12a"] = time.perf_counter() - t12
    log("phase 12c, 7B: VisualRWKV-6 7B training with the host-offloaded optimizer (trains phase 5's "
        "parameters in place: its last use)")
    t12 = time.perf_counter()
    phase12["12c_7b"], offload7_launches = run_offload_7b(cfg6, params, dev, args.seed)
    phase12_s["12c 7B"] = time.perf_counter() - t12
    del params  # the 7B leaves the card before phase 6
    torch.cuda.empty_cache()

    # phase 6 --------------------------------------------------------------
    log(f"phase 6: VisualRWKV-6 1.6B (RWKV-6 World 1.6B, the flagship's towers and projector) "
        f"training, full width, micro-batch {TRAIN_MICRO_BSZ} x {TRAIN_CTX} tokens, one image a "
        f"sample, 1 warm-up + {TRAIN_STEPS} counted steps")
    cfg6t = x060_training_cfg()
    params = build(cfg6t, args.seed, dev)
    training6, train_launches6, train_want6 = train(cfg6t, params, dev, args.seed)
    assert_launches("x060 training", train_launches6, train_want6)
    training6["plain_check"] = check_training_against_plain(cfg6t, params, PLAIN_LAYERS,
                                                            args.seed + 11, dev)
    log(f"phase 12b: VisualRWKV-6 1.6B trained as published (leftpad insertion, the bidirectional span, "
        f"the dense loss), micro-batch {TRAIN_MICRO_BSZ} x {TRAIN_CTX} tokens, 1 warm-up + {TRAIN_STEPS} "
        f"counted steps")
    t12 = time.perf_counter()
    phase12["12b"], leftpad_train_launches = run_leftpad_training(cfg6t, params, dev, args.seed)
    phase12_s["12b"] = time.perf_counter() - t12
    log(f"phase 12c: the host-offloaded optimizer on phase 6's 1.6B, {OFFLOAD_STEPS} steps offloaded and "
        f"{OFFLOAD_STEPS} resident from the same parameters")
    t12 = time.perf_counter()
    phase12["12c"] = run_offload(cfg6t, params, dev, args.seed)
    phase12_s["12c"] = time.perf_counter() - t12
    log("phase 12e: UHD on phase 6's 1.6B: the global view and 2x2 tiles fused, the projector's input doubled")
    t12 = time.perf_counter()
    phase12["12e"], uhd_launches = run_uhd_serving(cfg6t, params, dev, args.seed)
    phase12_s["12e"] = time.perf_counter() - t12
    phase12["seconds"] = phase12_s
    log(f"  phase 12 took {sum(phase12_s.values()):.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in phase12_s.items()))
    perturb_zero_projections(params["rwkv"], gen13)
    log(f"phase 13c, x060: image-as-state with state tuning on phase 6's 1.6B (1024 image tokens, {STATE_TEXT} "
        f"text, B=2)")
    t13 = time.perf_counter()
    phase13["13c_x060"], p13, _ = run_state_tuning(cfg6t, params, args.seed, dev, "x060 1.6B", mean_images=False)
    phase13_launches.update(p13)
    phase13_s["13c x060"] = time.perf_counter() - t13
    log(f"phase 13d: v6.23's hybrid on phase 6's 1.6B, {HYBRID_CROSS} cross blocks every {HYBRID_INTERVAL} from the "
        f"end, the flagship towers' 1024 projected features, B=2 x {HYBRID_T}")
    t13 = time.perf_counter()
    phase13["13d"], p13 = run_hybrid(cfg6t, params, args.seed, dev)
    phase13_launches.update(p13)
    phase13_s["13d"] = time.perf_counter() - t13
    del params
    torch.cuda.empty_cache()

    # phase 7 --------------------------------------------------------------
    log("phase 7: gradients through the vision towers at full width (SAM-B @1024, DINOv2-L/14-reg4 "
        "@448, SigLIP-so400m/14 @448), one image, seeded random bf16 weights")
    towers, tower_launches = {}, {}
    for name, tcfg in tower_grad_cfgs().items():
        towers[name], tower_launches[f"tower_grad_{name}"] = run_tower_grad(name, tcfg, args.seed, dev)
        assert_launches(f"{name} forward + backward", tower_launches[f"tower_grad_{name}"],
                        tower_grad_launches(name, tcfg))

    # phase 8 --------------------------------------------------------------
    log("phase 8: ops.wkv7.wkv7_v2, the chunk-batched WKV7 forward, through its public entry point")
    v2_run, v2_launches = run_wkv7_v2_path(args.seed, dev)
    want_v2 = dict.fromkeys(REPLACES, 0)
    want_v2["wkv7_fwd_v2"] = 1
    assert_launches("wkv7_v2", v2_launches, want_v2)
    torch.cuda.empty_cache()

    # phase 9e -------------------------------------------------------------
    log("phase 9e: the CUDA dispatchers on bf16, strided and [..., H, N] inputs (fault C.3)")
    t9 = time.perf_counter()
    phase9["dispatch_c3"], c3_launches = check_dispatch_narrow(args.seed + 17, dev)
    phase9_s["9e"] = time.perf_counter() - t9
    phase9["seconds"] = phase9_s
    log(f"  phase 9 took {sum(phase9_s.values()):.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in phase9_s.items()))
    torch.cuda.empty_cache()
    phase10["seconds"] = phase10_s

    # phase 11 -------------------------------------------------------------
    log("phase 11: the legacy families, RWKV-5 World 1.5B (x052) and RWKV-4 World 1.5B (x040), behind "
        "CLIP-L/14 @336 (577 image tokens) and a linear projector, seeded random bf16 weights")
    phase11, legacy_launches = {}, {}
    for version in ("x052", "x040"):
        t11 = time.perf_counter()
        phase11[version], paths = run_legacy(version, args.seed, dev)
        phase11[version]["seconds"] = time.perf_counter() - t11
        legacy_launches.update(paths)
    log(f"phase 13e: the v4 adapter behind phase 11's RWKV-4 World 1.5B (x040), rebuilt from its seed, and "
        f"CLIP-L/14 @336, B={ADAPTER_B}, {ADAPTER_CAPTION}-token captions")
    t13 = time.perf_counter()
    cfg4 = legacy_cfg("x040")
    params = init_model(cfg4, args.seed, dev)
    phase13["13e"], p13 = run_adapter(cfg4, params, args.seed, dev)
    phase13_launches.update(p13)
    phase13_s["13e"] = time.perf_counter() - t13
    del params
    torch.cuda.empty_cache()
    phase10_s["11"] = sum(phase11[v]["seconds"] for v in phase11)
    log(f"  phases 10 and 11 took {sum(phase10_s.values()):.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in phase10_s.items()))
    phase13["seconds"] = phase13_s
    log(f"  phase 13 took {sum(phase13_s.values()):.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in phase13_s.items()))

    # phase 16: multi-GPU training on the one card, over a one-rank NCCL
    # group (before phase 15, whose profile_trace slows every later launch)
    log("phase 16(a): a one-rank NCCL group: the 1B5's Trainer on make_mesh(n_data=1) at zero_stage 1 and 3 "
        "against the plain Trainer; training_loss_seq on one seq rank against training_loss (x070 1B5, x060 "
        f"1.6B); the ring of {RING_SHARDS} shards on the card")
    phase16, multigpu_launches = run_multigpu(args.seed, dev)

    # phase 15: the tooling, after every timed phase (its profile_trace
    # leaves the profiler attached), on the 1B5 rebuilt from its seed ---------
    log(f"phase 15: the tooling on the card: (a) kernel_bench {' '.join(KBENCH_ARGV)}; (b) the 1B5 through "
        f"Trainer.run_epoch for {TOOLING_STEPS} steps, its train_log.txt, device_memory() and one step under "
        f"profile_trace; (c) the peak of those steps by allocation site")
    phase15, tooling_launches = run_tooling(cfg, args.seed, dev)


    # profiles, after every counted run: each model built again from its seed
    log("profiles: one prefill and 9 decode steps a serving model, one step a training model, "
        "one forward + backward a tower")
    for what, c, out, prof in (("x070 serving", cfg, serving, profile_serving),
                               ("x070 training", cfg, training, profile_training),
                               ("x070 training, grad_cp='wkv'", cfg, option_runs["training_remat_wkv"],
                                lambda *a: profile_training(*a, grad_cp="wkv")),
                               ("x060 7B serving", cfg6, serving6, profile_serving),
                               ("x060 1.6B training", cfg6t, training6, profile_training)):
        params = init_model(c, args.seed, dev)
        out["breakdown"] = prof(c, params, dev, args.seed)
        log_breakdown(what, out["breakdown"])
        if what == "x070 serving":  # K2's device time a B=1 decode step, from the profile
            d = out["breakdown"]["decode (9 steps, B=1)"]
            k2_ms, k2_n = d["device_ms_by_kind"].get("K2 wkv7_step", 0.0), d["events_by_kind"].get("K2 wkv7_step", 0)
            steps = k2_n / c.rwkv.n_layer
            assert k2_n > 0 and k2_n % c.rwkv.n_layer == 0, f"K2 launches in the decode profile: {k2_n}"
            d["k2_ms_per_step"] = k2_ms / steps
            log(f"  x070 serving, decode B=1: K2 {k2_ms / steps:.4f} ms of device time a step ({k2_n} "
                f"launches over {steps:g} steps, {k2_ms / k2_n * 1e3:.3f} us a launch) of the card's "
                f"{d['device_busy_ms'] / steps:.2f} ms busy a step")
        if what == "x060 7B serving":  # K10's device time a B=1 decode step, from the profile
            d = out["breakdown"]["decode (9 steps, B=1)"]
            k10_ms, k10_n = d["device_ms_by_kind"].get("K10 wkv6_step", 0.0), d["events_by_kind"].get("K10 wkv6_step", 0)
            steps = k10_n / c.rwkv.n_layer
            assert k10_n > 0 and k10_n % c.rwkv.n_layer == 0, f"K10 launches in the decode profile: {k10_n}"
            d["k10_ms_per_step"] = k10_ms / steps
            log(f"  x060 7B serving, decode B=1: K10 {k10_ms / steps:.4f} ms of device time a step ({k10_n} "
                f"launches over {steps:g} steps, {k10_ms / k10_n * 1e3:.3f} us a launch) of the card's "
                f"{d['device_busy_ms'] / steps:.2f} ms busy a step")
        if what == "x060 1.6B training":
            g = out["breakdown"]["loss and gradients"]
            k9 = g["device_ms_by_kind"].get("K9 wkv6_bwd", 0.0)
            log(f"  x060 1.6B training: K9 (both passes) {k9:.2f} ms of the gradient pass's "
                f"{g['device_busy_ms']:.1f} ms card busy ({k9 / g['device_busy_ms']:.3f})")
        del params
        torch.cuda.empty_cache()
    for name, tcfg in tower_grad_cfgs().items():
        towers[name]["breakdown"] = profile_tower_grad(tcfg, args.seed, dev)
        log_breakdown(f"{name} tower gradient", towers[name]["breakdown"])
        torch.cuda.empty_cache()

    # results --------------------------------------------------------------
    # launches of each kernel over the counted runs of the paths
    by_path = {"serving_head": launches, "serving_flat": flat_launches,
               "serving_packed": packed_launches, "training": train_launches, **option_launches,
               "serving_x060": launches6, "training_x060": train_launches6, **tower_launches,
               "wkv7_v2": v2_launches, "checkpoint_round_trip": ckpt_launches, "server": server_launches,
               "serving_x060_flat": flat6_launches, "spec_x070_fp32": spec_fp32_launches,
               **{f"spec_x070 {k}": v for k, v in spec_launches.items()}, "spec_x060_fp32": spec6_launches,
               **legacy_launches, **vtc_launches, "serving_x060_leftpad": leftpad_launches,
               "training_x060_leftpad": leftpad_train_launches,
               **{f"training_x060_{k}": v["launches"] for k, v in phase12["12c"].items()
                  if isinstance(v, dict) and "launches" in v},
               "serving_x060_uhd": uhd_launches,
               **({"training_x060_7b_offloaded": offload7_launches} if offload7_launches else {}),
               **phase13_launches, **eval_launches, **tooling_launches, **multigpu_launches}
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
    log(json.dumps({"card": card, "build_s": build_s, "serving": serving, "training": training,
                    "serving_x060": serving6, "training_x060": training6, "tower_grads": towers,
                    "wkv6_ms_by_chunk_len": wkv6_floor_times,
                    "wkv7_v2": v2_run, "phase9": phase9, "dispatch_c3_launches": c3_launches,
                    "phase10": phase10, "phase11": phase11, "phase12": phase12, "phase13": phase13,
                    "phase14": phase14, "phase15": phase15, "phase16": phase16}))
    from visualrwkv_torch.parallel import distributed

    distributed.shutdown()
    log(f"the whole run took {time.perf_counter() - t_run:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def _named_leaves(tree, path=""):
    """(path, leaf) pairs in :func:`_leaves`'s order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{path}.{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


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
