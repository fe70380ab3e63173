"""Serving latency and memory benchmark of an RWKV-7 LM (the reference's
app/benchmark_gpu.py protocol). Counterpart of
``visualrwkv_tpu/apps/benchmark.py``:

- decode latency for new_tokens in powers of two, ``--reps`` repetitions
  with the first ``--discard`` left out;
- the state reused: one 512-token prefill, then many decodes from it;
- TTFT of that prefill;
- device memory (``torch.cuda.memory_allocated`` / ``max_memory_allocated``
  / ``memory_reserved``, where the JAX package reads its device's
  ``memory_stats``);
- with ``--spec_k``, speculative decoding (``infer/speculative.py``) with an
  int8 self-draft or a separate smaller draft.

Writes one JSON record a line to ``--output_file`` and prints each. Runs on
the card unless ``--device cpu`` asks for the CPU:

    python -m visualrwkv_torch.apps.benchmark --n_layer 24 --n_embd 2048 --spec_k 4 \\
        --output_file bench.jsonl
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch


def device_memory_stats(device: torch.device) -> dict:
    """Bytes the caching allocator holds on the card: in use, the peak in
    use, and reserved; empty on the CPU."""
    if device.type != "cuda":
        return {}
    return {"bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
            "bytes_reserved": torch.cuda.memory_reserved(device)}


def _rwkv7_params(cfg, seed: int, model_path: str, quant: str, device):
    """Seeded random bf16 weights, or a reference ``.pth`` (fp32, as the
    JAX package imports it), int8-quantized when ``quant`` says so."""
    from visualrwkv_torch.convert.pth_import import import_rwkv_state_dict, load_pth
    from visualrwkv_torch.infer.quant import quantize_lm_params
    from visualrwkv_torch.infer.strategy import place
    from visualrwkv_torch.models import rwkv7

    if model_path.endswith(".pth"):
        params = place(import_rwkv_state_dict(load_pth(model_path)), device)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = rwkv7.init_rwkv7_params(gen, cfg, device, dtype=torch.bfloat16)
    return quantize_lm_params(params) if quant == "int8" else params


def main(argv=None):
    p = argparse.ArgumentParser("visualrwkv_torch.apps.benchmark")
    p.add_argument("--model_path", default="", type=str)
    p.add_argument("--n_layer", default=24, type=int)
    p.add_argument("--n_embd", default=2048, type=int)
    p.add_argument("--ctx_len", default=2048, type=int)
    p.add_argument("--quant", default="none", choices=["none", "int8"])
    p.add_argument("--state_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--state_layout", default="head", choices=["head", "flat"],
                   help="flat = the [B, 64, H*64] decode state carry (kernel K4)")
    p.add_argument("--batch", default=1, type=int)
    p.add_argument("--max_pow", default=10, type=int, help="max new_tokens = 2^max_pow")
    p.add_argument("--reps", default=15, type=int)
    p.add_argument("--discard", default=5, type=int)
    p.add_argument("--spec_k", default=0, type=int,
                   help="also benchmark speculative decoding at this proposal window (0 = off; "
                        "greedy-lossless, see infer/speculative.py)")
    p.add_argument("--spec_draft", default="int8_self", choices=["int8_self", "small"],
                   help="draft source: int8_self = a quantized copy of the target (no second "
                        "checkpoint); small = a separate smaller RWKV draft "
                        "(--draft_n_layer/--draft_n_embd, optionally --draft_model_path)")
    p.add_argument("--draft_n_layer", default=12, type=int)
    p.add_argument("--draft_n_embd", default=768, type=int)
    p.add_argument("--draft_model_path", default="", type=str,
                   help=".pth checkpoint of the separate draft (random init if empty)")
    p.add_argument("--draft_quant", default="int8", choices=["none", "int8"])
    p.add_argument("--output_file", default="benchmark_results.jsonl")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from visualrwkv_torch.config import RWKVConfig, resolve_device
    from visualrwkv_torch.models import rwkv7
    from visualrwkv_torch.ops.wkv7 import state_to_flat

    dev = resolve_device(args.device)
    cfg = RWKVConfig(n_layer=args.n_layer, n_embd=args.n_embd, ctx_len=args.ctx_len)
    params = _rwkv7_params(cfg, 0, args.model_path, args.quant, dev)

    # prefill once (the state reused), decode many
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompt = torch.randint(0, 65000, (args.batch, 512), generator=gen, device=dev)
    state_dt = getattr(torch, args.state_dtype)

    @torch.no_grad()
    def prefill(params, tokens):
        logits, states = rwkv7.rwkv7_forward(params, cfg, rwkv7.embed(params, tokens))
        if args.state_layout == "flat":
            states = [s._replace(wkv=state_to_flat(s.wkv)) for s in states]
        states = [s._replace(wkv=s.wkv.to(state_dt).contiguous()) for s in states]
        return logits[:, -1].float(), states

    @torch.no_grad()
    def decode(n, params, fl, st):
        logits, total = fl, 0
        for _ in range(n):
            tok = logits.argmax(-1)
            logits, st = rwkv7.rwkv7_decode_step(params, cfg, tok, st)
            total = total + tok.sum()
        return int(total)  # waits for the device

    records = []

    # TTFT: the 512-token prefill
    fl, st = prefill(params, prompt)
    float(fl.sum())  # waits for the device
    t0 = time.time()
    for _ in range(5):
        fl, st = prefill(params, prompt)
    float(fl.sum())
    ttft = (time.time() - t0) / 5
    records.append({"metric": "ttft_prefill512_s", "value": round(ttft, 4)})

    for pow2 in range(0, args.max_pow + 1):
        n = 2**pow2
        decode(n, params, fl, st)  # warm-up
        times = []
        for _ in range(args.reps):
            t0 = time.time()
            decode(n, params, fl, st)
            times.append(time.time() - t0)
        mean_s = float(np.mean(times[args.discard:]))
        records.append({"new_tokens": n, "batch": args.batch, "latency_s": round(mean_s, 5),
                        "tok_per_s": round(args.batch * n / mean_s, 1),
                        "memory": device_memory_stats(dev)})
        print(records[-1])

    if args.spec_k > 0:
        from visualrwkv_torch.config import VisionConfig, VLMConfig
        from visualrwkv_torch.infer.speculative import SpeculativeEngine, quantize_self_draft

        def text_vlm(rcfg):
            return VLMConfig(rwkv=rcfg, vision=VisionConfig(towers=()), proj_type="linear",
                             num_token_per_image=1)

        vcfg = text_vlm(cfg)
        tgt = {"rwkv": params}
        if args.spec_draft == "small":
            # the deployment shape: a separate smaller draft checkpoint
            dcfg = RWKVConfig(n_layer=args.draft_n_layer, n_embd=args.draft_n_embd, ctx_len=args.ctx_len)
            dparams = _rwkv7_params(dcfg, 7, args.draft_model_path, args.draft_quant, dev)
            draft, dvcfg = {"rwkv": dparams}, text_vlm(dcfg)
        elif args.quant == "none":
            draft, dvcfg = {"rwkv": quantize_self_draft(params)}, vcfg
        else:
            # an int8 target already: the draft is the target (every proposal accepted;
            # this measures the loop's overhead, not a deployment)
            draft, dvcfg = tgt, vcfg
        spec = SpeculativeEngine(tgt, vcfg, draft, dvcfg, k=args.spec_k, device=dev)
        n = 2**args.max_pow
        ids = prompt.cpu().numpy()
        r = spec.generate(ids, max_new_tokens=n, stop_tokens=())
        times = []
        for _ in range(max(1, args.reps - args.discard)):
            t0 = time.time()
            r = spec.generate(ids, max_new_tokens=n, stop_tokens=())
            times.append(time.time() - t0)
        mean_s = float(np.mean(times))
        records.append({
            "new_tokens": n, "batch": args.batch, "spec_k": args.spec_k, "spec_draft": args.spec_draft,
            "latency_s": round(mean_s, 5), "tok_per_s": round(args.batch * n / mean_s, 1),
            "acceptance": round(float(r.accepted.sum()) / max(1, r.rounds * args.spec_k * args.batch), 3),
        })
        print(records[-1])

    out_path = Path(args.output_file)
    with open(out_path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
