"""Evaluation CLI (reference evaluate.py equivalent). Counterpart of
``visualrwkv_tpu/evals/cli.py``, with the same flags and ``--device`` (the
card unless ``cpu`` is asked for).

Shard with --num_chunks/--chunk_idx exactly like the reference's shell fan-out
(scripts/eval/eval_vqav2.sh); results concatenate downstream.

    python -m visualrwkv_torch.evals.cli --model_path m.pth --question_file q.jsonl \\
        --image_folder imgs --output_file answers.jsonl --eval_batch 8
"""

from __future__ import annotations

import argparse
import logging

from visualrwkv_torch.config import RWKVConfig, VisionConfig, VLMConfig


def build_argparser():
    p = argparse.ArgumentParser("visualrwkv_torch.evals")
    p.add_argument("--model_path", default="", type=str, help="a reference .pth")
    p.add_argument("--question_file", required=True, type=str)
    p.add_argument("--image_folder", default=None, type=str)
    p.add_argument("--output_file", required=True, type=str)
    p.add_argument("--dataset_name", default="", type=str)
    p.add_argument("--image_strategy", default="single", choices=["single", "multi", "video", "uhd"])
    p.add_argument("--num_chunks", default=1, type=int)
    p.add_argument("--chunk_idx", default=0, type=int)
    p.add_argument("--max_new_tokens", default=128, type=int)
    p.add_argument("--temperature", default=0.0, type=float, help="0 = greedy (reference eval default)")
    p.add_argument("--top_p", default=1.0, type=float)
    p.add_argument("--rwkv_version", default="auto",
                   choices=["auto", "x070", "x060", "x052"],
                   help="auto = detect generation + geometry from checkpoint "
                   "keys (reference app/modeling_rwkv.py:227-244)")
    p.add_argument("--quant", default="none", choices=["none", "int8"])
    p.add_argument("--state_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--state_layout", default="head", choices=["head", "flat"],
                   help="flat = the [B, 64, H*64] decode state")
    p.add_argument("--eval_batch", default=1, type=int,
                   help="questions decoded together (grouped by bucketed length and images a question)")
    p.add_argument("--length_bucket", default=16, type=int,
                   help="pad prompts (EOS-left) to length buckets; 16 (default) is "
                   "reference-exact padding, 64 is a documented deviation "
                   "(more questions share a batch, slightly different EOS-prefix states)")
    p.add_argument("--n_layer", default=12, type=int)
    p.add_argument("--n_embd", default=768, type=int)
    p.add_argument("--ctx_len", default=2048, type=int)
    p.add_argument("--vocab_size", default=65536, type=int)
    p.add_argument("--proj_type", default="mlp", choices=["linear", "mlp"])
    p.add_argument("--num_token_per_image", default=1024, type=int)
    p.add_argument("--vision_towers", default="dino,siglip,sam", type=str)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def build_engine(args):
    """Build (engine, cfg) from CLI args: a seeded init on ``--device``, the
    checkpoint of ``--model_path`` (combined or bare-LM .pth) in its place,
    then ``--quant`` on the LM and the state's dtype and layout. Shared by
    the eval and ranking CLIs."""
    from visualrwkv_torch.apps.demo import _device, _engine
    from visualrwkv_torch.infer.strategy import place
    from visualrwkv_torch.models.visualrwkv import init_visualrwkv_params

    sd = None
    if args.model_path.endswith(".pth"):
        from visualrwkv_torch.convert.pth_import import load_pth

        sd = load_pth(args.model_path)
    version = args.rwkv_version
    geometry = {}
    if version == "auto":
        version = "x070"
        if sd is not None:
            from visualrwkv_torch.convert.pth_import import detect_rwkv_version

            info = detect_rwkv_version(sd)
            version = info["version"]
            geometry = {
                k: info[k]
                for k in ("n_layer", "n_embd", "vocab_size", "head_size")
                if info.get(k)
            }
            logging.info("checkpoint autodetect: %s %s", version, geometry)

    cfg = VLMConfig(
        rwkv=RWKVConfig(
            n_layer=geometry.get("n_layer", args.n_layer),
            n_embd=geometry.get("n_embd", args.n_embd),
            vocab_size=geometry.get("vocab_size", args.vocab_size),
            head_size=geometry.get("head_size", 64),
            ctx_len=args.ctx_len, version=version,
        ),
        vision=VisionConfig(towers=tuple(args.vision_towers.split(","))),
        proj_type=args.proj_type,
        num_token_per_image=args.num_token_per_image,
    )
    device = _device(args)
    params = init_visualrwkv_params(cfg, seed=0, device=device)
    if sd is not None:
        from visualrwkv_torch.convert.pth_import import (
            import_rwkv_state_dict,
            import_visualrwkv_checkpoint,
        )

        if any(k.startswith(("vit.", "proj.")) for k in sd):
            # combined released checkpoint: LM + projector + towers
            loaded = import_visualrwkv_checkpoint(sd, dst_grid=cfg.vision.image_size // 14)
            params.update(place(loaded, device))
            logging.info("loaded combined checkpoint (%d tensors) from %s", len(sd), args.model_path)
            for part in ("vit", "proj"):
                if part not in loaded and part in params:
                    logging.warning(
                        "checkpoint has no %s.* keys: the %s stays RANDOMLY "
                        "INITIALIZED (load the towers separately or expect "
                        "garbage outputs)", part, part,
                    )
        else:
            rwkv_keys = {k[5:] if k.startswith("rwkv.") else k: v for k, v in sd.items()}
            known = ("emb.", "blocks.", "ln_out.", "head.")
            stray = [k for k in rwkv_keys if not k.startswith(known)]
            for k in stray:  # tolerate stray non-LM keys instead of KeyError-ing
                logging.warning("ignoring unrecognized checkpoint key %r", k)
                rwkv_keys.pop(k)
            params["rwkv"] = place(import_rwkv_state_dict(rwkv_keys), device)
            logging.info("loaded %d rwkv tensors from %s", len(rwkv_keys), args.model_path)
    # --quant int8 quantizes params["rwkv"] only; the engine carries --state_dtype / --state_layout
    return _engine(params, cfg, args), cfg


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_argparser().parse_args(argv)

    from visualrwkv_torch.data.tokenizer import get_tokenizer
    from visualrwkv_torch.evals.loaders import get_chunk, load_questions
    from visualrwkv_torch.evals.runner import run_eval

    engine, _ = build_engine(args)
    tok = get_tokenizer()
    questions = get_chunk(load_questions(args.question_file), args.num_chunks, args.chunk_idx)
    return run_eval(
        engine, tok, questions, args.image_folder, args.output_file,
        dataset_name=args.dataset_name, image_strategy=args.image_strategy,
        max_new_tokens=args.max_new_tokens, length_bucket=args.length_bucket,
        batch_size=args.eval_batch,
    )


if __name__ == "__main__":
    main()
