"""HF-datasets evaluation (reference evaluate_hfds.py:64-186): the same eval
flow over records that carry their image in-line (a PIL image, bytes, or a
``{"bytes": ...}`` dict) instead of a path. Counterpart of
``visualrwkv_tpu/evals/hfds.py``; ``main`` reads a ``datasets.load_from_disk``
folder and runs on the card unless ``--device cpu`` is asked for.

    python -m visualrwkv_torch.evals.hfds --dataset_path ds --output_file answers.jsonl
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Dict, Iterable

import numpy as np


def record_to_images(rec: Dict, sizes: Dict[str, int]) -> Dict[str, np.ndarray]:
    """A record's in-line image -> uint8 ``[1, S, S, 3]`` a tower."""
    from PIL import Image

    img = rec["image"]
    if hasattr(img, "convert"):
        img = img.convert("RGB")
    else:  # bytes / dict forms
        from io import BytesIO

        data = img["bytes"] if isinstance(img, dict) else img
        img = Image.open(BytesIO(data)).convert("RGB")
    return {
        t: np.array(img.resize((s, s), Image.BICUBIC), np.uint8)[None]
        for t, s in sizes.items()
    }


def run_hfds_eval(engine, tokenizer, dataset: Iterable[Dict], output_file: str,
                  question_key: str = "question", id_key: str = "question_id",
                  dataset_name: str = "", max_new_tokens: int = 128,
                  model_id: str = "visualrwkv_torch") -> list:
    """One greedy answer a record, one question at a time, through
    :func:`visualrwkv_torch.evals.runner.eval_batch`; writes and returns
    ``{question_id, prompt, text, model_id}`` a record."""
    from visualrwkv_torch.evals.runner import eval_batch, prepare_question, tower_image_sizes

    cfg = engine.cfg
    sizes = tower_image_sizes(cfg)
    out_path = Path(output_file)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = []
    with open(out_path, "w") as f:
        for i, rec in enumerate(dataset):
            line = {"question_id": rec.get(id_key, i), "text": "<image>\n" + rec[question_key]}
            item = prepare_question(line, tokenizer, cfg, 1, dataset_name)
            (full,), _ = eval_batch(engine, tokenizer, item["input_ids"][None, :],
                                    record_to_images(rec, sizes), [line], [item["input_text"]],
                                    max_new_tokens=max_new_tokens, model_id=model_id)
            out = {k: full[k] for k in ("question_id", "prompt", "text", "model_id")}
            f.write(json.dumps(out, ensure_ascii=False) + "\n")
            results.append(out)
    return results


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser("visualrwkv_torch.evals.hfds")
    p.add_argument("--dataset_path", required=True, help="datasets.load_from_disk dir")
    p.add_argument("--split", default="test")
    p.add_argument("--output_file", required=True)
    p.add_argument("--model_path", default="")
    p.add_argument("--n_layer", default=12, type=int)
    p.add_argument("--n_embd", default=768, type=int)
    p.add_argument("--max_new_tokens", default=128, type=int)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from visualrwkv_torch.config import RWKVConfig, VisionConfig, VLMConfig, resolve_device
    from visualrwkv_torch.data.tokenizer import get_tokenizer
    from visualrwkv_torch.infer.engine import InferenceEngine
    from visualrwkv_torch.infer.strategy import place
    from visualrwkv_torch.models.visualrwkv import init_visualrwkv_params

    device = resolve_device(args.device)
    import datasets

    ds = datasets.load_from_disk(args.dataset_path)
    if args.split in getattr(ds, "keys", lambda: [])():
        ds = ds[args.split]
    cfg = VLMConfig(rwkv=RWKVConfig(n_layer=args.n_layer, n_embd=args.n_embd),
                    vision=VisionConfig())
    params = init_visualrwkv_params(cfg, seed=0, device=device)
    if args.model_path:
        from visualrwkv_torch.convert.pth_import import import_rwkv_state_dict, load_pth

        params["rwkv"] = place(import_rwkv_state_dict(load_pth(args.model_path)), device)
    engine = InferenceEngine(params, cfg, device=device)
    return run_hfds_eval(engine, get_tokenizer(), ds, args.output_file,
                         max_new_tokens=args.max_new_tokens)


if __name__ == "__main__":
    main()
