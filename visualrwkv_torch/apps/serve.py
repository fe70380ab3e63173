"""Batch serving from a jsonl file over the continuous-batching server
(``infer/server.py``). Counterpart of ``visualrwkv_tpu/apps/serve.py``.

Reads requests ``{"id": ..., "text": ..., "image": optional path,
"max_new_tokens": optional}``, one a line, and writes ``{"id", "text"}``
lines, the decode batch kept full by slot-level continuous batching. Runs on
the card unless ``--device cpu`` or a ``cpu`` strategy asks for the CPU.

    python -m visualrwkv_torch.apps.serve --model_path m.pth \\
        --strategy "gpu bf16i8 s16" --input requests.jsonl --output answers.jsonl --max_batch 16
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path


def main(argv=None):
    from visualrwkv_torch.apps.demo import add_engine_args

    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser("visualrwkv_torch.apps.serve")
    p.add_argument("--input", required=True, type=str)
    p.add_argument("--output", required=True, type=str)
    p.add_argument("--image_folder", default="", type=str)
    p.add_argument("--max_batch", default=16, type=int)
    p.add_argument("--max_new_tokens", default=128, type=int)
    p.add_argument("--temperature", default=0.0, type=float, help="0 = greedy (for the whole server)")
    p.add_argument("--top_p", default=0.3, type=float)
    add_engine_args(p)
    args = p.parse_args(argv)

    import numpy as np

    from visualrwkv_torch.apps.demo import GEN_PROMPT, build_engine
    from visualrwkv_torch.data.dataset import load_image_uint8
    from visualrwkv_torch.data.tokenizer import get_tokenizer
    from visualrwkv_torch.infer.sampling import SamplingParams
    from visualrwkv_torch.infer.server import BatchedServer

    engine, cfg = build_engine(args)
    tok = get_tokenizer()
    server = BatchedServer(engine, max_batch=args.max_batch,
                           sp=SamplingParams(temperature=args.temperature, top_p=args.top_p))
    sizes = {t: (cfg.vision.sam_image_size if t == "sam" else cfg.vision.image_size)
             for t in cfg.vision.towers}

    id_by_rid = {}
    with open(args.input) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            images = None
            if rec.get("image"):
                path = str(Path(args.image_folder) / rec["image"])

                # loaded when the request takes a slot: about max_batch images at once
                def images(path=path):
                    return {t: v[None] for t, v in load_image_uint8(path, sizes).items()}
            ids = np.asarray([tok.encode(GEN_PROMPT.format(instruction=rec["text"].strip()))])
            rid = server.submit(ids, images=images,
                                max_new_tokens=rec.get("max_new_tokens", args.max_new_tokens))
            id_by_rid[rid] = rec.get("id", rid)

    results = server.run()
    with open(args.output, "w") as out:
        for rid, tokens in sorted(results.items()):
            if tokens and tokens[-1] in server.stop_tokens:
                tokens = tokens[:-1]
            out.write(json.dumps({"id": id_by_rid[rid], "text": tok.decode(tokens)},
                                 ensure_ascii=False) + "\n")
    logging.info("wrote %d results to %s", len(results), args.output)


if __name__ == "__main__":
    main()
