"""Context-length analyzer (reference calc_ctxlen.py:42-133).

Tokenizes a dataset and reports percentiles of context length, valid-label
count, and conversation rounds; flags zero-valid-label samples in debug mode.
The port's copy of ``visualrwkv_tpu/utils/calc_ctxlen.py``, on the port's
tokenizer and conversation templates.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def analyze(data_file: str, num_token_per_image: int, ctx_len: int,
            debug: bool = False) -> dict:
    from visualrwkv_torch.data.conversation import (
        IGNORE_INDEX,
        preprocess,
        process_image_tokens_in_conversations,
        process_tokens_in_conversations,
    )
    from visualrwkv_torch.data.tokenizer import get_tokenizer

    tok = get_tokenizer()
    records = json.load(open(data_file))
    ctx_lens, valid_lens, rounds = [], [], []
    zero_valid = []
    for rec in records:
        has_image = "image" in rec
        if has_image:
            names = rec["image"] if isinstance(rec["image"], list) else [rec["image"]]
            convs = process_image_tokens_in_conversations(rec["conversations"], len(names))
        else:
            convs = process_tokens_in_conversations(rec["conversations"])
        item = preprocess(convs, tok, has_image, ctx_len, num_token_per_image,
                          do_pad_to_max_length=False)
        n_valid = int((item["labels"][:ctx_len] != IGNORE_INDEX).sum())
        ctx_lens.append(len(item["input_ids"]))
        valid_lens.append(n_valid)
        rounds.append(len(rec["conversations"]) // 2)
        if n_valid == 0:
            zero_valid.append(rec.get("id", rec.get("sample_id")))

    pct = lambda a: {f"p{q}": float(np.percentile(a, q)) for q in (50, 90, 95, 99, 100)}
    report = {
        "n_samples": len(records),
        "ctx_len": pct(ctx_lens),
        "valid_labels": pct(valid_lens),
        "rounds": pct(rounds),
        "over_ctx_len": int(np.sum(np.asarray(ctx_lens) > ctx_len)),
        "zero_valid_label_samples": len(zero_valid),
    }
    if debug and zero_valid:
        report["zero_valid_ids"] = zero_valid[:50]
    return report


def main(argv=None):
    p = argparse.ArgumentParser("visualrwkv_torch.utils.calc_ctxlen")
    p.add_argument("--data_file", required=True)
    p.add_argument("--num_token_per_image", default=1024, type=int)
    p.add_argument("--ctx_len", default=2048, type=int)
    p.add_argument("--debug_mode", action="store_true")
    args = p.parse_args(argv)
    report = analyze(args.data_file, args.num_token_per_image, args.ctx_len,
                     args.debug_mode)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
