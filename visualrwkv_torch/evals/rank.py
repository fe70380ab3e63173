"""Answer ranking evaluation (MMBench-style, reference v6.0/rank_answer.py:131-210).
Counterpart of ``visualrwkv_tpu/evals/rank.py``.

Protocol: score every candidate's FIRST token probability at the prompt's last
position, take the top-k candidates, then re-rank those k by their full
sequence CE loss under the model. The reference re-runs the whole prefix per
candidate; here the prompt is prefilled once into an RNN state and the k
candidates continue together from k copies of it (one-token steps at B = k),
O(prompt + k * candidate) instead of O(k * (prompt + candidate)).

    python -m visualrwkv_torch.evals.rank --model_path m.pth --question_file q.jsonl \\
        --image_folder imgs --output_file ranked.jsonl --candidates_file cands.json
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from visualrwkv_torch.infer.engine import InferenceEngine
from visualrwkv_torch.models import lm
from visualrwkv_torch.models.rwkv7 import LayerState


def normalize_candidates(candidates: Sequence[str]) -> List[str]:
    """Leading space avoids tokenization boundary issues (rank_answer.py:133)."""
    return [" " + c.strip().capitalize() for c in candidates]


@torch.no_grad()
def rank_candidates(
    engine: InferenceEngine,
    tokenizer,
    input_ids: np.ndarray,
    images: Optional[Dict] = None,
    candidates: Sequence[str] = (),
    k: int = 5,
) -> Tuple[str, List[Tuple[str, float, float]]]:
    """Returns (best candidate, [(candidate, first_token_prob, ce_loss)] for
    the top-k); the best has the least CE."""
    cands = normalize_candidates(candidates)
    cand_ids = [tokenizer.encode(c) for c in cands]
    max_len = max(len(c) for c in cand_ids)
    cand_mat = np.zeros((len(cand_ids), max_len), np.int64)
    for i, c in enumerate(cand_ids):
        cand_mat[i, : len(c)] = c
    first_tokens = cand_mat[:, 0]

    first_logits, states = engine.prefill_ids(input_ids, images)
    probs = torch.softmax(first_logits[0].float(), -1).cpu().numpy()
    first_probs = probs[first_tokens]
    k = min(k, len(cands))
    topk = np.argsort(-first_probs)[:k]

    # continue the k candidates from k replicas of the prompt state
    rep = [LayerState(*(x.repeat_interleave(k, 0) for x in st)) for st in states]
    cand_batch = torch.as_tensor(cand_mat[topk], device=engine.device)  # [k, max_len]
    x_emb = lm.embed(engine.params["rwkv"], cand_batch)
    # per-position logits continued from the prompt state (the first
    # candidate token is scored from the prompt's last logits above)
    logits_seq = _stateful_logits(engine, x_emb, rep)  # [k, max_len, V]
    # log p of candidate token j + 1 at position j
    logp = torch.log_softmax(logits_seq[:, :-1].float(), -1)
    next_lp = logp.gather(-1, cand_batch[:, 1:, None])[..., 0].cpu().numpy()

    results = []
    for row, ci in enumerate(topk):
        n = len(cand_ids[ci])
        # CE: position j predicted by prompt-last (j=0) or candidate pos j-1
        ce = -math.log(max(first_probs[ci], 1e-30))
        for j in range(1, n):
            ce += -float(next_lp[row, j - 1])
        ce /= n
        results.append((candidates[ci], float(first_probs[ci]), ce))

    best = min(results, key=lambda r: r[2])[0]
    return best, results


def _stateful_logits(engine: InferenceEngine, x_emb: torch.Tensor,
                     states: List[LayerState]) -> torch.Tensor:
    """Per-position logits of embeddings ``[B, T, C]`` continued from
    ``states``: ``[B, T, V]`` fp32, one decode step a position."""
    rcfg = engine.cfg.rwkv
    out = []
    for t in range(x_emb.shape[1]):
        logits, states = lm.lm_decode_step_embed(engine.params["rwkv"], rcfg, x_emb[:, t], states)
        out.append(logits)
    return torch.stack(out, 1)


# ---------------------------------------------------------------------------
# CLI (reference v6.0/rank_answer.py __main__): candidates are a shared json
# list; each question is prefilled once and the top-k candidates re-scored by
# per-candidate CE from replicated states.
# ---------------------------------------------------------------------------


def main(argv=None):
    import json
    import logging
    from pathlib import Path

    from visualrwkv_torch.data.tokenizer import get_tokenizer
    from visualrwkv_torch.evals.cli import build_argparser, build_engine
    from visualrwkv_torch.evals.loaders import get_chunk, get_question_id, load_questions
    from visualrwkv_torch.evals.runner import (
        build_image_dict,
        bucket_pad_ids,
        prepare_question,
        tower_image_sizes,
    )

    logging.basicConfig(level=logging.INFO)
    p = build_argparser()
    p.add_argument("--candidates_file", required=True,
                   help="json list of candidate answers (shared across questions)")
    p.add_argument("--topk", default=5, type=int)
    args = p.parse_args(argv)

    with open(args.candidates_file) as f:
        candidates = json.load(f)
    engine, cfg = build_engine(args)
    tok = get_tokenizer()
    questions = get_chunk(load_questions(args.question_file), args.num_chunks, args.chunk_idx)
    sizes = tower_image_sizes(cfg)
    out_path = Path(args.output_file)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        for line in questions:
            item = prepare_question(line, tok, cfg, 1, args.dataset_name)
            ids = bucket_pad_ids(item["input_ids"], args.length_bucket)[None, :]
            images = build_image_dict(line, Path(args.image_folder), sizes, args.image_strategy)
            best, ranked = rank_candidates(
                engine, tok, ids, images=images, candidates=candidates, k=args.topk
            )
            f.write(json.dumps({
                "question_id": get_question_id(line),
                "prompt": item["input_text"],
                "text": best,
                "candidates": [
                    {"text": c, "first_prob": p_, "ce": ce} for c, p_, ce in ranked
                ],
                "model_id": "visualrwkv_torch",
            }, ensure_ascii=False) + "\n")
            f.flush()


if __name__ == "__main__":
    main()
