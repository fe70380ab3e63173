"""Benchmark evaluation runner. Counterpart of
``visualrwkv_tpu/evals/runner.py``.

The reference's evaluate.py (SURVEY §3.2) decodes one question at a time and
re-runs the full prefix per generated token. This runner uses the O(1)-state
engine: one prefill a batch of questions, then one-token decode steps;
multi-process sharding is the same ``--num_chunks/--chunk_idx`` protocol.

Output is the reference's self-describing jsonl (question_id / prompt / text /
avg_logit / geometric-mean avg_prob / model_id / metadata, evaluate.py:218-228),
so the reference's downstream scorers and submission converters work unchanged.

The work of one batch (ids and numpy image arrays in, records out) is
:func:`eval_batch`; :func:`run_eval` adds the question files, the pixel
decoding (PIL) and the grouping around it.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from visualrwkv_torch.config import STOP_TOKEN_INDEX, VLMConfig
from visualrwkv_torch.data.conversation import (
    DEFAULT_STOP_TOKEN,
    preprocess,
    process_image_tokens_in_conversations,
)
from visualrwkv_torch.data.tiling import (
    load_video_frame_paths,
    n_tiles_for_size,
    sample_video_frames,
    single_to_multi_images,
)
from visualrwkv_torch.evals.loaders import get_input_text, get_question_id
from visualrwkv_torch.infer.engine import GenerateResult, InferenceEngine

log = logging.getLogger(__name__)


def tower_image_sizes(cfg: VLMConfig) -> Dict[str, int]:
    """The square side each tower's pixels are resized to."""
    return {t: (cfg.vision.sam_image_size if t == "sam" else cfg.vision.image_size)
            for t in cfg.vision.towers}


def _pil_to_tower_arrays(images: List, sizes: Dict[str, int]) -> Dict[str, np.ndarray]:
    from PIL import Image

    out: Dict[str, List[np.ndarray]] = {t: [] for t in sizes}
    for img in images:
        for t, size in sizes.items():
            out[t].append(np.asarray(img.resize((size, size), Image.BICUBIC), np.uint8))
    return {t: np.stack(v) for t, v in out.items()}


def build_image_dict(
    line: Dict,
    image_folder: Optional[Path],
    sizes: Dict[str, int],
    strategy: str = "single",
) -> Dict[str, np.ndarray]:
    """single | multi (tile strategy) | video (uniform frames) | uhd (the
    global view and 2x2 tiles): uint8 ``[n_images, S, S, 3]`` a tower.

    (reference evaluate.py:80-137)
    """
    from PIL import Image

    if strategy == "video":
        frames = load_video_frame_paths(Path(image_folder) / line["video"])
        n = _video_frame_count(line, frames)
        paths = sample_video_frames(frames, n)
        images = [Image.open(p).convert("RGB") for p in paths]
    elif strategy == "uhd":
        from visualrwkv_torch.multimodal.uhd import uhd_image_to_tiles

        img = Image.open(Path(image_folder) / line["image"]).convert("RGB")
        images = uhd_image_to_tiles(img)  # [global, tl, tr, bl, br]
    else:
        img = Image.open(Path(image_folder) / line["image"]).convert("RGB")
        images = single_to_multi_images(img) if strategy == "multi" else [img]
    return _pil_to_tower_arrays(images, sizes)


def prepare_question(
    line: Dict,
    tokenizer,
    cfg: VLMConfig,
    num_images: int,
    dataset_name: str = "",
) -> Dict:
    """A question -> ``{"input_ids", "labels", "input_text"}``: its images
    placed by ``cfg.image_position``, the assistant's turn left open."""
    text = get_input_text(line, num_images, dataset_name)
    conversations = [
        {"from": "human", "value": text},
        {"from": "gpt", "value": ""},
    ]
    conversations = process_image_tokens_in_conversations(
        conversations, num_images, cfg.image_position
    )
    return preprocess(
        conversations,
        tokenizer,
        has_image=True,
        ctx_len=cfg.rwkv.ctx_len,
        num_token_per_image=cfg.num_token_per_image,
        do_pad_to_max_length=False,
    )


def bucket_pad_ids(input_ids: np.ndarray, bucket: int = 64) -> np.ndarray:
    """Left-pad prompt ids with EOS to the next length bucket.

    EOS left-padding is the model's own chunk-padding semantics (reference
    RWKV.forward, src/model.py:286-312), so questions of one bucket batch
    together whatever their own lengths."""
    T = input_ids.shape[-1]
    target = max(bucket, -(-T // bucket) * bucket)
    pad = target - T
    if pad == 0:
        return input_ids
    return np.concatenate(
        [np.full(input_ids.shape[:-1] + (pad,), STOP_TOKEN_INDEX, input_ids.dtype),
         input_ids], axis=-1,
    )


def _video_frame_count(line: Dict, frames) -> int:
    """Frames to sample for a video question: min(prompt's <image> count,
    available frames). Fails loudly at zero so the prompt and the pixel
    batch can never disagree (they both derive from this function)."""
    count = line["text"].count("<image>")
    if count == 0 or not frames:
        raise ValueError(
            f"video question {line.get('question_id')!r}: "
            f"{count} <image> tags, {len(frames)} frames on disk"
        )
    return min(count, len(frames))


def n_images_for_strategy(line: Dict, image_folder: Optional[Path], strategy: str) -> int:
    """Images-per-sample for a question WITHOUT decoding pixels (PIL.open is
    header-lazy), so batching keys can be derived cheaply."""
    if strategy == "video":
        frames = load_video_frame_paths(Path(image_folder) / line["video"])
        return _video_frame_count(line, frames)
    if strategy == "uhd":
        return 5  # global + 2x2 tiles
    if strategy == "multi":
        from PIL import Image

        with Image.open(Path(image_folder) / line["image"]) as img:
            return n_tiles_for_size(img.size)
    return 1


@torch.no_grad()
def eval_batch(
    engine: InferenceEngine,
    tokenizer,
    ids: np.ndarray,
    images: Optional[Dict[str, np.ndarray]],
    lines: Sequence[Dict],
    prompts: Sequence[str],
    max_new_tokens: int = 128,
    model_id: str = "visualrwkv_torch",
) -> Tuple[List[Dict], GenerateResult]:
    """One batch of questions: prompt ids ``[B, T]`` (one length bucket)
    and uint8 images ``[B * n_images, S, S, 3]`` a tower (``None`` for a
    text prompt) -> one greedy ``engine.generate`` -> a result record a
    row, in the reference's schema, and the generation itself."""
    res = engine.generate(
        ids,
        images=images,
        max_new_tokens=max_new_tokens,
        do_sample=False,
        stop_tokens=(0, STOP_TOKEN_INDEX),
    )
    records = []
    for row, (line, prompt) in enumerate(zip(lines, prompts)):
        n = int(res.lengths[row])  # generated tokens, the stop token included
        text = tokenizer.decode([int(t) for t in res.tokens[row][:n]]).split(DEFAULT_STOP_TOKEN)[0].strip()
        logits = res.logits[row][: max(n, 1)]
        probs = res.probs[row][: max(n, 1)]
        avg_logit = float(np.mean(logits))
        avg_prob = float(np.prod(probs) ** (1.0 / len(probs)))  # the geometric mean
        records.append({
            "question_id": get_question_id(line),
            "prompt": prompt,
            "text": text,
            "avg_logit": str(round(avg_logit, 3)),
            "avg_prob": str(round(avg_prob, 3)),
            "model_id": model_id,
            "metadata": {**line.get("metadata", {}), "image_file": line.get("image")},
        })
    return records, res


def run_eval(
    engine: InferenceEngine,
    tokenizer,
    questions: List[Dict],
    image_folder: Optional[str],
    output_file: str,
    dataset_name: str = "",
    image_strategy: str = "single",
    max_new_tokens: int = 128,
    model_id: str = "visualrwkv_torch",
    tower_sizes: Optional[Dict[str, int]] = None,
    progress: bool = True,
    length_bucket: int = 16,
    batch_size: int = 1,
) -> List[Dict]:
    """Evaluate questions, write the jsonl, return the result records.

    ``batch_size > 1`` groups questions whose (bucketed prompt length,
    images-per-sample) match and decodes them together. Records stream to
    the file as each batch completes (a crash keeps the finished answers);
    on success the file is rewritten in the original question order."""
    cfg = engine.cfg
    sizes = tower_sizes or tower_image_sizes(cfg)
    out_path = Path(output_file)
    out_path.parent.mkdir(parents=True, exist_ok=True)

    # pass 1: tokenize (cheap, no pixel decode) to derive grouping keys
    prepared = []
    for i, line in enumerate(questions):
        if "image" not in line and "video" not in line:
            continue
        n_img = n_images_for_strategy(line, Path(image_folder), image_strategy)
        item = prepare_question(line, tokenizer, cfg, n_img, dataset_name)
        ids = bucket_pad_ids(item["input_ids"], length_bucket)
        prepared.append(
            {"order": i, "line": line, "item": item, "ids": np.asarray(ids), "n_img": n_img}
        )

    groups: Dict[tuple, List[dict]] = {}
    for q in prepared:
        groups.setdefault((q["ids"].shape[-1], q["n_img"]), []).append(q)

    records: Dict[int, Dict] = {}
    done = 0
    bs = max(1, batch_size)
    with open(out_path, "w") as partial:
        for queue in groups.values():
            for start in range(0, len(queue), bs):
                chunk = queue[start : start + bs]
                per_tower: Dict[str, List[np.ndarray]] = {}
                for q in chunk:
                    imgs = build_image_dict(q["line"], Path(image_folder), sizes, image_strategy)
                    for t, v in imgs.items():
                        per_tower.setdefault(t, []).append(v)
                recs, _ = eval_batch(
                    engine, tokenizer, np.stack([q["ids"] for q in chunk]),
                    {t: np.concatenate(v, axis=0) for t, v in per_tower.items()},
                    [q["line"] for q in chunk], [q["item"]["input_text"] for q in chunk],
                    max_new_tokens=max_new_tokens, model_id=model_id,
                )
                for q, rec in zip(chunk, recs):
                    records[q["order"]] = rec
                    partial.write(json.dumps(rec, ensure_ascii=False) + "\n")
                partial.flush()
                done += len(chunk)
                if progress:
                    log.info("eval %d/%d", done, len(prepared))

    results = [records[k] for k in sorted(records)]
    with open(out_path, "w") as f:
        for rec in results:
            f.write(json.dumps(rec, ensure_ascii=False) + "\n")
    return results
