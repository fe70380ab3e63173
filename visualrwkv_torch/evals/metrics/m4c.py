"""EvalAI / m4c answer processing and TextVQA-family evaluators.

Behavioral port of the reference's m4c evaluator module
(VisualRWKV-v7/v7.00/eval/m4c_evaluator.py:37-340, itself derived from the
public facebookresearch/mmf EvalAI processor): the EvalAI processor differs
from the official VQA normalizer (metrics/vqa.py) by a pre-tokenize step —
lowercase, strip ``,``/``?``, split possessive ``'s`` — applied BEFORE
punctuation/number/article handling.  These details move TextVQA scores, so
TextVQA scoring goes through this processor, not the VQA one.

Protocol constants (contractions/number/article tables) are the public
EvalAI protocol shared with metrics/vqa.py.

The port's own copy of ``visualrwkv_tpu/evals/metrics/m4c.py`` (host code, no torch).
"""

from __future__ import annotations

import re
from typing import Dict, List

from visualrwkv_torch.evals.metrics.vqa import (
    ARTICLES,
    CONTRACTIONS,
    NUMBER_MAP,
    process_punctuation,
)


def _word_tokenize(word: str) -> str:
    word = word.lower()
    word = word.replace(",", "").replace("?", "").replace("'s", " 's")
    return word.strip()


def _digit_article(text: str) -> str:
    # reference order: number-map + article drop in one pass, contractions in
    # a SECOND pass over the kept words (m4c_evaluator.py:199-212)
    kept = []
    for w in text.lower().split():
        w = NUMBER_MAP.get(w, w)
        if w not in ARTICLES:
            kept.append(w)
    return " ".join(CONTRACTIONS.get(w, w) for w in kept)


def evalai_process(answer: str) -> str:
    """The EvalAIAnswerProcessor __call__ pipeline."""
    answer = _word_tokenize(answer)
    answer = answer.replace("\n", " ").replace("\t", " ").strip()
    answer = process_punctuation(answer)
    answer = _digit_article(answer)
    return answer


def textvqa_soft_accuracy(pred_list: List[Dict]) -> float:
    """TextVQAAccuracyEvaluator: VQA-style leave-one-out soft score over 10
    human answers, both sides EvalAI-processed. Records: {'pred_answer',
    'gt_answers' (exactly 10 strings)}. Returns accuracy in [0, 1]."""
    scores = []
    for entry in pred_list:
        pred = evalai_process(entry["pred_answer"])
        answers = [evalai_process(a) for a in entry["gt_answers"]]
        assert len(answers) == 10, "TextVQA protocol expects 10 human answers"
        gt = list(enumerate(answers))
        per_unique = {}
        for u in set(answers):
            accs = []
            for g in gt:
                others = [it for it in gt if it != g]
                matching = [it for it in others if it[1] == u]
                accs.append(min(1, float(len(matching)) / 3))
            per_unique[u] = sum(accs) / len(accs)
        scores.append(per_unique.get(pred, 0.0))
    return sum(scores) / max(len(scores), 1)


def stvqa_accuracy(pred_list: List[Dict]) -> float:
    """STVQAAccuracyEvaluator: exact (processed) membership in the gt set."""
    scores = [
        1.0
        if evalai_process(e["pred_answer"])
        in {evalai_process(a) for a in e["gt_answers"]}
        else 0.0
        for e in pred_list
    ]
    return sum(scores) / max(len(scores), 1)


def _edit_distance(s1: str, s2: str) -> int:
    """Levenshtein distance (pure python; the reference shells out to the
    editdistance package)."""
    if len(s1) < len(s2):
        s1, s2 = s2, s1
    prev = list(range(len(s2) + 1))
    for i, c1 in enumerate(s1):
        cur = [i + 1]
        for j, c2 in enumerate(s2):
            cur.append(min(prev[j + 1] + 1, cur[j] + 1, prev[j] + (c1 != c2)))
        prev = cur
    return prev[-1]


def stvqa_anls(pred_list: List[Dict]) -> float:
    """STVQAANLSEvaluator: average normalized Levenshtein similarity with the
    0.5 threshold (ST-VQA / DocVQA protocol)."""

    def anls(s1: str, s2: str) -> float:
        s1, s2 = s1.lower().strip(), s2.lower().strip()
        if max(len(s1), len(s2)) == 0:
            return 1.0
        iou = 1 - _edit_distance(s1, s2) / max(len(s1), len(s2))
        return iou if iou >= 0.5 else 0.0

    scores = [
        max(anls(e["pred_answer"], g) for g in e["gt_answers"]) for e in pred_list
    ]
    return sum(scores) / max(len(scores), 1)


# ---------------------------------------------------------------------------
# TextVQA file-level evaluation (reference eval/eval_textvqa.py)
# ---------------------------------------------------------------------------


def prompt_to_question(prompt: str) -> str:
    """Recover the raw question from an eval prompt, for joining predictions
    back to annotations (reference eval_textvqa.py:17-33; handles the OCR
    prompt format and all three image positions)."""
    if prompt.startswith("OCR tokens: "):
        match = re.search(r"Question: (.*?) Short answer:", prompt, re.DOTALL)
        question = match.group(1)
    elif prompt.startswith("User: <image>\n"):  # image_position: first
        question = prompt.split("\n")[1]
    elif "\n<image>\n" in prompt:
        if prompt.endswith("\n<image>\n\nAssistant:"):  # image_position: last
            question = prompt.split("\n")[0].split("User: ")[-1]
        else:  # image_position: middle
            question = prompt.split("\n<image>\n")[-1].split("\n")[0]
    else:
        raise ValueError(f"unrecognized prompt format: {prompt[:80]!r}")
    return question.lower()


def eval_textvqa_file(annotation_file: str, result_file: str) -> Dict[str, float]:
    """Join an answers jsonl against the TextVQA annotation json and score."""
    import json

    with open(annotation_file) as f:
        annotations = {
            (a["image_id"], a["question"].lower()): a
            for a in json.load(f)["data"]
        }
    with open(result_file) as f:
        results = [json.loads(line) for line in f if line.strip()]
    pred_list = []
    for r in results:
        a = annotations[(r["question_id"], prompt_to_question(r["prompt"]))]
        pred_list.append({"pred_answer": r["text"], "gt_answers": a["answers"]})
    return {
        "accuracy": 100.0 * textvqa_soft_accuracy(pred_list),
        "n": len(pred_list),
    }
