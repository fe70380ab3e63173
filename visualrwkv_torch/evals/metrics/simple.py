"""Simple / per-benchmark scorers.

Own implementations of the public protocols the reference ports in eval/
(eval_pope.py, eval_science_qa.py, eval_gqa.py accuracy, visualrwkv_eval.py,
MME scoring in eval_your_results.py-style tools).

The port's own copy of ``visualrwkv_tpu/evals/metrics/simple.py`` (host code, no torch).
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from visualrwkv_torch.evals.metrics.vqa import normalize_answer


# -- POPE (yes/no hallucination probe): F1 / precision / recall / yes-ratio ---

def _to_yes_no(text: str) -> str:
    # reference eval_pope.py:10-20: keep only the first sentence, drop
    # commas, split on single spaces, then token membership ('No'/'not'/'no')
    if "." in text:
        text = text.split(".")[0]
    text = text.replace(",", "")
    words = text.split(" ")
    if "No" in words or "not" in words or "no" in words:
        return "no"
    return "yes"


def evaluate_pope(records: Iterable[Dict]) -> Dict[str, float]:
    """records: {'text': model output, 'label': 'yes'|'no'}."""
    tp = tn = fp = fn = 0
    yes = total = 0
    for r in records:
        pred = _to_yes_no(r["text"])
        label = r["label"].strip().lower()
        total += 1
        yes += pred == "yes"
        if pred == "yes" and label == "yes":
            tp += 1
        elif pred == "no" and label == "no":
            tn += 1
        elif pred == "yes" and label == "no":
            fp += 1
        else:
            fn += 1
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return {
        "accuracy": 100.0 * (tp + tn) / max(total, 1),
        "precision": 100.0 * precision,
        "recall": 100.0 * recall,
        "f1": 100.0 * f1,
        "yes_ratio": 100.0 * yes / max(total, 1),
        "n": total,
    }


# -- ScienceQA: option-letter accuracy ----------------------------------------

_OPTION_RE = re.compile(r"\b([A-E])\b")


def parse_option_letter(text: str, choices: Optional[List[str]] = None) -> str:
    """Extract the predicted option letter; fall back to matching choice text."""
    m = _OPTION_RE.search(text.strip())
    if m:
        return m.group(1)
    if choices:
        norm = normalize_answer(text)
        for i, c in enumerate(choices):
            if normalize_answer(c) == norm:
                return chr(ord("A") + i)
    return "?"


def evaluate_scienceqa(records: Iterable[Dict]) -> Dict[str, float]:
    """records: {'text': output, 'answer': int index, 'choices': [str, ...]}."""
    correct = total = 0
    failures = []
    for r in records:
        pred = parse_option_letter(r["text"], r.get("choices"))
        gold = chr(ord("A") + int(r["answer"]))
        total += 1
        if pred == gold:
            correct += 1
        else:
            failures.append(r.get("question_id"))
    return {"accuracy": 100.0 * correct / max(total, 1), "n": total,
            "failures": failures}


# -- GQA: exact-match accuracy after normalization ----------------------------

def evaluate_gqa(records: Iterable[Dict]) -> Dict[str, float]:
    """records: {'text'|'pred': output, 'answer': gold}."""
    correct = total = 0
    for r in records:
        pred = normalize_answer(r.get("pred", r.get("text", "")))
        gold = normalize_answer(r["answer"])
        total += 1
        correct += pred == gold
    return {"accuracy": 100.0 * correct / max(total, 1), "n": total}


# -- Generic accuracy + badcases (visualrwkv_eval.py equivalent) ---------------

def evaluate_exact(records: Iterable[Dict]) -> Dict:
    correct = total = 0
    badcases = []
    for r in records:
        pred = normalize_answer(r.get("pred", r.get("text", "")))
        gold = normalize_answer(r["answer"])
        total += 1
        if pred == gold:
            correct += 1
        else:
            badcases.append(r)
    return {"accuracy": 100.0 * correct / max(total, 1), "n": total,
            "badcases": badcases}


# -- MME: per-category acc + acc+ (pairwise) ----------------------------------

def evaluate_mme(records: Iterable[Dict]) -> Dict[str, Dict[str, float]]:
    """records: {'category', 'image', 'text' (yes/no output), 'label'}.

    MME score per category = accuracy + accuracy+ (both questions of an image
    correct), in percent; plus perception/cognition totals if categories known.
    """
    by_cat_img: Dict[Tuple[str, str], List[bool]] = defaultdict(list)
    by_cat: Dict[str, List[bool]] = defaultdict(list)
    for r in records:
        ok = _to_yes_no(r["text"]) == r["label"].strip().lower()
        by_cat[(r["category"])].append(ok)
        by_cat_img[(r["category"], r["image"])].append(ok)
    out = {}
    for cat, oks in by_cat.items():
        acc = 100.0 * sum(oks) / max(len(oks), 1)
        pair_ok = [all(v) for (c, _), v in by_cat_img.items() if c == cat]
        acc_plus = 100.0 * sum(pair_ok) / max(len(pair_ok), 1)
        out[cat] = {"acc": acc, "acc_plus": acc_plus, "score": acc + acc_plus}
    out["total"] = {"score": sum(v["score"] for k, v in out.items() if k != "total")}
    return out
