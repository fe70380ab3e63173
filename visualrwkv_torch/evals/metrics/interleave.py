"""Multi-image / interleaved-task scoring (reference eval/eval_interleave.py):
per-task accuracy for choice-style subtasks and ROUGE-L-fluency for free-form
subtasks.  ROUGE-L implemented here (no external rouge dependency).

The port's own copy of ``visualrwkv_tpu/evals/metrics/interleave.py`` (host code, no torch).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List

from visualrwkv_torch.evals.metrics.vqa import normalize_answer


def _lcs(a: List[str], b: List[str]) -> int:
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(prediction: str, reference: str, beta: float = 1.2) -> float:
    p = normalize_answer(prediction).split()
    r = normalize_answer(reference).split()
    if not p or not r:
        return 0.0
    lcs = _lcs(p, r)
    prec = lcs / len(p)
    rec = lcs / len(r)
    if prec == 0 or rec == 0:
        return 0.0
    return (1 + beta**2) * prec * rec / (rec + beta**2 * prec)


ACCURACY_TASKS = {"multi-choice", "yes-no", "matching"}


def evaluate_interleave(records: Iterable[Dict]) -> Dict[str, float]:
    """records: {'task': str, 'text': prediction, 'answer': gold}.

    Choice-style tasks -> exact-match accuracy; generation tasks -> ROUGE-L.
    """
    acc_by_task = defaultdict(list)
    for r in records:
        task = r.get("task", "default")
        pred, gold = r.get("text", ""), r.get("answer", "")
        if task in ACCURACY_TASKS or len(normalize_answer(gold).split()) <= 2:
            score = float(normalize_answer(pred) == normalize_answer(gold))
        else:
            score = rouge_l(pred, gold)
        acc_by_task[task].append(score)
    out = {
        t: 100.0 * sum(v) / max(len(v), 1) for t, v in acc_by_task.items()
    }
    all_scores = [s for v in acc_by_task.values() for s in v]
    out["overall"] = 100.0 * sum(all_scores) / max(len(all_scores), 1)
    out["n"] = len(all_scores)
    return out


def summarize_results(metric_files: Dict[str, Dict]) -> str:
    """eval_your_results.py analog: one table over per-benchmark metric dicts."""
    lines = ["benchmark            metric        value", "-" * 44]
    for name, metrics in metric_files.items():
        for k, v in metrics.items():
            if isinstance(v, (int, float)) and k != "n":
                lines.append(f"{name:<20} {k:<13} {v:.2f}")
    return "\n".join(lines)
