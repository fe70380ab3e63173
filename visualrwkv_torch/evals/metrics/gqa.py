"""GQA official-protocol scoring (reference eval/eval_gqa.py, 491 LoC port of
the public GQA eval): accuracy (overall / binary / open), consistency over
entailed questions, validity, plausibility, and per-structural-type breakdown.
Own implementation of the public protocol over the standard questions dict
({qid: {answer, entailed, equivalent, types: {structural, ...}, group, ...}}).

The port's own copy of ``visualrwkv_tpu/evals/metrics/gqa.py`` (host code, no torch).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Mapping, Optional

from visualrwkv_torch.evals.metrics.vqa import normalize_answer


def evaluate_gqa_detailed(
    predictions: Mapping[str, str],
    questions: Mapping[str, Dict],
    valid_answers: Optional[Mapping[str, List[str]]] = None,
    plausible_answers: Optional[Mapping[str, List[str]]] = None,
) -> Dict[str, float]:
    """predictions: qid -> predicted answer; questions: GQA questions dict.

    - accuracy: exact match after normalization (overall, binary yes/no
      questions, open questions, and per structural type);
    - consistency: among a question's ``entailed`` set, fraction answered
      correctly when the source question was answered correctly;
    - validity / plausibility: predicted answer appears in the per-question
      valid / plausible answer lists (when provided).
    """
    correct: Dict[str, bool] = {}
    acc_all: List[float] = []
    acc_binary: List[float] = []
    acc_open: List[float] = []
    by_structural = defaultdict(list)
    validity: List[float] = []
    plausibility: List[float] = []

    for qid, q in questions.items():
        pred = normalize_answer(predictions.get(qid, ""))
        gold = normalize_answer(q.get("answer", ""))
        ok = pred == gold
        correct[qid] = ok
        acc_all.append(float(ok))
        structural = (q.get("types") or {}).get("structural", "")
        by_structural[structural or "unknown"].append(float(ok))
        if gold in ("yes", "no"):
            acc_binary.append(float(ok))
        else:
            acc_open.append(float(ok))
        if valid_answers is not None and qid in valid_answers:
            validity.append(
                float(pred in {normalize_answer(a) for a in valid_answers[qid]})
            )
        if plausible_answers is not None and qid in plausible_answers:
            plausibility.append(
                float(pred in {normalize_answer(a) for a in plausible_answers[qid]})
            )

    cons_scores: List[float] = []
    for qid, q in questions.items():
        entailed = [e for e in q.get("entailed", []) if e in correct]
        if not entailed or not correct.get(qid, False):
            continue
        cons_scores.append(sum(correct[e] for e in entailed) / len(entailed))

    def pct(vals):
        return 100.0 * sum(vals) / len(vals) if vals else float("nan")

    out = {
        "accuracy": pct(acc_all),
        "binary": pct(acc_binary),
        "open": pct(acc_open),
        "consistency": pct(cons_scores),
        "validity": pct(validity),
        "plausibility": pct(plausibility),
        "n": len(acc_all),
    }
    for st, vals in sorted(by_structural.items()):
        out[f"acc_{st}"] = pct(vals)
    return out
