"""Video-MME scorer (reference eval/eval_your_results.py:1-260).

Scores the official Video-MME results format: a list of video records, each
with "duration" (short/medium/long), "domain", "sub_category" and a
"questions" list carrying per-question "task_type", the ground-truth answer
letter and the model response. Accuracy is reported per duration split with
per-category / per-sub-category / per-task breakdowns, counting only
questions whose response yields an extractable A-D letter (the reference's
"answered" denominator).

The port's own copy of ``visualrwkv_tpu/evals/metrics/videomme.py`` (host code, no torch).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Union

# reference eval_your_results.py:7-62 (the official category taxonomies);
# kept for validation/reporting order but unknown labels are tallied too
CATEGORIES = [
    "Knowledge", "Film & Television", "Sports Competition",
    "Artistic Performance", "Life Record", "Multilingual",
]
TASK_CATEGORIES = [
    "Temporal Perception", "Spatial Perception", "Attribute Perception",
    "Action Recognition", "Object Recognition", "OCR Problems",
    "Counting Problem", "Temporal Reasoning", "Spatial Reasoning",
    "Action Reasoning", "Object Reasoning", "Information Synopsis",
]

_ANSWER_PREFIXES = [
    "The best answer is", "The correct answer is", "The answer is",
    "The answer", "The best option is" "The correct option is",
    "Best answer:" "Best option:", "Answer:", "Option:",
    "The correct answer", "The correct option",
]


def extract_answer_letter(s: str) -> str:
    """First A-D letter after stripping answer prefixes
    (eval_your_results.py:65-89, including its concatenated-prefix quirks);
    long answers with no letter count as unanswered ("")."""
    s = s.strip()
    for prefix in _ANSWER_PREFIXES:
        s = s.replace(prefix, "")
    if len(s.split()) > 10 and not re.search("[ABCD]", s):
        return ""
    m = re.search(r"[ABCD]", s)
    return m[0] if m else ""


def _acc(cell: Dict[str, int]) -> float:
    return 100.0 * cell["correct"] / cell["answered"] if cell["answered"] else 0.0


def evaluate_videomme(
    results: Sequence[Dict],
    video_types: Optional[Union[List[str], str]] = None,
    skip_missing: bool = False,
    gt_answer_key: str = "answer",
    your_answer_key: str = "response",
) -> Dict:
    """Per-duration accuracy breakdowns + overall (eval_your_results.py:92-260).

    Returns {"by_duration": {dur: {"overall", "categories", "sub_categories",
    "task_types", "answered", "correct"}}, "overall": float}.
    """
    if isinstance(video_types, str):
        video_types = video_types.split(",")
    if video_types is None:
        video_types = sorted({r.get("duration", "all") for r in results})

    out: Dict = {"by_duration": {}}
    total = {"correct": 0, "answered": 0}
    for vt in video_types:
        rows = [r for r in results if r.get("duration", "all") == vt]
        cats: Dict[str, Dict[str, int]] = {}
        subs: Dict[str, Dict[str, int]] = {}
        tasks: Dict[str, Dict[str, int]] = {}
        split = {"correct": 0, "answered": 0}
        for item in rows:
            if skip_missing and item.get("missing"):
                continue
            for q in item.get("questions", []):
                letter = extract_answer_letter(str(q.get(your_answer_key, "")))
                if not letter:
                    continue
                hit = int(letter == q.get(gt_answer_key))
                for table, key in (
                    (cats, item.get("domain", "?")),
                    (subs, item.get("sub_category", "?")),
                    (tasks, q.get("task_type", "?")),
                ):
                    cell = table.setdefault(key, {"correct": 0, "answered": 0})
                    cell["answered"] += 1
                    cell["correct"] += hit
                split["answered"] += 1
                split["correct"] += hit
        out["by_duration"][vt] = {
            "overall": _acc(split),
            "answered": split["answered"],
            "correct": split["correct"],
            "categories": {k: _acc(v) for k, v in cats.items()},
            "sub_categories": {k: _acc(v) for k, v in subs.items()},
            "task_types": {k: _acc(v) for k, v in tasks.items()},
        }
        total["correct"] += split["correct"]
        total["answered"] += split["answered"]
    out["overall"] = _acc(total)
    out["answered"] = total["answered"]
    return out
