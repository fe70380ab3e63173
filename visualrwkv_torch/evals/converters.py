"""Submission-format converters (reference eval/convert_*_for_submission.py,
eval/convert_gqa_for_eval.py, etc.): map our answers jsonl into each
benchmark's upload format.

The port's own copy of ``visualrwkv_tpu/evals/converters.py`` (host code, no torch).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List


def read_answers_jsonl(path) -> List[Dict]:
    return [json.loads(l) for l in open(path) if l.strip()]


def convert_vqav2_for_submission(answers_jsonl, out_json) -> None:
    """[{question_id: int, answer: str}] (official test-dev upload)."""
    recs = read_answers_jsonl(answers_jsonl)
    out = [{"question_id": int(r["question_id"]), "answer": r["text"]} for r in recs]
    json.dump(out, open(out_json, "w"))


def convert_gqa_for_eval(answers_jsonl, out_json) -> None:
    """[{questionId, prediction}] (official GQA eval input)."""
    recs = read_answers_jsonl(answers_jsonl)
    out = [{"questionId": str(r["question_id"]), "prediction": r["text"]} for r in recs]
    json.dump(out, open(out_json, "w"))


def convert_vizwiz_for_submission(answers_jsonl, test_json, out_json) -> None:
    """[{image, answer}] aligned to the test split order."""
    recs = {str(r["question_id"]): r["text"] for r in read_answers_jsonl(answers_jsonl)}
    test = json.load(open(test_json))
    out = [
        {"image": t["image"], "answer": recs.get(str(t.get("question_id", t.get("id", i))), "")}
        for i, t in enumerate(test)
    ]
    json.dump(out, open(out_json, "w"))


def convert_mmvet_for_eval(answers_jsonl, out_json) -> None:
    """{question_id: answer} dict."""
    recs = read_answers_jsonl(answers_jsonl)
    json.dump({str(r["question_id"]): r["text"] for r in recs}, open(out_json, "w"))


def convert_mmbench_for_submission(answers_jsonl, questions_tsv, out_xlsx) -> None:
    """MMBench xlsx upload: original tsv columns + a 'prediction' column."""
    import pandas as pd

    df = pd.read_table(questions_tsv)
    preds = {str(r["question_id"]): r["text"] for r in read_answers_jsonl(answers_jsonl)}
    df["prediction"] = [preds.get(str(i), "") for i in df["index"]]
    keep = [c for c in df.columns if c not in ("image",)]
    df[keep].to_excel(out_xlsx, index=False, engine="openpyxl")


def convert_videomme_for_eval(answers_jsonl, questions_json, out_json) -> None:
    """Video-MME grouped-by-video results json."""
    preds = {str(r["question_id"]): r["text"] for r in read_answers_jsonl(answers_jsonl)}
    questions = json.load(open(questions_json))
    by_video: Dict[str, Dict] = {}
    for q in questions:
        vid = q.get("video_id", q.get("videoID", ""))
        entry = by_video.setdefault(
            vid,
            {"video_id": vid, "duration": q.get("duration", ""), "domain": q.get("domain", ""),
             "sub_category": q.get("sub_category", ""), "questions": []},
        )
        qid = str(q.get("question_id", q.get("id")))
        entry["questions"].append(
            {"question_id": qid, "task_type": q.get("task_type", ""),
             "question": q.get("question", ""), "options": q.get("options", []),
             "answer": q.get("answer", ""), "response": preds.get(qid, "")}
        )
    json.dump(list(by_video.values()), open(out_json, "w"))
