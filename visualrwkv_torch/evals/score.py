"""Unified benchmark scoring CLI.

One entry point replacing the reference's per-benchmark scorer scripts
(VisualRWKV-v7/v7.00/eval/eval_{textvqa,pope,science_qa,gqa}.py, the MME
calculation tool, and the submission converters):

    python -m visualrwkv_torch.evals.score <task> --result-file R [task flags]

Tasks: textvqa, pope, scienceqa, gqa, mme, interleave, videomme, anls
(DocVQA / ST-VQA / InfographicVQA), exact, and the converters vqav2-convert,
vizwiz-convert, mmbench-convert, mmvet-convert, videomme-convert.
Prints one JSON line of metrics (and the reference's human-readable line).

The port's own copy of ``visualrwkv_tpu/evals/score.py`` (host code, no torch).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List


def _read_jsonl(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _emit(metrics: Dict, human: str = "") -> None:
    if human:
        print(human)
    print(json.dumps(metrics, ensure_ascii=False))


# ---------------------------------------------------------------------------


def score_textvqa(args) -> None:
    from visualrwkv_torch.evals.metrics.m4c import eval_textvqa_file

    m = eval_textvqa_file(args.annotation_file, args.result_file)
    _emit(m, "Task: TextVQA Samples: {} Accuracy: {:.2f}%".format(m["n"], m["accuracy"]))


def score_pope(args) -> None:
    """Per-category + overall POPE F1 (reference eval/eval_pope.py)."""
    from visualrwkv_torch.evals.metrics.simple import evaluate_pope

    questions = {q["question_id"]: q for q in _read_jsonl(args.question_file)}
    answers = _read_jsonl(args.result_file)
    out: Dict[str, Dict] = {}
    if args.annotation_dir:
        for fname in sorted(os.listdir(args.annotation_dir)):
            if not (fname.startswith("coco_pope_") and fname.endswith(".json")):
                continue
            category = fname[len("coco_pope_") : -len(".json")]
            labels = [
                json.loads(line)["label"]
                for line in open(os.path.join(args.annotation_dir, fname))
                if line.strip()
            ]
            cur = [
                a for a in answers
                if questions[a["question_id"]].get("category") == category
            ]
            if len(cur) != len(labels):
                # zip-order pairing is only sound on complete, in-order
                # results; fail loudly instead of mis-pairing silently
                raise ValueError(
                    f"POPE {category}: {len(cur)} answers vs {len(labels)} "
                    "annotation labels — results are incomplete or reordered "
                    "(stale chunk files? crashed eval shard?)"
                )
            recs = [
                {"text": a["text"], "label": lbl} for a, lbl in zip(cur, labels)
            ]
            out[category] = evaluate_pope(recs)
    else:
        recs = [
            {"text": a["text"], "label": questions[a["question_id"]]["label"]}
            for a in answers
        ]
        out["all"] = evaluate_pope(recs)
    for cat, m in out.items():
        print("Category: {}  F1: {:.3f}  acc: {:.3f}  yes: {:.3f}".format(
            cat, m["f1"], m["accuracy"], m["yes_ratio"]))
    overall_f1 = sum(m["f1"] for m in out.values()) / max(len(out), 1)
    _emit({"per_category": out, "f1": overall_f1})


def score_scienceqa(args) -> None:
    from visualrwkv_torch.evals.metrics.simple import evaluate_scienceqa

    predictions = _read_jsonl(args.result_file)
    if args.base_dir:
        # join against the ScienceQA problems tree (reference
        # eval_science_qa.py:50-57)
        split_indices = json.load(
            open(os.path.join(args.base_dir, "pid_splits.json"))
        )[args.split]
        problems = json.load(open(os.path.join(args.base_dir, "problems.json")))
        by_id = {p["question_id"]: p for p in predictions}
        records = []
        for idx in split_indices:
            prob = problems[idx]
            pred = by_id.get(idx, {"text": ""})
            records.append({
                "question_id": idx,
                "text": pred.get("text", ""),
                "answer": prob["answer"],
                "choices": prob.get("choices"),
            })
    else:
        records = predictions  # runner already joined answer/choices
    m = evaluate_scienceqa(records)
    failures = m.pop("failures", [])
    if args.output_result:
        with open(args.output_result, "w") as f:
            json.dump({"failures": failures, **m}, f)
    _emit(m, "Task: ScienceQA Samples: {} Accuracy: {:.2f}%".format(m["n"], m["accuracy"]))


def score_gqa(args) -> None:
    questions = {q["question_id"]: q for q in _read_jsonl(args.question_file)} \
        if args.question_file else {}
    answers = _read_jsonl(args.result_file)
    if args.gqa_questions_json:
        # detailed official-protocol scoring (accuracy/validity/plausibility/
        # consistency) against the GQA questions json
        from visualrwkv_torch.evals.metrics.gqa import evaluate_gqa_detailed

        gqa = json.load(open(args.gqa_questions_json))
        preds = {a["question_id"]: a["text"] for a in answers}
        m = evaluate_gqa_detailed(preds, gqa)
    else:
        from visualrwkv_torch.evals.metrics.simple import evaluate_gqa

        records = [
            {
                "text": a["text"],
                "answer": a.get("answer", questions.get(a["question_id"], {}).get("answer", "")),
            }
            for a in answers
        ]
        m = evaluate_gqa(records)
    _emit(m, "Task: GQA Samples: {} Accuracy: {:.2f}%".format(m.get("n", 0), m.get("accuracy", 0.0)))


def score_mme(args) -> None:
    """MME acc/acc+ per category (the MME eval_tool calculation)."""
    from visualrwkv_torch.evals.metrics.simple import evaluate_mme

    questions = {q["question_id"]: q for q in _read_jsonl(args.question_file)}
    records = []
    for a in _read_jsonl(args.result_file):
        q = questions[a["question_id"]]
        records.append({
            "category": q["category"],
            "image": q["image"],
            "text": a["text"],
            "label": q.get("label", q.get("answer", "")),
        })
    m = evaluate_mme(records)
    for cat, v in sorted(m.items()):
        if cat != "total":
            print("{}: acc {:.2f} acc+ {:.2f} score {:.2f}".format(
                cat, v["acc"], v["acc_plus"], v["score"]))
    _emit(m, "MME total score: {:.2f}".format(m["total"]["score"]))


def _join_gold(args, records: List[Dict]) -> List[Dict]:
    """Attach gold 'answer' (and 'task') from --question-file by question_id
    when the answers jsonl doesn't carry them."""
    if not args.question_file:
        return records
    questions = {q["question_id"]: q for q in _read_jsonl(args.question_file)}
    out = []
    for r in records:
        q = questions.get(r.get("question_id"), {})
        merged = {**{k: q[k] for k in ("answer", "task") if k in q}, **r}
        out.append(merged)
    return out


def score_interleave(args) -> None:
    from visualrwkv_torch.evals.metrics.interleave import evaluate_interleave

    m = evaluate_interleave(_join_gold(args, _read_jsonl(args.result_file)))
    _emit(m)


def score_anls(args) -> None:
    """DocVQA / ST-VQA / InfographicVQA ANLS over an annotation json whose
    records carry 'question_id' (or 'questionId') and 'answers'."""
    from visualrwkv_torch.evals.metrics.m4c import stvqa_anls

    ann = json.load(open(args.annotation_file))
    data = ann.get("data", ann)
    gts = {str(a.get("question_id", a.get("questionId"))): a["answers"] for a in data}
    pred_list = [
        {"pred_answer": r["text"], "gt_answers": gts[str(r["question_id"])]}
        for r in _read_jsonl(args.result_file)
        if str(r["question_id"]) in gts
    ]
    anls = 100.0 * stvqa_anls(pred_list)
    _emit({"anls": anls, "n": len(pred_list)},
          "ANLS: {:.2f} over {} samples".format(anls, len(pred_list)))


def score_exact(args) -> None:
    from visualrwkv_torch.evals.metrics.simple import evaluate_exact

    m = evaluate_exact(_join_gold(args, _read_jsonl(args.result_file)))
    m.pop("badcases", None)
    _emit(m, "Accuracy: {:.2f}%".format(m["accuracy"]))


def score_videomme(args) -> None:
    """Official Video-MME results-format scorer (eval_your_results.py):
    per-duration accuracy with category/sub-category/task breakdowns."""
    from visualrwkv_torch.evals.metrics.videomme import evaluate_videomme

    results = json.load(open(args.result_file))
    # NOTE: --split is the ScienceQA flag (default "test") — Video-MME uses
    # its own --video-types so the default scores ALL durations
    m = evaluate_videomme(results, video_types=args.video_types or None)
    for vt, d in m["by_duration"].items():
        print(f"Video type {vt}: overall {d['overall']:.1f}% "
              f"({d['correct']}/{d['answered']})")
    _emit(m, "Overall: {:.1f}%".format(m["overall"]))


def run_converter(args) -> None:
    from visualrwkv_torch.evals import converters as C

    task = args.task
    if task == "vqav2-convert":
        C.convert_vqav2_for_submission(args.result_file, args.output_file)
    elif task == "vizwiz-convert":
        C.convert_vizwiz_for_submission(args.result_file, args.annotation_file, args.output_file)
    elif task == "mmvet-convert":
        C.convert_mmvet_for_eval(args.result_file, args.output_file)
    elif task == "mmbench-convert":
        C.convert_mmbench_for_submission(args.result_file, args.annotation_file, args.output_file)
    elif task == "videomme-convert":
        C.convert_videomme_for_eval(args.result_file, args.annotation_file, args.output_file)
    else:
        raise SystemExit(f"unknown converter {task}")
    print("wrote", args.output_file)


TASKS = {
    "textvqa": score_textvqa,
    "pope": score_pope,
    "scienceqa": score_scienceqa,
    "gqa": score_gqa,
    "mme": score_mme,
    "interleave": score_interleave,
    "anls": score_anls,
    "exact": score_exact,
    "vqav2-convert": run_converter,
    "vizwiz-convert": run_converter,
    "mmvet-convert": run_converter,
    "mmbench-convert": run_converter,
    "videomme-convert": run_converter,
    "videomme": score_videomme,
}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("visualrwkv_torch.evals.score")
    p.add_argument("task", choices=sorted(TASKS))
    p.add_argument("--result-file", required=True)
    p.add_argument("--annotation-file", default="")
    p.add_argument("--annotation-dir", default="")
    p.add_argument("--question-file", default="")
    p.add_argument("--gqa-questions-json", default="")
    p.add_argument("--base-dir", default="")
    p.add_argument("--split", default="test")
    p.add_argument("--video-types", default="",
                   help="videomme: comma-sep durations (default: all)")
    p.add_argument("--output-file", default="")
    p.add_argument("--output-result", default="")
    return p


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    TASKS[args.task](args)


if __name__ == "__main__":
    main()
