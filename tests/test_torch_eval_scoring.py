"""The port's copies of the benchmark scorers, metrics and submission
converters (``visualrwkv_torch.evals.{score,converters,metrics}``) against the
JAX package's: every metric function on the same inputs, and every
``score.py`` task on small result files written here, printing the same
lines and writing the same files.

``mmbench-convert`` has no case: it writes an xlsx through ``openpyxl``,
which this environment lacks; its code is the JAX package's, copied."""

import json

import pytest

import torch_port_helpers  # noqa: F401  (caps torch's CPU threads)
from visualrwkv_torch.evals import score as pscore
from visualrwkv_torch.evals.metrics import gqa as pgqa
from visualrwkv_torch.evals.metrics import interleave as pinterleave
from visualrwkv_torch.evals.metrics import m4c as pm4c
from visualrwkv_torch.evals.metrics import simple as psimple
from visualrwkv_torch.evals.metrics import videomme as pvideomme
from visualrwkv_torch.evals.metrics import vqa as pvqa
from visualrwkv_tpu.evals import score as jscore
from visualrwkv_tpu.evals.metrics import gqa as jgqa
from visualrwkv_tpu.evals.metrics import interleave as jinterleave
from visualrwkv_tpu.evals.metrics import m4c as jm4c
from visualrwkv_tpu.evals.metrics import simple as jsimple
from visualrwkv_tpu.evals.metrics import videomme as jvideomme
from visualrwkv_tpu.evals.metrics import vqa as jvqa

GT10 = ["yes"] * 4 + ["no"] * 6
PRED_GT = [{"pred_answer": "The Cat", "gt_answers": ["cat"] * 3 + ["dog"] * 7},
           {"pred_answer": "hello", "gt_answers": ["hallo"] * 10},
           {"pred_answer": "two dogs", "gt_answers": ["2 dogs"] * 5 + ["dogs"] * 5}]
GQA_QUESTIONS = {
    "q1": {"answer": "yes", "types": {"structural": "verify"}, "entailed": ["q2"]},
    "q2": {"answer": "cat", "types": {"structural": "query"}, "entailed": []},
    "q3": {"answer": "no", "types": {"structural": "verify"}, "entailed": []},
}
VIDEOMME_RESULTS = [
    {"duration": "short", "domain": "Knowledge", "sub_category": "Law", "questions": [
        {"task_type": "OCR Problems", "answer": "A", "response": "A."},
        {"task_type": "OCR Problems", "answer": "B", "response": "The answer is C"},
        {"task_type": "Counting Problem", "answer": "D", "response": "no idea " * 12}]},
    {"duration": "long", "domain": "Life Record", "sub_category": "Travel", "questions": [
        {"task_type": "Action Reasoning", "answer": "B", "response": "B"}]},
]

# (module name, function name, positional arguments)
METRIC_CASES = [
    ("vqa", "process_punctuation", ("Hello, world! It's 3.5",)),
    ("vqa", "process_digit_article", ("the two dogs isnt here",)),
    ("vqa", "normalize_answer", ("The TWO dogs.",)),
    ("vqa", "vqa_accuracy", ("no", GT10)),
    ("vqa", "evaluate_vqa", ({"a": "yes", "b": "3"}, {"a": ["yes"] * 10, "b": ["2"] * 10},
                             {"a": "is there", "b": "how many"}, {"a": "yes/no", "b": "number"})),
    ("vqa", "textvqa_accuracy", (PRED_GT,)),
    ("m4c", "evalai_process", ("The cat's bowl?",)),
    ("m4c", "textvqa_soft_accuracy", (PRED_GT,)),
    ("m4c", "stvqa_accuracy", (PRED_GT,)),
    ("m4c", "stvqa_anls", (PRED_GT,)),
    ("m4c", "prompt_to_question", ("User: Context here\n<image>\nWhat shape?\n\nAssistant:",)),
    ("simple", "evaluate_pope", ([{"text": "Yes, it is.", "label": "yes"}, {"text": "No.", "label": "no"},
                                  {"text": "Yes.", "label": "no"},
                                  {"text": "There is not a dog.", "label": "no"}],)),
    ("simple", "parse_option_letter", ("The answer is (D).", ["a", "b", "c", "d"])),
    ("simple", "evaluate_scienceqa", ([{"text": "B", "answer": 1, "choices": ["x", "y"], "question_id": 1},
                                       {"text": "blue", "answer": 0, "choices": ["blue", "red"],
                                        "question_id": 3},
                                       {"text": "nope", "answer": 0, "choices": ["blue", "red"],
                                        "question_id": 4}],)),
    ("simple", "evaluate_gqa", ([{"text": "A cat", "answer": "cat"}, {"text": "dog", "answer": "cat"}],)),
    ("simple", "evaluate_exact", ([{"text": "Cat", "answer": "cat"}, {"pred": "bird", "answer": "dog"}],)),
    ("simple", "evaluate_mme", ([{"category": "color", "image": "1.jpg", "text": "yes", "label": "yes"},
                                 {"category": "color", "image": "1.jpg", "text": "no", "label": "no"},
                                 {"category": "color", "image": "2.jpg", "text": "yes", "label": "no"},
                                 {"category": "count", "image": "3.jpg", "text": "no", "label": "no"}],)),
    ("gqa", "evaluate_gqa_detailed", ({"q1": "yes", "q2": "cat", "q3": "yes"}, GQA_QUESTIONS,
                                      {"q2": ["cat", "dog"]}, {"q2": ["cat"]})),
    ("interleave", "rouge_l", ("a cat sat on the mat", "the cat sat on a red mat")),
    ("interleave", "evaluate_interleave", ([{"task": "multi-choice", "text": "A", "answer": "A"},
                                            {"task": "caption", "text": "a dog runs in the park",
                                             "answer": "the dog is running in a park"},
                                            {"text": "yes", "answer": "no"}],)),
    ("interleave", "summarize_results", ({"pope": {"f1": 80.0, "n": 4}, "mme": {"score": 125.5}},)),
    ("videomme", "extract_answer_letter", ("Answer: (B) the dog",)),
    ("videomme", "evaluate_videomme", (VIDEOMME_RESULTS,)),
]
PORT = {"vqa": pvqa, "m4c": pm4c, "simple": psimple, "gqa": pgqa, "interleave": pinterleave,
        "videomme": pvideomme}
JAX = {"vqa": jvqa, "m4c": jm4c, "simple": jsimple, "gqa": jgqa, "interleave": jinterleave,
       "videomme": jvideomme}


def test_every_metric_function_is_covered():
    """Each public function of the JAX package's metrics modules has a case."""
    import inspect

    have = {(m, f) for m, f, _ in METRIC_CASES} | {("m4c", "eval_textvqa_file")}  # the textvqa task's
    for m, mod in JAX.items():
        for name, fn in inspect.getmembers(mod, inspect.isfunction):
            if fn.__module__ == mod.__name__ and not name.startswith("_"):
                assert (m, name) in have, (m, name)
                assert hasattr(PORT[m], name), (m, name)


@pytest.mark.parametrize("module,fn,args", METRIC_CASES, ids=[f"{m}.{f}" for m, f, _ in METRIC_CASES])
def test_metric_equals_jax(module, fn, args):
    assert getattr(PORT[module], fn)(*args) == getattr(JAX[module], fn)(*args)


def _write_jsonl(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def _case_textvqa(d):
    (d / "ann.json").write_text(json.dumps({"data": [
        {"image_id": "q1", "question": "What color?", "answers": ["red"] * 10},
        {"image_id": "q2", "question": "What animal?", "answers": ["cat"] * 5 + ["dog"] * 5}]}))
    _write_jsonl(d / "res.jsonl", [
        {"question_id": "q1", "prompt": "User: <image>\nWhat color?\n\nAssistant:", "text": "Red."},
        {"question_id": "q2", "prompt": "User: <image>\nWhat animal?\n\nAssistant:", "text": "cat"}])
    return ["textvqa", "--result-file", str(d / "res.jsonl"), "--annotation-file", str(d / "ann.json")]


def _pope_files(d):
    _write_jsonl(d / "q.jsonl", [{"question_id": i, "category": "popular", "label": lbl,
                                  "text": "is there a cat?"}
                                 for i, lbl in enumerate(("yes", "no", "no", "yes"))])
    _write_jsonl(d / "r.jsonl", [{"question_id": 0, "text": "Yes, there is."}, {"question_id": 1, "text": "No."},
                                 {"question_id": 2, "text": "Yes."}, {"question_id": 3, "text": "Yes it is."}])
    return ["pope", "--result-file", str(d / "r.jsonl"), "--question-file", str(d / "q.jsonl")]


def _case_pope(d):
    ann = d / "coco"
    ann.mkdir()
    _write_jsonl(ann / "coco_pope_popular.json", [{"label": x} for x in ("yes", "no", "no", "yes")])
    return _pope_files(d) + ["--annotation-dir", str(ann)]


def _case_scienceqa(d):
    (d / "pid_splits.json").write_text(json.dumps({"test": ["p1", "p2"]}))
    (d / "problems.json").write_text(json.dumps({"p1": {"answer": 0, "choices": ["cat", "dog"]},
                                                 "p2": {"answer": 1, "choices": ["red", "blue"]}}))
    _write_jsonl(d / "r.jsonl", [{"question_id": "p1", "text": "A"}, {"question_id": "p2", "text": "A"}])
    return ["scienceqa", "--result-file", str(d / "r.jsonl"), "--base-dir", str(d), "--split", "test",
            "--output-result", str(d / "out.json")]


def _case_scienceqa_joined(d):
    _write_jsonl(d / "r.jsonl", [{"question_id": 1, "text": "B", "answer": 1, "choices": ["x", "y"]},
                                 {"question_id": 2, "text": "nope", "answer": 0, "choices": ["x", "y"]}])
    return ["scienceqa", "--result-file", str(d / "r.jsonl")]


def _case_gqa(d):
    _write_jsonl(d / "q.jsonl", [{"question_id": 1, "answer": "cat"}, {"question_id": 2, "answer": "dog"}])
    _write_jsonl(d / "r.jsonl", [{"question_id": 1, "text": "A cat"}, {"question_id": 2, "text": "bird"}])
    return ["gqa", "--result-file", str(d / "r.jsonl"), "--question-file", str(d / "q.jsonl")]


def _case_gqa_detailed(d):
    (d / "gqa.json").write_text(json.dumps(GQA_QUESTIONS))
    _write_jsonl(d / "r.jsonl", [{"question_id": "q1", "text": "yes"}, {"question_id": "q2", "text": "cat"},
                                 {"question_id": "q3", "text": "yes"}])
    return ["gqa", "--result-file", str(d / "r.jsonl"), "--gqa-questions-json", str(d / "gqa.json")]


def _case_mme(d):
    _write_jsonl(d / "q.jsonl", [
        {"question_id": i, "category": "color", "image": f"i{i // 2}.jpg", "label": ("yes", "no")[i % 2]}
        for i in range(4)])
    _write_jsonl(d / "r.jsonl", [{"question_id": i, "text": t} for i, t in enumerate(("Yes", "No", "Yes", "Yes"))])
    return ["mme", "--result-file", str(d / "r.jsonl"), "--question-file", str(d / "q.jsonl")]


def _case_interleave(d):
    _write_jsonl(d / "q.jsonl", [{"question_id": 1, "answer": "A", "task": "multi-choice"},
                                 {"question_id": 2, "answer": "the dog is running in a park", "task": "caption"}])
    _write_jsonl(d / "r.jsonl", [{"question_id": 1, "text": "A"}, {"question_id": 2, "text": "a dog runs"}])
    return ["interleave", "--result-file", str(d / "r.jsonl"), "--question-file", str(d / "q.jsonl")]


def _case_anls(d):
    (d / "ann.json").write_text(json.dumps({"data": [{"questionId": 7, "answers": ["hallo"]},
                                                     {"question_id": 8, "answers": ["world"]}]}))
    _write_jsonl(d / "r.jsonl", [{"question_id": 7, "text": "hello"}, {"question_id": 8, "text": "hello"}])
    return ["anls", "--result-file", str(d / "r.jsonl"), "--annotation-file", str(d / "ann.json")]


def _case_exact(d):
    _write_jsonl(d / "q.jsonl", [{"question_id": 1, "answer": "cat"}, {"question_id": 2, "answer": "dog"}])
    _write_jsonl(d / "r.jsonl", [{"question_id": 1, "text": "Cat"}, {"question_id": 2, "text": "bird"}])
    return ["exact", "--result-file", str(d / "r.jsonl"), "--question-file", str(d / "q.jsonl")]


def _case_videomme(d):
    (d / "res.json").write_text(json.dumps(VIDEOMME_RESULTS))
    return ["videomme", "--result-file", str(d / "res.json")]


def _answers(d):
    _write_jsonl(d / "a.jsonl", [{"question_id": 1, "text": "yes"}, {"question_id": 2, "text": "two dogs"}])
    return d / "a.jsonl"


def _case_vqav2_convert(d):
    return ["vqav2-convert", "--result-file", str(_answers(d)), "--output-file", str(d / "out.json")]


def _case_vizwiz_convert(d):
    (d / "test.json").write_text(json.dumps([{"image": "v1.jpg", "question_id": 2}, {"image": "v2.jpg", "id": 9},
                                             {"image": "v3.jpg"}]))
    return ["vizwiz-convert", "--result-file", str(_answers(d)), "--annotation-file", str(d / "test.json"),
            "--output-file", str(d / "out.json")]


def _case_mmvet_convert(d):
    return ["mmvet-convert", "--result-file", str(_answers(d)), "--output-file", str(d / "out.json")]


def _case_videomme_convert(d):
    (d / "q.json").write_text(json.dumps([
        {"video_id": "v1", "question_id": 1, "duration": "short", "task_type": "OCR", "question": "What?",
         "options": ["A. x", "B. y"], "answer": "A"},
        {"videoID": "v1", "id": 2, "answer": "B"}, {"video_id": "v2", "question_id": 3}]))
    return ["videomme-convert", "--result-file", str(_answers(d)), "--annotation-file", str(d / "q.json"),
            "--output-file", str(d / "out.json")]


# every task of score.TASKS but mmbench-convert (openpyxl), pope and scienceqa in both of their modes
SCORE_CASES = {"textvqa": _case_textvqa, "pope": _case_pope, "pope-no-annotation-dir": _pope_files,
               "scienceqa": _case_scienceqa, "scienceqa-joined": _case_scienceqa_joined, "gqa": _case_gqa,
               "gqa-detailed": _case_gqa_detailed, "mme": _case_mme, "interleave": _case_interleave,
               "anls": _case_anls, "exact": _case_exact, "videomme": _case_videomme,
               "vqav2-convert": _case_vqav2_convert, "vizwiz-convert": _case_vizwiz_convert,
               "mmvet-convert": _case_mmvet_convert, "videomme-convert": _case_videomme_convert}


def test_score_tasks_match_jax_tasks():
    assert sorted(pscore.TASKS) == sorted(jscore.TASKS)
    tasks = {name.split("-no-")[0].replace("-joined", "").replace("-detailed", "") for name in SCORE_CASES}
    assert tasks == set(jscore.TASKS) - {"mmbench-convert"}


@pytest.mark.parametrize("case", sorted(SCORE_CASES))
def test_score_task_equals_jax(case, tmp_path, capsys):
    """The port's ``score.main`` prints the JAX package's lines and writes
    the same files, on the same inputs."""
    argv = SCORE_CASES[case](tmp_path)
    outputs = [a for a in argv[1:] if a.startswith(str(tmp_path)) and a.endswith("out.json")]
    printed, written = [], []
    for main in (jscore.main, pscore.main):
        main(argv)
        printed.append(capsys.readouterr().out)
        written.append([open(p).read() for p in outputs])
    assert printed[0] == printed[1]
    assert written[0] == written[1]
    if not case.endswith("convert"):  # the metrics' JSON line comes last
        assert isinstance(json.loads(printed[1].strip().splitlines()[-1]), dict)


def test_loaders_equal_jax(tmp_path):
    """Question files (jsonl, json, tsv), sharding, ids and prompt text as
    the JAX package's loaders read them."""
    from visualrwkv_torch.evals import loaders as pl
    from visualrwkv_tpu.evals import loaders as jl

    recs = [{"question_id": i, "text": f"<image>\nq{i}", "image": f"{i}.jpg"} for i in range(7)]
    _write_jsonl(tmp_path / "q.jsonl", recs)
    (tmp_path / "q.json").write_text(json.dumps(recs))
    (tmp_path / "q.tsv").write_text("index\tquestion\tanswer\n0\tWhat?\tA\n1\tWhy?\tnan\n")
    for name in ("q.jsonl", "q.json", "q.tsv"):
        assert pl.load_questions(tmp_path / name) == jl.load_questions(tmp_path / name)
    with pytest.raises(ValueError):
        pl.load_questions(tmp_path / "q.csv")
    for n, i in ((1, 0), (3, 0), (3, 2), (7, 6)):
        assert pl.get_chunk(recs, n, i) == jl.get_chunk(recs, n, i)
    assert pl.split_list(recs, 4) == jl.split_list(recs, 4)
    for v in (None, float("nan"), "NaN", "none", "x", 0):
        assert pl.is_none(v) == jl.is_none(v)
    for line in ({"question_id": 3}, {"id": "a"}, {"index": 5}):
        assert pl.get_question_id(line) == jl.get_question_id(line)
    with pytest.raises(ValueError):
        pl.get_question_id({"text": "no id"})
    sqa = {"conversations": [{"value": "<image>\nWhich?\nA. x\nB. y"}]}
    for line, n, ds in ((recs[1], 2, ""), (sqa, 1, "scienceqa"), (sqa, 1, "")):
        assert pl.get_input_text(line, n, ds) == jl.get_input_text(line, n, ds)
