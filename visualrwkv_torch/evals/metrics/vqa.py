"""VQA answer normalization + accuracy (the official VQAv2 protocol).

Own implementation of the public VQA evaluation protocol (the reference ports
the official scripts at eval/eval_vqa.py and eval/m4c_evaluator.py): answers
are normalized (contractions, number words, articles, punctuation) and scored
``min(#matching human answers / 3, 1)`` averaged over the 10 leave-one-out
subsets.  The same processor drives TextVQA (EvalAI-style) scoring.

The port's own copy of ``visualrwkv_tpu/evals/metrics/vqa.py`` (host code, no torch).
"""

from __future__ import annotations

import re
from typing import Dict, List

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hadnt've": "hadn't've", "hadn'tve": "hadn't've", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've",
    "itll": "it'll", "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
    "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't",
    "wed've": "we'd've", "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's", "whatve": "what've",
    "whens": "when's", "whered": "where'd", "wheres": "where's",
    "whereve": "where've", "whod": "who'd", "whod've": "who'd've",
    "who'dve": "who'd've", "wholl": "who'll", "whos": "who's", "whove": "who've",
    "whyll": "why'll", "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't", "wouldnt've": "wouldn't've",
    "wouldn'tve": "wouldn't've", "yall": "y'all", "yall'll": "y'all'll",
    "y'allll": "y'all'll", "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're", "youve": "you've",
}

NUMBER_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
}
ARTICLES = {"a", "an", "the"}
PUNCT = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]
PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
COMMA_STRIP = re.compile(r"(\d)(,)(\d)")


def process_punctuation(text: str) -> str:
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) or (COMMA_STRIP.search(text) is not None):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = PERIOD_STRIP.sub("", out, re.UNICODE)
    return out


def process_digit_article(text: str) -> str:
    words = []
    for w in text.lower().split():
        w = NUMBER_MAP.get(w, w)
        if w in ARTICLES:
            continue
        words.append(CONTRACTIONS.get(w, w))
    return " ".join(words)


def normalize_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip()
    ans = process_punctuation(ans)
    ans = process_digit_article(ans)
    return ans


def vqa_accuracy(prediction: str, gt_answers: List[str]) -> float:
    """Official VQA accuracy for one question (10 human answers)."""
    pred = normalize_answer(prediction)
    gts = [normalize_answer(a) for a in gt_answers]
    if len(gts) <= 1:
        return float(pred == gts[0]) if gts else 0.0
    accs = []
    for i in range(len(gts)):
        others = gts[:i] + gts[i + 1 :]
        matches = sum(1 for a in others if a == pred)
        accs.append(min(1.0, matches / 3.0))
    return sum(accs) / len(accs)


def evaluate_vqa(
    predictions: Dict[str, str],
    annotations: Dict[str, List[str]],
    question_types: Dict[str, str] = None,
    answer_types: Dict[str, str] = None,
) -> Dict[str, float]:
    """predictions: qid -> answer; annotations: qid -> list of human answers.

    With optional per-question type maps, also reports the official
    per-question-type and per-answer-type breakdowns (yes/no, number, other).
    """
    from collections import defaultdict

    scores = {}
    for qid, answers in annotations.items():
        scores[qid] = vqa_accuracy(predictions.get(qid, ""), answers)
    out = {
        "overall": 100.0 * sum(scores.values()) / max(len(scores), 1),
        "n": len(scores),
    }
    for name, mapping in (("perQuestionType", question_types),
                          ("perAnswerType", answer_types)):
        if not mapping:
            continue
        by_type = defaultdict(list)
        for qid, s in scores.items():
            by_type[mapping.get(qid, "unknown")].append(s)
        out[name] = {
            t: 100.0 * sum(v) / len(v) for t, v in sorted(by_type.items())
        }
    return out


def textvqa_accuracy(predictions: List[Dict]) -> Dict[str, float]:
    """EvalAI-style TextVQA scoring: each record has 'pred_answer' and
    'gt_answers' (10 strings)."""
    scores = [vqa_accuracy(r["pred_answer"], r["gt_answers"]) for r in predictions]
    return {"accuracy": 100.0 * sum(scores) / max(len(scores), 1), "n": len(scores)}
