"""Benchmark question loading + sharding (reference evaluate.py:20-77).

The port's own copy of ``visualrwkv_tpu/evals/loaders.py`` (host code, no torch).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List


def split_list(lst: List, n: int) -> List[List]:
    chunk = math.ceil(len(lst) / n)
    return [lst[i : i + chunk] for i in range(0, len(lst), chunk)]


def get_chunk(lst: List, num_chunks: int, chunk_idx: int) -> List:
    return split_list(lst, num_chunks)[chunk_idx]


def is_none(value) -> bool:
    if value is None:
        return True
    if isinstance(value, float) and math.isnan(value):
        return True
    if isinstance(value, str) and value.lower() in ("nan", "none"):
        return True
    return False


def load_questions(file_path) -> List[Dict]:
    file_path = Path(file_path)
    if file_path.suffix == ".jsonl":
        return [json.loads(q) for q in open(file_path) if q.strip()]
    if file_path.suffix == ".json":
        return json.load(open(file_path))
    if file_path.suffix == ".tsv":
        import pandas as pd

        return pd.read_table(file_path).to_dict("records")
    raise ValueError(f"Unsupported file type: {file_path.suffix}")


def get_question_id(line: Dict):
    for key in ("question_id", "id", "index"):
        if key in line:
            return line[key]
    raise ValueError(f"Cannot find question id in line: {line}")


def get_input_text(line: Dict, num_images: int, dataset_name: str = "") -> str:
    text = line["text"] if "text" in line else line["conversations"][0]["value"]
    text = text.replace("<image>", "").strip()
    prefix = "\n".join(num_images * ["<image>"])
    text = prefix + "\n" + text
    if "conversations" in line and dataset_name == "scienceqa":
        text += "\nAnswer with the option's letter from the given choices directly."
    return text
