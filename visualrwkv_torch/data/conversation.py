"""Conversation -> token/label preprocessing. The port's own copy of
``visualrwkv_tpu/data/conversation.py`` (numpy only).

Reproduces the reference prompt protocol (VisualRWKV-v7/v7.00/src/dataset.py:39-164):

- image tokens moved to the front of human turns (or "middle"/"last" placement,
  the v6.0 sandwich-prompt option, v6.0/src/dataset.py:40-66);
- "User: ...\n\n" / "Assistant: ...\n\n" speaker signals;
- each ``<image>`` expands to ``num_token_per_image`` copies of
  IMAGE_TOKEN_INDEX (65535);
- human turns and the 3-token "Assistant:" prefix are label-masked;
- pad/truncate to ``ctx_len``.
"""

from __future__ import annotations

import copy
import re
from typing import Dict, List, Sequence

import numpy as np

from visualrwkv_torch.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX, STOP_TOKEN_INDEX

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_STOP_TOKEN = "\n\n"


def _squash_newlines(s: str) -> str:
    return re.sub(r"\n(\s*\n)+", "\n", s)


def process_image_tokens_in_conversations(
    conversations: Sequence[Dict],
    num_image_paths: int,
    image_position: str = "first",
) -> List[Dict]:
    """Normalize <image> placement inside each human turn."""
    conversations = copy.deepcopy(list(conversations))
    num_global = sum(s["value"].count(DEFAULT_IMAGE_TOKEN) for s in conversations)
    assert num_global == num_image_paths, (
        f"num image tokens {num_global} != num image paths {num_image_paths}"
    )
    for sentence in conversations:
        if DEFAULT_IMAGE_TOKEN in sentence["value"]:
            n_local = sentence["value"].count(DEFAULT_IMAGE_TOKEN)
            text = sentence["value"].replace(DEFAULT_IMAGE_TOKEN, "").strip()
            text = _squash_newlines(text)
            if sentence["from"].lower() == "human":
                block = "\n".join(n_local * [DEFAULT_IMAGE_TOKEN])
                if image_position == "first":
                    text = block + "\n" + text
                elif image_position == "last":
                    text = text + "\n" + block
                elif image_position == "middle":  # sandwich: text, images, text
                    text = text + "\n" + block + "\n" + text
                else:
                    raise ValueError(f"unknown image_position: {image_position}")
            sentence["value"] = text.strip()
        else:
            sentence["value"] = _squash_newlines(sentence["value"].strip())
    return conversations


def process_tokens_in_conversations(conversations: Sequence[Dict]) -> List[Dict]:
    conversations = copy.deepcopy(list(conversations))
    for sentence in conversations:
        sentence["value"] = _squash_newlines(sentence["value"].strip())
    return conversations


def add_speaker_and_signal(conversations: Sequence[Dict]) -> List[Dict]:
    conversations = copy.deepcopy(list(conversations))
    for sentence in conversations:
        frm = sentence["from"].lower()
        if frm == "human":
            speaker = "User"
        elif frm == "gpt":
            speaker = "Assistant"
        else:
            raise ValueError(f"unknown speaker {sentence['from']}")
        if sentence["value"]:  # training turn: closing "\n\n"
            sentence["value"] = f"{speaker}: {sentence['value']}{DEFAULT_STOP_TOKEN}"
        else:  # generation prompt: bare "Assistant:"
            sentence["value"] = f"{speaker}:"
    return conversations


def tokenize_with_image_token(
    prompt: str, tokenizer, num_token_per_image: int,
    image_token_index: int = IMAGE_TOKEN_INDEX,
) -> List[int]:
    chunks = [tokenizer.encode(c) for c in prompt.split(DEFAULT_IMAGE_TOKEN)]
    ids = list(chunks[0])
    for chunk in chunks[1:]:
        ids.extend([image_token_index] * num_token_per_image)
        ids.extend(chunk)
    return ids


def mask_targets(targets: np.ndarray, tokenized_lens: List[int], speakers: List[str]) -> None:
    cur = 0
    for ln, spk in zip(tokenized_lens, speakers):
        if spk.lower() == "human":
            targets[cur : cur + ln] = IGNORE_INDEX
        elif spk.lower() == "gpt":
            targets[cur : cur + 3] = IGNORE_INDEX  # "Assistant:" prefix = 3 tokens
        cur += ln


def pad_to_max_len(input_ids, targets, max_len: int, pad_token_id: int = 0):
    input_ids = input_ids[:max_len]
    targets = targets[:max_len]
    n_pad = max_len - len(input_ids)
    if n_pad > 0:
        input_ids = np.concatenate(
            [input_ids, np.full(n_pad, pad_token_id, input_ids.dtype)]
        )
        targets = np.concatenate([targets, np.full(n_pad, IGNORE_INDEX, targets.dtype)])
    return input_ids, targets


def align_image_spans(
    batch_input_ids: List[np.ndarray],
    batch_labels: List[np.ndarray],
    pad_token_id: int = 0,
):
    """Left-pad samples so every row's FIRST image token sits at the same
    index (the v6.0 variable-position insertion protocol,
    v6.0/src/model.py:487-570 get_max_image_token_indice + left padding).
    Host-side prep; returns stacked [B, T'] arrays."""
    firsts = []
    for ids in batch_input_ids:
        pos = np.nonzero(ids == IMAGE_TOKEN_INDEX)[0]
        firsts.append(int(pos[0]) if len(pos) else 0)
    target = max(firsts)
    out_ids, out_labels = [], []
    for ids, labels, first in zip(batch_input_ids, batch_labels, firsts):
        pad = target - first
        out_ids.append(
            np.concatenate([np.full(pad, pad_token_id, ids.dtype), ids])
        )
        out_labels.append(
            np.concatenate([np.full(pad, IGNORE_INDEX, labels.dtype), labels])
        )
    max_len = max(len(x) for x in out_ids)
    out_ids = [
        np.concatenate([x, np.full(max_len - len(x), pad_token_id, x.dtype)])
        for x in out_ids
    ]
    out_labels = [
        np.concatenate([x, np.full(max_len - len(x), IGNORE_INDEX, x.dtype)])
        for x in out_labels
    ]
    return np.stack(out_ids), np.stack(out_labels)


def preprocess(
    conversations: Sequence[Dict],
    tokenizer,
    has_image: bool,
    ctx_len: int,
    num_token_per_image: int,
    pad_token_id: int = 0,
    do_pad_to_max_length: bool = True,
) -> Dict:
    conversations = add_speaker_and_signal(conversations)
    input_text = "".join(s["value"] for s in conversations)
    ids: List[int] = []
    lens: List[int] = []
    speakers: List[str] = []
    for sentence in conversations:
        if has_image:
            conv_ids = tokenize_with_image_token(
                sentence["value"], tokenizer, num_token_per_image
            )
        else:
            conv_ids = tokenizer.encode(sentence["value"])
        ids.extend(conv_ids)
        lens.append(len(conv_ids))
        speakers.append(sentence["from"])
    input_ids = np.asarray(ids, np.int64)
    targets = input_ids.copy()
    mask_targets(targets, lens, speakers)
    if do_pad_to_max_length:
        input_ids, targets = pad_to_max_len(input_ids, targets, ctx_len, pad_token_id)
    return dict(input_ids=input_ids, labels=targets, input_text=input_text)
