"""Training dataset pipeline (host side). The port's own copy of
``visualrwkv_tpu/data/dataset.py``: numpy in, numpy out.

Reproduces the reference's deterministic magic-prime sampling, conversation
preprocessing, per-tower image transforms, zero-tensor fallback for unreadable
images, and multi-image collation (VisualRWKV-v7/v7.00/src/dataset.py:167-246,
:24-36).  Host code produces numpy batches; normalization runs on the device
(:mod:`visualrwkv_torch.data.transforms`).
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from visualrwkv_torch.data.conversation import (
    preprocess,
    process_image_tokens_in_conversations,
    process_tokens_in_conversations,
)

log = logging.getLogger(__name__)

TOWER_SIZES = {"dino": 448, "siglip": 448, "sam": 1024}


def largest_3n_plus_2_prime(n: int) -> int:
    """Largest prime p <= n with p % 3 == 2 (the sampler's magic prime)."""

    def is_prime(x: int) -> bool:
        if x < 2:
            return False
        if x % 2 == 0:
            return x == 2
        i = 3
        while i * i <= x:
            if x % i == 0:
                return False
            i += 2
        return True

    p = n
    while p > 2:
        if p % 3 == 2 and is_prime(p):
            return p
        p -= 1
    return 2


def load_image_uint8(path, sizes: Dict[str, int] = TOWER_SIZES) -> Dict[str, np.ndarray]:
    """Decode + bicubic-resize an image to each tower's input size (uint8 HWC)."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    img = Image.open(path).convert("RGB")
    out = {}
    for tower, size in sizes.items():
        out[tower] = np.asarray(
            img.resize((size, size), Image.BICUBIC), np.uint8
        )
    return out


@dataclass
class DatasetConfig:
    data_file: str = ""
    image_folder: str = ""
    ctx_len: int = 2048
    num_token_per_image: int = 1024
    epoch_steps: int = 1000
    micro_bsz: int = 2
    image_position: str = "first"
    shuffle_mode: str = "magic_prime"  # "magic_prime" | "epoch_perm" (v7.01)
    towers: Sequence[str] = ("dino", "siglip", "sam")
    tower_sizes: Dict[str, int] = field(default_factory=lambda: dict(TOWER_SIZES))


class VisualRWKVDataset:
    """Deterministic pseudo-random dataset over a LLaVA-format json list.

    ``sample_idx = (step^3) mod magic_prime`` with the list reversed on the
    second epoch (reference src/dataset.py:182-195).
    """

    def __init__(self, cfg: DatasetConfig, tokenizer, world_size: int = 1, rank: int = 0):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.world_size = world_size
        self.rank = rank
        with open(cfg.data_file) as f:
            self.records: List[dict] = json.load(f)
        self.records_reversed = list(reversed(self.records))
        self.magic_prime = largest_3n_plus_2_prime(len(self.records))
        self.samples_per_epoch = cfg.epoch_steps * cfg.micro_bsz * world_size

    def __len__(self) -> int:
        return self.cfg.epoch_steps * self.cfg.micro_bsz

    def sample_for_step(self, epoch: int, idx: int) -> dict:
        step = epoch * self.samples_per_epoch + idx * self.world_size + self.rank
        if getattr(self.cfg, "shuffle_mode", "magic_prime") == "epoch_perm":
            # v7.01 deterministic per-epoch permutation (seed 222,
            # v7.01/src/dataset.py:154-177 get_sample_idx_mapping_for_epoch)
            perm = self._epoch_perm(epoch)
            return self.records[int(perm[step % len(self.records)])]
        sample_idx = (step * step * step) % self.magic_prime
        if step < self.magic_prime:
            return self.records[sample_idx]
        return self.records_reversed[sample_idx]

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        cache = getattr(self, "_perm_cache", None)
        if cache is None or cache[0] != epoch:
            rng = np.random.default_rng(222 + epoch)
            self._perm_cache = (epoch, rng.permutation(len(self.records)))
        return self._perm_cache[1]

    def get_item(self, epoch: int, idx: int) -> dict:
        cfg = self.cfg
        sample = self.sample_for_step(epoch, idx)
        has_image = "image" in sample

        images: Optional[Dict[str, np.ndarray]] = None
        num_images = 0
        if has_image:
            names = sample["image"]
            if isinstance(names, str):
                names = [names]
            num_images = len(names)
            paths = [Path(cfg.image_folder) / n for n in names]
            sizes = {t: cfg.tower_sizes[t] for t in cfg.towers}
            try:
                per_image = [load_image_uint8(p, sizes) for p in paths]
                images = {
                    t: np.stack([pi[t] for pi in per_image]) for t in cfg.towers
                }
            except Exception:
                log.warning("Image %s unreadable; using zero tensors.", paths)
                images = {
                    t: np.zeros((num_images, sizes[t], sizes[t], 3), np.uint8)
                    for t in cfg.towers
                }
            conversations = process_image_tokens_in_conversations(
                sample["conversations"], num_images, cfg.image_position
            )
        else:
            conversations = process_tokens_in_conversations(sample["conversations"])

        item = preprocess(
            conversations,
            self.tokenizer,
            has_image=has_image,
            ctx_len=cfg.ctx_len,
            num_token_per_image=cfg.num_token_per_image,
        )
        if images is not None:
            item["images"] = images
        item["sample_id"] = str(sample.get("sample_id", sample.get("id", idx)))
        return item


def collate(batch: List[dict], pad_images_to: int = 0) -> dict:
    """Multi-image collate (reference multi_image_collate_fn, dataset.py:24-36).

    ``pad_images_to``: pad the batch's total image count to a fixed bucket with
    zero images APPENDED AT THE END — the ordered token scatter consumes
    exactly the real features, so shapes stay the same across batches with
    ragged per-sample image counts.
    """
    out = {
        "input_ids": np.stack([b["input_ids"] for b in batch]),
        "labels": np.stack([b["labels"] for b in batch]),
        "sample_id": [b["sample_id"] for b in batch],
        "input_text": [b["input_text"] for b in batch],
    }
    with_images = [b for b in batch if "images" in b]
    if with_images:
        towers = with_images[0]["images"].keys()
        images = {
            t: np.concatenate([b["images"][t] for b in with_images]) for t in towers
        }
        n_real = next(iter(images.values())).shape[0]
        if pad_images_to:
            if n_real > pad_images_to:
                raise ValueError(
                    f"batch has {n_real} images > pad_images_to={pad_images_to}"
                )
            for t in images:
                pad_shape = (pad_images_to - n_real,) + images[t].shape[1:]
                images[t] = np.concatenate(
                    [images[t], np.zeros(pad_shape, images[t].dtype)]
                )
        out["images"] = images
        out["num_image_per_sample"] = np.asarray(
            [len(b["images"][next(iter(towers))]) if "images" in b else 0 for b in batch]
        )
    return out


def batches_for_epoch(
    dataset: VisualRWKVDataset, epoch: int, pad_images_to: int = 0
) -> "Callable[[int], dict]":
    """Returns batch_fn(step) -> collated batch for the given epoch."""
    bsz = dataset.cfg.micro_bsz

    def batch_fn(step: int) -> dict:
        items = [dataset.get_item(epoch, step * bsz + i) for i in range(bsz)]
        return collate(items, pad_images_to=pad_images_to)

    return batch_fn
