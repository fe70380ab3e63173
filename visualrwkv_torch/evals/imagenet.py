"""ImageNet classification evaluation of the VRWKV branch (reference
v7.10/evaluate_imagenet.py:1-262). Counterpart of
``visualrwkv_tpu/evals/imagenet.py``, with the same flags and ``--device``
(the card unless ``cpu`` is asked for). As there, ``main`` scores seeded
random weights: ``--model_path`` is accepted and not read.

    python -m visualrwkv_torch.evals.imagenet --data_root <class-per-directory folder>
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Iterable, Tuple

import numpy as np
import torch

from visualrwkv_torch.config import RWKVConfig, resolve_device
from visualrwkv_torch.data.transforms import normalize_uint8
from visualrwkv_torch.models.vrwkv import IMAGENET_CLASSES, init_vrwkv_params, vrwkv_forward


def topk_accuracy(logits: np.ndarray, labels: np.ndarray, ks=(1, 5)) -> dict:
    """Top-k accuracy in percent, for each k of ``ks``."""
    order = np.argsort(-logits, axis=-1)
    out = {}
    for k in ks:
        hits = (order[:, :k] == labels[:, None]).any(axis=1)
        out[f"top{k}"] = float(hits.mean()) * 100.0
    return out


def iter_imagefolder(root: str, image_size: int) -> Iterable[Tuple[np.ndarray, int, str]]:
    """The class-per-directory layout -> (uint8 image ``[S, S, 3]``, class
    index, path), classes in sorted order; a file PIL cannot read is
    skipped."""
    from PIL import Image

    root = Path(root)
    classes = sorted(d.name for d in root.iterdir() if d.is_dir())
    cls_to_idx = {c: i for i, c in enumerate(classes)}
    for cls in classes:
        for p in sorted((root / cls).glob("*")):
            try:
                img = Image.open(p).convert("RGB").resize((image_size, image_size), Image.BICUBIC)
            except Exception:
                continue
            yield np.asarray(img, np.uint8), cls_to_idx[cls], str(p)


@torch.no_grad()
def imagenet_logits(params, cfg: RWKVConfig, pixels_uint8: torch.Tensor, patch_size: int = 14) -> torch.Tensor:
    """The per-batch step: uint8 images ``[B, H, W, 3]`` normalised with the
    ImageNet statistics in the compute dtype, through
    :func:`vrwkv_forward`. Returns the logits ``[B, 1000]`` fp32."""
    x = normalize_uint8(pixels_uint8, "dino", cfg.dtype)
    return vrwkv_forward(params, cfg, x, patch_size=patch_size)[1]


def evaluate_imagenet(params, cfg: RWKVConfig, data_root: str, image_size: int = 224,
                      patch_size: int = 14, batch_size: int = 32, max_samples: int = 0,
                      device="cuda") -> dict:
    """Top-1 / top-5 accuracy (percent) and the count ``n`` of the images
    under ``data_root``, ``batch_size`` at a time through
    :func:`imagenet_logits` on ``device``; at most ``max_samples`` images
    when it is not 0."""
    device = resolve_device(device)
    all_logits, all_labels = [], []
    batch_imgs, batch_lbls = [], []

    def flush():
        if not batch_imgs:
            return
        pixels = torch.from_numpy(np.stack(batch_imgs)).to(device)
        all_logits.append(imagenet_logits(params, cfg, pixels, patch_size).cpu().numpy())
        all_labels.extend(batch_lbls)
        batch_imgs.clear()
        batch_lbls.clear()

    n = 0
    for img, label, _ in iter_imagefolder(data_root, image_size):
        batch_imgs.append(img)
        batch_lbls.append(label)
        n += 1
        if len(batch_imgs) == batch_size:
            flush()
        if max_samples and n >= max_samples:
            break
    flush()
    logits = np.concatenate(all_logits) if all_logits else np.zeros((0, IMAGENET_CLASSES))
    labels = np.asarray(all_labels)
    metrics = topk_accuracy(logits, labels) if len(labels) else {}
    metrics["n"] = len(labels)
    return metrics


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser("visualrwkv_torch.evals.imagenet")
    p.add_argument("--data_root", required=True)
    p.add_argument("--model_path", default="")
    p.add_argument("--n_layer", default=12, type=int)
    p.add_argument("--n_embd", default=768, type=int)
    p.add_argument("--image_size", default=224, type=int)
    p.add_argument("--patch_size", default=14, type=int)
    p.add_argument("--max_samples", default=0, type=int)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = RWKVConfig(n_layer=args.n_layer, n_embd=args.n_embd)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_vrwkv_params(gen, cfg, args.patch_size, device)
    metrics = evaluate_imagenet(params, cfg, args.data_root, args.image_size, args.patch_size,
                                max_samples=args.max_samples, device=device)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
