"""v6.0 insertion of a variable number of image features with left-pad
alignment of the image spans. Counterpart of
``visualrwkv_tpu/multimodal/insertion.py``.

The reference (VisualRWKV-v6/v6.0/src/model.py:487-570): a sample carries at
most ONE un-expanded image token. Every sample's text before its image is
left-padded so that all images start at the batch's largest image-token
position (``max_idx``); the projected features (any count L) go in at
embedding level; a sample longer than ``ctx_len`` keeps its head unless the
head holds no valid label, then its tail; rows are right-padded to the batch's
length. A sample without an image gets a zeroed feature block.

The rearrangement is one gather over ``[B, T_out]`` output slots on the
device: each slot's raw position tells whether it is left pad, image or text
and which text index it serves. The two numbers that depend on the batch's
data (``max_idx`` and ``T_out``) come from :func:`leftpad_plan` on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from visualrwkv_torch.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX

Tensor = torch.Tensor


@dataclass(frozen=True)
class LeftpadPlan:
    """The batch's geometry, computed on the host."""

    max_idx: int  # aligned image start: the largest image-token position
    T_out: int  # output length, a multiple of the bucket
    img_len: int  # inserted feature count L
    flip_len: int  # the bidirectional span: L - 1 (the reference's img_end leaves out the last, CLS, feature)
    ctx_len: int  # truncation limit


def leftpad_plan(input_ids, img_len: int, ctx_len: int, bucket: int = 16) -> LeftpadPlan:
    """The batch's geometry from its token ids (numpy or a tensor; read on
    the host). Raises ``ValueError`` on more than one image in a sample, as
    the reference does."""
    ids = input_ids.detach().cpu().numpy() if isinstance(input_ids, torch.Tensor) else np.asarray(input_ids)
    T_in = ids.shape[1]
    is_img = ids == IMAGE_TOKEN_INDEX
    n_img = is_img.sum(axis=1)
    if (n_img > 1).any():
        raise ValueError(f"Too many images in one sample: {int(n_img.max())}, should be 0 or 1.")
    has = n_img == 1
    first = np.argmax(is_img, axis=1)
    max_idx = int(np.where(has, first, 0).max())
    # a sample's raw length: the pad to max_idx, L features and the text after
    # the image (the whole text of an image-free sample, its index taken as -1)
    idx = np.where(has, first, -1)
    raw_len = max_idx + img_len + (T_in - idx - 1)
    T_out = int(min(ctx_len, raw_len.max()))
    T_out = -(-T_out // bucket) * bucket
    return LeftpadPlan(max_idx=max_idx, T_out=T_out, img_len=img_len, flip_len=max(1, img_len - 1),
                       ctx_len=ctx_len)


def leftpad_insert(embed_table: Tensor, input_ids: Tensor, labels: Tensor, image_features: Tensor,
                   plan: LeftpadPlan) -> Tuple[Tensor, Tensor, Tensor]:
    """The aligned (embeddings ``[B, T_out, C]``, labels ``[B, T_out]``,
    ``off`` ``[B]``), all on ``input_ids``' device.

    ``image_features`` ``[B, L, C]``: a sample without an image has its
    block zeroed. ``off`` is a sample's tail-keep truncation offset: its
    image span sits at output slots ``[max_idx - off, max_idx - off + L)``,
    so whatever addresses the span (the bidirectional flip) subtracts it.
    Left-pad slots carry the embedding of token 0 (the reference embeds a
    prefix of zero ids), the right padding zero vectors."""
    B, T_in = input_ids.shape
    L, max_idx, T_out, ctx = plan.img_len, plan.max_idx, plan.T_out, plan.ctx_len
    if image_features.shape[1] != L:
        raise ValueError(f"{image_features.shape[1]} image features for a plan of {L}")
    dev = input_ids.device

    img_mask = input_ids == IMAGE_TOKEN_INDEX
    has_img = img_mask.any(1)  # [B]
    idx = torch.where(has_img, img_mask.to(torch.uint8).argmax(1), -1)[:, None]  # [B, 1]
    raw_len = max_idx + L + (T_in - idx - 1)  # [B, 1]

    # truncation (the reference's truncate_input): keep the first ctx_len raw
    # positions unless they carry no valid label, else the last ctx_len
    j_in = torch.arange(T_in, device=dev)[None, :]
    rawpos = torch.where(j_in < idx, max_idx - idx + j_in, max_idx + L + j_in - idx - 1)
    rawpos = torch.where(j_in == idx, -1, rawpos)  # the image token itself
    head_valid = ((labels != IGNORE_INDEX) & (rawpos >= 0) & (rawpos < ctx)).any(1, keepdim=True)
    off = torch.where((raw_len > ctx) & ~head_valid, raw_len - ctx, 0)  # [B, 1]
    keep_len = raw_len.clamp_max(ctx)

    t = torch.arange(T_out, device=dev)[None, :]
    p = t + off  # the raw position each output slot serves
    kept = t < keep_len
    in_img = (p >= max_idx) & (p < max_idx + L) & kept
    j = torch.where(p < max_idx, p - (max_idx - idx), p - (max_idx + L) + idx + 1)
    text_ok = ~in_img & (j >= 0) & (j < T_in) & (p < raw_len) & kept
    j_safe = j.clamp(0, T_in - 1)

    src_ids = torch.where(text_ok, input_ids.gather(1, j_safe), 0)
    emb = embed_table[src_ids.clamp(0, embed_table.shape[0] - 1)]
    right_pad = (p >= raw_len) | ~kept
    emb = emb * (1.0 - right_pad[..., None].to(emb.dtype))

    feats = (image_features * has_img[:, None, None].to(image_features.dtype)).to(emb.dtype)
    f_idx = (p - max_idx).clamp(0, L - 1)
    feat_at = feats.gather(1, f_idx[..., None].expand(-1, -1, feats.shape[-1]))
    emb = torch.where(in_img[..., None], feat_at, emb)

    new_labels = torch.where(text_ok, labels.gather(1, j_safe), IGNORE_INDEX)
    return emb, new_labels, off[:, 0]
