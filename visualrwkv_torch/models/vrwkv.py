"""v7.10 branch: mixture-FFN blocks and the trainable vision RWKV (VRWKV).
Counterpart of ``visualrwkv_tpu/models/vrwkv.py``.

- Mixture-FFN: each LM block gains a second ChannelMix (``ffn_v``) and its
  LayerNorm ``ln_v``; image positions take ffn_v, text positions ffn
  (reference VisualRWKV-v7/v7.10/src/model.py:233-262). Both FFNs run and
  ``torch.where`` picks, as in the JAX package.
- VRWKV: a patch embedding (a matmul over patches flattened in (row, col,
  channel) order), ``VRWKV_DEPTH`` RWKV-7 blocks and a LayerNorm, giving
  patch features and ImageNet-1k logits over the mean of the tokens
  (:367-416).
- ``pretrain_mode_mask``: pretraining trains VRWKV and ffn_v / ln_v only
  (:438-443).

Linears are ``{"weight": [out, in]}`` as everywhere in the port: the patch
embedding ``[C, p*p*3]`` with its bias, the ImageNet head ``[1000, C]`` with
its bias. The WKV of the blocks is :func:`visualrwkv_torch.ops.wkv7.wkv7`:
kernel K1 without a gradient, K5 / K6 under autograd, on CUDA tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from visualrwkv_torch.config import STOP_TOKEN_INDEX, RWKVConfig, resolve_device
from visualrwkv_torch.models.rwkv7 import (
    _cast_tree,
    _ln_init,
    block_x070,
    cmix_x070,
    embed,
    init_cmix_x070,
    init_tmix_x070,
    layer_norm,
    linear,
    tmix_x070,
)
from visualrwkv_torch.train.optim import tree_map_with_path

Tensor = torch.Tensor
Params = Dict[str, Any]

VRWKV_DEPTH = 6
IMAGENET_CLASSES = 1000


# ---------------------------------------------------------------------------
# Mixture-FFN LM blocks
# ---------------------------------------------------------------------------


def add_mixture_ffn(gen: torch.Generator, lm_params: Params, cfg: RWKVConfig,
                    dtype: Optional[torch.dtype] = None) -> Params:
    """Add ``ffn_v`` and ``ln_v`` to every block of an RWKV-7 LM's
    parameters, in place, on the generator's device (stored in ``dtype``,
    fp32 by default). Returns the same tree."""
    device = gen.device
    for i, blk in enumerate(lm_params["blocks"]):
        new = {"ffn_v": init_cmix_x070(gen, cfg, i, device), "ln_v": _ln_init(cfg.n_embd, device)}
        blk.update(_cast_tree(new, dtype) if dtype is not None else new)
    return lm_params


def block_x070_mixffn(p: Params, cfg: RWKVConfig, layer_id: int, x: Tensor, mask: Tensor,
                      v_first: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """One block; mask ``[B, T, 1]``: True at an image position (ffn_v),
    False at a text position (ffn)."""
    if layer_id == 0:
        x = layer_norm(p["ln0"], x)
    xx, v_first, _, _ = tmix_x070(p["att"], cfg, layer_id, layer_norm(p["ln1"], x), v_first)
    x = x + xx
    ffn_t, _ = cmix_x070(p["ffn"], cfg, layer_norm(p["ln2"], x))
    ffn_v, _ = cmix_x070(p["ffn_v"], cfg, layer_norm(p["ln_v"], x))
    return x + torch.where(mask, ffn_v, ffn_t), v_first


def rwkv7_mixffn_forward(params: Params, cfg: RWKVConfig, x: Tensor, mask: Tensor,
                         grad_cp: bool = False) -> Tensor:
    """LM forward with image / text FFN routing: x ``[B, T, C]``, mask
    ``[B, T]`` bool. T is left-padded to a multiple of ``chunk_len`` with
    ``STOP_TOKEN_INDEX`` embeddings, text positions. ``grad_cp``: each block
    under activation checkpointing. Returns logits ``[B, T, vocab]`` fp32."""
    B, T, C = x.shape
    pad = (-T) % cfg.chunk_len
    if pad:
        eos = embed(params, torch.full((B, pad), STOP_TOKEN_INDEX, dtype=torch.long, device=x.device))
        x = torch.cat([eos.to(x.dtype), x], dim=1)
        mask = torch.cat([torch.zeros(B, pad, dtype=torch.bool, device=mask.device), mask], dim=1)
    m = mask[..., None]
    v_first = None
    for i, blk in enumerate(params["blocks"]):
        run = lambda xx, vf, blk=blk, i=i: block_x070_mixffn(blk, cfg, i, xx, m, vf)
        if grad_cp:
            x, v_first = checkpoint(run, x, v_first, use_reentrant=False, preserve_rng_state=False)
        else:
            x, v_first = run(x, v_first)
    x = layer_norm(params["ln_out"], x)
    if pad:
        x = x[:, pad:]
    return linear(params["head"], x, cfg.dtype)


# ---------------------------------------------------------------------------
# VRWKV vision encoder (ImageNet pretraining branch)
# ---------------------------------------------------------------------------


def init_vrwkv_params(gen: torch.Generator, cfg: RWKVConfig, patch_size: int = 14,
                      device="cuda", dtype: Optional[torch.dtype] = None) -> Params:
    """Seeded random VRWKV on ``device`` (CUDA unless the caller asks for the
    CPU; ``gen`` a generator there): ``VRWKV_DEPTH`` blocks of ``cfg``'s
    width whatever ``cfg.n_layer`` is, which the init's layer ratios take as
    at least ``VRWKV_DEPTH``."""
    device = resolve_device(device)
    cfg = dataclasses.replace(cfg, n_layer=max(cfg.n_layer, VRWKV_DEPTH))
    C = cfg.n_embd
    blocks: List[Params] = []
    for i in range(VRWKV_DEPTH):
        blk = {"ln1": _ln_init(C, device), "ln2": _ln_init(C, device),
               "att": init_tmix_x070(gen, cfg, i, device), "ffn": init_cmix_x070(gen, cfg, i, device)}
        if i == 0:
            blk["ln0"] = _ln_init(C, device)
        blocks.append(blk)
    params = {
        "emb": {"weight": torch.randn(C, patch_size * patch_size * 3, generator=gen, device=device) * 0.02,
                "bias": torch.zeros(C, device=device)},
        "blocks": blocks,
        "ln_out": _ln_init(C, device),
        "head": {"weight": torch.randn(IMAGENET_CLASSES, C, generator=gen, device=device) * 0.02,
                 "bias": torch.zeros(IMAGENET_CLASSES, device=device)},
    }
    return _cast_tree(params, dtype) if dtype is not None else params


def vrwkv_forward(params: Params, cfg: RWKVConfig, pixels: Tensor, patch_size: int = 14,
                  grad_cp: bool = False) -> Tuple[Tensor, Tensor]:
    """pixels ``[B, H, W, 3]`` (normalised) -> (patch features ``[B, T, C]``
    after ``ln_out``, ImageNet logits ``[B, 1000]`` fp32). The patch tokens
    are left-padded with zero vectors to a multiple of ``chunk_len`` after
    the embedding (block 0's ``ln0`` sees them), and the pool is a mean over
    the patch tokens only."""
    dt = cfg.dtype
    B, H, W, _ = pixels.shape
    gh, gw = H // patch_size, W // patch_size
    x = pixels.reshape(B, gh, patch_size, gw, patch_size, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, gh * gw, patch_size * patch_size * 3)
    emb = params["emb"]
    x = (F.linear(x.to(dt), emb["weight"].to(dt)).float() + emb["bias"].float()).to(dt)
    T = x.shape[1]
    pad = (-T) % cfg.chunk_len
    if pad:
        x = torch.cat([x.new_zeros(B, pad, x.shape[-1]), x], dim=1)
    v_first = None
    for i, blk in enumerate(params["blocks"]):
        run = lambda xx, vf, blk=blk, i=i: block_x070(blk, cfg, i, xx, vf)[:2]
        if grad_cp:
            x, v_first = checkpoint(run, x, v_first, use_reentrant=False, preserve_rng_state=False)
        else:
            x, v_first = run(x, v_first)
    x = layer_norm(params["ln_out"], x)
    if pad:
        x = x[:, pad:]
    head = params["head"]
    cls_logits = F.linear(x.mean(1).to(dt), head["weight"].to(dt)).float() + head["bias"].float()
    return x, cls_logits


def imagenet_loss(cls_logits: Tensor, labels: Tensor) -> Tensor:
    """Mean cross-entropy of ``[B, classes]`` logits (in fp32) against
    ``[B]`` labels."""
    return F.cross_entropy(cls_logits.float(), labels.long())


def pretrain_mode_mask(params: Params) -> Params:
    """The tree of ``params`` with a bool a leaf: True on the ``"vrwkv"``
    subtree and on every ``ffn_v`` / ``ln_v`` leaf, which pretraining trains
    (reference v7.10/src/model.py:438-443), False elsewhere."""
    def decide(path, _):
        if path and path[0] == "vrwkv":
            return True
        return any(k in ("ffn_v", "ln_v") for k in path)

    return tree_map_with_path(decide, params)
