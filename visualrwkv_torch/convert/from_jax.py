"""Carry a ``visualrwkv_tpu`` parameter tree into the port's layouts, and
back (:func:`params_to_numpy`), so that parameters the port has trained can
be held against the JAX trainer's.

The input is the JAX tree with every leaf a numpy array (a caller turns
``jax.Array`` leaves into numpy first; nothing here imports JAX). Layout
changes, so that both packages compute the same function:

- linears ``{"weight": [in, out]}`` -> ``[out, in]``, and int8 linears
  ``{"weight_q": int8 [in, out], "scale": [out]}`` (``infer.quant``) ->
  ``weight_q`` ``[out, in]``, the scale unchanged (the RWKV projections,
  x060's ``att.gate`` and ``ffn.receptance`` among them, the head, the ViT /
  SAM qkv, proj, fc1, fc2, and the projector);
- patch embeddings ``[p*p*3, C]`` in (ph, pw, c) raster order -> a Conv2d
  weight ``[C, 3, p, p]``;
- the SAM neck convolutions HWIO -> OIHW;
- everything else (LoRA factors ``[in, out]``, x060's ``time_maa_w2``
  ``[5, dm, C]``, ``time_decay_w1/w2`` and ``time_faaaa`` ``[H, N]``,
  embeddings, norms, tokens, rel-pos tables, mixing vectors) unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from visualrwkv_torch.config import VLMConfig, resolve_device
from visualrwkv_torch.vision.backbone import tower_configs
from visualrwkv_torch.vision.sam import SAMConfig

Params = Dict[str, Any]

_RWKV_LINEARS = {("att", "receptance"), ("att", "key"), ("att", "value"), ("att", "output"),
                 ("att", "gate"), ("ffn", "key"), ("ffn", "value"), ("ffn", "receptance")}
_VIT_LINEARS = {("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")}


def _t(x, device, dtype) -> torch.Tensor:
    if np.asarray(x).dtype == np.int8:  # int8 weights stay int8 whatever ``dtype`` is
        return torch.from_numpy(np.array(x, order="C")).to(device)
    x = torch.from_numpy(np.array(x, dtype=np.float32, order="C"))  # a writable copy
    return x.to(device=device, dtype=dtype or torch.float32)


def _tree(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, device, dtype) for v in tree]
    return _t(tree, device, dtype)


def _linear_T(p: Params) -> Params:
    """Transpose a linear's weight, or an int8 linear's ``weight_q`` (its
    per-output-channel ``scale`` is unchanged)."""
    out = dict(p)
    key = "weight_q" if "weight_q" in p else "weight"
    out[key] = np.asarray(p[key]).T
    return out


def _patch_to_conv(w, patch: int):
    """[p*p*3, C] (ph, pw, c order) -> [C, 3, p, p]."""
    w = np.asarray(w)
    return w.reshape(patch, patch, 3, w.shape[-1]).transpose(3, 2, 0, 1)


def _rwkv(tree: Params) -> Params:
    blocks = []
    for blk in tree["blocks"]:
        nb = {k: v for k, v in blk.items()}
        for part, name in _RWKV_LINEARS:
            if name in blk[part]:  # x070 has no att.gate or ffn.receptance
                nb[part] = dict(nb[part])
                nb[part][name] = _linear_T(blk[part][name])
        blocks.append(nb)
    return {"emb": tree["emb"], "blocks": blocks, "ln_out": tree["ln_out"],
            "head": _linear_T(tree["head"])}


def _blocks(blocks):
    out = []
    for blk in blocks:
        nb = dict(blk)
        for part, name in _VIT_LINEARS:
            nb[part] = dict(nb[part])
            nb[part][name] = _linear_T(blk[part][name])
        out.append(nb)
    return out


def _tower(tree: Params, tcfg) -> Params:
    out = dict(tree)
    pe = dict(tree["patch_embed"])
    pe["weight"] = _patch_to_conv(pe["weight"], tcfg.patch_size)
    out["patch_embed"] = pe
    out["blocks"] = _blocks(tree["blocks"])
    if isinstance(tcfg, SAMConfig):
        neck = dict(tree["neck"])
        for c in ("conv1", "conv2"):
            neck[c] = {"weight": np.asarray(tree["neck"][c]["weight"]).transpose(3, 2, 0, 1)}
        out["neck"] = neck
    return out


def _proj(tree: Params) -> Params:
    if "weight" in tree or "weight_q" in tree:  # linear projector
        return _linear_T(tree)
    return {"gate": _linear_T(tree["gate"]), "o_proj": _linear_T(tree["o_proj"]),
            "ln_v": tree["ln_v"]}


def tower_params_from_jax(np_tree: Params, tcfg, device="cuda",
                          dtype: Optional[torch.dtype] = None) -> Params:
    """One vision tower's JAX tree (numpy leaves) -> the port's parameters
    for ``tcfg`` (a ``ViTConfig`` or ``SAMConfig``)."""
    return _tree(_tower(np_tree, tcfg), resolve_device(device), dtype)


def params_from_jax(np_tree: Params, cfg: VLMConfig, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX ``{"rwkv", "vit", "proj"}`` tree (numpy leaves) -> the port's
    parameters on ``device`` (stored in ``dtype``, fp32 by default)."""
    device = resolve_device(device)
    out: Params = {"rwkv": _rwkv(np_tree["rwkv"])}
    if "vit" in np_tree:
        tcfgs = tower_configs(cfg.vision, cfg.rwkv.compute_dtype)
        out["vit"] = {name: _tower(np_tree["vit"][name], tcfgs[name]) for name in tcfgs}
        out["proj"] = _proj(np_tree["proj"])
    return _tree(out, device, dtype)


# ---------------------------------------------------------------------------
# The inverse direction: the port's parameters -> the JAX layout (numpy)
# ---------------------------------------------------------------------------


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    if tree.dtype == torch.int8:
        return tree.detach().cpu().numpy()
    return tree.detach().float().cpu().numpy()


def _conv_to_patch(w):
    """[C, 3, p, p] -> [p*p*3, C] (ph, pw, c order)."""
    return w.transpose(2, 3, 1, 0).reshape(-1, w.shape[0])


def _tower_to_jax(tree: Params, tcfg) -> Params:
    out = dict(tree)
    pe = dict(tree["patch_embed"])
    pe["weight"] = _conv_to_patch(pe["weight"])
    out["patch_embed"] = pe
    out["blocks"] = _blocks(tree["blocks"])  # a transpose is its own inverse
    if isinstance(tcfg, SAMConfig):
        neck = dict(tree["neck"])
        for c in ("conv1", "conv2"):
            neck[c] = {"weight": tree["neck"][c]["weight"].transpose(2, 3, 1, 0)}  # OIHW -> HWIO
        out["neck"] = neck
    return out


def params_to_numpy(params: Params, cfg: VLMConfig) -> Params:
    """The port's ``{"rwkv", "vit", "proj"}`` parameters -> the JAX package's
    tree with fp32 numpy leaves: :func:`params_from_jax` reversed."""
    tree = _np_tree(params)
    out: Params = {"rwkv": _rwkv(tree["rwkv"])}
    if "vit" in tree:
        tcfgs = tower_configs(cfg.vision, cfg.rwkv.compute_dtype)
        out["vit"] = {name: _tower_to_jax(tree["vit"][name], tcfgs[name]) for name in tcfgs}
        out["proj"] = _proj(tree["proj"])
    return out
