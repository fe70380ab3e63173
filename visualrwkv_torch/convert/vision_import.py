"""Vision tower state dicts -> the port's tower parameters. Counterpart of
``visualrwkv_tpu/convert/vision_import.py``.

The reference loads DINOv2 / SigLIP through timm and SAM through its vendored
encoder (VisualRWKV-v7/v7.00/src/vision.py:58-70); the same weights are
published as HF-transformers checkpoints (Dinov2WithRegisters,
SiglipVisionModel, CLIPVisionModel, SamModel). Every importer takes a flat
``{name: tensor or array}`` state dict (``pth_import.load_pth`` or a model's
``state_dict()``; nothing here imports ``transformers``) and returns the
parameters of :mod:`visualrwkv_torch.vision.vit` / :mod:`~.sam` as fp32
tensors. Those layouts are the checkpoints' own: a ``Conv2d`` patch weight
``[C, 3, p, p]``, OIHW neck convolutions and ``[out, in]`` linears, so
nothing is transposed (the JAX importers transpose to their ``[in, out]``
and patch-matrix layouts); q, k and v are fused into one ``[3C, C]`` linear.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from visualrwkv_torch.convert.pth_import import to_tensor

Params = Dict[str, Any]


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5, of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_matrix(src: int, dst: int) -> np.ndarray:
    """``[src, dst]`` fp32 weights of a 1-D bicubic resize, the weights
    ``jax.image.resize(..., "bicubic")`` computes (jax/_src/image/scale.py:
    ``compute_weight_mat`` with Keys' cubic, half-pixel centres, antialiasing
    on): when shrinking, the kernel is stretched by src / dst so that it
    low-passes; each output's weights are normalised to sum to 1."""
    f32 = np.float32
    scale = f32(dst) / f32(src)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(dst, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(src, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x).astype(f32)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def interpolate_pos_embed(pos, src_grid: int, dst_grid: int) -> torch.Tensor:
    """Bicubic 2-D interpolation of patch position embeddings ``[N, C]`` from
    a ``src_grid`` square to ``dst_grid``, as the JAX package's
    ``jax.image.resize`` (:func:`resize_matrix`; ``F.interpolate``'s bicubic
    takes a = -0.75 and no antialiasing, so it differs)."""
    pos = to_tensor(pos)
    if src_grid == dst_grid:
        return pos
    C = pos.shape[-1]
    m = torch.from_numpy(resize_matrix(src_grid, dst_grid)).to(pos.device)
    grid = pos.reshape(src_grid, src_grid, C)
    out = torch.einsum("hwc,hi,wj->ijc", grid, m, m)
    return out.reshape(dst_grid * dst_grid, C)


def _weight_bias(sd: Mapping, name: str) -> Params:
    """A linear's or a LayerNorm's ``{"weight", "bias"}`` under ``name``."""
    return {"weight": to_tensor(sd[f"{name}.weight"]), "bias": to_tensor(sd[f"{name}.bias"])}


def _fuse_qkv(sd: Mapping, prefix: str, q: str, k: str, v: str) -> Params:
    """Separate q, k, v linears -> one ``[3C, C]`` linear (rows q, k, v)."""
    names = [f"{prefix}.{n}" for n in (q, k, v)]
    return {"weight": torch.cat([to_tensor(sd[f"{n}.weight"]) for n in names], 0),
            "bias": torch.cat([to_tensor(sd[f"{n}.bias"]) for n in names], 0)}


def _hf_clip_like_blocks(sd: Mapping, pre: str) -> list:
    """The encoder layers of an HF SigLIP / CLIP vision model."""
    dot = f"{pre}." if pre else ""
    blocks = []
    i = 0
    while f"{dot}encoder.layers.{i}.layer_norm1.weight" in sd:
        base = f"{dot}encoder.layers.{i}"
        blocks.append({
            "ln1": _weight_bias(sd, f"{base}.layer_norm1"),
            "ln2": _weight_bias(sd, f"{base}.layer_norm2"),
            "attn": {"qkv": _fuse_qkv(sd, f"{base}.self_attn", "q_proj", "k_proj", "v_proj"),
                     "proj": _weight_bias(sd, f"{base}.self_attn.out_proj")},
            "mlp": {"fc1": _weight_bias(sd, f"{base}.mlp.fc1"), "fc2": _weight_bias(sd, f"{base}.mlp.fc2")},
        })
        i += 1
    return blocks


def _vision_prefix(sd: Mapping) -> str:
    return "vision_model" if any(key.startswith("vision_model") for key in sd) else ""


def import_siglip_vision(sd: Mapping, dst_grid: int) -> Params:
    """HF SiglipVisionModel state dict -> ViT parameters (no cls, no layer scale)."""
    pre = _vision_prefix(sd)
    g = lambda name: to_tensor(sd[f"{pre}.{name}" if pre else name])
    pos = g("embeddings.position_embedding.weight")
    src_grid = int(round(pos.shape[0] ** 0.5))
    return {
        "patch_embed": {"weight": g("embeddings.patch_embedding.weight"),
                        "bias": g("embeddings.patch_embedding.bias")},
        "pos_embed": interpolate_pos_embed(pos, src_grid, dst_grid),
        "blocks": _hf_clip_like_blocks(sd, pre),
        "ln_out": {"weight": g("post_layernorm.weight"), "bias": g("post_layernorm.bias")},
    }


def import_clip_vision(sd: Mapping, dst_grid: int) -> Params:
    """HF CLIPVisionModel state dict -> ViT parameters (cls, pre-LN, quick-gelu)."""
    pre = _vision_prefix(sd)
    g = lambda name: to_tensor(sd[f"{pre}.{name}" if pre else name])
    pos = g("embeddings.position_embedding.weight")  # [1+N, C]
    cls_pos, patch_pos = pos[:1], pos[1:]
    src_grid = int(round(patch_pos.shape[0] ** 0.5))
    return {
        "cls_token": g("embeddings.class_embedding").reshape(-1),
        "patch_embed": {"weight": g("embeddings.patch_embedding.weight")},
        "pos_embed": torch.cat([cls_pos, interpolate_pos_embed(patch_pos, src_grid, dst_grid)], 0),
        # HF spells it "pre_layrnorm"
        "pre_ln": {"weight": g("pre_layrnorm.weight"), "bias": g("pre_layrnorm.bias")},
        "blocks": _hf_clip_like_blocks(sd, pre),
        "ln_out": {"weight": g("post_layernorm.weight"), "bias": g("post_layernorm.bias")},
    }


def import_dinov2_vision(sd: Mapping, dst_grid: int) -> Params:
    """HF Dinov2WithRegistersModel state dict -> ViT parameters (cls +
    registers, layer scale)."""
    g = lambda name: to_tensor(sd[name])
    pos = g("embeddings.position_embeddings")[0]  # [1+N, C]
    cls_pos, patch_pos = pos[:1], pos[1:]
    src_grid = int(round(patch_pos.shape[0] ** 0.5))
    p: Params = {
        "cls_token": g("embeddings.cls_token").reshape(-1),
        "reg_tokens": g("embeddings.register_tokens")[0],
        "patch_embed": {"weight": g("embeddings.patch_embeddings.projection.weight"),
                        "bias": g("embeddings.patch_embeddings.projection.bias")},
        "pos_embed": torch.cat([cls_pos, interpolate_pos_embed(patch_pos, src_grid, dst_grid)], 0),
        "blocks": [],
        "ln_out": _weight_bias(sd, "layernorm"),
    }
    i = 0
    while f"encoder.layer.{i}.norm1.weight" in sd:
        base = f"encoder.layer.{i}"
        p["blocks"].append({
            "ln1": _weight_bias(sd, f"{base}.norm1"),
            "ln2": _weight_bias(sd, f"{base}.norm2"),
            "ls1": g(f"{base}.layer_scale1.lambda1"),
            "ls2": g(f"{base}.layer_scale2.lambda1"),
            "attn": {"qkv": _fuse_qkv(sd, f"{base}.attention.attention", "query", "key", "value"),
                     "proj": _weight_bias(sd, f"{base}.attention.output.dense")},
            "mlp": {"fc1": _weight_bias(sd, f"{base}.mlp.fc1"), "fc2": _weight_bias(sd, f"{base}.mlp.fc2")},
        })
        i += 1
    return p


def import_sam_vision(sd: Mapping) -> Params:
    """SAM image encoder -> SAM parameters. Layouts: HF SamModel
    (``vision_encoder.*``), Meta SAM checkpoints (``image_encoder.*``,
    Sequential neck ``neck.{0..3}``), or the reference's vendored encoder
    with no prefix, which is what ``vit.sam_featurizer.*`` of a combined
    VisualRWKV checkpoint strips down to (reference sam.py:149-167)."""
    if any(k.startswith("vision_encoder.") for k in sd):
        pre, layers = "vision_encoder", "layers"
    elif any(k.startswith("image_encoder.") for k in sd):
        pre, layers = "image_encoder", "blocks"
    else:
        pre, layers = "", "blocks"
    dot = f"{pre}." if pre else ""
    g = lambda name: to_tensor(sd[f"{dot}{name}"])
    patch = "patch_embed.projection" if f"{dot}patch_embed.projection.weight" in sd else "patch_embed.proj"

    def neck(named: str, index: int) -> str:
        # HF names the neck's convolutions and norms; Meta and vendored number them
        return f"neck.{named}" if f"{dot}neck.{named}.weight" in sd else f"neck.{index}"

    p: Params = {
        "patch_embed": {"weight": g(f"{patch}.weight"), "bias": g(f"{patch}.bias")},
        "pos_embed": g("pos_embed")[0],  # [64, 64, C]
        "blocks": [],
        "neck": {
            "conv1": {"weight": g(f"{neck('conv1', 0)}.weight")},
            "ln1": _weight_bias(sd, dot + neck("layer_norm1", 1)),
            "conv2": {"weight": g(f"{neck('conv2', 2)}.weight")},
            "ln2": _weight_bias(sd, dot + neck("layer_norm2", 3)),
        },
    }
    i = 0
    while f"{dot}{layers}.{i}.layer_norm1.weight" in sd or f"{dot}{layers}.{i}.norm1.weight" in sd:
        base = f"{dot}{layers}.{i}"
        ln = "layer_norm" if f"{base}.layer_norm1.weight" in sd else "norm"
        p["blocks"].append({
            "ln1": _weight_bias(sd, f"{base}.{ln}1"),
            "ln2": _weight_bias(sd, f"{base}.{ln}2"),
            "attn": {"qkv": _weight_bias(sd, f"{base}.attn.qkv"), "proj": _weight_bias(sd, f"{base}.attn.proj"),
                     "rel_pos_h": to_tensor(sd[f"{base}.attn.rel_pos_h"]),
                     "rel_pos_w": to_tensor(sd[f"{base}.attn.rel_pos_w"])},
            "mlp": {"fc1": _weight_bias(sd, f"{base}.mlp.lin1"), "fc2": _weight_bias(sd, f"{base}.mlp.lin2")},
        })
        i += 1
    return p


def import_timm_vit(sd: Mapping, dst_grid: int) -> Params:
    """timm VisionTransformer state dict -> ViT parameters: the layout of the
    towers inside released VisualRWKV checkpoints (``vit.{dino,siglip}_
    featurizer.*``, reference vision.py:58-81): fused ``blocks.{i}.attn.qkv``,
    optional ``cls_token`` / ``reg_token`` / LayerScale ``ls{1,2}.gamma``; the
    SigLIP variant's unused ``attn_pool.*`` head is skipped. Where the model
    has no position row for the cls token (timm ``no_embed_class``), a zero
    row is emitted, the same function as timm's."""
    g = lambda name: to_tensor(sd[name])
    pos = g("pos_embed")[0]  # [N(+1), C]
    has_cls = "cls_token" in sd
    n_pos = pos.shape[0]
    src_grid = int(round(n_pos**0.5))
    if has_cls and src_grid * src_grid != n_pos:  # pos covers cls + patches
        cls_pos, patch_pos = pos[:1], pos[1:]
        src_grid = int(round(patch_pos.shape[0] ** 0.5))
    else:  # patches only (no_embed_class): a zero row for cls
        cls_pos, patch_pos = pos.new_zeros(1, pos.shape[-1]), pos
    patch_pos = interpolate_pos_embed(patch_pos, src_grid, dst_grid)

    p: Params = {"patch_embed": {"weight": g("patch_embed.proj.weight")}, "blocks": [],
                 "ln_out": _weight_bias(sd, "norm")}
    if "patch_embed.proj.bias" in sd:
        p["patch_embed"]["bias"] = g("patch_embed.proj.bias")
    if has_cls:
        p["cls_token"] = g("cls_token").reshape(-1)
        p["pos_embed"] = torch.cat([cls_pos, patch_pos], 0)
    else:
        p["pos_embed"] = patch_pos
    if "reg_token" in sd:
        p["reg_tokens"] = g("reg_token")[0]
    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        base = f"blocks.{i}"
        blk = {
            "ln1": _weight_bias(sd, f"{base}.norm1"),
            "ln2": _weight_bias(sd, f"{base}.norm2"),
            "attn": {"qkv": _weight_bias(sd, f"{base}.attn.qkv"), "proj": _weight_bias(sd, f"{base}.attn.proj")},
            "mlp": {"fc1": _weight_bias(sd, f"{base}.mlp.fc1"), "fc2": _weight_bias(sd, f"{base}.mlp.fc2")},
        }
        if f"{base}.ls1.gamma" in sd:
            blk["ls1"] = g(f"{base}.ls1.gamma")
            blk["ls2"] = g(f"{base}.ls2.gamma")
        p["blocks"].append(blk)
        i += 1
    return p


def _export_block(sd: Dict[str, torch.Tensor], base: str, blk: Params, mlp: str) -> None:
    """A ViT / SAM block's norms and linears under timm's names (the MLP's
    linears ``{mlp}1`` / ``{mlp}2``: timm's ``fc``, vendored SAM's ``lin``)."""
    parts = (("norm1", blk["ln1"]), ("norm2", blk["ln2"]), ("attn.qkv", blk["attn"]["qkv"]),
             ("attn.proj", blk["attn"]["proj"]), (f"mlp.{mlp}1", blk["mlp"]["fc1"]),
             (f"mlp.{mlp}2", blk["mlp"]["fc2"]))
    for name, node in parts:
        sd[f"{base}.{name}.weight"] = node["weight"].detach().float()
        sd[f"{base}.{name}.bias"] = node["bias"].detach().float()


def export_timm_vit(p: Params) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`import_timm_vit`: ViT parameters -> the timm
    state-dict layout (that of the towers inside released combined
    checkpoints), fp32 tensors on the parameters' device."""
    f = lambda t: t.detach().float()
    sd: Dict[str, torch.Tensor] = {"patch_embed.proj.weight": f(p["patch_embed"]["weight"])}
    if "bias" in p["patch_embed"]:
        sd["patch_embed.proj.bias"] = f(p["patch_embed"]["bias"])
    sd["pos_embed"] = f(p["pos_embed"])[None]
    if "cls_token" in p:
        sd["cls_token"] = f(p["cls_token"]).reshape(1, 1, -1)
    if "reg_tokens" in p:
        sd["reg_token"] = f(p["reg_tokens"])[None]
    sd["norm.weight"], sd["norm.bias"] = f(p["ln_out"]["weight"]), f(p["ln_out"]["bias"])
    for i, blk in enumerate(p["blocks"]):
        _export_block(sd, f"blocks.{i}", blk, "fc")
        if "ls1" in blk:
            sd[f"blocks.{i}.ls1.gamma"] = f(blk["ls1"])
            sd[f"blocks.{i}.ls2.gamma"] = f(blk["ls2"])
    return sd


def export_sam_vision(p: Params) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`import_sam_vision` into the reference's vendored
    encoder layout (no prefix, Sequential neck ``neck.{0..3}``): what a
    combined checkpoint holds under ``vit.sam_featurizer.``. fp32 tensors on
    the parameters' device."""
    f = lambda t: t.detach().float()
    sd: Dict[str, torch.Tensor] = {"patch_embed.proj.weight": f(p["patch_embed"]["weight"]),
                                   "patch_embed.proj.bias": f(p["patch_embed"]["bias"]),
                                   "pos_embed": f(p["pos_embed"])[None]}
    neck = p["neck"]
    sd["neck.0.weight"], sd["neck.2.weight"] = f(neck["conv1"]["weight"]), f(neck["conv2"]["weight"])
    for i, ln in ((1, "ln1"), (3, "ln2")):
        sd[f"neck.{i}.weight"], sd[f"neck.{i}.bias"] = f(neck[ln]["weight"]), f(neck[ln]["bias"])
    for i, blk in enumerate(p["blocks"]):
        _export_block(sd, f"blocks.{i}", blk, "lin")
        for name in ("rel_pos_h", "rel_pos_w"):
            sd[f"blocks.{i}.attn.{name}"] = f(blk["attn"][name])
    return sd
