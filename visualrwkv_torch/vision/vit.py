"""Generic ViT encoder (DINOv2-with-registers, SigLIP and CLIP towers).

Counterpart of ``visualrwkv_tpu/vision/vit.py``. Parameters are plain dicts
of tensors in PyTorch layouts: linears ``[out, in]``, the patch embedding a
``Conv2d`` weight ``[C, 3, p, p]``. Pixels enter as ``[B, H, W, 3]``;
features leave as ``[B, num_patches, width]`` at ``feature_layer`` (prefix
tokens stripped, no final norm), or ``[B, 1 + num_patches, width]`` with the
CLS token first under ``keep_cls_feature`` (CLIP's grid pooling). LayerNorm
and softmax run fp32, matmuls in the compute dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from visualrwkv_torch.vision.flash import mha, mha_reference

Tensor = torch.Tensor
Params = Dict[str, Any]


@dataclass(frozen=True)
class ViTConfig:
    img_size: int = 448
    patch_size: int = 14
    width: int = 1024
    depth: int = 24
    heads: int = 16
    mlp_dim: int = 4096
    act: str = "gelu"  # "gelu" | "gelu_tanh" | "quick_gelu"
    use_cls: bool = True
    num_reg: int = 0
    layerscale: bool = False
    pre_ln: bool = False  # CLIP: LayerNorm after the embeddings
    patch_bias: bool = True
    keep_cls_feature: bool = False  # CLIP grid pooling wants [cls, patches]
    ln_eps: float = 1e-6
    feature_layer: int = -2
    compute_dtype: str = "bfloat16"

    @property
    def grid(self) -> int:
        if self.img_size % self.patch_size:
            raise ValueError(f"img_size {self.img_size} % patch_size {self.patch_size}")
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


DINOV2_L_REG4 = ViTConfig(
    img_size=448, patch_size=14, width=1024, depth=24, heads=16, mlp_dim=4096,
    act="gelu", use_cls=True, num_reg=4, layerscale=True,
)
SIGLIP_SO400M = ViTConfig(
    img_size=448, patch_size=14, width=1152, depth=27, heads=16, mlp_dim=4304,
    act="gelu_tanh", use_cls=False, num_reg=0, layerscale=False,
)
CLIP_L_336 = ViTConfig(
    img_size=336, patch_size=14, width=1024, depth=24, heads=16, mlp_dim=4096,
    act="quick_gelu", use_cls=True, num_reg=0, layerscale=False,
    pre_ln=True, patch_bias=False, keep_cls_feature=True, ln_eps=1e-5,
)

MHA_MIN_TOKENS = 256  # below this the plain attention runs (as the JAX package does)


def _normal(gen: torch.Generator, shape, std: float, device, dtype) -> Tensor:
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def _ln_init(C: int, device, dtype) -> Params:
    return {"weight": torch.ones(C, device=device, dtype=dtype),
            "bias": torch.zeros(C, device=device, dtype=dtype)}


def _linear_init(gen, din: int, dout: int, device, dtype, std: float = 0.02) -> Params:
    return {"weight": _normal(gen, (dout, din), std, device, dtype),
            "bias": torch.zeros(dout, device=device, dtype=dtype)}


def init_vit_params(gen: torch.Generator, cfg: ViTConfig, device="cuda",
                    dtype=torch.float32) -> Params:
    """Random init with the JAX package's distributions (normal 0.02 for
    weights and embeddings, zero biases, LayerScale 1e-5)."""
    C, p = cfg.width, cfg.patch_size
    params: Params = {
        "patch_embed": {"weight": _normal(gen, (C, 3, p, p), 0.02, device, dtype)},
        "pos_embed": _normal(gen, (cfg.num_patches + (1 if cfg.use_cls else 0), C), 0.02, device, dtype),
        "blocks": [],
    }
    if cfg.patch_bias:
        params["patch_embed"]["bias"] = torch.zeros(C, device=device, dtype=dtype)
    if cfg.pre_ln:
        params["pre_ln"] = _ln_init(C, device, dtype)
    if cfg.use_cls:
        params["cls_token"] = torch.zeros(C, device=device, dtype=dtype)
    if cfg.num_reg:
        params["reg_tokens"] = _normal(gen, (cfg.num_reg, C), 0.02, device, dtype)
    for _ in range(cfg.depth):
        blk = {
            "ln1": _ln_init(C, device, dtype),
            "ln2": _ln_init(C, device, dtype),
            "attn": {"qkv": _linear_init(gen, C, 3 * C, device, dtype),
                     "proj": _linear_init(gen, C, C, device, dtype)},
            "mlp": {"fc1": _linear_init(gen, C, cfg.mlp_dim, device, dtype),
                    "fc2": _linear_init(gen, cfg.mlp_dim, C, device, dtype)},
        }
        if cfg.layerscale:
            blk["ls1"] = torch.full((C,), 1e-5, device=device, dtype=dtype)
            blk["ls2"] = torch.full((C,), 1e-5, device=device, dtype=dtype)
        params["blocks"].append(blk)
    params["ln_out"] = _ln_init(C, device, dtype)
    return params


def layer_norm(p: Params, x: Tensor, eps: float) -> Tensor:
    """LayerNorm in fp32, result in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], p["weight"].float(), p["bias"].float(), eps).to(x.dtype)


def dense(p: Params, x: Tensor, dt: torch.dtype) -> Tensor:
    """x @ W^T (+ b) with operands in ``dt``; the result is fp32."""
    y = F.linear(x.to(dt), p["weight"].to(dt)).float()
    return y + p["bias"].float() if "bias" in p else y


def _act(x: Tensor, kind: str) -> Tensor:
    if kind == "gelu":
        return F.gelu(x)
    if kind == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if kind == "quick_gelu":  # CLIP: x * sigmoid(1.702 x)
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(kind)


def attention(p: Params, x: Tensor, heads: int, dt: torch.dtype) -> Tensor:
    """Bidirectional MHA: kernel K3 (through :func:`mha`) from
    ``MHA_MIN_TOKENS`` tokens, the plain version below."""
    B, N, C = x.shape
    hd = C // heads
    qkv = dense(p["qkv"], x, dt).reshape(B, N, 3, heads, hd)
    q, k, v = (qkv[:, :, i].to(dt).contiguous() for i in range(3))
    out = mha(q, k, v) if N >= MHA_MIN_TOKENS else mha_reference(q, k, v)
    return dense(p["proj"], out.reshape(B, N, C), dt)


def patchify(p: Params, pixels: Tensor, patch: int, dt: torch.dtype) -> Tensor:
    """[B, H, W, 3] -> [B, N, C]: the patch convolution (stride = patch)."""
    y = F.conv2d(pixels.permute(0, 3, 1, 2).to(dt), p["weight"].to(dt), stride=patch).float()
    if "bias" in p:
        y = y + p["bias"].float()[:, None, None]
    return y.flatten(2).transpose(1, 2)


def vit_block(p: Params, cfg: ViTConfig, x: Tensor, dt: torch.dtype) -> Tensor:
    h = attention(p["attn"], layer_norm(p["ln1"], x, cfg.ln_eps), cfg.heads, dt)
    if cfg.layerscale:
        h = h * p["ls1"].float()
    x = x + h.to(x.dtype)
    h = dense(p["mlp"]["fc1"], layer_norm(p["ln2"], x, cfg.ln_eps), dt)
    h = dense(p["mlp"]["fc2"], _act(h, cfg.act).to(dt), dt)
    if cfg.layerscale:
        h = h * p["ls2"].float()
    return x + h.to(x.dtype)


def vit_features(params: Params, cfg: ViTConfig, pixels: Tensor,
                 feature_layer: Optional[int] = None) -> Tensor:
    """Patch features [B, num_patches, width] at ``feature_layer`` ([cls,
    patches] under ``keep_cls_feature``)."""
    dt = getattr(torch, cfg.compute_dtype)
    fl = (cfg.feature_layer if feature_layer is None else feature_layer) % cfg.depth
    x = patchify(params["patch_embed"], pixels, cfg.patch_size, dt)
    B = x.shape[0]
    n_prefix = 0
    if cfg.use_cls:
        cls = params["cls_token"].to(x.dtype).expand(B, 1, cfg.width)
        x = torch.cat([cls, x], dim=1)
        n_prefix = 1
    x = x + params["pos_embed"].to(x.dtype)
    if cfg.num_reg:
        reg = params["reg_tokens"].to(x.dtype).expand(B, cfg.num_reg, cfg.width)
        x = torch.cat([x[:, :n_prefix], reg, x[:, n_prefix:]], dim=1)
        n_prefix += cfg.num_reg
    if cfg.pre_ln:
        x = layer_norm(params["pre_ln"], x, cfg.ln_eps)
    for i in range(fl + 1):
        x = vit_block(params["blocks"][i], cfg, x, dt)
    return x if cfg.keep_cls_feature else x[:, n_prefix:]


def blocks_run(cfg: ViTConfig) -> int:
    """How many blocks :func:`vit_features` runs (one attention each)."""
    return cfg.feature_layer % cfg.depth + 1

