"""Weight-only int8 for serving. Counterpart of
``visualrwkv_tpu/infer/quant.py``.

A quantized linear is ``{"weight_q": int8 [out, in], "scale": fp32 [out]}``
(the port's ``[out, in]`` layout; the JAX package stores ``[in, out]``): a
symmetric scale per output channel, ``amax / 127``, with the values rounded
half to even, as ``jnp.round`` does, so both packages hold the same int8
values. The product dequantises to the compute dtype and multiplies
(:func:`linear_any`), as the JAX package's XLA fuses it; the JAX package has
no kernel of its own for it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = Dict[str, Any]

_QUANT_MIN_SIZE = 256 * 256


def quantize_weight(w: Tensor) -> Params:
    """``[out, in]`` float -> int8 values and an fp32 scale per output channel."""
    wf = w.float()
    scale = (wf.abs().amax(1) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127).to(torch.int8)
    return {"weight_q": q, "scale": scale}


def dequantize_weight(p: Params, dt: torch.dtype) -> Tensor:
    return (p["weight_q"].float() * p["scale"].float()[:, None]).to(dt)


def linear_any(p: Params, x: Tensor, dt: torch.dtype) -> Tensor:
    """x @ W^T (+ b) for a float or an int8 linear, operands in ``dt``; the
    result is fp32."""
    w = dequantize_weight(p, dt) if "weight_q" in p else p["weight"].to(dt)
    y = F.linear(x.to(dt), w).float()
    return y + p["bias"].float() if "bias" in p else y


def quantize_lm_params(params: Params, min_size: int = _QUANT_MIN_SIZE) -> Params:
    """Quantize every large 2-D linear weight of an LM or VLM parameter tree:
    each dict node ``{"weight": 2-D}`` (a bias kept beside it) of at least
    ``min_size`` elements, but the embedding (a gather, not a product).
    LoRA factors, mixing vectors and norms stay float, as in the JAX package.
    (The JAX package's patch embeddings are 2-D matrices there and are
    quantized with the rest; the port's are 4-D ``Conv2d`` weights and stay
    float.)"""

    def walk(node, name=""):
        if isinstance(node, dict):
            w = node.get("weight")
            if name != "emb" and isinstance(w, Tensor) and w.dim() == 2 and w.numel() >= min_size:
                out = quantize_weight(w)
                out.update((k, v) for k, v in node.items() if k != "weight")
                return out
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        return node

    return walk(params)
