"""Visual token compressor (v7.03 / v7.04). Counterpart of
``visualrwkv_tpu/multimodal/vtc.py``.

``n_vtc_layer`` RWKV blocks run over the projected visual tokens in both
directions (the whole sequence reversed on odd blocks), then a LayerNorm;
the blocks may start as copies of the LM's first blocks (reference
VisualRWKV-v7/v7.03/src/model.py:329-375,408-413). Tokens are left-padded
with zero vectors to a multiple of ``chunk_len``. The WKV recurrence is the
LM's: on CUDA kernel K1 without autograd, K5 / K6 with it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from visualrwkv_torch.config import RWKVConfig
from visualrwkv_torch.models.lm import lm_block_forward
from visualrwkv_torch.models.rwkv7 import _cast_tree, _ln_init, init_cmix_x070, init_tmix_x070, layer_norm
from visualrwkv_torch.train.optim import tree_map

Tensor = torch.Tensor
Params = Dict[str, Any]


def init_vtc_params(gen: torch.Generator, cfg: RWKVConfig, n_vtc_layer: int, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Params:
    """Fresh x070 blocks (the LM's init formulas at layers 0..n-1) and an
    output LayerNorm; ``dtype`` an optional storage dtype."""
    C = cfg.n_embd
    blocks: List[Params] = []
    for i in range(n_vtc_layer):
        blk = {"ln1": _ln_init(C, device), "ln2": _ln_init(C, device),
               "att": init_tmix_x070(gen, cfg, i, device), "ffn": init_cmix_x070(gen, cfg, i, device)}
        if i == 0:
            blk["ln0"] = _ln_init(C, device)
        blocks.append(blk)
    out = {"blocks": blocks, "ln_out": _ln_init(C, device)}
    return _cast_tree(out, dtype) if dtype is not None else out


def init_vtc_from_lm(lm_params: Params, n_vtc_layer: int) -> Params:
    """Copies of the LM's first ``n_vtc_layer`` blocks and its ``ln_out``
    (the reference's init_vtc_weights). Copies, not the same tensors: the
    compressor and the LM train apart."""
    copy = lambda t: t.detach().clone()
    return {"blocks": tree_map(copy, lm_params["blocks"][:n_vtc_layer]),
            "ln_out": tree_map(copy, lm_params["ln_out"])}


def vtc_forward(params: Params, cfg: RWKVConfig, x: Tensor, grad_cp=False) -> Tensor:
    """Contextualise the visual tokens ``[B, L, C]`` -> ``[B, L, C]``."""
    B, T, C = x.shape
    pad = (-T) % cfg.chunk_len
    if pad:
        x = torch.cat([x.new_zeros(B, pad, C), x], dim=1)
    v_first = None
    for i, blk in enumerate(params["blocks"]):
        reverse = i % 2 == 1
        if reverse:
            x = x.flip(1)
            v_first = None if v_first is None else v_first.flip(1)
        x, v_first, _ = lm_block_forward(blk, cfg, i, x, v_first, grad_cp=grad_cp)
        if reverse:
            x = x.flip(1)
            v_first = None if v_first is None else v_first.flip(1)
    x = layer_norm(params["ln_out"], x)
    return x[:, pad:] if pad else x
