"""RWKV-4 ("x040") language model in PyTorch: the frozen RWKV-4 World RNN of
the legacy VisualRWKV-v4. Counterpart of ``visualrwkv_tpu/models/rwkv4.py``.

Static token-shift mixes as x052, a per-channel (headless) recurrence with
the log-domain (aa, bb, pp) state (:mod:`visualrwkv_torch.ops.wkv4`: kernel
K17 for a sequence on CUDA, K18 its gradient), a sigmoid receptance, and x052's squared-ReLU
ChannelMix. The tree is the checkpoint's: ``blocks.N.att.{time_decay,
time_first, time_mix_k/v/r, key/value/receptance/output}``,
``blocks.N.ffn.{time_mix_k/r, key/receptance/value}``, and ``blocks.0.ln0``
applied in the forward (the reference folds it into the embedding when it
loads). ``time_decay`` is stored raw; the forward takes
``w = -exp(time_decay)``, the reference's load-time transform. Linears are
``{"weight": [out, in]}``. The state of a layer is ``LayerState(att_shift
[B, C], wkv [B, C, 3] fp32, ffn_shift [B, C])``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from visualrwkv_torch.config import RWKVConfig
from visualrwkv_torch.models.rwkv5 import cmix_x052, init_legacy_params, legacy_forward, static_mixes
from visualrwkv_torch.models.rwkv7 import (
    LayerState,
    _token_shift,
    _uniform,
    embed,
    layer_norm,
    linear,
    split_region,
)
from visualrwkv_torch.ops.wkv4 import wkv4, wkv4_init_state, wkv4_step
from visualrwkv_torch.parallel.collectives import reduce_from_model
from visualrwkv_torch.parallel.tensor import local_slice, model_group, split_rows

Tensor = torch.Tensor
Params = Dict[str, Any]


def init_tmix_x040(gen: torch.Generator, cfg: RWKVConfig, layer_id: int, device) -> Params:
    """RWKV-4's init: a per-channel decay, ``time_first`` zigzagging around
    log(0.3), positional mixing powers."""
    C, A = cfg.n_embd, cfg.dim_att
    r01 = layer_id / max(1, cfg.n_layer - 1)
    r10 = 1.0 - layer_id / cfg.n_layer
    ddd = torch.arange(C, dtype=torch.float32, device=device) / C
    n = torch.arange(A, dtype=torch.float64, device=device)
    decay_speed = (-5 + 8 * (n / max(1, A - 1)) ** (0.7 + 1.3 * r01)).float()
    zigzag = (0.5 * ((n + 1) % 3 - 1)).float()
    u = lambda shape, s: _uniform(gen, shape, -s, s, device)
    return {
        "time_decay": decay_speed,
        "time_first": torch.full((A,), math.log(0.3), device=device) + zigzag,
        "time_mix_k": ddd**r10,
        "time_mix_v": ddd**r10 + 0.3 * r01,
        "time_mix_r": ddd ** (0.5 * r10),
        "receptance": {"weight": u((A, C), 0.5 / C**0.5)},
        "key": {"weight": u((A, C), 0.05 / C**0.5)},
        "value": {"weight": u((A, C), 0.5 / C**0.5)},
        "output": {"weight": torch.zeros(C, A, device=device)},
    }


def init_rwkv4_params(gen: torch.Generator, cfg: RWKVConfig, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Params:
    return init_legacy_params(gen, cfg, init_tmix_x040, device, dtype)


def init_state_x040(cfg: RWKVConfig, batch: int, device="cuda") -> List[LayerState]:
    """The token-shift carries are ``n_embd`` wide (they hold the block's
    input); the (aa, bb, pp) recurrence runs over the ``dim_att`` channels."""
    return [
        LayerState(torch.zeros(batch, cfg.n_embd, device=device),
                   wkv4_init_state(batch, cfg.dim_att, device),
                   torch.zeros(batch, cfg.n_embd, device=device))
        for _ in range(cfg.n_layer)
    ]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _tmix_inputs(p: Params, cfg: RWKVConfig, xf: Tensor, prev: Tensor):
    """(r after its sigmoid, k, v) fp32 and the log decay ``w``."""
    dt = cfg.dtype
    xk, xv, xr = static_mixes(p, xf, prev, dt, ("k", "v", "r"))
    r = torch.sigmoid(linear(p["receptance"], xr, dt))
    k = linear(p["key"], xk, dt)
    v = linear(p["value"], xv, dt)
    return r, k, v, -torch.exp(p["time_decay"].float())


def tmix_x040(p: Params, cfg: RWKVConfig, x: Tensor, shift_state: Optional[Tensor] = None,
              wkv_state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (out, new_shift_state, new_wkv_state). Under a model axis
    that split the projections, the recurrence runs on this rank's slice of
    the ``dim_att`` channels (``time_decay`` and ``time_first`` through it)."""
    group = model_group()
    split = split_rows(p["receptance"], cfg.dim_att, group)
    if split:
        sl = local_slice(cfg.dim_att, group)
        p = dict(p, time_decay=p["time_decay"][sl], time_first=p["time_first"][sl])
        x, shift_state = split_region(x, shift_state, group)
    xf = x.float()
    r, k, v, w = _tmix_inputs(p, cfg, xf, _token_shift(xf, shift_state))
    y, new_wkv = wkv4(w, p["time_first"], k, v, initial_state=wkv_state)
    out = linear(p["output"], (r * y).to(cfg.dtype), cfg.dtype)
    return (reduce_from_model(out, group) if split else out), xf[:, -1].clone(), new_wkv


def block_x040(p: Params, cfg: RWKVConfig, layer_id: int, x: Tensor,
               state: Optional[LayerState] = None) -> Tuple[Tensor, LayerState]:
    if layer_id == 0:
        x = layer_norm(p["ln0"], x)
    att_shift, wkv_state, ffn_shift = state if state is not None else (None, None, None)
    xx, new_att_shift, new_wkv = tmix_x040(p["att"], cfg, layer_norm(p["ln1"], x), att_shift,
                                           wkv_state)
    x = x + xx
    ff, new_ffn_shift = cmix_x052(p["ffn"], cfg, layer_norm(p["ln2"], x), ffn_shift)
    return x + ff, LayerState(new_att_shift, new_wkv, new_ffn_shift)


def rwkv4_forward(params: Params, cfg: RWKVConfig, x: Tensor,
                  states: Optional[List[LayerState]] = None, grad_cp=False,
                  return_hidden: bool = False) -> Tuple[Tensor, List[LayerState]]:
    """Forward over input embeddings ``x`` [B, T, C]: the per-channel
    recurrence takes any T, so nothing is padded. The RNN is frozen in the
    reference (only the v4 adapter trains), and a gradient with respect to
    its input runs through ``ops.wkv4.WKV4Function`` (K17 forward, K18
    backward on CUDA; their plain versions on the CPU)."""
    return legacy_forward(params, cfg, x, states, grad_cp, return_hidden, block_x040, pad=0)


# ---------------------------------------------------------------------------
# O(1) decode step
# ---------------------------------------------------------------------------


def rwkv4_decode_step(params: Params, cfg: RWKVConfig, token: Tensor,
                      states: List[LayerState]) -> Tuple[Tensor, List[LayerState]]:
    """One autoregressive step. token [B] -> (logits [B, vocab] fp32, states)."""
    return rwkv4_decode_step_embed(params, cfg, embed(params, token), states)


def rwkv4_decode_step_embed(params: Params, cfg: RWKVConfig, x_emb: Tensor,
                            states: List[LayerState]) -> Tuple[Tensor, List[LayerState]]:
    """One step from an input embedding [B, C] with the elementwise
    (aa, bb, pp) step (``ops.wkv4.wkv4_step``) on both devices."""
    x = x_emb[:, None, :]
    new_states: List[LayerState] = []
    for i, blk in enumerate(params["blocks"]):
        st = states[i]
        if i == 0:
            x = layer_norm(blk["ln0"], x)
        p = blk["att"]
        xf = layer_norm(blk["ln1"], x).float()
        r, k, v, w = _tmix_inputs(p, cfg, xf, st.att_shift[:, None, :])
        new_wkv, y = wkv4_step(st.wkv, w, p["time_first"], k[:, 0], v[:, 0])
        x = x + linear(p["output"], (r * y[:, None]).to(cfg.dtype), cfg.dtype)
        ff, new_ffn_shift = cmix_x052(blk["ffn"], cfg, layer_norm(blk["ln2"], x), st.ffn_shift)
        x = x + ff
        new_states.append(LayerState(xf[:, -1], new_wkv, new_ffn_shift))
    x = layer_norm(params["ln_out"], x)
    return linear(params["head"], x, cfg.dtype)[:, 0], new_states
