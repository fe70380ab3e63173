"""RWKV-6 ("x060") language model in PyTorch: the published VisualRWKV-6
backbone.

Counterpart of ``visualrwkv_tpu/models/rwkv6.py``: five-way data-dependent
token shift through a shared LoRA, a data-dependent decay LoRA, the per-head
bonus ``time_faaaa``, a SiLU gate, and a receptance-gated ChannelMix.
Parameters are nested dicts with the JAX package's leaf names; linears are
``{"weight": [out, in]}`` (PyTorch's layout), the LoRA factors
``time_maa_w1 [C, 5*dm]``, ``time_maa_w2 [5, dm, C]``, ``time_decay_w1
[C, dd]`` and ``time_decay_w2 [dd, A]`` keep the JAX package's layout and are
used as ``x @ w``.

Compute policy as in :mod:`visualrwkv_torch.models.rwkv7`, whose helpers
(state, norms, token shift, embedding, linear) this module reuses. The
sequence path casts r, w_raw, k and v to the compute dtype before the WKV
(:func:`visualrwkv_torch.ops.wkv6.wkv6`: kernel K7 on CUDA, or K8 / K9 under
autograd); the decode step hands the one-token step fp32 vectors
(``wkv6_step_auto``: kernel K10 on CUDA), as the JAX package does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from visualrwkv_torch.config import STOP_TOKEN_INDEX, RWKVConfig
from visualrwkv_torch.models.rwkv7 import (
    GRAD_CP,
    LayerState,
    _cast_tree,
    _ln_init,
    _ortho,
    _token_shift,
    _uniform,
    embed,
    group_norm,
    layer_norm,
    linear,
)
from visualrwkv_torch.ops.wkv6 import wkv6, wkv6_step_auto

Tensor = torch.Tensor
Params = Dict[str, Any]

_MAA = ("time_maa_w", "time_maa_k", "time_maa_v", "time_maa_r", "time_maa_g")


def _d_mix_lora(cfg: RWKVConfig) -> int:
    return 64 if cfg.n_embd >= 4096 else 32


def _d_decay_lora(cfg: RWKVConfig) -> int:
    return 128 if cfg.n_embd >= 4096 else 64


# ---------------------------------------------------------------------------
# Init (the reference's formulas, as in the JAX package)
# ---------------------------------------------------------------------------


def init_tmix_x060(gen: torch.Generator, cfg: RWKVConfig, layer_id: int, device) -> Params:
    C, H, N, A = cfg.n_embd, cfg.n_head, cfg.head_size, cfg.dim_att
    r01 = layer_id / max(1, cfg.n_layer - 1)
    r10 = 1.0 - layer_id / cfg.n_layer
    ddd = torch.arange(C, dtype=torch.float32, device=device) / C
    n = torch.arange(A, dtype=torch.float64, device=device)
    decay_speed = (-6 + 5 * (n / max(1, A - 1)) ** (0.7 + 1.3 * r01)).float()
    zigzag = (((n + 1) % 3 - 1) * 0.1).float()
    faaaa = (r01 * (1 - n / max(1, A - 1))).float() + zigzag
    dm, dd = _d_mix_lora(cfg), _d_decay_lora(cfg)
    u = lambda shape, s: _uniform(gen, shape, -s, s, device)
    return {
        "time_maa_x": 1.0 - ddd**r10,
        "time_maa_w": 1.0 - ddd**r10,
        "time_maa_k": 1.0 - ddd**r10,
        "time_maa_v": 1.0 - (ddd**r10 + 0.3 * r01),
        "time_maa_r": 1.0 - ddd ** (0.5 * r10),
        "time_maa_g": 1.0 - ddd ** (0.5 * r10),
        "time_maa_w1": torch.zeros(C, dm * 5, device=device),
        "time_maa_w2": u((5, dm, C), 0.01),
        "time_decay": decay_speed,
        "time_decay_w1": torch.zeros(C, dd, device=device),
        "time_decay_w2": u((dd, A), 0.01),
        "time_faaaa": faaaa.reshape(H, N),
        "receptance": {"weight": u((A, C), 0.5 / C**0.5)},
        "key": {"weight": u((A, C), 0.05 / C**0.5)},
        "value": {"weight": u((A, C), 0.5 / C**0.5)},
        "gate": {"weight": u((A, C), 0.5 / C**0.5)},
        "output": {"weight": torch.zeros(C, A, device=device)},
        "ln_x": _ln_init(A, device),
    }


def init_cmix_x060(gen: torch.Generator, cfg: RWKVConfig, layer_id: int, device) -> Params:
    C = cfg.n_embd
    r10 = 1.0 - layer_id / cfg.n_layer
    ddd = torch.arange(C, dtype=torch.float32, device=device) / C
    s = 0.5 / C**0.5
    return {
        "time_maa_k": 1.0 - ddd**r10,
        "time_maa_r": 1.0 - ddd**r10,
        "key": {"weight": _uniform(gen, (cfg.dim_ffn, C), -s, s, device)},
        "receptance": {"weight": _uniform(gen, (C, C), -s, s, device)},
        "value": {"weight": torch.zeros(C, cfg.dim_ffn, device=device)},
    }


def init_rwkv6_params(gen: torch.Generator, cfg: RWKVConfig, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Params:
    """Random init; ``dtype`` is an optional storage dtype for every leaf
    (bf16 for serving 7B-scale models). Each leaf is cast as it is made, so
    the fp32 copy of the whole model never exists at once."""
    C = cfg.n_embd
    cast = (lambda t: _cast_tree(t, dtype)) if dtype is not None else (lambda t: t)
    blocks: List[Params] = []
    for i in range(cfg.n_layer):
        blk = {
            "ln1": _ln_init(C, device),
            "ln2": _ln_init(C, device),
            "att": init_tmix_x060(gen, cfg, i, device),
            "ffn": init_cmix_x060(gen, cfg, i, device),
        }
        if i == 0:
            blk["ln0"] = _ln_init(C, device)
        blocks.append(cast(blk))
    emb = cast(_uniform(gen, (cfg.vocab_size, C), -1e-4, 1e-4, device))
    # orthogonal head (gain 0.5); a scaled gaussian beyond the size where QR is slow
    if C * cfg.vocab_size <= 16 * 2**20:
        head = _ortho(gen, C, cfg.vocab_size, 0.5, device).t().contiguous()
    else:
        head = torch.randn(cfg.vocab_size, C, generator=gen, device=device) * (0.5 * C**-0.5)
    return {
        "emb": {"weight": emb},
        "blocks": blocks,
        "ln_out": cast(_ln_init(C, device)),
        "head": {"weight": cast(head)},
    }


# ---------------------------------------------------------------------------
# TimeMix / ChannelMix / Block (sequence mode, optional state)
# ---------------------------------------------------------------------------


def _tmix_inputs(p: Params, cfg: RWKVConfig, xf: Tensor, xx: Tensor):
    """The projections of a TimeMix: (r, w_raw, k, v, g), fp32."""
    dt = cfg.dtype
    B, T, C = xf.shape
    xxx = (xf + xx * p["time_maa_x"].float()).to(dt)
    mixed = torch.tanh((xxx @ p["time_maa_w1"].to(dt)).float())
    mixed = mixed.reshape(B, T, 5, -1)
    # per-branch LoRA: [B, T, 5, D] x [5, D, C] -> [B, T, 5, C]
    m = torch.einsum("btsd,sdc->btsc", mixed.to(dt), p["time_maa_w2"].to(dt)).float()
    xw, xk, xv, xr, xg = ((xf + xx * (p[n].float() + m[:, :, i])).to(dt) for i, n in enumerate(_MAA))
    r = linear(p["receptance"], xr, dt)
    k = linear(p["key"], xk, dt)
    v = linear(p["value"], xv, dt)
    g = F.silu(linear(p["gate"], xg, dt))
    ww = (torch.tanh((xw @ p["time_decay_w1"].to(dt)).float()).to(dt) @ p["time_decay_w2"].to(dt)).float()
    w_raw = p["time_decay"].float() + ww
    return r, w_raw, k, v, g


def _tmix_output(p: Params, cfg: RWKVConfig, y: Tensor, g: Tensor) -> Tensor:
    """ln_x (per-head group norm), the gate and the output projection; y [B, T, A]."""
    dt = cfg.dtype
    y = group_norm(p["ln_x"], y.to(dt), cfg.n_head, 1e-5 * cfg.head_size_divisor**2)
    return linear(p["output"], (y.float() * g.float()).to(dt), dt)


def tmix_x060(p: Params, cfg: RWKVConfig, x: Tensor, shift_state: Optional[Tensor] = None,
              wkv_state: Optional[Tensor] = None, wkv_fn=None) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (out, new_shift_state, new_wkv_state). ``wkv_fn`` replaces
    the WKV op (:func:`visualrwkv_torch.ops.wkv6.wkv6`'s call signature):
    the speculative verify pass gives ``ops.wkv6.wkv6_scan_states``, and the
    returned WKV state is then the trail ``[B, T, H, N, N]``."""
    B, T, C = x.shape
    dt = cfg.dtype
    xf = x.float()
    xx = _token_shift(xf, shift_state) - xf
    r, w_raw, k, v, g = _tmix_inputs(p, cfg, xf, xx)
    shp = (B, T, cfg.n_head, cfg.head_size)
    y, new_wkv = (wkv_fn or wkv6)(
        r.to(dt).reshape(shp), w_raw.to(dt).reshape(shp), k.to(dt).reshape(shp),
        v.to(dt).reshape(shp), p["time_faaaa"], initial_state=wkv_state, chunk=cfg.chunk_len,
    )
    # the shift carry is copied out: a view would keep all of xf alive with the state
    return _tmix_output(p, cfg, y.reshape(B, T, cfg.dim_att), g), xf[:, -1].clone(), new_wkv


def cmix_x060(p: Params, cfg: RWKVConfig, x: Tensor, shift_state: Optional[Tensor] = None
              ) -> Tuple[Tensor, Tensor]:
    dt = cfg.dtype
    xf = x.float()
    xx = _token_shift(xf, shift_state) - xf
    xk = (xf + xx * p["time_maa_k"].float()).to(dt)
    xr = (xf + xx * p["time_maa_r"].float()).to(dt)
    k = torch.relu(linear(p["key"], xk, dt)).square()  # relu^2 in fp32
    kv = linear(p["value"], k.to(dt), dt)
    return torch.sigmoid(linear(p["receptance"], xr, dt)) * kv, xf[:, -1].clone()


def block_x060(p: Params, cfg: RWKVConfig, layer_id: int, x: Tensor,
               state: Optional[LayerState] = None) -> Tuple[Tensor, LayerState]:
    if layer_id == 0:
        x = layer_norm(p["ln0"], x)
    att_shift, wkv_state, ffn_shift = state if state is not None else (None, None, None)
    xx, new_att_shift, new_wkv = tmix_x060(p["att"], cfg, layer_norm(p["ln1"], x), att_shift,
                                           wkv_state)
    x = x + xx
    ff, new_ffn_shift = cmix_x060(p["ffn"], cfg, layer_norm(p["ln2"], x), ffn_shift)
    return x + ff, LayerState(new_att_shift, new_wkv, new_ffn_shift)


def _block_checkpointed(blk: Params, cfg: RWKVConfig, layer_id: int, x: Tensor,
                        state: Optional[LayerState], block=None):
    """:func:`block_x060` (or ``block``, a block of the same signature: the
    x052 and x040 families') under activation checkpointing: only the
    block's inputs are kept and the block runs again in the backward pass."""
    block = block or block_x060

    def run(x, *st):
        y, ns = block(blk, cfg, layer_id, x, LayerState(*st) if st else None)
        return (y, *ns)

    y, *ns = checkpoint(run, x, *(state or ()), use_reentrant=False, preserve_rng_state=False)
    return y, LayerState(*ns)


def rwkv6_forward(params: Params, cfg: RWKVConfig, x: Tensor,
                  states: Optional[List[LayerState]] = None, grad_cp=False,
                  return_hidden: bool = False) -> Tuple[Tensor, List[LayerState]]:
    """Forward over input embeddings ``x`` [B, T, C], with the semantics of
    :func:`visualrwkv_torch.models.rwkv7.rwkv7_forward`: EOS left padding to
    a multiple of ``cfg.chunk_len`` when stateless, ``grad_cp`` (any policy
    but False gives the per-block non-reentrant checkpoint: the JAX
    package's x060 forward has no selective policy), ``return_hidden``."""
    if grad_cp not in GRAD_CP:
        raise ValueError(f"grad_cp must be one of {GRAD_CP}; got {grad_cp!r}")
    B, T, C = x.shape
    pad = (-T) % cfg.chunk_len
    if pad:
        if states is not None:
            raise ValueError("stateful forward requires T % chunk_len == 0")
        eos = embed(params, torch.full((B, pad), STOP_TOKEN_INDEX, dtype=torch.long, device=x.device))
        x = torch.cat([eos.to(x.dtype), x], dim=1)

    new_states: List[LayerState] = []
    for i, blk in enumerate(params["blocks"]):
        block = _block_checkpointed if grad_cp else block_x060
        x, ns = block(blk, cfg, i, x, states[i] if states is not None else None)
        new_states.append(ns)

    x = layer_norm(params["ln_out"], x)
    if pad:
        x = x[:, pad:]
    if return_hidden:
        return x, new_states
    return linear(params["head"], x, cfg.dtype), new_states


# ---------------------------------------------------------------------------
# O(1) decode step
# ---------------------------------------------------------------------------


def rwkv6_decode_step(params: Params, cfg: RWKVConfig, token: Tensor,
                      states: List[LayerState]) -> Tuple[Tensor, List[LayerState]]:
    """One autoregressive step. token [B] -> (logits [B, vocab] fp32, states)."""
    return rwkv6_decode_step_embed(params, cfg, embed(params, token), states)


def rwkv6_decode_step_embed(params: Params, cfg: RWKVConfig, x_emb: Tensor,
                            states: List[LayerState]) -> Tuple[Tensor, List[LayerState]]:
    """One step from an input embedding [B, C]; the WKV update is the
    one-token step on fp32 vectors (kernel K10 on CUDA, no decay floor). The
    carried WKV dtype is kept."""
    x = x_emb[:, None, :]
    B = x.shape[0]
    shp = (B, cfg.n_head, cfg.head_size)
    new_states: List[LayerState] = []
    for i, blk in enumerate(params["blocks"]):
        st = states[i]
        if i == 0:
            x = layer_norm(blk["ln0"], x)
        p = blk["att"]
        xf = layer_norm(blk["ln1"], x).float()
        xx = st.att_shift[:, None, :] - xf
        r, w_raw, k, v, g = _tmix_inputs(p, cfg, xf, xx)
        new_wkv, y = wkv6_step_auto(st.wkv, r.reshape(shp), w_raw.reshape(shp), k.reshape(shp),
                                    v.reshape(shp), p["time_faaaa"])
        x = x + _tmix_output(p, cfg, y.reshape(B, 1, -1), g)
        ff, new_ffn_shift = cmix_x060(blk["ffn"], cfg, layer_norm(blk["ln2"], x), st.ffn_shift)
        x = x + ff
        new_states.append(LayerState(xf[:, -1], new_wkv.to(st.wkv.dtype), new_ffn_shift))

    x = layer_norm(params["ln_out"], x)
    return linear(params["head"], x, cfg.dtype)[:, 0], new_states
