"""Image-as-state training and inference, and state tuning. Counterpart of
``visualrwkv_tpu/multimodal/image_as_state.py``.

v6.xx protocol (reference VisualRWKV-v6/v6.xx/src/model.py:302-344): in each
block the image embeddings run through the block first to produce its WKV
state, and the text runs through the same block *starting from that state*:
the image is absorbed into the recurrent state instead of the token stream.
v6.yy (v6.yy/src/model.py:392-407): the states of N images are averaged.
State tuning trains a per-block initial state ``time_state``
(:func:`init_time_states`), whose gradient reaches it through the WKV
kernels' initial-state gradient (K6 for x070, K9 for x060, on CUDA).

The port walks the list of blocks: it has no stacked layout (the
configuration's ``stacked_layers`` is accepted and ignored, by design), and
the JAX package's scan over stacked blocks computes the same function. States are
``[.., H, N, N]`` in the JAX package's orientation for x070 and x060 alike:
the port's x060 carries the transposed state only inside ``ops.wkv6``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from visualrwkv_torch.config import STOP_TOKEN_INDEX, VLMConfig, resolve_device
from visualrwkv_torch.models import lm
from visualrwkv_torch.models.rwkv7 import LayerState, embed, layer_norm, linear

Tensor = torch.Tensor
Params = Dict[str, Any]


def init_time_states(cfg: VLMConfig, device="cuda") -> Tensor:
    """The trainable per-block initial WKV state (v6.xx ``time_state``):
    zeros ``[L, H, N, N]`` fp32 on ``device`` (CUDA unless the caller asks
    for the CPU)."""
    r = cfg.rwkv
    return torch.zeros(r.n_layer, r.n_head, r.head_size, r.head_size, device=resolve_device(device))


def _wkv_only_state(cfg: VLMConfig, batch: int, wkv: Tensor) -> LayerState:
    """A block's state of ``wkv`` with zero token-shift carries."""
    C = cfg.rwkv.n_embd
    zeros = lambda: torch.zeros(batch, C, device=wkv.device)
    return LayerState(att_shift=zeros(), wkv=wkv, ffn_shift=zeros())


def image_as_state_forward(params: Params, cfg: VLMConfig, text_emb: Tensor, image_emb: Tensor,
                           grad_cp: bool = False, mean_multi_image: bool = False,
                           time_states: Optional[Tensor] = None) -> Tensor:
    """Per block: the image pass gives a WKV state, the text pass starts from
    it. text_emb ``[B, T_text, C]``; image_emb ``[B, T_img, C]``, or with
    ``mean_multi_image`` ``[N, T_img, C]``: N images whose states average
    into one row, broadcast to B (v6.yy). The text is left-padded with EOS
    embeddings and the image with zero vectors, each to a multiple of
    ``chunk_len``: real tokens that move the state. Each pass keeps its own
    ``v_first``, and the text pass starts with zero token-shift carries.
    ``time_states`` ``[L, H, N, N]`` (or None: zero) is each block's
    initial state of the image pass. ``grad_cp``: each block's double pass
    under activation checkpointing. Returns the text's logits
    ``[B, T_text, vocab]`` fp32."""
    rcfg = cfg.rwkv
    B, T, C = text_emb.shape
    pad_t = (-T) % rcfg.chunk_len
    if pad_t:
        eos = embed(params["rwkv"], torch.full((B, pad_t), STOP_TOKEN_INDEX, dtype=torch.long,
                                               device=text_emb.device))
        text_emb = torch.cat([eos.to(text_emb.dtype), text_emb], dim=1)
    pad_i = (-image_emb.shape[1]) % rcfg.chunk_len
    if pad_i:
        image_emb = torch.cat([image_emb.new_zeros(image_emb.shape[0], pad_i, image_emb.shape[2]),
                               image_emb], dim=1)
    n_img = image_emb.shape[0]

    def block_step(blk, i, x_img, vf_img, x_txt, vf_txt, ts_i):
        init_img = None
        if ts_i is not None:
            init_img = _wkv_only_state(cfg, n_img, ts_i.expand(n_img, *ts_i.shape).contiguous())
        x_img, vf_img, st_img = lm.lm_block_forward(blk, rcfg, i, x_img, vf_img, init_img)
        wkv = st_img.wkv
        if mean_multi_image:
            wkv = wkv.mean(0, keepdim=True).expand(B, *wkv.shape[1:]).contiguous()
        x_txt, vf_txt, _ = lm.lm_block_forward(blk, rcfg, i, x_txt, vf_txt, _wkv_only_state(cfg, B, wkv))
        return x_img, vf_img, x_txt, vf_txt

    x_img, x_txt = image_emb, text_emb
    vf_img = vf_txt = None
    for i in range(rcfg.n_layer):
        blk = params["rwkv"]["blocks"][i]
        ts_i = time_states[i] if time_states is not None else None
        run = lambda *a, blk=blk, i=i: block_step(blk, i, *a)
        if grad_cp:
            x_img, vf_img, x_txt, vf_txt = checkpoint(run, x_img, vf_img, x_txt, vf_txt, ts_i,
                                                      use_reentrant=False, preserve_rng_state=False)
        else:
            x_img, vf_img, x_txt, vf_txt = run(x_img, vf_img, x_txt, vf_txt, ts_i)

    x = layer_norm(params["rwkv"]["ln_out"], x_txt)
    if pad_t:
        x = x[:, pad_t:]
    return linear(params["rwkv"]["head"], x, rcfg.dtype)
