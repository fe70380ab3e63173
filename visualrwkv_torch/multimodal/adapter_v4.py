"""The legacy v4 adapter: BLIP2-style query-token pretraining (ITC / ITM /
LM). Counterpart of ``visualrwkv_tpu/multimodal/adapter_v4.py``.

The reference's VisualRWKV-v4 pretrains an adapter of learned task
embeddings that cross-attend to frozen vision features, trained with
image-text contrastive (ITC), image-text matching (ITM) and language-model
(LM) losses, feeding a frozen RWKV-4 RNN (VisualRWKV-v4/visualrwkv/
components/adapter.py:31-80, model.py:11-142). As in the JAX package, the
adapter is cross-attention blocks (``multimodal.hybrid``) and the LM loss
runs through the frozen LM of any family, x040 included.

The LM's weights take no gradient; its input, the adapter's queries, does:
through x040's recurrence that is kernel K18 on CUDA (``ops.wkv4``).
Linears are ``{"weight": [out, in]}``; as in the JAX package, the ITM
head's bias is carried and not added (``linear`` takes the weight only).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from visualrwkv_torch.config import RWKVConfig, resolve_device
from visualrwkv_torch.models import lm
from visualrwkv_torch.models.rwkv7 import _ln_init, embed, layer_norm, linear
from visualrwkv_torch.multimodal.contrastive import in_batch_contrastive_loss
from visualrwkv_torch.multimodal.hybrid import cross_attention_block, init_cross_block_params
from visualrwkv_torch.train.optim import tree_map

Tensor = torch.Tensor
Params = Dict[str, Any]


@dataclass(frozen=True)
class AdapterConfig:
    num_task_embeddings: int = 32
    feature_size: int = 256
    n_adapter_layers: int = 2
    temperature_init: float = 0.07


def init_adapter_params(gen: torch.Generator, cfg: RWKVConfig, acfg: AdapterConfig, device="cuda") -> Params:
    """Seeded random adapter on ``device``. The temperature starts at the
    class default ``AdapterConfig.temperature_init``, as the JAX package's
    init does."""
    device = resolve_device(device)
    C = cfg.n_embd
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    return {
        "task_embs": randn(acfg.num_task_embeddings, C) * 1e-4,
        "blocks": [init_cross_block_params(gen, cfg, device) for _ in range(acfg.n_adapter_layers)],
        "ln_vision": _ln_init(C, device),
        "vision_proj": {"weight": randn(acfg.feature_size, C) * C**-0.5},
        "text_proj": {"weight": randn(acfg.feature_size, C) * C**-0.5},
        "itm_head": {"weight": randn(2, C) * C**-0.5, "bias": torch.zeros(2, device=device)},
        "temperature": torch.tensor(AdapterConfig.temperature_init, device=device),
    }


def adapter_queries(params: Params, cfg: RWKVConfig, vit_feats: Tensor) -> Tensor:
    """The task embeddings cross-attend to the (ln'd) vision features
    ``[B, S, C]`` -> ``[B, Q, C]``."""
    B = vit_feats.shape[0]
    feats = layer_norm(params["ln_vision"], vit_feats)
    x = params["task_embs"].expand(B, *params["task_embs"].shape).to(feats.dtype)
    for blk in params["blocks"]:
        x = cross_attention_block(blk, cfg, x, feats)
    return x


def adapter_pretrain_losses(params: Params, lm_params: Params, cfg: RWKVConfig, vit_feats: Tensor,
                            caption_ids: Tensor, caption_mask: Tensor) -> Tuple[Tensor, Dict[str, Tensor]]:
    """ITC + ITM + LM losses (the reference's AdapterOutput fields).
    caption_ids ``[B, T]`` (0-padded), caption_mask ``[B, T]`` bool. The LM
    loss runs the frozen LM (``lm_params``, detached here: no LM weight
    takes a gradient) on the adapter's queries as a prefix of the caption.
    Returns (total, {"loss_itc", "loss_itm", "loss_lm"})."""
    dt = cfg.dtype
    B, T = caption_ids.shape
    frozen = tree_map(lambda t: t.detach(), lm_params)
    queries = adapter_queries(params, cfg, vit_feats)  # [B, Q, C]

    # ITC: pooled queries against the pooled caption embedding, symmetric InfoNCE
    vision_feat = linear(params["vision_proj"], queries.mean(1), dt)
    text_emb = embed(frozen, caption_ids)
    m = caption_mask.to(text_emb.dtype)
    text_pooled = (text_emb * m[..., None]).sum(1) / m.sum(-1, keepdim=True).clamp_min(1)
    text_feat = linear(params["text_proj"], text_pooled, dt)
    # the temperature is learnable (reference: nn.Parameter(0.07))
    loss_itc = in_batch_contrastive_loss(text_feat, vision_feat, params["temperature"].clamp_min(1e-3))

    # ITM: matched pairs against in-batch shifted negatives, a binary head on the queries
    neg_queries = torch.roll(queries, 1, dims=0)
    pooled_pos = (queries.mean(1) + text_pooled).to(dt)
    pooled_neg = (neg_queries.mean(1) + text_pooled).to(dt)
    logits = torch.cat([linear(params["itm_head"], pooled_pos, dt),
                        linear(params["itm_head"], pooled_neg, dt)]).float()
    labels = torch.cat([torch.ones(B, dtype=torch.long, device=logits.device),
                        torch.zeros(B, dtype=torch.long, device=logits.device)])
    loss_itm = F.cross_entropy(logits, labels)

    # LM: the frozen LM conditioned on the queries as a visual prefix
    x = torch.cat([queries.to(dt), text_emb.to(dt)], dim=1)
    logits_lm, _ = lm.lm_forward(frozen, cfg, x)
    Q = queries.shape[1]
    pred = logits_lm[:, Q - 1: Q - 1 + T].float()
    ce = F.cross_entropy(pred.transpose(1, 2), caption_ids.long(), reduction="none")
    ce = torch.where(caption_mask, ce, 0.0)
    loss_lm = ce.sum() / caption_mask.sum().clamp_min(1)

    total = loss_itc + loss_itm + loss_lm
    return total, {"loss_itc": loss_itc, "loss_itm": loss_itm, "loss_lm": loss_lm}
