"""VisualRWKV: vision ensemble -> projector -> token scatter -> RWKV LM
(RWKV-7 or RWKV-6), and the training loss (shifted cross-entropy with the
L2Wrap logit penalty).

Counterpart of ``visualrwkv_tpu/models/visualrwkv.py`` (the unidirectional
v7.00 path, and the v6.0 CLIP grid pooling) over a parameter dict
``{"rwkv", "vit", "proj"}``. The vision towers are frozen feature
extractors: they run without autograd and their features are detached
before the projector, which is trained.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from visualrwkv_torch.config import IGNORE_INDEX, VLMConfig, resolve_device
from visualrwkv_torch.models import lm, rwkv7
from visualrwkv_torch.multimodal.projector import (
    adaptive_pool_tokens,
    apply_projector,
    grid_pooling,
    init_projector_params,
    scatter_image_features,
)
from visualrwkv_torch.vision.backbone import backbone_features, init_backbone_params

Tensor = torch.Tensor
Params = Dict[str, Any]


def init_visualrwkv_params(cfg: VLMConfig, seed: int = 0, device="cuda",
                           dtype: Optional[torch.dtype] = None) -> Params:
    """Seeded random init of the whole assembly on ``device`` (CUDA unless
    the caller asks for the CPU); ``dtype`` is an optional storage dtype."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {"rwkv": lm.init_lm_params(gen, cfg.rwkv, device, dtype)}
    if cfg.vision.towers:
        sdt = dtype or torch.float32
        params["vit"] = init_backbone_params(gen, cfg.vision, cfg.rwkv.compute_dtype, device, sdt)
        params["proj"] = init_projector_params(
            gen, cfg.proj_type, cfg.projector_in_dim, cfg.rwkv.n_embd, device, sdt
        )
    return params


def _has_int8(tree) -> bool:
    if isinstance(tree, dict):
        return "weight_q" in tree or any(_has_int8(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_int8(v) for v in tree)
    return False


def encode_images(params: Params, cfg: VLMConfig, images: Dict[str, Tensor],
                  normalized: bool = False) -> Tensor:
    """Per-tower pixel batches -> [N_img, tokens, n_embd]: adaptive pooling
    to ``num_token_per_image`` tokens, or CLIP grid pooling when
    ``grid_size != -2``. No gradient reaches the towers; the projector is
    differentiable. The towers and the projector take float weights only:
    a tree quantized whole (``infer.strategy`` with int8 weights quantizes
    them too, as the JAX package does, whose towers then fail on the
    missing ``weight``) raises here."""
    for part in ("vit", "proj"):
        if _has_int8(params.get(part)):
            raise ValueError(
                f"params[{part!r}] holds int8 weights (weight_q): the vision towers and the "
                "projector take float weights only, so this tree serves text requests only"
            )
    with torch.no_grad():
        feats = backbone_features(params["vit"], cfg.vision, images, cfg.rwkv.compute_dtype,
                                  normalized)
    feats = feats.detach()
    if cfg.grid_size != -2:  # expects a CLS-keeping tower (CLIP, keep_cls_feature)
        feats = grid_pooling(feats, cfg.grid_size)
    else:
        feats = adaptive_pool_tokens(feats, cfg.num_token_per_image)
    return apply_projector(params["proj"], cfg.proj_type, feats, cfg.rwkv.dtype)


def prepare_embeddings(params: Params, cfg: VLMConfig, input_ids: Tensor,
                       images: Optional[Dict[str, Tensor]] = None,
                       image_features: Optional[Tensor] = None,
                       normalized: bool = False) -> Tensor:
    """Token embeddings with image features scattered at image-token slots."""
    input_embeds = rwkv7.embed(params["rwkv"], input_ids.clamp(0, cfg.rwkv.vocab_size - 1))
    if image_features is None:
        if images is None:
            return input_embeds
        image_features = encode_images(params, cfg, images, normalized)
    return scatter_image_features(input_ids, input_embeds, image_features)


def vlm_forward(params: Params, cfg: VLMConfig, input_ids, images=None, grad_cp=False,
                return_hidden: bool = False, device="cuda") -> Tensor:
    """Logits [B, T, vocab] fp32 (or the final hidden states). ``input_ids``
    [B, T] and the per-tower uint8 images (arrays or tensors) are moved to
    ``device``, where ``params`` must already be. Differentiable with respect
    to the LM's and the projector's parameters; ``grad_cp`` as in
    :func:`visualrwkv_torch.models.rwkv7.rwkv7_forward`."""
    device = resolve_device(device)
    ids = torch.as_tensor(input_ids, device=device).long()
    if images is not None:
        images = {t: torch.as_tensor(v, device=device) for t, v in images.items()}
    x = prepare_embeddings(params, cfg, ids, images)
    out, _ = lm.lm_forward(params["rwkv"], cfg.rwkv, x, grad_cp=grad_cp, return_hidden=return_hidden)
    return out


# ---------------------------------------------------------------------------
# Loss (shifted CE, per-sample valid-length normalisation, L2Wrap)
# ---------------------------------------------------------------------------

L2WRAP_FACTOR = 1e-4  # the reference's L2Wrap: gradient max_logit * 1e-4 / (B * T) on the argmax


class _L2Wrap(torch.autograd.Function):
    """Identity on the loss whose backward also pushes each position's
    largest logit toward zero. As in the reference, the injected gradient is
    NOT scaled by the upstream cotangent."""

    @staticmethod
    def forward(ctx, loss, logits):
        ctx.save_for_backward(logits)
        return loss.view_as(loss)

    @staticmethod
    def backward(ctx, g):
        (logits,) = ctx.saved_tensors
        B, T, V = logits.shape
        maxx, ids = logits.max(-1, keepdim=True)
        gy = torch.zeros_like(logits).scatter_(-1, ids, maxx * (L2WRAP_FACTOR / (B * T)))
        return g, gy


def l2wrap(loss: Tensor, logits: Tensor) -> Tensor:
    return _L2Wrap.apply(loss, logits)


def _shifted_labels(labels: Tensor):
    """Labels for position t are labels[t + 1]; the last position has none.
    Returns (next labels [B, T], valid mask [B, T])."""
    nxt = F.pad(labels[:, 1:], (0, 1), value=IGNORE_INDEX)
    return nxt, nxt != IGNORE_INDEX


def _ce_sums(logits: Tensor, lbl_next: Tensor, valid: Tensor) -> Tensor:
    """Per-sample fp32 sum of the cross-entropy over valid positions. A label
    beyond the vocabulary is clamped to the last id, not an error."""
    logz = torch.logsumexp(logits, -1)
    safe = torch.where(valid, lbl_next, 0).clamp(0, logits.shape[-1] - 1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, logz - gold, 0.0).sum(1)


def _dense_ce_l2wrap(logits: Tensor, labels: Tensor) -> Tensor:
    """Shifted CE (normalised per sample by its valid-label count, then the
    batch mean) + L2Wrap over the full fp32 logits [B, T, V]."""
    logits = logits.float()
    lbl_next, valid = _shifted_labels(labels)
    counts = valid[:, :-1].sum(1).clamp_min(1)
    ce = _ce_sums(logits[:, :-1], lbl_next[:, :-1], valid[:, :-1])
    return l2wrap((ce / counts).mean(), logits)


class _ChunkedCEL2Wrap(torch.autograd.Function):
    """Head matmul + shifted CE + L2Wrap, one T-chunk at a time in both
    passes, so that at most one fp32 ``[B, chunk, V]`` block of logits is
    alive. Same numbers as :func:`_dense_ce_l2wrap` on ``hidden @ head^T``.
    The head matmuls run in ``hidden``'s dtype with fp32 results; the
    head-weight gradient accumulates in fp32 across chunks."""

    @staticmethod
    def forward(ctx, chunk_t, head_w, hidden, labels):
        B, T, C = hidden.shape
        dt = hidden.dtype
        lbl_next, valid = _shifted_labels(labels)
        w = head_w.to(dt)
        ce = torch.zeros(B, dtype=torch.float32, device=hidden.device)
        for s in range(0, T, chunk_t):
            sl = slice(s, s + chunk_t)
            logits = F.linear(hidden[:, sl], w).float()
            ce = ce + _ce_sums(logits, lbl_next[:, sl], valid[:, sl])
        counts = valid.sum(1).clamp_min(1)
        ctx.save_for_backward(head_w, hidden, lbl_next, valid, counts)
        ctx.chunk_t = chunk_t
        return (ce / counts).mean()

    @staticmethod
    def backward(ctx, g):
        head_w, hidden, lbl_next, valid, counts = ctx.saved_tensors
        chunk_t = ctx.chunk_t
        B, T, C = hidden.shape
        V = head_w.shape[0]
        dt = hidden.dtype
        w = head_w.to(dt)
        scale = (g.float() / (B * counts.float()))[:, None, None]  # [B, 1, 1]
        l2 = L2WRAP_FACTOR / (B * T)  # the full T, whatever the chunk
        dw = torch.zeros(V, C, dtype=torch.float32, device=hidden.device)
        dh = torch.empty_like(hidden)
        for s in range(0, T, chunk_t):
            sl = slice(s, s + chunk_t)
            h_c = hidden[:, sl]
            logits = F.linear(h_c, w).float()
            vl = valid[:, sl, None]
            safe = torch.where(valid[:, sl], lbl_next[:, sl], 0).clamp(0, V - 1)
            maxx, ids = logits.max(-1, keepdim=True)
            dlogits = torch.softmax(logits, -1) * vl
            dlogits.scatter_add_(-1, safe[..., None], -vl.float())
            dlogits *= scale
            dlogits.scatter_add_(-1, ids, maxx * l2)  # L2Wrap: not scaled by g
            dl = dlogits.to(dt)
            dh[:, sl] = (dl @ w).to(dt)  # fp32 accumulation inside the matmul
            dw += (dl.reshape(-1, V).t() @ h_c.reshape(-1, C)).float()
        return None, dw.to(head_w.dtype), dh, None


def chunked_ce_l2wrap(chunk_t: int, head_w: Tensor, hidden: Tensor, labels: Tensor) -> Tensor:
    """``head_w`` [V, C], ``hidden`` [B, T, C] with T a multiple of
    ``chunk_t``, ``labels`` [B, T] (unshifted, ``IGNORE_INDEX`` where masked)."""
    if hidden.shape[1] % chunk_t:
        raise ValueError(f"T={hidden.shape[1]} must be a multiple of chunk_t={chunk_t}")
    return _ChunkedCEL2Wrap.apply(chunk_t, head_w, hidden, labels)


def training_loss(params: Params, cfg: VLMConfig, input_ids, labels, images=None,
                  grad_cp=True, chunked_ce: bool = True, ce_chunk_t: int = 128,
                  device="cuda") -> Tensor:
    """Shifted cross-entropy, normalised per sample by its valid-label count,
    then the batch mean, with the L2Wrap penalty. ``chunked_ce`` (default)
    never materialises the full fp32 ``[B, T, vocab]`` logits; it applies when
    T is a multiple of ``ce_chunk_t``, else the dense loss runs."""
    device = resolve_device(device)
    ids = torch.as_tensor(input_ids, device=device).long()
    labels = torch.as_tensor(labels, device=device).long()
    if chunked_ce and ids.shape[1] % ce_chunk_t == 0:
        hidden = vlm_forward(params, cfg, ids, images, grad_cp=grad_cp, return_hidden=True,
                             device=device)
        return chunked_ce_l2wrap(ce_chunk_t, params["rwkv"]["head"]["weight"], hidden, labels)
    logits = vlm_forward(params, cfg, ids, images, grad_cp=grad_cp, device=device)
    return _dense_ce_l2wrap(logits, labels)
