"""VisualRWKV: vision ensemble -> projector -> token insertion -> RWKV LM,
and the training loss (shifted cross-entropy with the L2Wrap logit penalty).

Counterpart of ``visualrwkv_tpu/models/visualrwkv.py`` over a parameter
dict ``{"rwkv", "vit", "proj"}`` (and ``"vtc"`` with the token compressor):
the v7.00 scatter of ``num_token_per_image`` features into image-token
slots, and the published VisualRWKV-6 / HD / UHD paths: v6.0's leftpad
insertion (:func:`vlm_forward_leftpad`), the image span reversed on odd
blocks (:func:`bidirectional_forward`), CLIP grid pooling, UHD tile fusion,
the v7.03 token compressor and v5.1 patch scanning (:func:`encode_images`).
The vision towers are frozen feature extractors: they run without autograd
and their features are detached before the projector, which is trained.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from visualrwkv_torch.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX, STOP_TOKEN_INDEX, VLMConfig, resolve_device
from visualrwkv_torch.models import lm, rwkv6, rwkv7
from visualrwkv_torch.multimodal.insertion import LeftpadPlan, leftpad_insert, leftpad_plan
from visualrwkv_torch.multimodal.projector import (
    adaptive_pool_tokens,
    apply_projector,
    grid_pooling,
    init_projector_params,
    scatter_image_features,
)
from visualrwkv_torch.multimodal.scanning import apply_scanning
from visualrwkv_torch.multimodal.uhd import fuse_image_features
from visualrwkv_torch.multimodal.vtc import vtc_forward
from visualrwkv_torch.parallel.collectives import all_reduce_replicated, group_size
from visualrwkv_torch.vision.backbone import backbone_features, backbone_tower_features, init_backbone_params

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


def encode_images(params: Params, cfg: VLMConfig, images: Optional[Dict[str, Tensor]],
                  normalized: bool = False,
                  tower_features: Optional[Dict[str, Tensor]] = None) -> Tensor:
    """Per-tower pixel batches -> [N_img, tokens, n_embd]: adaptive pooling
    to ``num_token_per_image`` tokens, or CLIP grid pooling when
    ``grid_size != -2``. No gradient reaches the towers; the projector (and
    the token compressor) are differentiable. The optional stages:

    - ``uhd_fusion``: each tower's batch holds five views an image (the
      global view, then 2x2 tiles, ``[5 * N_img, H, W, 3]``), fused by
      :func:`visualrwkv_torch.multimodal.uhd.fuse_image_features`;
    - the token compressor, when ``n_vtc_layer > 0`` and ``params`` has a
      ``"vtc"`` subtree: it runs after the projector in place of the
      adaptive pooling, which follows it;
    - ``image_scanning``: the tokens reordered (and repeated) by the scan.

    ``tower_features`` (by tower, as :func:`backbone_tower_features` gives
    them) stand in for running the towers on ``images``.

    The towers and the projector take float weights only: a tree quantized
    whole (``infer.strategy`` with int8 weights quantizes them too, as the
    JAX package does, whose towers then fail on the missing ``weight``)
    raises here."""
    for part in ("vit", "proj"):
        if _has_int8(params.get(part)):
            raise ValueError(
                f"params[{part!r}] holds int8 weights (weight_q): the vision towers and the "
                "projector take float weights only, so this tree serves text requests only"
            )
    with torch.no_grad():
        tower = tower_features
        if tower is None and cfg.uhd_fusion:
            tower = backbone_tower_features(params["vit"], cfg.vision, images,
                                            cfg.rwkv.compute_dtype, normalized)
        if cfg.uhd_fusion:
            feats = fuse_image_features([tower[t].reshape(-1, 5, *tower[t].shape[1:])
                                         for t in cfg.vision.towers])
        elif tower is not None:
            feats = torch.cat([tower[t] for t in cfg.vision.towers], dim=-1)
        else:
            feats = backbone_features(params["vit"], cfg.vision, images, cfg.rwkv.compute_dtype,
                                      normalized)
    feats = feats.detach()
    use_vtc = cfg.n_vtc_layer > 0 and "vtc" in params
    if cfg.grid_size != -2:  # expects a CLS-keeping tower (CLIP, keep_cls_feature)
        feats = grid_pooling(feats, cfg.grid_size)
    elif not use_vtc:
        feats = adaptive_pool_tokens(feats, cfg.num_token_per_image)
    feats = apply_projector(params["proj"], cfg.proj_type, feats, cfg.rwkv.dtype)
    if use_vtc:
        feats = adaptive_pool_tokens(vtc_forward(params["vtc"], cfg.rwkv, feats),
                                     cfg.num_token_per_image)
    if cfg.image_scanning != "unidirection":
        feats = apply_scanning(feats, cfg.image_scanning)
    return feats


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


def image_token_span(input_ids: Tensor) -> Tensor:
    """The position of each row's first image token (0 where it has none)."""
    return (input_ids == IMAGE_TOKEN_INDEX).to(torch.uint8).argmax(-1)


def _flip_span(x: Tensor, start, length: int) -> Tensor:
    """``x[:, start:start + length]`` reversed along T. ``start`` is shared
    (an int or a 0-d tensor) or a row's own (``[B]``: leftpad tail-keep
    truncation moves a row's span). As JAX's dynamic slice takes it, a
    negative start counts from the end (a tail-keep row whose cut fell past
    its span start has one) and the start is then clamped to
    ``[0, T - length]``. One gather on the device, no host wait."""
    T = x.shape[1]
    start = torch.as_tensor(start, device=x.device).reshape(-1, 1)
    start = torch.where(start < 0, start + T, start).clamp(0, T - length)
    t = torch.arange(T, device=x.device)[None, :]
    inside = (t >= start) & (t < start + length)
    idx = torch.where(inside, 2 * start + length - 1 - t, t).expand(x.shape[0], T)
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def bidirectional_forward(params: Params, cfg: VLMConfig, x: Tensor, img_start, img_len: int,
                          grad_cp=False) -> Tensor:
    """Logits of the LM over embeddings ``x`` [B, T, C] where the odd blocks
    see the image span ``[img_start, img_start + img_len)`` reversed (v6.0
    / HD / UHD, v6.0/src/model.py:408-431): the span is flipped before and
    after each odd block. ``img_start`` is shared or a row's own (``[B]``).
    The sequence is left-padded with STOP-token embeddings to a multiple of
    ``chunk_len`` and the span start moved by the pad: the padded prefix
    changes the state, as in the LM's own forward."""
    rcfg = cfg.rwkv
    B, T, _ = x.shape
    pad = (-T) % rcfg.chunk_len
    if pad:
        stop = torch.full((B, pad), STOP_TOKEN_INDEX, dtype=torch.long, device=x.device)
        eos = rwkv7.embed(params["rwkv"], stop)
        x = torch.cat([eos.to(x.dtype), x], dim=1)
    start = torch.as_tensor(img_start, device=x.device) + pad
    v_first = None
    for i, blk in enumerate(params["rwkv"]["blocks"]):
        reverse = i % 2 == 1
        if reverse:
            x = _flip_span(x, start, img_len)
        x, v_first, _ = lm.lm_block_forward(blk, rcfg, i, x, v_first, grad_cp=grad_cp)
        if reverse:
            x = _flip_span(x, start, img_len)
    x = rwkv7.layer_norm(params["rwkv"]["ln_out"], x)
    if pad:
        x = x[:, pad:]
    return rwkv7.linear(params["rwkv"]["head"], x, rcfg.dtype)


def _on_device(input_ids, images, device):
    ids = torch.as_tensor(input_ids, device=device).long()
    if images is not None:
        images = {t: torch.as_tensor(v, device=device) for t, v in images.items()}
    return ids, images


def vlm_forward(params: Params, cfg: VLMConfig, input_ids, images=None, grad_cp=False,
                return_hidden: bool = False, device="cuda") -> Tensor:
    """Logits [B, T, vocab] fp32 (or the final hidden states). ``input_ids``
    [B, T] and the per-tower uint8 images (arrays or tensors) are moved to
    ``device``, where ``params`` must already be. Differentiable with respect
    to the LM's and the projector's parameters; ``grad_cp`` as in
    :func:`visualrwkv_torch.models.rwkv7.rwkv7_forward`. With
    ``bidirectional_image`` and images, the span of ``num_token_per_image``
    tokens at row 0's first image token is reversed on the odd blocks (the
    logits only)."""
    device = resolve_device(device)
    ids, images = _on_device(input_ids, images, device)
    x = prepare_embeddings(params, cfg, ids, images)
    if cfg.bidirectional_image and images is not None:
        if return_hidden:
            raise ValueError("the bidirectional path returns logits only")
        return bidirectional_forward(params, cfg, x, image_token_span(ids)[0],
                                     cfg.num_token_per_image, grad_cp)
    out, _ = lm.lm_forward(params["rwkv"], cfg.rwkv, x, grad_cp=grad_cp, return_hidden=return_hidden)
    return out


def vlm_forward_leftpad(params: Params, cfg: VLMConfig, input_ids, labels, images=None,
                        image_features: Optional[Tensor] = None, plan: Optional[LeftpadPlan] = None,
                        grad_cp=False, return_hidden: bool = False, device="cuda"):
    """v6.0's forward over samples that carry at most one un-expanded image
    token each (:mod:`visualrwkv_torch.multimodal.insertion`). Returns
    (logits or hidden, the realigned labels, the plan): the insertion
    rearranges the sequence, so the labels move with it. ``plan`` is
    computed from the token ids on the host when not given. Under
    ``bidirectional_image`` each row's span of ``flip_len`` tokens is
    reversed on the odd blocks at ``max_idx - off`` (its tail-keep offset)."""
    device = resolve_device(device)
    ids, images = _on_device(input_ids, images, device)
    labels = torch.as_tensor(labels, device=device).long()
    if image_features is None:
        if images is None:
            raise ValueError("leftpad insertion needs images or image_features")
        image_features = encode_images(params, cfg, images)
    if plan is None:
        plan = leftpad_plan(input_ids, int(image_features.shape[1]), cfg.rwkv.ctx_len)
    emb, new_labels, off = leftpad_insert(params["rwkv"]["emb"]["weight"], ids, labels,
                                          image_features, plan)
    if cfg.bidirectional_image:
        if return_hidden:
            raise ValueError("the bidirectional path returns logits only")
        out = bidirectional_forward(params, cfg, emb, plan.max_idx - off, plan.flip_len, grad_cp)
    else:
        out, _ = lm.lm_forward(params["rwkv"], cfg.rwkv, emb, grad_cp=grad_cp,
                               return_hidden=return_hidden)
    return out, new_labels, plan


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


def _ce_stats(chunk_t: int, head_w: Tensor, hidden: Tensor, lbl_next: Tensor, valid: Tensor) -> Tensor:
    """Per-sample fp32 sums of the shifted CE over ``hidden``'s T, one
    T-chunk of logits at a time."""
    w = head_w.to(hidden.dtype)
    ce = torch.zeros(hidden.shape[0], dtype=torch.float32, device=hidden.device)
    for s in range(0, hidden.shape[1], chunk_t):
        sl = slice(s, s + chunk_t)
        ce = ce + _ce_sums(F.linear(hidden[:, sl], w).float(), lbl_next[:, sl], valid[:, sl])
    return ce


def _ce_l2wrap_grads(chunk_t: int, head_w: Tensor, hidden: Tensor, lbl_next: Tensor, valid: Tensor,
                     counts: Tensor, g: Tensor, l2: float):
    """(d head_w, d hidden) of the CE mean ``g``-scaled over per-sample
    ``counts``, plus the L2Wrap injection ``max_logit * l2`` at each
    position's argmax, NOT scaled by ``g`` (the reference's L2Wrap)."""
    B, T, C = hidden.shape
    V = head_w.shape[0]
    dt = hidden.dtype
    w = head_w.to(dt)
    scale = (g.float() / (B * counts.float()))[:, None, None]  # [B, 1, 1]
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
        dlogits.scatter_add_(-1, ids, maxx * l2)
        dl = dlogits.to(dt)
        dh[:, sl] = (dl @ w).to(dt)  # fp32 accumulation inside the matmul
        dw += (dl.reshape(-1, V).t() @ h_c.reshape(-1, C)).float()
    return dw.to(head_w.dtype), dh


class _ChunkedCEL2Wrap(torch.autograd.Function):
    """Head matmul + shifted CE + L2Wrap, one T-chunk at a time in both
    passes, so that at most one fp32 ``[B, chunk, V]`` block of logits is
    alive. Same numbers as :func:`_dense_ce_l2wrap` on ``hidden @ head^T``.
    The head matmuls run in ``hidden``'s dtype with fp32 results; the
    head-weight gradient accumulates in fp32 across chunks.

    The labels are PRE-SHIFTED (``labels_next[t]`` is the target of position
    t). Under a token axis split over ``seq_group`` (the JAX package's
    ``chunked_ce_l2wrap_sp``) ``hidden`` is this rank's part: the per-sample
    CE sums and valid counts are summed over the group, so that each sample
    is normalised over its whole sequence, and the result is this rank's row
    mean. The L2Wrap injection is ``1e-4 / (B_local * T_global)`` a
    position: the trainer averages gradients over the data ranks
    (``parallel.collectives``), which makes it the reference's
    ``1e-4 / (B_global * T_global)``."""

    @staticmethod
    def forward(ctx, chunk_t, head_w, hidden, labels_next, seq_group):
        B, T, _ = hidden.shape
        valid = labels_next != IGNORE_INDEX
        stats = torch.stack([_ce_stats(chunk_t, head_w, hidden, labels_next, valid),
                             valid.sum(1).float()])
        if seq_group is not None:
            dist.all_reduce(stats, group=seq_group)
        ce, counts = stats[0], stats[1].clamp_min(1)
        ctx.save_for_backward(head_w, hidden, labels_next, valid, counts)
        ctx.chunk_t = chunk_t
        ctx.l2 = L2WRAP_FACTOR / (B * T * group_size(seq_group))  # the full T, whatever the chunk
        return (ce / counts).mean()

    @staticmethod
    def backward(ctx, g):
        head_w, hidden, labels_next, valid, counts = ctx.saved_tensors
        dw, dh = _ce_l2wrap_grads(ctx.chunk_t, head_w, hidden, labels_next, valid, counts, g, ctx.l2)
        return None, dw, dh, None, None


def chunked_ce_l2wrap(chunk_t: int, head_w: Tensor, hidden: Tensor, labels: Tensor) -> Tensor:
    """``head_w`` [V, C], ``hidden`` [B, T, C] with T a multiple of
    ``chunk_t``, ``labels`` [B, T] (unshifted, ``IGNORE_INDEX`` where masked)."""
    return chunked_ce_l2wrap_sp(chunk_t, head_w, hidden, _shifted_labels(labels)[0])


def chunked_ce_l2wrap_sp(chunk_t: int, head_w: Tensor, hidden: Tensor, labels_next: Tensor,
                         seq_group=None) -> Tensor:
    """``hidden`` [B, T_local, C] with T_local a multiple of ``chunk_t``,
    ``labels_next`` [B, T_local] pre-shifted (``labels_next[t]`` is the
    target of position t): :class:`_ChunkedCEL2Wrap`."""
    if hidden.shape[1] % chunk_t:
        raise ValueError(f"T={hidden.shape[1]} must be a multiple of chunk_t={chunk_t}")
    return _ChunkedCEL2Wrap.apply(chunk_t, head_w, hidden, labels_next, seq_group)


def training_loss_seq(params: Params, cfg: VLMConfig, input_ids, labels_next, grad_cp=True,
                      ce_chunk_t: int = 128, seq_group=None, data_group=None,
                      embeds: Optional[Tensor] = None, device="cuda") -> Tensor:
    """The training loss under context parallelism (the JAX package's
    ``training_loss_seq``), x070 and x060: this rank holds its rows (of its
    ``data`` index) and its token range (of its ``seq`` index).

    ``labels_next`` are pre-shifted on the host, before the split, so that
    each rank holds its own positions' targets. Text batches pass this
    rank's ``input_ids``; image batches pass ``embeds``, this rank's range of
    the embeddings with the image features scattered in, built from its
    rows' whole sequences (``prepare_embeddings``). Returns the loss over
    every rank's rows, the same on each, whose backward is the identity:
    each rank's gradients are then its own part, to be summed over the seq
    ranks and averaged over the data ranks."""
    device = resolve_device(device)
    rcfg = cfg.rwkv
    forward_seq = {"x070": rwkv7.rwkv7_forward_seq, "x060": rwkv6.rwkv6_forward_seq}.get(rcfg.version)
    if forward_seq is None:
        raise NotImplementedError("sequence-parallel training supports RWKV-7/RWKV-6 "
                                  f"(x070/x060); got version={rcfg.version!r}")
    labels_next = torch.as_tensor(labels_next, device=device).long()
    if embeds is None:
        ids = torch.as_tensor(input_ids, device=device).long()
        embeds = rwkv7.embed(params["rwkv"], ids.clamp(0, rcfg.vocab_size - 1))
    hidden = forward_seq(params["rwkv"], rcfg, embeds, group=seq_group, grad_cp=grad_cp,
                         return_hidden=True)
    T_local = embeds.shape[1]
    chunk = ce_chunk_t if T_local % ce_chunk_t == 0 else T_local
    local = chunked_ce_l2wrap_sp(chunk, params["rwkv"]["head"]["weight"], hidden, labels_next,
                                 seq_group)
    return all_reduce_replicated(local, data_group, mean=True)


def training_loss_leftpad(params: Params, cfg: VLMConfig, input_ids, labels, images=None,
                          plan: Optional[LeftpadPlan] = None, grad_cp=True, device="cuda") -> Tensor:
    """The training loss of the v6.0 leftpad insertion: the dense loss on
    the realigned labels (:func:`vlm_forward_leftpad`)."""
    logits, new_labels, _ = vlm_forward_leftpad(params, cfg, input_ids, labels, images, plan=plan,
                                                grad_cp=grad_cp, device=device)
    return _dense_ce_l2wrap(logits, new_labels)


def training_loss(params: Params, cfg: VLMConfig, input_ids, labels, images=None,
                  grad_cp=True, chunked_ce: bool = True, ce_chunk_t: int = 128,
                  device="cuda") -> Tensor:
    """Shifted cross-entropy, normalised per sample by its valid-label count,
    then the batch mean, with the L2Wrap penalty. ``chunked_ce`` (default)
    never materialises the full fp32 ``[B, T, vocab]`` logits; it applies when
    T is a multiple of ``ce_chunk_t`` and the forward is not the
    bidirectional one (which gives logits only), else the dense loss runs."""
    device = resolve_device(device)
    ids = torch.as_tensor(input_ids, device=device).long()
    labels = torch.as_tensor(labels, device=device).long()
    bidirectional = cfg.bidirectional_image and images is not None
    if chunked_ce and not bidirectional and ids.shape[1] % ce_chunk_t == 0:
        hidden = vlm_forward(params, cfg, ids, images, grad_cp=grad_cp, return_hidden=True,
                             device=device)
        return chunked_ce_l2wrap(ce_chunk_t, params["rwkv"]["head"]["weight"], hidden, labels)
    logits = vlm_forward(params, cfg, ids, images, grad_cp=grad_cp, device=device)
    return _dense_ce_l2wrap(logits, labels)
