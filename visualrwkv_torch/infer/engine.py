"""O(1)-state RNN inference engine. Counterpart of
``visualrwkv_tpu/infer/engine.py``.

prefill (images encoded, features scattered, one chunked LM forward) ->
per-layer recurrent state -> a decode loop of one-token steps. Batched
greedy / top-p sampling with presence and frequency penalties, stop-token
masking with per-row state freezing, and a content-keyed image-state cache.
The decode loop is a Python loop that never waits on the device until the
generated ids are returned.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from visualrwkv_torch.config import STOP_TOKEN_INDEX, VLMConfig, resolve_device
from visualrwkv_torch.infer.sampling import (
    SamplingParams,
    apply_penalties,
    sample_logits,
    update_occurrence,
)
from visualrwkv_torch.models import lm
from visualrwkv_torch.models.rwkv7 import LayerState
from visualrwkv_torch.models.visualrwkv import encode_images, prepare_embeddings
from visualrwkv_torch.ops.wkv7 import state_from_flat, state_to_flat

Tensor = torch.Tensor
Params = Dict[str, Any]


class GenerateResult(NamedTuple):
    tokens: np.ndarray  # [B, max_new_tokens] (padded with the stop token)
    lengths: np.ndarray  # [B] generated tokens, the stop token included
    logits: np.ndarray  # [B, max_new_tokens] logit of each sampled token
    probs: np.ndarray  # [B, max_new_tokens] softmax prob of each sampled token


def _prefill(params: Params, cfg: VLMConfig, x_emb: Tensor,
             states: Optional[List[LayerState]]) -> Tuple[Tensor, List[LayerState]]:
    """Embeddings through the LM; returns (last logits [B, V], states).

    Stateless: one chunked forward with EOS left padding. Stateful: the
    chunk-aligned bulk as one forward, then one-token steps for the tail."""
    rcfg = cfg.rwkv
    if states is None:
        logits, states = lm.lm_forward(params["rwkv"], rcfg, x_emb)
        return logits[:, -1], states
    T = x_emb.shape[1]
    bulk = T - T % rcfg.chunk_len
    last_logits = None
    # a carried decode state (flat layout, bf16) re-enters prefill in the head layout, fp32
    # (x040's [B, C, 3] triple has one layout)
    if rcfg.version != "x040":
        states = [st._replace(wkv=state_from_flat(st.wkv, rcfg.n_head)) if st.wkv.dim() == 3 else st
                  for st in states]
    if bulk:
        states = [st._replace(wkv=st.wkv.float()) for st in states]
        logits, states = lm.lm_forward(params["rwkv"], rcfg, x_emb[:, :bulk], states=states)
        last_logits = logits[:, -1]
    for t in range(bulk, T):
        last_logits, states = lm.lm_decode_step_embed(params["rwkv"], rcfg, x_emb[:, t], states)
    return last_logits, states


def _freeze(finished: Tensor, old: List[LayerState], new: List[LayerState]) -> List[LayerState]:
    """Keep the old state of rows that have finished."""
    out = []
    for o, n in zip(old, new):
        out.append(LayerState(*(
            torch.where(finished.reshape((-1,) + (1,) * (b.dim() - 1)), a, b)
            for a, b in zip(o, n)
        )))
    return out


def _decode_loop(params: Params, cfg: VLMConfig, first_logits: Tensor, states: List[LayerState],
                 sp: SamplingParams, max_new_tokens: int, stop_tokens: Tuple[int, ...],
                 generator: Optional[torch.Generator]):
    rcfg = cfg.rwkv
    B, V = first_logits.shape
    dev = first_logits.device
    occurrence = torch.zeros(B, V, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    stop = torch.tensor(stop_tokens, dtype=torch.long, device=dev)
    logits = first_logits
    toks, tls, tps, was_finished = [], [], [], []
    for _ in range(max_new_tokens):
        lf = logits.float()
        token = sample_logits(apply_penalties(lf, occurrence, sp), sp, generator)
        tok_logit = lf.gather(-1, token[:, None])[:, 0]
        tok_prob = torch.softmax(lf, -1).gather(-1, token[:, None])[:, 0]
        token = torch.where(finished, torch.full_like(token, STOP_TOKEN_INDEX), token)
        occurrence = update_occurrence(occurrence, token, sp)
        new_finished = finished | (token[:, None] == stop[None, :]).any(-1)
        logits, new_states = lm.lm_decode_step(params["rwkv"], rcfg, token, states)
        states = _freeze(new_finished, states, new_states)
        toks.append(token)
        tls.append(tok_logit)
        tps.append(tok_prob)
        was_finished.append(finished)
        finished = new_finished
    tokens = torch.stack(toks, 1)
    lengths = (~torch.stack(was_finished, 1)).sum(1)
    return tokens, lengths, torch.stack(tls, 1), torch.stack(tps, 1)


class InferenceEngine:
    """Parameters + the prefill / decode paths + an image-state cache."""

    def __init__(self, params: Params, cfg: VLMConfig, state_dtype: str = "float32",
                 state_layout: str = "head", device="cuda"):
        """state_dtype: dtype the WKV state is carried in during decode
        ("float32", or "bfloat16" to halve the decode state traffic; the step
        math stays fp32). state_layout: "head" carries the WKV state as
        [B, H, 64, 64]; "flat" carries it as [B, 64, H*64] during decode
        (``ops.wkv7.wkv7_step_flat``, kernel K4 on CUDA; x060:
        ``ops.wkv6.wkv6_step_flat``, K10 on the flat layout). ``params``
        must be on ``device`` (CUDA unless the caller asks for the CPU);
        their large linears may be int8 (``infer.quant``,
        ``infer.strategy``). x040 (a ``[B, C, 3]`` (aa, bb, pp) state)
        takes the head layout and an fp32 state only, as the JAX package
        rules: the flat layout does not fit its shape, and its max-tracked
        pp is unsafe in bf16. x052 takes both layouts (K10 on the flat
        one)."""
        if state_layout not in ("head", "flat"):
            raise ValueError(f"unknown state_layout {state_layout!r}")
        if state_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown state_dtype {state_dtype!r}")
        if cfg.rwkv.version == "x040":
            if state_layout != "head":
                raise ValueError("state_layout='flat' requires a matrix-state RWKV version "
                                 "(x052/x060/x070); x040 carries an aa/bb/pp triple")
            if state_dtype != "float32":
                raise ValueError("x040 requires state_dtype='float32' (the log-domain pp carry "
                                 "is max-tracked and unsafe in bf16)")
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.state_dtype = getattr(torch, state_dtype)
        self.state_layout = state_layout
        self._state_cache: Dict[str, List[LayerState]] = {}
        self._sample_counter = 0

    def _images(self, images):
        if images is None:
            return None
        return {t: torch.as_tensor(v, device=self.device) for t, v in images.items()}

    @torch.no_grad()
    def prefill_ids(self, input_ids, images=None, states=None):
        """(last logits [B, V] fp32, states) after the prompt."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        x = prepare_embeddings(self.params, self.cfg, ids, self._images(images))
        return _prefill(self.params, self.cfg, x, states)

    @torch.no_grad()
    def compute_image_state(self, images: Dict[str, Any], cache_key: Optional[str] = None):
        """Image -> RNN state (prefill on the projected image embeddings
        only), cached by a content hash."""
        if cache_key is None:
            h = hashlib.sha256()
            for t in sorted(images):
                h.update(np.asarray(torch.as_tensor(images[t]).cpu()).tobytes())
            cache_key = h.hexdigest()
        if cache_key in self._state_cache:
            return self._state_cache[cache_key]
        feats = encode_images(self.params, self.cfg, self._images(images))
        x = feats.reshape(1, -1, feats.shape[-1])
        _, states = _prefill(self.params, self.cfg, x,
                             lm.init_lm_state(self.cfg.rwkv, 1, self.device))
        self._state_cache[cache_key] = states
        return states

    @torch.no_grad()
    def generate(self, input_ids, images: Optional[Dict[str, Any]] = None, states=None,
                 max_new_tokens: int = 128, do_sample: bool = False, temperature: float = 1.0,
                 top_p: float = 1.0, alpha_presence: float = 0.0, alpha_frequency: float = 0.0,
                 stop_tokens: Tuple[int, ...] = (0, STOP_TOKEN_INDEX),
                 generator: Optional[torch.Generator] = None) -> GenerateResult:
        sp = SamplingParams(
            temperature=temperature if do_sample else 0.0, top_p=top_p,
            alpha_presence=alpha_presence, alpha_frequency=alpha_frequency,
        )
        if generator is None and do_sample:
            # vary sampling across calls: a fixed default seed would repeat
            self._sample_counter += 1
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self._sample_counter)
        first_logits, states = self.prefill_ids(input_ids, images, states)
        if self.state_layout == "flat":
            states = [st._replace(wkv=state_to_flat(st.wkv)) for st in states]
        states = [st._replace(wkv=st.wkv.to(self.state_dtype).contiguous()) for st in states]
        tokens, lengths, tls, tps = _decode_loop(
            self.params, self.cfg, first_logits, states, sp, max_new_tokens,
            tuple(stop_tokens), generator,
        )
        return GenerateResult(*(t.cpu().numpy() for t in (tokens, lengths, tls, tps)))

    def decode_text(self, result: GenerateResult, tokenizer, strip_stop: bool = True) -> List[str]:
        """Each row's generated ids as text, the final stop token left out."""
        outs = []
        for row, n in zip(result.tokens, result.lengths):
            ids = [int(t) for t in row[: int(n)]]
            if strip_stop and ids and ids[-1] in (0, STOP_TOKEN_INDEX):
                ids = ids[:-1]
            outs.append(tokenizer.decode(ids))
        return outs
