"""Token sampling: top-p with temperature plus presence/frequency penalties.
Counterpart of ``visualrwkv_tpu/infer/sampling.py`` (same semantics; the
random stream is a ``torch.Generator``, so sampled ids differ from JAX's)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


class SamplingParams(NamedTuple):
    temperature: float = 1.0
    top_p: float = 1.0
    alpha_presence: float = 0.0
    alpha_frequency: float = 0.0
    occurrence_decay: float = 0.996


def apply_penalties(logits: Tensor, occurrence: Tensor, p: SamplingParams) -> Tensor:
    seen = (occurrence > 0).to(logits.dtype)
    return logits - (p.alpha_presence * seen + occurrence * p.alpha_frequency)


def update_occurrence(occurrence: Tensor, token: Tensor, p: SamplingParams) -> Tensor:
    occurrence = occurrence * p.occurrence_decay
    return occurrence.scatter_add(
        1, token[:, None].long(), torch.ones_like(occurrence[:, :1])
    )


def sample_logits(logits: Tensor, p: SamplingParams,
                  generator: Optional[torch.Generator] = None) -> Tensor:
    """[B, V] logits -> [B] token ids (argmax when temperature == 0)."""
    logits = logits.float()
    if p.temperature == 0.0:
        return logits.argmax(-1)
    probs = torch.softmax(logits, -1)
    sorted_probs = probs.sort(-1, descending=True).values
    cum = sorted_probs.cumsum(-1)
    # cutoff = prob of the first sorted entry whose cumulative exceeds top_p
    idx = (cum > p.top_p).to(torch.int8).argmax(-1)
    cutoff = sorted_probs.gather(-1, idx[:, None])
    probs = torch.where(probs < cutoff, torch.zeros_like(probs), probs)
    if p.temperature != 1.0:
        probs = probs.pow(1.0 / p.temperature)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
