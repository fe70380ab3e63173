"""Continuous batching around the inference engine. Counterpart of
``visualrwkv_tpu/infer/server.py``.

A fixed batch of ``max_batch`` decode slots stays on the device:

* a request is prefilled alone and its RNN state is written into a free
  slot of the batched state (slice assignment in place, never a rebuilt
  batch);
* one eager decode step advances every slot one token;
* a slot that emits a stop token, or reaches its token budget, retires at
  once and is refilled from the queue, so no request waits on the longest
  one of a batch.

An RNN makes admission cheap: a slot's whole context is its O(1) state. Each
row's recurrence is independent of the others', so greedy ids are those of
``InferenceEngine.generate`` for the request alone, up to the rounding of
batched products. Sampling settings belong to the server, not to a request;
sampling draws from one explicit ``torch.Generator``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from visualrwkv_torch.config import STOP_TOKEN_INDEX
from visualrwkv_torch.infer.sampling import (
    SamplingParams,
    apply_penalties,
    sample_logits,
    update_occurrence,
)
from visualrwkv_torch.models import lm
from visualrwkv_torch.models.rwkv7 import LayerState
from visualrwkv_torch.ops.wkv7 import state_to_flat


@dataclass
class _Request:
    request_id: int
    input_ids: np.ndarray
    images: Optional[Any]
    max_new_tokens: int
    tokens: List[int] = field(default_factory=list)


class BatchedServer:
    """Slot-based continuous batching around an ``InferenceEngine``::

        server = BatchedServer(engine, max_batch=8)
        rid = server.submit(ids, max_new_tokens=64)
        results = server.run()          # drain everything
        text = tokenizer.decode(results[rid])
    """

    def __init__(self, engine, max_batch: int = 8,
                 sp: SamplingParams = SamplingParams(temperature=0.0),
                 stop_tokens: Tuple[int, ...] = (0, STOP_TOKEN_INDEX),
                 generator: Optional[torch.Generator] = None):
        self.engine = engine
        self.cfg = engine.cfg
        self.max_batch = max_batch
        self.sp = sp
        self.stop_tokens = tuple(stop_tokens)
        self._queue: deque = deque()
        self._slots: List[Optional[_Request]] = [None] * max_batch
        self._results: Dict[int, List[int]] = {}
        self._next_id = 0
        dev = engine.device
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        self._generator = generator
        V = self.cfg.rwkv.vocab_size
        self._states = self._to_carry(lm.init_lm_state(self.cfg.rwkv, max_batch, dev))
        self._logits = torch.zeros(max_batch, V, device=dev)
        self._occurrence = torch.zeros(max_batch, V, device=dev)
        self._stop = torch.tensor(self.stop_tokens, dtype=torch.long, device=dev)
        # idle slots decode a masked row; which slots are busy is host logic
        self._active = np.zeros((max_batch,), bool)

    def _to_carry(self, states: List[LayerState]) -> List[LayerState]:
        """The engine's decode carry (flat layout, bf16) of a state built
        fresh or by a prefill, as ``InferenceEngine.generate`` makes it."""
        if self.engine.state_layout == "flat":
            states = [s._replace(wkv=state_to_flat(s.wkv)) for s in states]
        return [s._replace(wkv=s.wkv.to(self.engine.state_dtype).contiguous()) for s in states]

    # -- client API ----------------------------------------------------------

    def submit(self, input_ids, images: Optional[Any] = None, max_new_tokens: int = 128) -> int:
        """Queue one request. ``images`` is a per-tower dict, or a
        zero-argument callable that returns one: it is called when the
        request takes a slot, so that at most about ``max_batch`` decoded
        images are held at once."""
        ids = np.asarray(input_ids)
        if ids.ndim == 2 and ids.shape[0] != 1:
            raise ValueError(
                f"submit() takes ONE request (got batch shape {ids.shape}); call it once per "
                "request: batching is the server's job"
            )
        rid = self._next_id
        self._next_id += 1
        self._queue.append(_Request(rid, ids.reshape(1, -1), images, max_new_tokens))
        return rid

    @property
    def pending(self) -> int:
        return len(self._queue) + sum(r is not None for r in self._slots)

    # -- scheduling ----------------------------------------------------------

    @torch.no_grad()
    def _admit(self) -> None:
        """Prefill queued requests into free slots."""
        for slot in range(self.max_batch):
            if self._slots[slot] is not None or not self._queue:
                continue
            req = self._queue.popleft()
            images = req.images() if callable(req.images) else req.images
            first_logits, states = self.engine.prefill_ids(req.input_ids, images)
            for dst, src in zip(self._states, self._to_carry(states)):
                for d, s in zip(dst, src):
                    d[slot] = s[0].to(d.dtype)
            self._logits[slot] = first_logits[0].float()
            self._occurrence[slot] = 0
            self._slots[slot] = req
            self._active[slot] = True

    @torch.no_grad()
    def step(self) -> None:
        """Advance every busy slot one token; retire the finished ones."""
        self._admit()
        if not self._active.any():
            return
        sp = self.sp
        token = sample_logits(apply_penalties(self._logits, self._occurrence, sp), sp, self._generator)
        self._occurrence = update_occurrence(self._occurrence, token, sp)
        stopped = (token[:, None] == self._stop[None, :]).any(-1)
        logits, self._states = lm.lm_decode_step(self.engine.params["rwkv"], self.cfg.rwkv, token,
                                                 self._states)
        self._logits = logits.float()
        token, stopped = token.cpu().numpy(), stopped.cpu().numpy()
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            req.tokens.append(int(token[slot]))
            if stopped[slot] or len(req.tokens) >= req.max_new_tokens:
                self._results[req.request_id] = req.tokens
                self._slots[slot] = None
                self._active[slot] = False

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue and every busy slot; ``{request_id: tokens}``."""
        while self.pending:
            self.step()
        out, self._results = self._results, {}
        return out
