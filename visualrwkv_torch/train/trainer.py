"""Single-GPU trainer. Counterpart of ``visualrwkv_tpu/train/trainer.py``
without its meshes: one device holds the parameters, the gradients and the
optimizer state.

- a train step is the loss and its gradient over ``accumulate_grad_batches``
  micro-batches of ``micro_bsz`` samples (a loop; the mean of the losses and
  of the gradients), then one optimizer update
  (:mod:`visualrwkv_torch.train.optim`);
- per-block activation checkpointing (``grad_cp``), the chunked head +
  cross-entropy (``ce_chunk_t``);
- the vision towers are frozen: they run without autograd and their leaves
  never change;
- checkpoints carry the parameters, the optimizer state and the step, so
  that a resumed run takes the same next step.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from visualrwkv_torch.config import TrainConfig, VLMConfig, resolve_device
from visualrwkv_torch.models.visualrwkv import training_loss
from visualrwkv_torch.train.optim import OptState, Optimizer, make_optimizer, tree_map

log = logging.getLogger(__name__)
Tensor = torch.Tensor
Params = Any


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: OptState
    step: int


def create_train_state(params: Params, cfg: TrainConfig, vlm_cfg: VLMConfig,
                       total_steps: int) -> Tuple[TrainState, Optimizer]:
    opt = make_optimizer(cfg, params, total_steps, vlm_cfg.rwkv.n_layer)
    return TrainState(params=params, opt_state=opt.init(params), step=0), opt


def make_loss_fn(cfg: TrainConfig, vlm_cfg: VLMConfig, device) -> Callable[[Params, Dict], Tensor]:
    """The micro-batch loss: the default scatter insertion of the image
    features (the JAX package's leftpad insertion and sequence-parallel loss
    are not ported; the configurations that would select them do not exist
    in the port)."""

    def loss_fn(params: Params, micro: Dict[str, Any]) -> Tensor:
        return training_loss(
            params, vlm_cfg, micro["input_ids"], micro["labels"], micro.get("images"),
            grad_cp=cfg.grad_cp, ce_chunk_t=cfg.ce_chunk_t, device=device,
        )

    return loss_fn


def _micro_batches(batch: Dict[str, Any], accum: int) -> List[Dict[str, Any]]:
    """Split the leading axis of every array of ``batch`` into ``accum`` parts."""
    def part(x, i):
        n = len(x) // accum
        return x[i * n:(i + 1) * n]

    out = []
    for i in range(accum):
        micro = {k: part(batch[k], i) for k in ("input_ids", "labels")}
        if batch.get("images") is not None:
            micro["images"] = {t: part(v, i) for t, v in batch["images"].items()}
        out.append(micro)
    return out


def loss_and_grads(loss_fn: Callable, params: Params, leaves: List[Tensor], batch: Dict[str, Any],
                   accum: int) -> Tuple[Tensor, List[Tensor]]:
    """Mean loss and mean gradient (with respect to ``leaves``) over the
    ``accum`` micro-batches of ``batch``."""
    accum = max(1, accum)
    total, grads = None, None
    for micro in _micro_batches(batch, accum):
        loss = loss_fn(params, micro)
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x for p, x in zip(leaves, g)]
        total = loss.detach() if total is None else total + loss.detach()
        if grads is None:
            grads = list(g)
        else:
            torch._foreach_add_(grads, g)
    if accum > 1:
        total = total / accum
        torch._foreach_div_(grads, accum)
    return total, grads


class Trainer:
    """Host-side training loop: data feeding, the step, logging and
    checkpoints."""

    def __init__(self, vlm_cfg: VLMConfig, train_cfg: TrainConfig, params: Params,
                 device="cuda", proj_dir: str = "out", log_every: int = 10):
        """``params`` must be on ``device`` (CUDA unless the caller asks for
        the CPU). Floating leaves are cast to ``train_cfg.param_dtype``;
        the optimizer keeps fp32 masters of trainable leaves stored below
        fp32 unless ``optim_precision="bf16_sr"``."""
        self.device = resolve_device(device)
        self.vlm_cfg = vlm_cfg
        self.cfg = train_cfg
        self.proj_dir = proj_dir
        self.log_every = log_every
        self.total_steps = (train_cfg.epoch_begin + train_cfg.epoch_count) * train_cfg.epoch_steps

        pd = getattr(torch, train_cfg.param_dtype)
        params = tree_map(
            lambda p: p.detach().to(pd) if p.is_floating_point() else p.detach(), params)
        state, self.opt = create_train_state(params, train_cfg, vlm_cfg, self.total_steps)
        self.state = state
        # the trainable leaves, in the optimizer's order, and the micro-batch loss
        self.leaves = self.opt.trainable_leaves(params)
        for p in self.leaves:
            p.requires_grad_(True)
        self.loss_fn = make_loss_fn(train_cfg, vlm_cfg, self.device)
        self.history: List[Dict[str, Any]] = []

    @property
    def params(self) -> Params:
        return self.state.params

    def train_step(self, batch: Dict[str, Any]) -> Tensor:
        """One step on ``batch`` (``input_ids`` and ``labels`` [A*B, T],
        optional per-tower ``images`` [A*N_img, H, W, 3]; A =
        ``accumulate_grad_batches``). Returns the loss (a 0-d tensor on the
        device; the caller decides when to wait for it)."""
        loss, grads = loss_and_grads(self.loss_fn, self.state.params, self.leaves, batch,
                                     self.cfg.accumulate_grad_batches)
        self.opt.step(self.state.params, grads, self.state.opt_state, self.state.step)
        self.state.step += 1
        return loss

    def run_epoch(self, batch_fn: Callable[[int], Dict], epoch: int) -> float:
        cfg = self.cfg
        last_loss = float("nan")
        t_prev, tokens = time.perf_counter(), 0
        for s in range(cfg.epoch_steps):
            batch = batch_fn(s)
            loss = self.train_step(batch)
            tokens += int(np.prod(np.shape(batch["input_ids"])))
            if s % self.log_every == 0 or s == cfg.epoch_steps - 1:
                last_loss = float(loss)  # waits for the device
                now = time.perf_counter()
                rate = tokens / max(now - t_prev, 1e-9)  # since the last logged step
                t_prev, tokens = now, 0
                lr = self.opt.lr(self.state.opt_state.count - 1)
                log.info("epoch %d step %d/%d loss %.4f exp(loss) %.3f lr %.3e tok/s %.0f",
                         epoch, s, cfg.epoch_steps, last_loss, math.exp(min(last_loss, 20)), lr, rate)
                self.history.append({"epoch": epoch, "step": s, "loss": last_loss, "lr": lr,
                                     "token/s": rate})
        return last_loss

    def save_checkpoint(self, path: str, with_optimizer: bool = True) -> None:
        """Parameters, step and (for a true resume) the optimizer state."""
        payload = {"params": tree_map(lambda p: p.detach(), self.state.params),
                   "step": self.state.step}
        if with_optimizer:
            payload["opt_state"] = self.state.opt_state.state_dict()
        torch.save(payload, path)

    def load_checkpoint(self, path: str) -> None:
        """Restore into the live trees (same configuration as the run that
        saved it); a checkpoint without optimizer state restores the weights."""
        payload = torch.load(path, map_location=self.device, weights_only=True)
        copy = lambda dst, src: dst if dst is None else dst.copy_(src)
        with torch.no_grad():
            tree_map(copy, self.state.params, payload["params"])
            if "opt_state" in payload:
                st, saved = self.state.opt_state, payload["opt_state"]
                for name in ("mu", "nu", "master"):
                    tree_map(copy, getattr(st, name), saved[name])
                st.count = int(saved["count"])
        self.state.step = int(payload["step"])
