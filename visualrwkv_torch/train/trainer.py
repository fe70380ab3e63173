"""The trainer. Counterpart of ``visualrwkv_tpu/train/trainer.py``: one
device, or one process a device over a ``(data, seq, model)`` mesh
(:mod:`visualrwkv_torch.parallel.mesh`).

- a train step is the loss and its gradient over ``accumulate_grad_batches``
  micro-batches of ``micro_bsz`` samples (a loop; the mean of the losses and
  of the gradients), then one optimizer update
  (:mod:`visualrwkv_torch.train.optim`);
- per-block activation checkpointing (``grad_cp``: True, or the selective
  policies "dots" and "wkv"), the chunked head + cross-entropy
  (``ce_chunk_t``);
- the vision towers are frozen: they run without autograd and their leaves
  never change;
- checkpoints carry the parameters, the optimizer state and the step, so
  that a resumed run takes the same next step;
- ``offload_optimizer`` keeps the fp32 masters and moments in pinned host
  memory, streamed to the device a group at a time
  (:mod:`visualrwkv_torch.train.offload`); a partial layer freeze keeps the
  resident optimizer, as the JAX trainer does;
- ``insertion_mode="leftpad"``: the loss of the v6.0 insertion, its plan
  made on the host from each batch's token ids;
- ``<proj_dir>/train_log.txt``: a ``NEW RUN`` header, the run configuration
  and one line an epoch, with the meter's rates mirrored to wandb under
  ``wandb_project`` (:mod:`visualrwkv_torch.utils.observability`).

With a mesh, each process is given its own rows (its ``data`` index's part
of the global batch, :func:`visualrwkv_torch.parallel.mesh.data_rows`):

- data parallelism: the gradients are reduced once a step, after the last
  micro-batch, summed over every rank in fp32 buckets and divided by the
  data size (:func:`visualrwkv_torch.parallel.collectives.reduce_gradients`);
- ``zero_stage >= 1`` (ZeRO-1): each data rank keeps the optimizer state of
  its part of every leaf the rule splits; ``zero_stage >= 3`` (ZeRO-3): the
  parameters too, and each block's leaves are gathered just before the
  block runs (:mod:`visualrwkv_torch.parallel.zero`), again under
  ``grad_cp`` in the backward, and their gradients reduce-scattered;
- context parallelism (``seq > 1``): the labels are shifted on the host,
  then each rank takes its token range and runs
  :func:`visualrwkv_torch.models.visualrwkv.training_loss_seq` (x070 and
  x060; image batches build their rows' embeddings whole on each seq rank,
  then keep the range; leftpad and bidirectional image batches raise, as in
  the JAX package);
- tensor parallelism (``model > 1``, every LM family): each rank keeps its
  part of every leaf the rule splits (:mod:`visualrwkv_torch.parallel.
  tensor`) and runs the blocks on its heads, the head on its slice of the
  vocabulary (the vocab-parallel loss) and the projector on its slice of
  the input channels. A replicated leaf used inside a split region gets
  its gradient summed over every rank; the others' are reduced over the
  ``data`` x ``seq`` ranks of this model index. ZeRO-1 splits each rank's
  parts over the data ranks; ``zero_stage >= 3`` runs as 1, as the JAX
  trainer ignores it under a model axis;
- ``offload_optimizer`` over several data ranks (or under ``zero_stage``
  3): each rank keeps the host state of its ZeRO part of every split leaf;
- the reported loss is the mean over the data ranks; the log, the history
  and ``train_log.txt`` come from rank 0 only; a checkpoint is gathered and
  written by rank 0 in the one-process format, and each rank reads its part
  back.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from visualrwkv_torch.config import TrainConfig, VLMConfig, resolve_device
from visualrwkv_torch.models.visualrwkv import (
    _on_device,
    _shifted_labels,
    prepare_embeddings,
    training_loss,
    training_loss_leftpad,
    training_loss_seq,
)
from visualrwkv_torch.multimodal.insertion import LeftpadPlan, leftpad_plan
from visualrwkv_torch.ops.wkv7 import get_wkv_impl
from visualrwkv_torch.parallel.collectives import (
    all_reduce_replicated,
    gather_leaf,
    reduce_gradients,
)
from visualrwkv_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
    data_seq_group,
    seq_range,
    zero_sharding,
)
from visualrwkv_torch.parallel.tensor import TensorPlan, model_axis
from visualrwkv_torch.parallel.zero import ZeroPlan, gathering
from visualrwkv_torch.train.offload import StreamedOffloadOptimizer
from visualrwkv_torch.train.optim import OptState, make_optimizer, tree_leaves, tree_map
from visualrwkv_torch.train.schedule import cosine_warmup_lr
from visualrwkv_torch.utils.observability import ThroughputMeter, TrainLogWriter

log = logging.getLogger(__name__)
Tensor = torch.Tensor
Params = Any


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: OptState
    step: int


def make_loss_fn(cfg: TrainConfig, vlm_cfg: VLMConfig, device, mesh=None) -> Callable[..., Tensor]:
    """The micro-batch loss ``loss_fn(params, micro, plan=None)``: the
    scatter insertion of the image features, or with
    ``insertion_mode="leftpad"`` the v6.0 insertion under ``plan`` (the
    whole batch's :func:`leftpad_plan`, made on the host). With a mesh the
    loss is the mean over the data ranks, whose backward is the identity
    (each rank's gradients are its own rows'); under ``seq > 1`` the micro
    batch's labels must be pre-shifted (:func:`shift_labels`) and its
    arrays whole along T: the loss takes this rank's range. Under
    ``model > 1`` the loss runs on this rank's parts of the parameters."""
    data_group = axis_group(mesh, "data")
    model_group = axis_group(mesh, "model") if axis_size(mesh, "model") > 1 else None
    if axis_size(mesh, "seq") > 1:
        if vlm_cfg.rwkv.version not in ("x070", "x060"):
            raise NotImplementedError("sequence-parallel training supports RWKV-7/RWKV-6 "
                                      f"(x070/x060); got version={vlm_cfg.rwkv.version!r}")
        seq_group = axis_group(mesh, "seq")

        def seq_loss_fn(params: Params, micro: Dict[str, Any], plan=None) -> Tensor:
            ids, images = _on_device(micro["input_ids"], micro.get("images"), device)
            labels_next = seq_range(torch.as_tensor(micro["labels"], device=device), mesh)
            kw = dict(grad_cp=cfg.grad_cp, ce_chunk_t=cfg.ce_chunk_t, seq_group=seq_group,
                      data_group=data_group, device=device, model_group=model_group)
            if images is None:
                return training_loss_seq(params, vlm_cfg, seq_range(ids, mesh), labels_next, **kw)
            if vlm_cfg.insertion_mode == "leftpad" or vlm_cfg.bidirectional_image:
                raise NotImplementedError(
                    "sequence-parallel image training supports the default scatter insertion only "
                    "(leftpad reshapes T per batch; bidirectional needs the whole span)")
            with model_axis(model_group):  # the projector on this rank's input channels
                emb = seq_range(prepare_embeddings(params, vlm_cfg, ids, images), mesh)
            return training_loss_seq(params, vlm_cfg, None, labels_next, embeds=emb, **kw)

        return seq_loss_fn

    def loss_fn(params: Params, micro: Dict[str, Any], plan: Optional[LeftpadPlan] = None) -> Tensor:
        if vlm_cfg.insertion_mode == "leftpad":
            loss = training_loss_leftpad(
                params, vlm_cfg, micro["input_ids"], micro["labels"], micro.get("images"),
                plan=plan, grad_cp=cfg.grad_cp, device=device, model_group=model_group,
            )
        else:
            loss = training_loss(
                params, vlm_cfg, micro["input_ids"], micro["labels"], micro.get("images"),
                grad_cp=cfg.grad_cp, ce_chunk_t=cfg.ce_chunk_t, device=device,
                model_group=model_group,
            )
        return loss if mesh is None else all_reduce_replicated(loss, data_group, mean=True)

    return loss_fn


def shift_labels(labels):
    """Labels for position t are labels[t + 1], the last position has none
    (``IGNORE_INDEX``): made on the host before a token split, so that each
    rank holds its own positions' targets (the JAX trainer's pre-shift)."""
    if isinstance(labels, Tensor):
        return _shifted_labels(labels)[0]
    return _shifted_labels(torch.from_numpy(np.asarray(labels)))[0].numpy()


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
        g = [torch.zeros_like(p) if x is None else x.contiguous() for p, x in zip(leaves, g)]
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
                 device="cuda", proj_dir: str = "out", log_every: int = 10, mesh=None):
        """``params`` must be on ``device`` (CUDA unless the caller asks for
        the CPU), whole on every rank. Floating leaves are cast to
        ``train_cfg.param_dtype``; the optimizer keeps fp32 masters of
        trainable leaves stored below fp32 unless ``optim_precision="bf16_sr"``.
        ``mesh``: a :func:`visualrwkv_torch.parallel.mesh.make_mesh` mesh
        (None: one device)."""
        self.device = resolve_device(device)
        self.vlm_cfg = vlm_cfg
        self.cfg = train_cfg
        self.mesh = mesh
        self.n_data = axis_size(mesh, "data")
        self.n_seq = axis_size(mesh, "seq")
        self.n_model = axis_size(mesh, "model")
        self.rank0 = not dist.is_initialized() or dist.get_rank() == 0
        self.proj_dir = proj_dir
        self.log_every = log_every
        self.total_steps = (train_cfg.epoch_begin + train_cfg.epoch_count) * train_cfg.epoch_steps

        pd = getattr(torch, train_cfg.param_dtype)
        params = tree_map(
            lambda p: p.detach().to(pd) if p.is_floating_point() else p.detach(), params)
        zero_stage = train_cfg.zero_stage
        self.tp = tp = None
        self._kinds: Optional[List[Optional[str]]] = None
        if self.n_model > 1:
            tp = self.tp = self._tensor_plan(params)
            if zero_stage >= 3:
                log.info("zero_stage %d under a model axis of %d runs as ZeRO-1 (the JAX trainer "
                         "places the parameters by the tensor-parallel rule then)", zero_stage,
                         self.n_model)
                zero_stage = 1
            kinds = tp.kinds(params)
            params = tree_map(lambda p, ax: p if ax is None else tp.part(p, ax).clone(), params, tp.axes)
        # ZeRO over the data ranks: asked for, or the host state of an
        # offloaded optimizer over several of them
        zero = None
        if mesh is not None and (zero_stage >= 1 or (train_cfg.offload_optimizer and self.n_data > 1)):
            zero = ZeroPlan(stage=3 if zero_stage >= 3 else 1,
                            axes=zero_sharding(params, self.n_data), n=self.n_data,
                            index=axis_index(mesh, "data"), group=axis_group(mesh, "data"))
        self.zero = zero
        self._dp_group = data_seq_group(mesh) if self.n_model > 1 else None
        if zero is not None and zero.stage >= 3:  # a rank keeps its part of each split leaf
            params = tree_map(lambda p, ax: p if ax is None else zero.part(p, ax).clone(), params, zero.axes)
        self._streamed = None
        if train_cfg.offload_optimizer and 0 < train_cfg.freeze_rwkv_layers < vlm_cfg.rwkv.n_layer:
            log.info("offload_optimizer: a partial layer freeze keeps the resident optimizer")
        elif train_cfg.offload_optimizer:
            self._streamed = StreamedOffloadOptimizer(train_cfg, vlm_cfg, params, self.total_steps,
                                                      self.device, zero, tp)
        if self._streamed is not None:
            self.opt = self._streamed.opt
            self.state = TrainState(params=params, opt_state=self._streamed.state, step=0)
        else:
            self.opt = make_optimizer(train_cfg, params, self.total_steps, vlm_cfg.rwkv.n_layer, zero, tp)
            self.state = TrainState(params=params, opt_state=self.opt.init(params), step=0)
        if tp is not None:
            self._kinds = [k for k, t in zip(tree_leaves(kinds), tree_leaves(self.opt.train_mask)) if t]
        # ZeRO-3: the split dim of each part, by the part's identity (updates are in place)
        self._split: Dict[int, int] = {}
        if zero is not None and zero.stage >= 3:
            self._split = {id(p): ax for p, ax in zip(tree_leaves(params), tree_leaves(zero.axes))
                           if ax is not None}
        # the trainable leaves, in the optimizer's order, and the micro-batch loss
        self.leaves = self.opt.trainable_leaves(params)
        for p in self.leaves:
            p.requires_grad_(True)
        self.loss_fn = make_loss_fn(train_cfg, vlm_cfg, self.device, mesh)
        self.history: List[Dict[str, Any]] = []
        self.meter = ThroughputMeter()
        self.train_log = (TrainLogWriter(proj_dir, run_config={"train": vars(train_cfg)},
                                         wandb_project=train_cfg.wandb_project)
                          if self.rank0 else None)
        log.info("trainer: %s on %s, WKV mode %s, grad_cp %r, mesh data=%d seq=%d model=%d, "
                 "zero_stage %d", vlm_cfg.rwkv.version, self.device, get_wkv_impl(), train_cfg.grad_cp,
                 self.n_data, self.n_seq, self.n_model, zero_stage)

    def _tensor_plan(self, params: Params) -> TensorPlan:
        """The split of ``params`` (whole) over the model ranks. Raises for
        a head count the axis does not divide where the rule splits
        ``dim_att`` (the matrix-state families run the WKV on whole heads;
        x040's recurrence is per channel)."""
        rcfg = self.vlm_cfg.rwkv
        tp = TensorPlan.make(params, axis_group(self.mesh, "model"))
        att_split = any(blk["att"]["receptance"]["weight"] is not None for blk in tp.axes["rwkv"]["blocks"])
        if att_split and rcfg.version != "x040" and rcfg.n_head % tp.n:
            raise ValueError(f"a model axis of {tp.n} splits dim_att {rcfg.dim_att} but not the "
                             f"{rcfg.n_head} heads: the WKV runs on whole heads")
        return tp

    @property
    def params(self) -> Params:
        """The live parameter tree (under ZeRO-3 each rank's parts:
        :meth:`full_params` gathers them)."""
        return self.state.params

    # -- ZeRO-3 gathers ----------------------------------------------------

    def _gather_tree(self, tree):
        """``tree`` with every ZeRO-3 part replaced by its differentiable
        gather (the other leaves as they are)."""
        seq_group = axis_group(self.mesh, "seq") if self.n_seq > 1 else None
        return tree_map(lambda t: t if id(t) not in self._split
                        else gather_leaf(t, self._split[id(t)], self.zero.group, seq_group), tree)

    def _gathered_outside_blocks(self, params: Params) -> Params:
        """Every part gathered but the LM blocks' of the families whose
        blocks gather their own (``parallel.zero.materialize``)."""
        own = self.vlm_cfg.rwkv.version in ("x070", "x060")
        out = {k: self._gather_tree(v) for k, v in params.items() if k != "rwkv"}
        out["rwkv"] = {k: v if own and k == "blocks" else self._gather_tree(v)
                       for k, v in params["rwkv"].items()}
        return out

    @torch.no_grad()
    def _whole(self, tree, of_params: bool):
        """``tree`` (the parameters, or a tree of optimizer state shaped like
        them) with each split leaf gathered whole, over the data ranks, then
        the model ranks; every rank must call it."""
        gather = lambda t, ax, plan: t if t is None or ax is None else plan.gather(t, ax)
        z = self.zero
        if z is not None and not (of_params and z.stage < 3):
            tree = tree_map(lambda t, ax: gather(t, ax, z), tree, z.axes)
        if self.tp is not None:
            tree = tree_map(lambda t, ax: gather(t, ax, self.tp), tree, self.tp.axes)
        return tree

    def _local(self, tree, of_params: bool):
        """The inverse of :meth:`_whole`: this rank's parts of a tree of whole
        leaves (views)."""
        part = lambda t, ax, plan: t if t is None or ax is None else plan.part(t, ax)
        if self.tp is not None:
            tree = tree_map(lambda t, ax: part(t, ax, self.tp), tree, self.tp.axes)
        z = self.zero
        if z is not None and not (of_params and z.stage < 3):
            tree = tree_map(lambda t, ax: part(t, ax, z), tree, z.axes)
        return tree

    def full_params(self) -> Params:
        """The whole parameter tree (a collective under ZeRO-3)."""
        return self._whole(self.state.params, of_params=True)

    # -- the step ----------------------------------------------------------

    def _plan(self, input_ids) -> LeftpadPlan:
        """The leftpad plan of the whole step's rows: under data parallelism
        made from every data rank's token ids, as one device would."""
        ids = np.asarray(input_ids.detach().cpu() if isinstance(input_ids, Tensor) else input_ids)
        if self.n_data > 1:
            every = [None] * self.n_data
            dist.all_gather_object(every, ids, group=axis_group(self.mesh, "data"))
            ids = np.concatenate(every)
        return leftpad_plan(ids, self.vlm_cfg.num_token_per_image, self.vlm_cfg.rwkv.ctx_len)

    def loss_and_reduced_grads(self, batch: Dict[str, Any]) -> Tuple[Tensor, List[Tensor]]:
        """The step's loss and the gradients of :attr:`leaves` (under ZeRO-3
        a split leaf's gradient is this rank's part), reduced over the mesh:
        summed over the seq ranks, averaged over the data ranks."""
        loss_fn = self.loss_fn
        if self.vlm_cfg.insertion_mode == "leftpad" and self.n_seq == 1:  # one plan for the batch
            plan = self._plan(batch["input_ids"])
            loss_fn = lambda params, micro: self.loss_fn(params, micro, plan)
        if self.n_seq > 1:
            batch = dict(batch, labels=shift_labels(batch["labels"]))
        if self._split:
            inner = loss_fn
            loss_fn = lambda params, micro: inner(self._gathered_outside_blocks(params), micro)
        with gathering(self._gather_tree if self._split else None):
            loss, grads = loss_and_grads(loss_fn, self.state.params, self.leaves, batch,
                                         self.cfg.accumulate_grad_batches)
        if self._kinds is not None:  # model > 1: a rank's share of a replicated leaf's gradient is
            # summed over every rank, the others over this model index's data and seq ranks
            reduce_gradients([g for g, k in zip(grads, self._kinds) if k == "partial"], dist.group.WORLD,
                             divide=self.n_data)
            reduce_gradients([g for g, k in zip(grads, self._kinds) if k != "partial"], self._dp_group,
                             divide=self.n_data)
        elif self.mesh is not None:  # once a step: sum over every rank, mean over the data ranks
            whole = [g for g, p in zip(grads, self.leaves) if id(p) not in self._split]
            reduce_gradients(whole, dist.group.WORLD, divide=self.n_data)
        return loss, grads

    def train_step(self, batch: Dict[str, Any]) -> Tensor:
        """One step on ``batch`` (``input_ids`` and ``labels`` [A*B, T],
        optional per-tower ``images`` [A*N_img, H, W, 3]; A =
        ``accumulate_grad_batches``; under a mesh this process's rows,
        whole along T). Returns the loss (a 0-d tensor on the device, the
        mean over the data ranks; the caller decides when to wait for it)."""
        loss, grads = self.loss_and_reduced_grads(batch)
        if self._streamed is not None:
            self._streamed.step(self.state.params, grads)
        else:
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
            n_tokens = int(np.prod(np.shape(batch["input_ids"])))
            tokens += n_tokens
            rates = self.meter.step(len(batch["input_ids"]), n_tokens)
            if s % self.log_every == 0 or s == cfg.epoch_steps - 1:
                last_loss = float(loss)  # waits for the device
                now = time.perf_counter()
                rate = tokens / max(now - t_prev, 1e-9)  # since the last logged step
                t_prev, tokens = now, 0
                if self.rank0:
                    lr = self.opt.lr(self.state.opt_state.count - 1)
                    log.info("epoch %d step %d/%d loss %.4f exp(loss) %.3f lr %.3e tok/s %.0f",
                             epoch, s, cfg.epoch_steps, last_loss, math.exp(min(last_loss, 20)), lr,
                             rate)
                    self.history.append({"epoch": epoch, "step": s, "loss": last_loss, "lr": lr,
                                         "token/s": rate})
                    self.train_log.log_step({"loss": last_loss, **rates})
        if self.rank0:
            lr_now = cosine_warmup_lr(self.state.step, cfg.lr_init, cfg.lr_final, cfg.warmup_steps,
                                      self.total_steps)
            self.train_log.log_epoch(epoch, last_loss, lr_now)
        return last_loss

    # -- checkpoints -------------------------------------------------------

    def save_checkpoint(self, path: str, with_optimizer: bool = True) -> None:
        """Parameters, step and (for a true resume) the optimizer state, in
        the one-process format: under a mesh the ZeRO parts are gathered
        (every rank must call this) and rank 0 writes the file."""
        payload = {"params": tree_map(lambda p: p.detach(), self.full_params()),
                   "step": self.state.step}
        if with_optimizer:
            st = self._streamed.opt_state if self._streamed is not None else self.state.opt_state
            payload["opt_state"] = dict(st.state_dict(), **{
                name: self._whole(getattr(st, name), of_params=False)
                for name in ("mu", "nu", "master")})
        if self.rank0:
            torch.save(payload, path)
        if dist.is_initialized():
            dist.barrier()

    def load_checkpoint(self, path: str) -> None:
        """Restore into the live trees (same configuration as the run that
        saved it); a checkpoint without optimizer state restores the weights.
        An offloaded optimizer's state goes back into its host buffers;
        under ZeRO and tensor parallelism each rank takes its parts of the
        split leaves."""
        where = "cpu" if self._streamed is not None else self.device
        payload = torch.load(path, map_location=where, weights_only=True)
        copy = lambda dst, src: tree_map(lambda d, s: d if d is None else d.copy_(s), dst, src)
        with torch.no_grad():
            copy(self.state.params, self._local(payload["params"], of_params=True))
            if "opt_state" in payload:
                saved = dict(payload["opt_state"], **{
                    name: self._local(payload["opt_state"][name], of_params=False)
                    for name in ("mu", "nu", "master")})
                if self._streamed is not None:
                    self._streamed.opt_state = saved
                else:
                    st = self.state.opt_state
                    for name in ("mu", "nu", "master"):
                        copy(getattr(st, name), saved[name])
                    st.count = int(saved["count"])
        self.state.step = int(payload["step"])
