"""The host-offloaded optimizer: AdamW whose fp32 masters and moments live
in pinned host memory and reach the device one group at a time (the
reference's DeepSpeedCPUAdam, src/model.py:360-366). Counterpart of
``visualrwkv_tpu/train/offload.py``.

It lets a model train on one card whose optimizer state would not fit
beside it: VisualRWKV-6 7B carries 12 bytes of state a trainable parameter
(an fp32 master and two fp32 moments), about 95 GB, on top of 16 GB of bf16
parameters and as many of gradients.

The state is kept in the JAX package's groups: block 0, each of blocks
1..L-1, and the rest of the tree (embedding, head, projector, ...). Each
group is one flat fp32 buffer in pinned host memory (a trainable leaf's
moments, then its master when it is stored below fp32). A step:

- clips the gradients by their global norm, over all of them, first;
- streams the groups through two device slots sized to the largest group:
  while group g updates on the compute stream, group g + 1 copies in on one
  copy stream and group g - 1 copies back on another, each copy ordered by
  events (a slot is refilled only once its last copy back is done);
- updates each leaf with the resident optimizer's arithmetic
  (:meth:`visualrwkv_torch.train.optim.Optimizer.update_leaf`), so that
  offloaded and resident training give bit-equal parameters on one device.

On the CPU (a caller that asks for it) the same groups and copies run
synchronously, without pinning.

Over several data ranks (a :class:`visualrwkv_torch.parallel.zero.ZeroPlan`)
each rank keeps the state of its ZeRO part of every leaf the rule splits,
so its pinned bytes are about ``1 / n_data`` of one device's: it steps
those parts on the gradients averaged over the data ranks, then each
updated leaf is gathered (ZeRO-1; under ZeRO-3 a rank's parameters are its
parts, and stay so). The JAX package keeps the whole state on every rank,
behind a replicated host sharding, and steps it on the same gradients: the
numbers are the same. Under tensor parallelism (a
:class:`visualrwkv_torch.parallel.tensor.TensorPlan`) the leaves are each
model rank's parts, and the clip counts them as the resident optimizer
does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from visualrwkv_torch.config import TrainConfig, VLMConfig
from visualrwkv_torch.parallel.tensor import TensorPlan
from visualrwkv_torch.parallel.zero import ZeroPlan
from visualrwkv_torch.train.optim import (
    OptState,
    Optimizer,
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
    tree_map_with_path,
)

Tensor = torch.Tensor
Params = Any

_ALIGN = 16  # floats: each leaf's state starts on a 64-byte boundary


def _group_of(path) -> Tuple[int, ...]:
    """The group a leaf belongs to, as a sort key: (0, i) for LM block i,
    (1,) for the rest of the tree."""
    if path[:2] == ("rwkv", "blocks"):
        return (0, path[2])
    return (1,)


def state_part(opt: Optimizer, i: int, p: Tensor) -> Tensor:
    """The part of trainable leaf ``i`` (``p``, as the rank holds it) whose
    state this rank keeps: its ZeRO-1 part where the rule splits it over
    the data ranks, else ``p`` (a ZeRO-3 part already, or whole)."""
    _, zax = opt.axes(i)
    return opt.zero.part(p, zax) if zax is not None and opt.zero.stage < 3 else p


def group_layout(opt: Optimizer, params: Params):
    """Where each trainable leaf's state sits: (rows, groups, sizes). ``rows``
    are the trainable leaves' (path, leaf), in the order of their gradients;
    ``groups[g]`` lists (row index, decayed, offsets of mu / nu / master or
    None) and ``sizes[g]`` is group g's buffer length in floats. Sizes
    follow from the shapes and dtypes alone: the host memory an offloaded
    run needs is ``4 * sum(sizes)`` bytes before anything is allocated.
    Under ZeRO a leaf's state is that of this rank's part (:func:`state_part`)."""
    leaves = tree_leaves_with_path(params)
    train = tree_leaves(opt.train_mask)
    decay = tree_leaves(opt.wd_mask)
    rows = [(path, p, d) for (path, p), t, d in zip(leaves, train, decay) if t]
    groups, sizes = [], []
    for key in sorted({_group_of(path) for path, _, _ in rows}):
        members, n = [], 0
        for i, (path, p, d) in enumerate(rows):
            if _group_of(path) != key:
                continue
            step = -(-state_part(opt, i, p).numel() // _ALIGN) * _ALIGN
            master = p.dtype != torch.float32
            members.append((i, d, (n, n + step, n + 2 * step if master else None)))
            n += (3 if master else 2) * step
        groups.append(members)
        sizes.append(n)
    return [(path, p) for path, p, _ in rows], groups, sizes


class StreamedOffloadOptimizer:
    """AdamW over the trainable leaves of ``params`` with its state in host
    memory (module docstring). ``state`` is an :class:`OptState` whose
    ``mu`` / ``nu`` / ``master`` trees are views into the host buffers."""

    def __init__(self, cfg: TrainConfig, vlm_cfg: VLMConfig, params: Params, total_steps: int,
                 device="cuda", zero: Optional[ZeroPlan] = None, tp: Optional[TensorPlan] = None):
        """``params`` as the rank holds them (under ZeRO-3 its parts);
        ``zero`` the split over the data ranks, ``tp`` over the model ranks."""
        self.device = torch.device(device)
        self.opt = Optimizer(cfg, params, total_steps, vlm_cfg.rwkv.n_layer, zero, tp)
        self._check_uniform_blocks()
        cuda = self.device.type == "cuda"

        rows, self.groups, sizes = group_layout(self.opt, params)
        self._host = [torch.zeros(n, dtype=torch.float32, pin_memory=cuda) for n in sizes]
        views: Dict[Tuple, Tuple[Tensor, Tensor, Optional[Tensor]]] = {}
        for buf, members in zip(self._host, self.groups):
            for i, _, offs in members:
                path, p = rows[i]
                part = state_part(self.opt, i, p)
                view = lambda o: buf[o:o + part.numel()].view(part.shape)
                mu, nu = view(offs[0]), view(offs[1])
                master = None
                if offs[2] is not None:
                    master = view(offs[2])
                    master.copy_(part.detach().float())
                views[path] = (mu, nu, master)
        pick = lambda k: tree_map_with_path(lambda path, _: views[path][k] if path in views else None,
                                            params)
        self.state = OptState(count=0, mu=pick(0), nu=pick(1), master=pick(2))

        stage = max(sizes, default=0)
        self._stage = [torch.empty(stage, dtype=torch.float32, device=self.device) for _ in range(2)]
        self._streams = (torch.cuda.Stream(self.device), torch.cuda.Stream(self.device)) if cuda else None
        self._events = {k: [torch.cuda.Event() for _ in range(2)] for k in ("loaded", "updated", "free")} \
            if cuda else None
        self.copy_timing = False  # when set, a step records its copies' device times
        self._timers: List[Tuple[str, Any, Any]] = []

    def _check_uniform_blocks(self):
        """Blocks 1..L-1 share one structure of trainable leaves, as the
        JAX package's shared block update needs (a partial layer freeze keeps
        the resident optimizer: the trainer does not build this one then)."""
        mask = self.opt.train_mask.get("rwkv", {}).get("blocks", [])
        first = tree_leaves(mask[1]) if len(mask) > 1 else None
        for m in mask[2:]:
            if tree_leaves(m) != first:
                raise ValueError("the offloaded optimizer needs uniform block masks "
                                 "(a partial layer freeze keeps the resident optimizer)")

    # -- sizes ----------------------------------------------------------------

    @property
    def pinned_bytes(self) -> int:
        """Bytes of the optimizer state in host memory: a step copies them
        to the device and back."""
        return sum(b.numel() * 4 for b in self._host)

    @property
    def stage_bytes(self) -> int:
        """Bytes of the two device slots."""
        return sum(b.numel() * 4 for b in self._stage)

    # -- the step ---------------------------------------------------------------

    def _copy(self, kind: str, stream, dst: Tensor, src: Tensor):
        if self.copy_timing and stream is not None:
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record(stream)
            dst.copy_(src, non_blocking=True)
            t1.record(stream)
            self._timers.append((kind, t0, t1))
        else:
            dst.copy_(src, non_blocking=stream is not None)

    def _copy_in(self, g: int, slot: int):
        n = self._host[g].numel()
        if self._streams is None:
            self._stage[slot][:n].copy_(self._host[g])
            return
        s_in = self._streams[0]
        with torch.cuda.stream(s_in):
            s_in.wait_event(self._events["free"][slot])  # the slot's last copy back is done
            self._copy("in", s_in, self._stage[slot][:n], self._host[g])
            self._events["loaded"][slot].record(s_in)

    def _copy_back(self, g: int, slot: int):
        n = self._host[g].numel()
        if self._streams is None:
            self._host[g].copy_(self._stage[slot][:n])
            return
        s_out = self._streams[1]
        self._events["updated"][slot].record(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(s_out):
            s_out.wait_event(self._events["updated"][slot])
            self._copy("out", s_out, self._host[g], self._stage[slot][:n])
            self._events["free"][slot].record(s_out)

    @torch.no_grad()
    def step(self, params: Params, grads: List[Tensor]) -> None:
        """One update of the trainable leaves of ``params`` (in place) from
        ``grads``, in :meth:`Optimizer.trainable_leaves` order."""
        opt = self.opt
        leaves = opt.trainable_leaves(params)
        if len(leaves) != len(grads):
            raise ValueError(f"{len(grads)} gradients for {len(leaves)} trainable leaves")
        hyper = opt.hyper(self.state.count, grads)
        self._timers = []
        live = [g for g, members in enumerate(self.groups) if members]
        if live:
            self._copy_in(live[0], 0)
        compute = torch.cuda.current_stream(self.device) if self._streams is not None else None
        for k, g in enumerate(live):
            slot = k % 2
            if k + 1 < len(live):
                self._copy_in(live[k + 1], 1 - slot)  # overlaps this group's update
            if compute is not None:
                compute.wait_event(self._events["loaded"][slot])
            stage = self._stage[slot]
            for i, decayed, (o_mu, o_nu, o_ms) in self.groups[g]:
                p = leaves[i]
                shape = state_part(opt, i, p).shape
                view = lambda o: stage[o:o + shape.numel()].view(shape)
                master = view(o_ms) if o_ms is not None else None
                opt.apply_leaf(i, p, grads[i], view(o_mu), view(o_nu), master, decayed, hyper)
            self._copy_back(g, slot)
        self.state.count += 1

    def copy_ms(self) -> Dict[str, float]:
        """The device time of the last step's copies in and back, ms (with
        ``copy_timing`` set before the step; waits for them)."""
        self.synchronize()
        out = {"in": 0.0, "out": 0.0}
        for kind, t0, t1 in self._timers:
            out[kind] += t0.elapsed_time(t1)
        return out

    def synchronize(self) -> None:
        """Wait until every copy has landed, so that the host buffers can be
        read or written."""
        if self._streams is not None:
            for s in self._streams:
                s.synchronize()

    # -- checkpoints ------------------------------------------------------------

    @property
    def opt_state(self) -> OptState:
        """The state, its host buffers settled (what a checkpoint saves)."""
        self.synchronize()
        return self.state

    @opt_state.setter
    def opt_state(self, saved: Dict[str, Any]) -> None:
        """Restore from :meth:`OptState.state_dict` (any device)."""
        self.synchronize()
        copy = lambda dst, src: dst if dst is None else dst.copy_(src)
        for name in ("mu", "nu", "master"):
            tree_map(copy, getattr(self.state, name), saved[name])
        self.state.count = int(saved["count"])

