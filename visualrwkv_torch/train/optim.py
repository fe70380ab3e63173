"""The optimizer of the trainer, as functions over the parameter tree.

Counterpart of ``visualrwkv_tpu/train/optim.py`` (an optax chain there).
AdamW with the reference's two-group policy (weight decay only on
parameters whose squeezed shape has two or more dims), global-norm clipping
in fp32 with a skip of non-finite steps, scheduled learning rate and weight
decay, and freezing masks. One step does, in the order of the optax chain:

    clip (norm over the trainable leaves only)
    -> Adam moments with bias correction, update m_hat / (sqrt(v_hat) + eps)
    -> + weight_decay * p on the decayed leaves
    -> * -lr
    -> applied to the fp32 master (``master_fp32``: kept for every trainable
       leaf stored below fp32, the stored leaf is the master cast down) or to
       the bf16 leaf itself with stochastic rounding (``bf16_sr``: no masters,
       bf16 moments).

Frozen leaves are never touched. Parameters are updated in place, under
``torch.no_grad()``; the step needs no kernel of its own (elementwise
PyTorch ops). The JAX package's ``PartitionedOptimizer`` regroups the same
math to fit a TPU's memory and has no counterpart here; its host-offloaded
optimizer is :mod:`visualrwkv_torch.train.offload`, which runs
:meth:`Optimizer.update_leaf` on state streamed from host memory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from visualrwkv_torch.config import TrainConfig
from visualrwkv_torch.train.schedule import cosine_warmup_lr, wd_schedule

Tensor = torch.Tensor
Params = Any
Path = Tuple[Any, ...]


# ---------------------------------------------------------------------------
# Trees of tensors (nested dicts and lists)
# ---------------------------------------------------------------------------


def tree_leaves_with_path(tree, path: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in tree_leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map_with_path(fn: Callable, tree, *rest, path: Path = ()):
    """``fn(path, leaf, *other_leaves)`` over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, *(r[i] for r in rest), path=path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree, *rest):
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------


def weight_decay_mask(params: Params) -> Params:
    """True where the squeezed parameter has >= 2 dims (gets weight decay)."""
    return tree_map(lambda p: len([d for d in p.shape if d > 1]) >= 2, params)


def trainable_mask(params: Params, cfg: TrainConfig, n_layer: int) -> Params:
    """Boolean tree, False = frozen: the vision towers always, the projector,
    the embedding and the first N LM layers on request."""

    def decide(path: Path, _) -> bool:
        if path and path[0] == "vit":
            return False
        if path and path[0] == "proj" and cfg.freeze_proj:
            return False
        if "emb" in path and cfg.freeze_emb:
            return False
        if path and path[0] == "rwkv":
            if "blocks" in path:
                layer = path[path.index("blocks") + 1]
                if isinstance(layer, int) and layer < cfg.freeze_rwkv_layers:
                    return False
            if cfg.freeze_rwkv_layers >= n_layer:
                return False
        return True

    return tree_map_with_path(decide, params)


# ---------------------------------------------------------------------------
# Pieces of the step
# ---------------------------------------------------------------------------


def global_norm_scale(grads: List[Tensor], max_norm: float) -> Tuple[Tensor, Tensor]:
    """(scale, finite) of the global-norm clip: ``scale = min(1, max_norm /
    norm)`` with the norm accumulated in fp32 (the sum of squares of bf16
    gradients overflows at scale), and whether the norm is finite."""
    sq = sum(torch.sum(g.float() ** 2) for g in grads)
    gnorm = torch.sqrt(sq)
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0), torch.isfinite(gnorm)


def _clipped(g: Tensor, scale: Tensor, finite: Tensor) -> Tensor:
    """One clipped gradient, in its own dtype. A non-finite norm (inf or nan
    anywhere) zeroes it instead of feeding nan to the moments; where(), not
    a product: inf * 0 = nan."""
    return torch.where(finite, g.float() * scale, 0.0).to(g.dtype)


def clip_by_global_norm_f32(grads: List[Tensor], max_norm: float) -> List[Tensor]:
    """Scale ``grads`` so that their global norm is at most ``max_norm``
    (:func:`global_norm_scale`); a non-finite norm zeroes every gradient."""
    scale, finite = global_norm_scale(grads, max_norm)
    return [_clipped(g, scale, finite) for g in grads]


def sr_round_bf16(x32: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
    """Round fp32 to bf16 stochastically: add uniform random bits below the
    bf16 truncation point, then truncate. Unbiased, E[sr(x)] = x. Non-finite
    inputs pass through."""
    x32 = x32.float()
    bits = x32.view(torch.int32)
    rnd = torch.randint(0, 1 << 16, x32.shape, dtype=torch.int32, device=x32.device,
                        generator=generator)
    out = ((bits + rnd) & -65536).view(torch.float32).to(torch.bfloat16)  # -65536 = 0xFFFF0000
    return torch.where(torch.isfinite(x32), out, x32.to(torch.bfloat16))


def sr_generator(step: int, device) -> torch.Generator:
    """The random stream of one step's stochastic rounding, a function of the
    step alone so that a resumed run rounds as the original would have."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0x5A0000 + int(step))
    return gen


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OptState:
    """Optimizer state. ``mu``, ``nu`` and ``master`` are trees shaped like
    the parameters with None at frozen leaves (and, for ``master``, at
    trainable fp32 leaves, which are their own masters). ``count`` is the
    number of steps taken: it drives the schedules and the bias correction."""

    count: int
    mu: Params
    nu: Params
    master: Params

    def state_dict(self) -> Dict[str, Any]:
        """The state as a plain dict (the same tensors, not copies)."""
        return {"count": self.count, "mu": self.mu, "nu": self.nu, "master": self.master}


class Optimizer:
    """AdamW over the trainable leaves of a parameter tree (module docstring)."""

    def __init__(self, cfg: TrainConfig, params: Params, total_steps: int, n_layer: int):
        self.cfg = cfg
        self.total_steps = total_steps
        self.lean = cfg.optim_precision == "bf16_sr"
        self.train_mask = trainable_mask(params, cfg, n_layer)
        self.wd_mask = weight_decay_mask(params)

    def lr(self, count: int) -> float:
        c = self.cfg
        return cosine_warmup_lr(count, c.lr_init, c.lr_final, c.warmup_steps, self.total_steps)

    def weight_decay(self, count: int) -> float:
        c = self.cfg
        return wd_schedule(count, c.weight_decay, c.weight_decay_final, c.warmup_steps,
                           self.total_steps)

    def init(self, params: Params) -> OptState:
        mdt = torch.bfloat16 if self.lean else torch.float32
        moment = lambda t, p: torch.zeros_like(p, dtype=mdt) if t else None
        needs_master = lambda t, p: t and not self.lean and p.dtype != torch.float32
        return OptState(
            count=0,
            mu=tree_map(moment, self.train_mask, params),
            nu=tree_map(moment, self.train_mask, params),
            master=tree_map(lambda t, p: p.detach().float() if needs_master(t, p) else None,
                            self.train_mask, params),
        )

    def trainable_leaves(self, params: Params) -> List[Tensor]:
        return [p for p, t in zip(tree_leaves(params), tree_leaves(self.train_mask)) if t]

    def hyper(self, count: int, grads: List[Tensor]):
        """What one step at ``count`` shares across its leaves: the clip
        ``(scale, finite)`` over all of ``grads`` (None without clipping),
        the learning rate, the weight decay and the bias corrections."""
        cfg = self.cfg
        clip = global_norm_scale(grads, cfg.grad_clip) if cfg.grad_clip > 0 else None
        c1, c2 = 1.0 - cfg.beta1**(count + 1), 1.0 - cfg.beta2**(count + 1)
        return clip, self.lr(count), self.weight_decay(count), c1, c2

    def update_leaf(self, p: Tensor, g: Tensor, mu: Tensor, nu: Tensor, master: Optional[Tensor],
                    decayed: bool, hyper, gen: Optional[torch.Generator] = None) -> None:
        """One leaf's update, in place on ``p``, ``mu``, ``nu`` and
        ``master``; ``hyper`` from :meth:`hyper`. The clip is applied here,
        leaf by leaf, so that no fp32 copy of the whole gradient tree is
        alive at once."""
        cfg = self.cfg
        clip, lr, wd_now, c1, c2 = hyper
        if not self.lean:
            g = g.float()  # master_fp32: the clip and the moments see fp32 gradients
        g32 = (_clipped(g, *clip) if clip is not None else g).float()
        mu32 = mu.float().mul_(cfg.beta1).add_(g32, alpha=1.0 - cfg.beta1)
        nu32 = nu.float().mul_(cfg.beta2).addcmul_(g32, g32, value=1.0 - cfg.beta2)
        mu.copy_(mu32)
        nu.copy_(nu32)
        u = (mu32 / c1) / (torch.sqrt(nu32 / c2) + cfg.adam_eps)
        target = master if master is not None else p
        if decayed and wd_now != 0.0:
            u.add_(target.float(), alpha=wd_now)
        u.mul_(-lr)
        if master is not None:
            master.add_(u)
            p.copy_(master)
        elif self.lean and p.dtype == torch.bfloat16:
            p.copy_(sr_round_bf16(p.float() + u, gen))
        else:
            p.add_(u.to(p.dtype))

    @torch.no_grad()
    def step(self, params: Params, grads: List[Tensor], state: OptState, step: int) -> None:
        """One update, in place on ``params`` and ``state``. ``grads`` are the
        gradients of :meth:`trainable_leaves`, in that order; ``step`` seeds
        the stochastic rounding of ``bf16_sr``."""
        rows = [
            (p, mu, nu, ms, wd)
            for p, t, mu, nu, ms, wd in zip(*(tree_leaves(x) for x in (
                params, self.train_mask, state.mu, state.nu, state.master, self.wd_mask)))
            if t
        ]
        if len(rows) != len(grads):
            raise ValueError(f"{len(grads)} gradients for {len(rows)} trainable leaves")
        hyper = self.hyper(state.count, grads)
        gen = sr_generator(step, rows[0][0].device) if self.lean and rows else None
        for (p, mu, nu, master, decayed), g in zip(rows, grads):
            self.update_leaf(p, g, mu, nu, master, decayed, hyper, gen)
        state.count += 1


def make_optimizer(cfg: TrainConfig, params: Params, total_steps: int, n_layer: int) -> Optimizer:
    return Optimizer(cfg, params, total_steps, n_layer)
