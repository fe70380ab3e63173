"""Tensor parallelism over the ``model`` axis: the plan a trainer keeps and
the context the model code reads. Counterpart of the JAX package's
``tensor_parallel_sharding`` placement (``visualrwkv_tpu/parallel/mesh.py``)
and of the all-reduces GSPMD inserts for it.

A rank holds its part of every leaf the rule splits
(:func:`visualrwkv_torch.parallel.mesh.tensor_parallel_sharding`) and the
other leaves whole. The forward runs each RWKV block on this rank's heads
and its slice of the channel-mix hidden dim, the head on its slice of the
vocabulary and the projector on its slice of the input channels
(``models.rwkv7``, ``models.rwkv6``, ``multimodal.projector``,
``models.visualrwkv``), with the Megatron operators of
:mod:`visualrwkv_torch.parallel.collectives` at the region boundaries:
:func:`copy_to_model` where a replicated activation enters a block's
time-mix or channel-mix and :func:`reduce_from_model` after a product split
on its input dim.

Gradients then come in three kinds (:meth:`TensorPlan.kinds`):

- a split leaf's is its part's, whole on this rank;
- a replicated leaf used inside a split region (the token-shift mixes, the
  LoRA factors, the per-channel and per-head leaves the rank uses through
  its slice, ``ln_x``) holds only this rank's share: it is summed over the
  model ranks after the backward;
- every other leaf's (the embedding, the LayerNorms outside the regions,
  the projector's ``ln_v``, the towers) is already whole on every rank.

The model code learns of the model axis from :func:`model_axis`, a context
that the trainer (or a caller) holds over the forward and the backward; a
checkpointed block takes the group of its forward into its recompute.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

from visualrwkv_torch.parallel.collectives import group_rank, group_size
from visualrwkv_torch.parallel.mesh import tensor_parallel_sharding
from visualrwkv_torch.parallel.zero import SplitPlan

_GROUP = None

# the leaves of a block's channel-mix whose gradient is a rank's share when
# its ``key`` is split (they feed only the split product): x070's mix, the
# key mix of x060 and of x052 / x040 (their receptance branch runs whole on
# every rank)
_CMIX_PARTIAL = ("x_k", "time_maa_k", "time_mix_k")


def model_group():
    """The model axis of the running forward (None: one rank)."""
    return _GROUP


@contextlib.contextmanager
def model_axis(group):
    """Run the enclosed forward and backward with their blocks, head and
    projector split over the process group ``group`` (None: whole)."""
    global _GROUP
    prev = _GROUP
    _GROUP = group
    try:
        yield
    finally:
        _GROUP = prev


def local_slice(size: int, group) -> slice:
    """This rank's equal part of a dim of ``size`` along the model axis."""
    n, i = group_size(group), group_rank(group)
    return slice(i * size // n, (i + 1) * size // n)


def split_rows(linear: Any, whole: int, group) -> bool:
    """Whether the linear ``linear`` (``{"weight": [out, in]}``) holds this
    rank's part of ``whole`` output rows: under a model axis whose rule
    split it. Without a model axis its leaves are not read (an int8 linear
    has no ``weight``)."""
    return group_size(group) > 1 and linear["weight"].shape[0] != whole


@dataclasses.dataclass
class TensorPlan(SplitPlan):
    """How the leaves split over the model ranks (:class:`SplitPlan`, with
    ``axes`` from :func:`visualrwkv_torch.parallel.mesh.
    tensor_parallel_sharding`)."""

    @classmethod
    def make(cls, params, group) -> "TensorPlan":
        n = group_size(group)
        return cls(axes=tensor_parallel_sharding(params, n), n=n, index=group_rank(group), group=group)

    def kinds(self, params):
        """A tree over ``params`` (whole leaves) of each gradient's kind:
        ``"split"``, ``"partial"`` (a replicated leaf inside a split region:
        sum its gradient over the model ranks) or None (whole)."""
        from visualrwkv_torch.train.optim import tree_map_with_path

        def kind(path, leaf, ax):
            if ax is not None:
                return "split"
            if leaf is None or len(path) < 2:
                return None
            region = next((k for k in ("att", "ffn", "ffn_v") if k in path), None)
            if region is None:
                return None
            axes = _get(self.axes, path[:path.index(region) + 1])
            if region == "att":
                return "partial" if axes.get("receptance", {}).get("weight") is not None else None
            key_split = axes.get("key", {}).get("weight") is not None
            return "partial" if key_split and path[-1] in _CMIX_PARTIAL else None

        return tree_map_with_path(kind, params, self.axes)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree

