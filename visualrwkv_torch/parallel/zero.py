"""The block hook of ZeRO-3 parameter sharding.

Under ``zero_stage >= 3`` a rank holds only its slice of every leaf that the
ZeRO rule splits. The trainer declares, around a step's forward and
backward, a function that gathers a block's slices into whole leaves; the
model families whose blocks call :func:`materialize` (x070 and x060, and
their context-parallel forwards) then gather each block's leaves just
before the block runs, and under activation checkpointing again when the
backward recomputes the block. Outside :func:`gathering` the hook is the
identity.

:class:`SplitPlan` is a split of the leaves over one mesh axis: ZeRO's
over ``data`` (:class:`ZeroPlan`), tensor parallelism's over ``model``
(:class:`visualrwkv_torch.parallel.tensor.TensorPlan`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Tuple

from visualrwkv_torch.parallel.collectives import all_gather_along
from visualrwkv_torch.parallel.mesh import take_part

_GATHER: Optional[Callable[[Any], Any]] = None


def materialize(block):
    """``block`` (a tree of parameters) with every sharded leaf gathered."""
    return block if _GATHER is None else _GATHER(block)


@contextlib.contextmanager
def gathering(fn: Optional[Callable[[Any], Any]]):
    """Run the enclosed forward and backward with ``fn`` as the block gather."""
    global _GATHER
    prev = _GATHER
    _GATHER = fn
    try:
        yield
    finally:
        _GATHER = prev


@dataclasses.dataclass
class SplitPlan:
    """How the leaves split over the ranks of one mesh axis: ``axes`` is a
    tree over the parameters of each leaf's split dim (None: whole on every
    rank), ``group`` the axis's ranks, ``n`` their count and ``index`` this
    rank's place."""

    axes: Any
    n: int
    index: int
    group: Any

    def part(self, t, axis: int):
        """This rank's part of the whole leaf ``t`` (a view)."""
        return take_part(t, axis, self.n, self.index)

    def gather(self, part, axis: int):
        """The whole leaf from every rank's ``part``."""
        return all_gather_along(part, axis, self.group)

    def whole_shape(self, part, axis: int) -> Tuple[int, ...]:
        shape = list(part.shape)
        shape[axis] *= self.n
        return tuple(shape)


@dataclasses.dataclass
class ZeroPlan(SplitPlan):
    """How the leaves split over the data ranks (:class:`SplitPlan`, with
    ``axes`` from :func:`visualrwkv_torch.parallel.mesh.zero_sharding`).
    ``stage`` 1 splits the optimizer state, 3 the parameters too."""

    stage: int = dataclasses.field(kw_only=True)
