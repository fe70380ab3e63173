"""Sequence (context) parallelism for the WKV recurrence. Counterpart of
``visualrwkv_tpu/ops/wkv_sp.py``.

The token axis is split over the ranks of a ``seq`` process group. The
recurrence's state transition over a shard is linear in the entering
state: for WKV7 ``S_out = S_in @ R + C`` (rows of the state evolve apart),
for WKV6 the same with a diagonal decay. So each rank

1. runs its tokens once from ``S_in = 0``: the constant ``C``;
2. runs them once from ``S_in = I``: ``R + C``, so ``R = RC - C``;
3. relaxes the entry states around the ring: ``D - 1`` sweeps of one
   ``[N, N] @ [N, N]`` composition and a :func:`ppermute` to the next rank
   carry the true entry state one shard a sweep;
4. runs its tokens again from the true entry state, for its outputs.

The three local runs go through the ordinary dispatchers
(:func:`visualrwkv_torch.ops.wkv7.wkv7`, :func:`visualrwkv_torch.ops.wkv6.wkv6`):
on CUDA kernels K5 + K6 (x070) and K8 + K9 (x060). Gradients flow through
the ring by autograd: through the initial-state gradient of the fourth run
and the final-state cotangents of the first two. Shard boundaries must fall
on chunk boundaries.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from visualrwkv_torch.parallel.collectives import all_reduce_replicated, group_rank, group_size, ppermute

Tensor = torch.Tensor


def _ring_entry_states(call: Callable, z0: Tensor, size: int, is_first: Tensor,
                       shift: Callable[[Tensor], Tensor]) -> Tensor:
    """The true entry state of each shard. ``call(S_in) -> (y, S_out)`` runs
    the local tokens from ``S_in`` (fp32 ``[B, H, N, N]``); ``z0`` is the
    first shard's entry state (fp32, the shape of ``S_in``), ``is_first`` a
    bool tensor that broadcasts against it and marks the first shard's
    states, ``size`` the number of shards and ``shift(S)`` every shard's
    ``S`` of the shard before it (cyclic). Over a seq group (:func:`_ring`)
    a rank holds one shard and ``shift`` is a :func:`ppermute`; several
    shards stacked along B on one device take a roll instead."""
    zero = torch.zeros_like(z0)
    eye = torch.eye(z0.shape[-1], dtype=z0.dtype, device=z0.device).expand_as(z0).contiguous()
    _, C = call(zero)
    _, RC = call(eye)
    R = RC - C
    S_in = torch.where(is_first, z0, zero)
    for _ in range(size - 1):
        # the first shard keeps the shifted state in the graph for the backward's exchange
        S_in = torch.where(is_first, z0, shift(torch.matmul(S_in, R) + C))
    return S_in


def _ring(call: Callable, r: Tensor, initial_state: Optional[Tensor], group) -> Tuple[Tensor, Tensor]:
    """This rank's run of the ring over ``group``: its y slice and the whole
    sequence's final state."""
    B, _, H, N = r.shape
    f32 = torch.float32
    z0 = torch.zeros(B, H, N, N, dtype=f32, device=r.device) if initial_state is None \
        else initial_state.to(f32)
    is_first = z0.new_full((), group_rank(group) == 0, dtype=torch.bool)  # a fill: no host wait
    S_in = _ring_entry_states(call, z0, group_size(group), is_first, lambda S: ppermute(S, group, 1))
    y, S_exit = call(S_in)
    return y, _final_state(S_exit, group)


def _final_state(S_exit: Tensor, group) -> Tensor:
    """The whole sequence's final state lives on the last rank: replicate it
    (a masked sum whose backward is the identity)."""
    is_last = S_exit.new_full((), group_rank(group) == group_size(group) - 1, dtype=torch.bool)
    return all_reduce_replicated(torch.where(is_last, S_exit, 0.0), group)


def wkv7_seq_shard(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, a: Tensor, b: Tensor,
                   initial_state: Optional[Tensor] = None, chunk: int = 16,
                   group=None) -> Tuple[Tensor, Tensor]:
    """This rank's WKV7 under the token split over ``group``: its y slice
    and the whole sequence's final state (on every rank). The contract of
    :func:`visualrwkv_torch.ops.wkv7.wkv7` on the whole sequence."""
    from visualrwkv_torch.ops.wkv7 import wkv7, wkv_seq_axis

    def call(S_in):
        with wkv_seq_axis(None):  # this is the local run
            return wkv7(r, w_raw, k, v, a, b, initial_state=S_in, chunk=chunk)

    return _ring(call, r, initial_state, group)


def wkv6_seq_shard(r: Tensor, w_raw: Tensor, k: Tensor, v: Tensor, u: Tensor,
                   initial_state: Optional[Tensor] = None, chunk: Optional[int] = None,
                   group=None) -> Tuple[Tensor, Tensor]:
    """The WKV6 counterpart of :func:`wkv7_seq_shard` (the diagonal decay
    takes the same identity-probe construction). ``chunk`` defaults to
    ``ops.wkv6.DEFAULT_CHUNK``, as the unsplit op's does; its decay floor
    is -80 / chunk in every local run."""
    from visualrwkv_torch.ops.wkv6 import DEFAULT_CHUNK, wkv6
    from visualrwkv_torch.ops.wkv7 import wkv_seq_axis

    chunk = DEFAULT_CHUNK if chunk is None else chunk

    def call(S_in):
        with wkv_seq_axis(None):
            return wkv6(r, w_raw, k, v, u, initial_state=S_in, chunk=chunk)

    return _ring(call, r, initial_state, group)
