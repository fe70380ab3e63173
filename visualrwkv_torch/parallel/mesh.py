"""The ``(data, seq, model)`` device mesh, the per-process batch and the
ZeRO sharding rule. Counterpart of ``visualrwkv_tpu/parallel/mesh.py``.

One process drives one device, so where the JAX package places a global
array on a mesh (``shard_batch``), a process here takes its own part of
the batch (:func:`local_batch`): the rows of its ``data`` index and, under
context parallelism, the token range of its ``seq`` index. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over every process of the
group, or None for one process without a group: the helpers below read
both (sizes 1, index 0, no group).

Tensor parallelism over ``model`` (``tensor_parallel_sharding``) is not
ported: :func:`make_mesh` refuses ``n_model > 1``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "seq", "model")
ZERO_MIN_SIZE = 2**16


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_seq: int = 1):
    """A ``DeviceMesh`` of shape ``(n_data, n_seq, n_model)`` named
    ``("data", "seq", "model")`` over the process group (rank r at data
    index ``r // (n_seq * n_model)``, seq index ``(r // n_model) % n_seq``),
    or None, the one-process mesh, when no group is initialised.
    ``n_data`` defaults to the world size over ``n_seq * n_model``; the
    product must be the world size."""
    if n_model > 1:
        raise NotImplementedError("tensor parallelism over a `model` axis is not ported yet "
                                  "(ROADMAP item A.17b)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // (n_model * n_seq)
    if n_data * n_seq * n_model != world:
        raise ValueError(f"mesh data={n_data} x seq={n_seq} x model={n_model} does not cover "
                         f"the {world} processes of the group")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_seq, n_model), mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_index(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of ``axis`` (this process and the others that
    differ from it only there), None for the one-process mesh."""
    return None if mesh is None else mesh.get_group(axis)


def take_part(x, axis: int, n: int, i: int):
    """Part ``i`` of ``n`` equal parts of ``x`` along ``axis`` (numpy or torch)."""
    size = x.shape[axis]
    if size % n:
        raise ValueError(f"dim {axis} of {tuple(x.shape)} does not split into {n} parts")
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(i * size // n, (i + 1) * size // n)
    return x[tuple(sl)]


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return None if batch is None else fn(batch)


def data_rows(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This process's rows of a global batch: the leading dim of every array
    (``input_ids``, ``labels``, each tower's images) split over ``data``."""
    n, i = axis_size(mesh, "data"), axis_index(mesh, "data")
    if n == 1:
        return batch
    return _map(lambda x: take_part(x, 0, n, i), batch)


def seq_range(x, mesh):
    """This process's token range of a ``[B, T, ...]`` array under ``seq``."""
    n = axis_size(mesh, "seq")
    return x if n == 1 else take_part(x, 1, n, axis_index(mesh, "seq"))


def local_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The one-process-per-device counterpart of ``shard_batch``: the rows of
    this process's ``data`` index and, under ``seq > 1``, the T range of its
    ``seq`` index of every 2-D ``[B, T]`` array (the images keep their rows
    whole)."""
    rows = data_rows(batch, mesh)
    if axis_size(mesh, "seq") == 1:
        return rows
    return {k: (seq_range(v, mesh) if getattr(v, "ndim", 0) == 2 else v) for k, v in rows.items()}


def shardable_axis(shape: Sequence[int], n: int) -> Optional[int]:
    """The ZeRO rule of the JAX package's ``_shardable_axis``: a leaf of at
    least ``ZERO_MIN_SIZE`` elements splits over ``n`` ranks along its first dim
    that ``n`` divides; None keeps it whole on every rank. The port's
    linears are ``[out, in]`` where JAX's are ``[in, out]``, so the chosen
    dim may differ, but the set of leaves that split is the same."""
    if int(np.prod(shape)) < ZERO_MIN_SIZE:
        return None
    for axis, dim in enumerate(shape):
        if dim % n == 0 and dim >= n:
            return axis
    return None


def zero_sharding(tree, n: int):
    """The split dim of every leaf of ``tree`` for ``n`` data ranks (None:
    replicated), as a tree of the same structure (None leaves stay None)."""
    if isinstance(tree, dict):
        return {k: zero_sharding(v, n) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [zero_sharding(v, n) for v in tree]
    if tree is None or not isinstance(tree, torch.Tensor):
        return None
    return shardable_axis(tuple(tree.shape), n)
