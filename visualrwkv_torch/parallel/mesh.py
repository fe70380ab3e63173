"""The ``(data, seq, model)`` device mesh, the per-process batch, the ZeRO
sharding rule and the tensor-parallel rule. Counterpart of
``visualrwkv_tpu/parallel/mesh.py``.

One process drives one device, so where the JAX package places a global
array on a mesh (``shard_batch``), a process here takes its own part of
the batch (:func:`local_batch`): the rows of its ``data`` index and, under
context parallelism, the token range of its ``seq`` index. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over every process of the
group, or None for one process without a group: the helpers below read
both (sizes 1, index 0, no group).

Tensor parallelism over ``model`` (:func:`tensor_parallel_sharding`) splits
the RWKV blocks' head and hidden dims, the vocabulary and the projector's
input dim; :mod:`visualrwkv_torch.parallel.tensor` holds the split and the
model code runs on it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

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


def data_seq_group(mesh):
    """The process group of this process's ``model`` index: the ranks that
    differ from it along ``data`` and ``seq`` (all of them when ``model`` is
    1; None for the one-process mesh). Every rank makes every such group,
    in the same order, as ``torch.distributed.new_group`` requires."""
    if mesh is None:
        return None
    n_model = axis_size(mesh, "model")
    if n_model == 1:
        return dist.group.WORLD
    world = dist.get_world_size()
    groups = [dist.new_group([r for r in range(world) if r % n_model == m]) for m in range(n_model)]
    return groups[dist.get_rank() % n_model]


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


def tensor_parallel_axis(path: Sequence[Any], shape: Sequence[int], n: int) -> Optional[int]:
    """The ``model`` split dim of the leaf at ``path`` (its keys) in the
    port's layout, or None (replicated): the rule of the JAX package's
    ``tensor_parallel_sharding``, over 2-D leaves only.

    - a block's time-mix ``receptance`` / ``key`` / ``value`` / ``gate``
      split on their output (head) dim, its ``output`` on its input dim;
    - the channel-mix (``ffn``, ``ffn_v``) ``key`` on its output dim,
      ``value`` on its input dim;
    - the vocabulary ``head`` on the vocabulary;
    - the projector's ``gate`` and ``o_proj`` on their input dim;
    - a dim that ``n`` does not divide keeps its leaf replicated.

    JAX's linears are ``[in, out]``, the port's ``[out, in]``: JAX's
    ``P(None, "model")`` (output) is dim 0 here, ``P("model", None)``
    (input) dim 1."""
    keys = [str(k) for k in path]
    if len(shape) != 2 or n == 1:
        return None
    tail = keys[-2] if len(keys) >= 2 else ""
    out_dim, in_dim = shape  # [out, in]
    if tail == "head" and out_dim % n == 0:
        return 0
    if "att" in keys:
        if tail in ("receptance", "key", "value", "gate") and out_dim % n == 0:
            return 0
        if tail == "output" and in_dim % n == 0:
            return 1
    if "ffn" in keys or "ffn_v" in keys:
        if tail == "key" and out_dim % n == 0:
            return 0
        if tail == "value" and in_dim % n == 0:
            return 1
    if tail in ("o_proj", "gate") and keys[0] == "proj" and in_dim % n == 0:
        return 1
    return None


def tensor_parallel_sharding(tree, n: int, path: Tuple[Any, ...] = ()):
    """The ``model`` split dim of every leaf of ``tree`` for ``n`` model
    ranks (:func:`tensor_parallel_axis`; None: replicated), as a tree of the
    same structure."""
    if isinstance(tree, dict):
        return {k: tensor_parallel_sharding(v, n, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tensor_parallel_sharding(v, n, path + (i,)) for i, v in enumerate(tree)]
    if tree is None or not hasattr(tree, "shape"):
        return None
    return tensor_parallel_axis(path, tuple(tree.shape), n)
