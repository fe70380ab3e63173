"""Multi-process start-up. Counterpart of ``visualrwkv_tpu/parallel/distributed.py``.

The reference trains multi-node with one NCCL rank per GPU and data
parallelism (``--num_nodes``, reference train.py:75,98). Here every process
drives one device and joins one ``torch.distributed`` process group: NCCL
on CUDA devices, gloo only where the caller asks for the CPU. There is no
fallback from NCCL to gloo: if NCCL fails, the run fails.

The address, the process count and this process's id come from the
arguments, else from ``VRWKV_COORDINATOR_ADDRESS`` / ``VRWKV_NUM_PROCESSES``
/ ``VRWKV_PROCESS_ID`` (the JAX package's variables), else from torchrun's
``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``. ``LOCAL_RANK``
picks the CUDA device (else the process id modulo the visible devices).
One process with no address is the no-op: :func:`initialize` returns False
and every helper here answers for one process.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

ENV_COORDINATOR = "VRWKV_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "VRWKV_NUM_PROCESSES"
ENV_PROCESS_ID = "VRWKV_PROCESS_ID"


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def _env_address() -> Optional[str]:
    if os.environ.get(ENV_COORDINATOR):
        return os.environ[ENV_COORDINATOR]
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def _cuda_index(process_id: int) -> int:
    """The CUDA device of process ``process_id`` on its host: ``LOCAL_RANK``,
    else the process id modulo the visible devices."""
    lr = _env_int("LOCAL_RANK")
    return lr if lr is not None else process_id % torch.cuda.device_count()


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               init_method: Optional[str] = None, timeout_s: float = 600.0) -> bool:
    """Join this process into the run's process group. Returns True when a
    group was initialised (or already was), False for the one-process no-op.

    ``device``: a CUDA device gives the ``nccl`` backend and
    ``torch.cuda.set_device`` first (the index given, else ``LOCAL_RANK``,
    else the process id modulo the visible devices); ``"cpu"`` gives
    ``gloo``.
    ``init_method`` replaces the ``tcp://<address>`` rendezvous (the CPU
    tests give ``file://...``, so that concurrent runs never race for a
    port)."""
    if dist.is_initialized():
        return True
    address = coordinator_address or _env_address()
    if num_processes is None:
        num_processes = _env_int(ENV_NUM_PROCESSES, "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int(ENV_PROCESS_ID, "RANK")
    if init_method is None and address is None:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes need a coordinator address "
                             f"({ENV_COORDINATOR} or MASTER_ADDR / MASTER_PORT)")
        return False
    num_processes = 1 if num_processes is None else num_processes
    process_id = 0 if process_id is None else process_id
    device = torch.device(device)
    kw = {}
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' for a gloo group on the CPU")
        backend = "nccl"
        cuda = torch.device("cuda", _cuda_index(process_id) if device.index is None else device.index)
        torch.cuda.set_device(cuda)
        kw["device_id"] = cuda
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device}")
    dist.init_process_group(backend, init_method=init_method or f"tcp://{address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s), **kw)
    log.info("process group: rank %d of %d, backend %s", process_id, num_processes, backend)
    return True


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def device_for(device="cuda") -> torch.device:
    """The device this process drives: for CUDA the device :func:`initialize`
    set (``torch.cuda.current_device()``, ``cuda:0`` without a group), else
    ``device`` as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def local_batch_size(global_batch_size: int) -> int:
    """This process's share of the global batch (reference real_bsz = nodes
    * devices * micro_bsz, train.py:98)."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by process count {n}")
    return global_batch_size // n
