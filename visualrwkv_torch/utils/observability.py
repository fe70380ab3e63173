"""Tracing, metrics and the training log. Counterpart of
``visualrwkv_tpu/utils/observability.py``.

The reference has wall-clock helpers, it/s logging and optional wandb
(src/trainer.py:55-109, src/utils.py:13-21); on the GPU this adds a
``torch.profiler`` trace (Chrome format) and the CUDA caching allocator's
counters.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from visualrwkv_torch.config import resolve_device

log = logging.getLogger(__name__)


@contextlib.contextmanager
def profile_trace(out_dir: str):
    """``torch.profiler`` over the block, CPU and (where present) CUDA
    activities; writes ``<out_dir>/trace_<time>_<pid>.json``, a Chrome
    trace (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    Path(out_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    name = f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(str(Path(out_dir) / name))


def device_memory(device="cuda") -> Dict[str, int]:
    """The CUDA caching allocator's counters whose names hold ``bytes``
    (``torch.cuda.memory_stats``). Raises where CUDA is asked for and
    absent; ``device="cpu"`` gives ``{}``."""
    device = resolve_device(device)
    if device.type != "cuda":
        return {}
    return {k: int(v) for k, v in torch.cuda.memory_stats(device).items() if "bytes" in k}


class ThroughputMeter:
    """it/s, tokens/s, Ksamples counters (reference trainer.py:84-93)."""

    def __init__(self):
        self.t_last = time.time_ns()
        self.total_samples = 0
        self.total_tokens = 0

    def step(self, batch_size: int, tokens: int) -> Dict[str, float]:
        now = time.time_ns()
        dt = max((now - self.t_last) / 1e9, 1e-9)
        self.t_last = now
        self.total_samples += batch_size
        self.total_tokens += tokens
        return {
            "it/s": 1.0 / dt,
            "sample/s": batch_size / dt,
            "token/s": tokens / dt,
            "Ksamples": self.total_samples / 1000.0,
        }


class TrainLogWriter:
    """Appends per-epoch lines to ``<proj_dir>/train_log.txt``
    (reference trainer.py:59-65,152-154) and optionally mirrors to wandb."""

    def __init__(self, proj_dir: str, run_config: Optional[dict] = None,
                 wandb_project: str = ""):
        Path(proj_dir).mkdir(parents=True, exist_ok=True)
        self.path = Path(proj_dir) / "train_log.txt"
        with open(self.path, "a") as f:
            f.write(f"NEW RUN {time.strftime('%Y-%m-%d %H:%M:%S')}\n")
            if run_config:
                f.write(json.dumps(run_config, default=str) + "\n")
        self.wandb = None
        if wandb_project:
            try:
                import wandb

                self.wandb = wandb
                wandb.init(project=wandb_project, config=run_config)
            except ImportError:
                log.warning("wandb not installed; metrics go to train_log.txt only")

    def log_step(self, metrics: Dict[str, float]) -> None:
        if self.wandb is not None:
            self.wandb.log(metrics)

    def log_epoch(self, epoch: int, loss: float, lr: float) -> None:
        line = (
            f"{epoch} {loss:.6f} {math.exp(min(loss, 20)):.4f} {lr:.8f} "
            f"{time.strftime('%Y-%m-%d %H:%M:%S')}"
        )
        with open(self.path, "a") as f:
            f.write(line + "\n")
