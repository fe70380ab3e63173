"""Configuration of the port: the fields of the JAX configuration tree that
the VisualRWKV-7 serving and training paths read, plus the token constants.

Options of the JAX configuration that select paths the port does not have
yet raise ``NotImplementedError`` when the configuration is built, so that a
configuration is never silently served by a different model.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import torch

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = 65535
STOP_TOKEN_INDEX = 261  # "\n\n" in the RWKV World vocabulary


def _round_up(x: float, m: int) -> int:
    return int((int(x) + m - 1) // m * m)


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV-7 ("x070") language model configuration."""

    n_layer: int = 12
    n_embd: int = 768
    vocab_size: int = 65536
    version: str = "x070"
    head_size: int = 64
    head_size_divisor: int = 8
    ctx_len: int = 2048
    dim_att: int = 0  # 0 -> n_embd
    dim_ffn: int = 0  # 0 -> 4 * n_embd
    chunk_len: int = 16  # WKV chunk length (T is left-padded to a multiple)
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.version != "x070":
            raise NotImplementedError(
                f"RWKV version {self.version!r} is not ported yet (x070 only)"
            )
        if self.dim_att == 0:
            object.__setattr__(self, "dim_att", self.n_embd)
        if self.dim_ffn == 0:
            object.__setattr__(self, "dim_ffn", self.n_embd * 4)

    @property
    def n_head(self) -> int:
        if self.dim_att % self.head_size:
            raise ValueError(f"dim_att {self.dim_att} % head_size {self.head_size}")
        return self.dim_att // self.head_size

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    # LoRA widths follow the reference's suggestion formulas
    @property
    def d_decay_lora(self) -> int:
        return max(32, _round_up(round(1.8 * self.n_embd**0.5), 32))

    @property
    def d_aaa_lora(self) -> int:
        return max(32, _round_up(round(1.8 * self.n_embd**0.5), 32))

    @property
    def d_mv_lora(self) -> int:
        return max(32, _round_up(round(1.3 * self.n_embd**0.5), 32))

    @property
    def d_gate_lora(self) -> int:
        return max(32, _round_up(round(0.6 * self.n_embd**0.8), 32))


@dataclass(frozen=True)
class VisionConfig:
    """Vision backbone ensemble configuration."""

    towers: Tuple[str, ...] = ("dino", "siglip", "sam")
    image_size: int = 448
    sam_image_size: int = 1024
    dino_dim: int = 1024
    siglip_dim: int = 1152
    sam_dim: int = 1024
    # tower name -> ViTConfig / SAMConfig replacing the default architecture
    tower_config_overrides: Any = None

    @property
    def embed_dim(self) -> int:
        dims = {"dino": self.dino_dim, "siglip": self.siglip_dim, "sam": self.sam_dim}
        return sum(dims[t] for t in self.towers)


@dataclass(frozen=True)
class VLMConfig:
    """VisualRWKV-7 multimodal assembly configuration."""

    rwkv: RWKVConfig = field(default_factory=RWKVConfig)
    vision: VisionConfig = field(default_factory=VisionConfig)
    proj_type: str = "mlp"  # "linear" | "mlp" (gated MLP)
    num_token_per_image: int = 1024
    n_vtc_layer: int = 0
    bidirectional_image: bool = False
    image_scanning: str = "unidirection"
    grid_size: int = -2
    uhd_fusion: bool = False

    def __post_init__(self):
        unported = {
            "uhd_fusion": self.uhd_fusion,
            "n_vtc_layer > 0": self.n_vtc_layer > 0,
            "grid_size != -2": self.grid_size != -2,
            "bidirectional_image": self.bidirectional_image,
            "image_scanning != 'unidirection'": self.image_scanning != "unidirection",
        }
        for name, on in unported.items():
            if on:
                raise NotImplementedError(f"{name} is not ported yet")
        for t in self.vision.towers:
            if t not in ("dino", "siglip", "sam"):
                raise NotImplementedError(f"vision tower {t!r} is not ported yet")

    @property
    def projector_in_dim(self) -> int:
        return self.vision.embed_dim

    def replace(self, **kw) -> "VLMConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Trainer configuration: every field of the JAX package's ``TrainConfig``.

    ``split_step``, ``opt_partition_mb`` and ``stacked_layers`` are accepted
    and ignored: they shape how XLA compiles and places the step on a TPU
    (two programs instead of one, optimizer leaf groups, a scan over depth)
    and do not change the result. Options of paths that are not ported raise
    ``NotImplementedError``."""

    lr_init: float = 6e-4
    lr_final: float = 1e-5
    warmup_steps: int = -1
    beta1: float = 0.9
    beta2: float = 0.99
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    weight_decay_final: float = -1.0
    grad_clip: float = 1.0
    micro_bsz: int = 2
    accumulate_grad_batches: int = 1
    epoch_steps: int = 1000
    epoch_count: int = 2
    epoch_begin: int = 0
    epoch_save: int = 1
    grad_cp: Any = True  # False | True (per-block activation checkpointing)
    ce_chunk_t: int = 128  # T-chunk of the chunked head + cross-entropy
    freeze_rwkv_layers: int = 0
    freeze_emb: bool = False
    freeze_proj: bool = False
    enable_state_tuning: bool = False
    zero_stage: int = 1  # optimizer-state sharding; one GPU holds it whole
    offload_optimizer: bool = False
    param_dtype: str = "float32"  # "bfloat16": bf16 parameters and gradients
    # "master_fp32": fp32 master weights and Adam moments for parameters stored
    # below fp32; "bf16_sr": no masters, bf16 moments, stochastic rounding
    optim_precision: str = "master_fp32"
    stacked_layers: bool = False
    split_step: Optional[bool] = None
    opt_partition_mb: int = 64
    wandb_project: str = ""

    def __post_init__(self):
        unported = {
            "offload_optimizer": self.offload_optimizer,
            "zero_stage >= 3": self.zero_stage >= 3,
            "enable_state_tuning": self.enable_state_tuning,
            f"grad_cp={self.grad_cp!r}": self.grad_cp not in (False, True),
        }
        for name, on in unported.items():
            if on:
                raise NotImplementedError(f"{name} is not ported yet")
        if self.optim_precision not in ("master_fp32", "bf16_sr"):
            raise ValueError(f"unknown optim_precision {self.optim_precision!r}")
        if self.param_dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(f"param_dtype {self.param_dtype!r} is not ported (float32, bfloat16)")


def resolve_device(device) -> torch.device:
    """The device a public entry point runs on. CUDA unless the caller asks
    for the CPU; raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return device
