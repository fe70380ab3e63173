"""Configuration of the port: the fields of the JAX configuration tree that
the VisualRWKV-7 / -6 serving and training paths, their published variants
(v6.0 leftpad insertion and the bidirectional image span, HD / UHD tile
fusion, the v7.03 token compressor, v5.1 patch scanning) and the legacy
RWKV-5.2 / RWKV-4 serving paths read, plus the token constants.

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


VERSIONS = ("x070", "x060", "x052", "x040")
SCAN_STRATEGIES = ("unidirection", "bidirection", "multidirection", "rotation", "spiral", "snake",
                   "zigzag")


def _round_up(x: float, m: int) -> int:
    return int((int(x) + m - 1) // m * m)


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV language model configuration: RWKV-7 ("x070"), RWKV-6 ("x060"),
    RWKV-5.2 ("x052") or RWKV-4 ("x040")."""

    n_layer: int = 12
    n_embd: int = 768
    vocab_size: int = 65536
    version: str = "x070"
    head_size: int = 64
    head_size_divisor: int = 8
    ctx_len: int = 2048
    dim_att: int = 0  # 0 -> n_embd
    dim_ffn: int = 0  # 0 -> 4 * n_embd (x070, x040), 3.5 * n_embd rounded to 32 (x060, x052)
    chunk_len: int = 16  # WKV chunk length (T is left-padded to a multiple)
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.version not in VERSIONS:
            raise ValueError(f"unknown RWKV version {self.version!r}; expected one of {VERSIONS}")
        if self.dim_att == 0:
            object.__setattr__(self, "dim_att", self.n_embd)
        if self.dim_ffn == 0:
            four = self.version in ("x070", "x040")  # RWKV-4 World models ship 4x FFNs too
            ffn = self.n_embd * 4 if four else _round_up(self.n_embd * 3.5, 32)
            object.__setattr__(self, "dim_ffn", ffn)

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

    towers: Tuple[str, ...] = ("dino", "siglip", "sam")  # or ("clip",)
    image_size: int = 448
    sam_image_size: int = 1024
    dino_dim: int = 1024
    siglip_dim: int = 1152
    sam_dim: int = 1024
    clip_dim: int = 1024
    # tower name -> ViTConfig / SAMConfig replacing the default architecture
    tower_config_overrides: Any = None

    @property
    def embed_dim(self) -> int:
        dims = {"dino": self.dino_dim, "siglip": self.siglip_dim, "sam": self.sam_dim,
                "clip": self.clip_dim}
        return sum(dims[t] for t in self.towers)


@dataclass(frozen=True)
class VLMConfig:
    """VisualRWKV multimodal assembly configuration."""

    rwkv: RWKVConfig = field(default_factory=RWKVConfig)
    vision: VisionConfig = field(default_factory=VisionConfig)
    proj_type: str = "mlp"  # "linear" | "mlp" (gated MLP)
    num_token_per_image: int = 1024
    image_position: str = "first"  # "first" | "middle" | "last": where a prompt's images go (v6.0 sandwich)
    n_vtc_layer: int = 0  # visual token compressor depth (v7.03); 0 = none
    bidirectional_image: bool = False  # v6.0 / HD / UHD: odd blocks see the image span reversed
    image_scanning: str = "unidirection"  # v5.1 patch scan order (multimodal.scanning)
    grid_size: int = -2  # CLIP grid pooling (v5/v6.0); -2 = adaptive pooling instead
    uhd_fusion: bool = False  # UHD global + 2x2-tile fusion (doubles the projector's input)
    # "scatter": num_token_per_image image tokens a sample, the features
    # scattered in place (v7.00). "leftpad": one un-expanded image token a
    # sample, the text before it left-padded so that the batch's image spans
    # start together, the features inserted at embedding level (v6.0)
    insertion_mode: str = "scatter"

    def __post_init__(self):
        for t in self.vision.towers:
            if t not in ("dino", "siglip", "sam", "clip"):
                raise NotImplementedError(f"vision tower {t!r} is not ported yet")
        if self.image_position not in ("first", "middle", "last"):
            raise ValueError(f"image_position must be 'first', 'middle' or 'last'; got {self.image_position!r}")
        if self.insertion_mode not in ("scatter", "leftpad"):
            raise ValueError(f"insertion_mode must be 'scatter' or 'leftpad'; got {self.insertion_mode!r}")
        if self.image_scanning not in SCAN_STRATEGIES:
            raise ValueError(f"unknown image_scanning {self.image_scanning!r}; expected one of "
                             f"{SCAN_STRATEGIES}")

    @property
    def projector_in_dim(self) -> int:
        return self.vision.embed_dim * (2 if self.uhd_fusion else 1)

    def replace(self, **kw) -> "VLMConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Trainer configuration: every field of the JAX package's ``TrainConfig``.

    ``split_step``, ``opt_partition_mb`` and ``stacked_layers`` are accepted
    and ignored: they shape how XLA compiles and places the step on a TPU
    (two programs instead of one, optimizer leaf groups, a scan over depth)
    and do not change the result. ``offload_optimizer`` keeps the fp32
    masters and moments in pinned host memory (:mod:`visualrwkv_torch.train.
    offload`); with ``optim_precision="bf16_sr"`` it raises, as the JAX
    trainer does."""

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
    # False | True (per-block activation checkpointing) | "dots" | "wkv"
    # (selective policies of the checkpoint: models/rwkv7.py::_remat_context)
    grad_cp: Any = True
    ce_chunk_t: int = 128  # T-chunk of the chunked head + cross-entropy
    freeze_rwkv_layers: int = 0
    freeze_emb: bool = False
    freeze_proj: bool = False
    enable_state_tuning: bool = False
    zero_stage: int = 1  # under a mesh, 1: optimizer state split over the data ranks, 3: parameters too
    offload_optimizer: bool = False  # masters and moments in pinned host memory, streamed a group at a time
    param_dtype: str = "float32"  # "bfloat16" / "float16": parameters and gradients stored so
    # "master_fp32": fp32 master weights and Adam moments for parameters stored
    # below fp32; "bf16_sr": no masters, bf16 moments, stochastic rounding
    optim_precision: str = "master_fp32"
    stacked_layers: bool = False
    split_step: Optional[bool] = None
    opt_partition_mb: int = 64
    wandb_project: str = ""

    def __post_init__(self):
        # zero_stage takes effect under a mesh (train/trainer.py); on one
        # device every stage keeps the whole state. The reference reads
        # enable_state_tuning nowhere: it is accepted and ignored, as
        # split_step is
        if self.offload_optimizer and self.optim_precision == "bf16_sr":
            raise NotImplementedError(
                "offload_optimizer keeps fp32 masters in host memory; optim_precision='bf16_sr' "
                "keeps a lean state on the device instead: pick one")
        if self.grad_cp not in (False, True, "dots", "wkv"):
            raise ValueError(f"grad_cp must be False, True, 'dots' or 'wkv'; got {self.grad_cp!r}")
        if self.optim_precision not in ("master_fp32", "bf16_sr"):
            raise ValueError(f"unknown optim_precision {self.optim_precision!r}")
        if self.param_dtype not in ("float32", "bfloat16", "float16"):
            raise ValueError(f"param_dtype must be float32, bfloat16 or float16; got {self.param_dtype!r}")


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
