"""Configuration of the port: the fields of the JAX configuration tree that
the VisualRWKV-7 serving path reads, plus the token constants.

Options of the JAX configuration that select paths the port does not have
yet raise ``NotImplementedError`` when the configuration is built, so that a
configuration is never silently served by a different model.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Tuple

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
