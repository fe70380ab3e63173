"""Strategy strings for serving: device, compute dtype, int8 weights and the
decode state's carry. Counterpart of ``visualrwkv_tpu/infer/strategy.py``,
with its grammar, so that the reference's strings parse:

    "gpu bf16"           bf16 weights on the card
    "gpu bf16i8"         bf16 activations, int8 weights (weight-only)
    "gpu bf16 *int8"     the same as bf16i8 (the reference's modifier)
    "gpu bf16i8 s16"     + the WKV decode state carried in bf16
    "gpu bf16i8 flat"    + the flat [B, 64, H*64] decode state
    "cpu fp32"           the CPU, fp32

``cpu`` selects the CPU; ``gpu`` selects the card, and so does ``tpu``,
kept so that the JAX package's strings (``"tpu bf16i8 s16"``) parse and
serve here unchanged.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict

import torch

from visualrwkv_torch.infer.quant import quantize_lm_params

_STRATEGY_RE = re.compile(
    r"^\s*(?P<device>tpu|cpu|gpu)\s+"
    r"(?P<dtype>bf16|fp16|fp32)(?P<quant>i8)?"
    r"(?:\s+\*(?P<mod>int8|stream))?"
    r"(?:\s+s(?P<state>16|32))?"
    r"(?:\s+(?P<layout>flat))?\s*$"
)

_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}


@dataclass(frozen=True)
class Strategy:
    device: str = "gpu"  # "cpu", else the card ("gpu", or "tpu" as the JAX strings say)
    compute_dtype: Any = torch.bfloat16
    int8_weights: bool = False
    state_dtype: str = "float32"  # the WKV decode state's carry dtype
    state_layout: str = "head"  # "head" | "flat" decode state layout

    @property
    def dtype_name(self) -> str:
        return str(self.compute_dtype).removeprefix("torch.")

    @property
    def torch_device(self) -> str:
        return "cpu" if self.device == "cpu" else "cuda"


def parse_strategy(s: str) -> Strategy:
    m = _STRATEGY_RE.match(s)
    if not m:
        raise ValueError(f"bad strategy {s!r}; expected e.g. 'gpu bf16', 'gpu bf16i8 s16', 'cpu fp32'")
    return Strategy(
        device=m.group("device"),
        compute_dtype=_DTYPES[m.group("dtype")],
        int8_weights=bool(m.group("quant")) or m.group("mod") == "int8",
        state_dtype="bfloat16" if m.group("state") == "16" else "float32",
        state_layout="flat" if m.group("layout") else "head",
    )


def place(tree, device, float_dtype=None):
    """Every tensor of ``tree`` on ``device``; float tensors also in
    ``float_dtype`` when it is given (int8 weights keep their dtype)."""
    if isinstance(tree, dict):
        return {k: place(v, device, float_dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [place(v, device, float_dtype) for v in tree]
    if float_dtype is not None and tree.is_floating_point():
        return tree.to(device=device, dtype=float_dtype)
    return tree.to(device=device)


def apply_strategy(params: Dict[str, Any], strategy: Strategy) -> Dict[str, Any]:
    """The parameter tree on the strategy's device, quantized (every large
    2-D linear of the tree, towers and projector included, as the JAX
    package does) and with every float leaf, the int8 scales included, in
    the compute dtype."""
    params = place(params, strategy.torch_device)
    if strategy.int8_weights:
        params = quantize_lm_params(params)
    return place(params, strategy.torch_device, strategy.compute_dtype)


def make_engine(params, cfg, strategy):
    """An ``InferenceEngine`` from a strategy string or :class:`Strategy`:
    placement, int8 weights, dtype and the state's carry in one call."""
    from visualrwkv_torch.infer.engine import InferenceEngine

    s = parse_strategy(strategy) if isinstance(strategy, str) else strategy
    return InferenceEngine(apply_strategy(params, s), cfg, state_dtype=s.state_dtype,
                           state_layout=s.state_layout, device=s.torch_device)
