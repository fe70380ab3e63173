"""Reference RWKV / VisualRWKV ``.pth`` state dicts <-> the port's parameter
trees. Counterpart of ``visualrwkv_tpu/convert/pth_import.py``.

The reference checkpoints (VisualRWKV-v7/v7.00/src/model.py:76-325,
train.py:182-191) hold ``nn.Linear`` weights as ``[out, in]``, which is the
port's own layout, so no linear is transposed here (the JAX importer
transposes them to its ``[in, out]``). Layout rules:

- linears (``receptance``, ``key``, ``value``, ``output``, ``gate``,
  ``head``, the projector's ``gate`` / ``o_proj``) stay ``[out, in]``;
- LoRA factors (``w1``, ``w2``, ``a1``, ``a2``, ``v1``, ``v2``, ``g1``,
  ``g2``) stay ``[in, out]``, as the reference stores them;
- ``(1, 1, C)`` mixing vectors become ``(C,)``;
- ``att.r_k`` stays ``(H, N)``; ``ln_x`` and the norms stay ``(C,)``.

Leaves are fp32 tensors, on the device of the state dict's tensors (numpy
arrays become CPU tensors).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

Params = Dict[str, Any]

# (1, 1, C) vectors of the reference, (C,) in the port (export reshapes them back)
_MIX_VECTORS = {
    "x_r", "x_w", "x_k", "x_v", "x_a", "x_g", "w0", "a0", "v0", "k_k", "k_a",
    "time_maa_x", "time_maa_w", "time_maa_k", "time_maa_v", "time_maa_r", "time_maa_g",
    "time_decay", "time_mix_k", "time_mix_v", "time_mix_r", "time_mix_g",
}
_LM_PREFIXES = ("emb.", "blocks.", "ln_out.", "head.")


def to_tensor(t) -> torch.Tensor:
    """A state-dict value as an fp32 tensor (a tensor keeps its device)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float()
    return torch.from_numpy(np.array(t, dtype=np.float32))


def _assign(tree: Params, path: list, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def import_rwkv_state_dict(state_dict: Mapping[str, Any]) -> Params:
    """A reference RWKV LM state dict -> the port's LM parameters
    ``{"emb", "blocks", "ln_out", "head"}``. Takes bare-LM checkpoints
    (``blocks.0...``) and VisualRWKV combined ones (``rwkv.`` prefix).
    Raises ``KeyError`` on a key it does not know and ``ValueError`` on a
    gap in the layers."""
    out: Params = {"blocks": {}}
    for key, tensor in state_dict.items():
        if key.startswith("rwkv."):
            key = key[len("rwkv."):]
        arr = to_tensor(tensor)
        parts = key.split(".")
        if parts[0] == "blocks":
            blk = out["blocks"].setdefault(int(parts[1]), {})
            sub = parts[2:]
            if arr.dim() == 3 and tuple(arr.shape[:2]) == (1, 1):
                arr = arr.reshape(-1)  # (1, 1, C) mixing / decay / k_k / k_a vectors
            _assign(blk, sub, arr)
        elif key == "emb.weight":
            out["emb"] = {"weight": arr}
        elif key == "head.weight":
            out["head"] = {"weight": arr}
        elif parts[0] == "ln_out" and len(parts) == 2:
            out.setdefault("ln_out", {})[parts[1]] = arr
        else:
            raise KeyError(f"unrecognized RWKV checkpoint key: {key}")
    layers = sorted(out["blocks"])
    if layers != list(range(len(layers))):
        raise ValueError(f"missing layers: {layers}")
    out["blocks"] = [out["blocks"][i] for i in layers]
    return out


def detect_rwkv_version(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """The RWKV generation and geometry from the state dict's keys: the
    reference engine's detector (app/modeling_rwkv.py:227-244: ln_x => v5,
    gate.weight => v5.1, 2-D time_decay => v5.2, time_maa => v6) with the v7
    signature (``att.r_k`` / ``att.w0``). Returns ``{"version": "x040" |
    "x052" | "x060" | "x070", "n_layer", "n_embd", "vocab_size",
    "head_size", "n_head"}``, as the JAX package does; raises on other
    generations and on a dict without LM keys. (The port builds x070 and x060
    models; ``RWKVConfig`` raises for the others.)"""
    keys = {}
    for k, v in state_dict.items():  # LM keys only: towers carry "blocks." too
        k = k[len("rwkv."):] if k.startswith("rwkv.") else k
        if k.startswith(_LM_PREFIXES):
            keys[k] = v

    def shape_of(t):
        return tuple(getattr(t, "shape", np.asarray(t).shape))

    version = 0.0
    for k, t in keys.items():
        if k.endswith("att.time_first") or k.endswith("att.time_decay"):
            version = max(4.0, version)
        if "ln_x" in k:
            version = max(5.0, version)
        if "gate.weight" in k:
            version = max(5.1, version)
        if k.endswith("att.time_decay") and len(shape_of(t)) > 1 and shape_of(t)[1] > 1:
            version = max(5.2, version)
        if "time_maa" in k:
            version = max(6.0, version)
        if k.endswith("att.r_k") or k.endswith("att.w0"):
            version = max(7.0, version)

    n_layer, n_head, head_size = 0, None, None
    for k, t in keys.items():
        if k.startswith("blocks."):
            n_layer = max(n_layer, int(k.split(".")[1]) + 1)
        if 5.0 <= version < 6.0 and k.endswith("att.time_decay"):
            shape = shape_of(t)
            n_head = shape[0]
            if len(shape) > 1 and shape[1] > 1:
                head_size = shape[1]
        if 6.0 <= version < 7.0 and k.endswith("att.time_faaaa"):
            n_head, head_size = shape_of(t)[:2]
        if version >= 7.0 and k.endswith("att.r_k"):
            n_head, head_size = shape_of(t)[:2]
    emb = keys.get("emb.weight")
    vocab_size, n_embd = shape_of(emb) if emb is not None else (None, None)
    name = {4.0: "x040", 5.2: "x052", 6.0: "x060", 7.0: "x070"}.get(version)
    if version == 0.0:
        raise ValueError(
            "no RWKV LM keys recognized in the state dict (expected emb./blocks./ln_out./head. "
            "entries with att.time_* signatures); is this a vision-only or non-RWKV checkpoint?"
        )
    if name is None:
        raise NotImplementedError(
            f"detected legacy RWKV v{version:.1f} checkpoint; supported generations are 4 (x040), "
            "5.2 (x052), 6 (x060) and 7 (x070)"
        )
    if version == 4.0:  # a per-channel recurrence: one head as wide as the model
        n_head, head_size = 1, n_embd
    if head_size is None and n_embd is not None and n_head:
        head_size = n_embd // n_head
    return {"version": name, "n_layer": n_layer, "n_embd": n_embd, "vocab_size": vocab_size,
            "head_size": head_size, "n_head": n_head}


def export_rwkv_state_dict(params: Params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Inverse of :func:`import_rwkv_state_dict`: the port's LM parameters ->
    a reference-layout state dict of fp32 tensors (on the parameters'
    device)."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            arr = node.detach().float()
            if path[-1] in _MIX_VECTORS and arr.dim() == 1:
                arr = arr.reshape(1, 1, -1)
            sd[prefix + ".".join(path)] = arr

    walk(params, [])
    return sd


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state dict as fp32 CPU tensors."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: to_tensor(v) for k, v in sd.items()}


def import_visualrwkv_checkpoint(sd_or_path, dst_grid: int = 32) -> Params:
    """A combined VisualRWKV checkpoint -> ``{"rwkv", "proj", "vit"}`` in the
    port's layouts. The reference saves the whole LightningModule state dict
    (keys ``rwkv.*``, ``proj.*``, ``vit.{dino,siglip,sam}_featurizer.*``; its
    export.py:14-27 splits on the same prefixes); the towers inside are timm
    and vendored-SAM layouts. ``dst_grid``: the patch grid of the serving
    resolution (448 / 14 = 32)."""
    from visualrwkv_torch.convert.vision_import import import_sam_vision, import_timm_vit

    sd = load_pth(sd_or_path) if isinstance(sd_or_path, str) else sd_or_path

    def strip(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    params: Params = {"rwkv": import_rwkv_state_dict(strip("rwkv."))}
    proj_sd = strip("proj.")
    if "weight" in proj_sd and len(proj_sd) == 1:  # linear projector
        params["proj"] = {"weight": to_tensor(proj_sd["weight"])}
    elif proj_sd:  # MLPWithContextGating (model.py:328-338)
        params["proj"] = {
            "gate": {"weight": to_tensor(proj_sd["gate.weight"])},
            "o_proj": {"weight": to_tensor(proj_sd["o_proj.weight"])},
            "ln_v": {"weight": to_tensor(proj_sd["ln_v.weight"]),
                     "bias": to_tensor(proj_sd["ln_v.bias"])},
        }
    vit: Params = {}
    for name in ("dino", "siglip"):
        tower_sd = strip(f"vit.{name}_featurizer.")
        if tower_sd:
            vit[name] = import_timm_vit(tower_sd, dst_grid)
    sam_sd = strip("vit.sam_featurizer.")
    if sam_sd:
        vit["sam"] = import_sam_vision(sam_sd)
    if vit:
        params["vit"] = vit
    return params


def export_visualrwkv_checkpoint(params: Params) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`import_visualrwkv_checkpoint`: ``{"rwkv", "proj",
    "vit"}`` -> the reference's combined layout (``rwkv.*``, ``proj.*``,
    ``vit.{dino,siglip}_featurizer.*`` in timm's layout,
    ``vit.sam_featurizer.*`` in the vendored encoder's), fp32 tensors on the
    parameters' device. CLIP (x060) has no place in that layout."""
    from visualrwkv_torch.convert.vision_import import export_sam_vision, export_timm_vit

    sd = export_rwkv_state_dict(params["rwkv"], prefix="rwkv.")
    proj = params.get("proj")
    if proj is not None:
        if "weight" in proj:
            sd["proj.weight"] = proj["weight"].detach().float()
        else:
            for name in ("gate.weight", "o_proj.weight", "ln_v.weight", "ln_v.bias"):
                part, leaf = name.split(".")
                sd[f"proj.{name}"] = proj[part][leaf].detach().float()
    for name, tower in params.get("vit", {}).items():
        if name not in ("dino", "siglip", "sam"):
            raise KeyError(f"tower {name!r} has no place in the combined checkpoint layout")
        export = export_sam_vision if name == "sam" else export_timm_vit
        sd.update((f"vit.{name}_featurizer.{k}", v) for k, v in export(tower).items())
    return sd
