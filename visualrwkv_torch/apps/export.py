"""Checkpoint export and split (the reference's export.py:1-27).
Counterpart of ``visualrwkv_tpu/apps/export.py``.

Splits a combined VisualRWKV checkpoint into the LM half (``*_rwkv.pth``)
and the visual half (``*_visual.pth``), in fp16, for the reference's demo
apps. The input is a reference-layout ``.pth`` state dict, or a checkpoint
that the port's ``Trainer.save_checkpoint`` wrote (``{"params", "step",
...}``), which is first exported to the reference's combined layout
(``convert.pth_import.export_visualrwkv_checkpoint``).

    python -m visualrwkv_torch.apps.export rwkv-0.pth --out_prefix out/model
"""

from __future__ import annotations

import argparse
from pathlib import Path


def split_state_dict(sd: dict) -> tuple[dict, dict]:
    rwkv = {k[len("rwkv."):]: v for k, v in sd.items() if k.startswith("rwkv.")}
    visual = {k: v for k, v in sd.items() if not k.startswith("rwkv.")}
    return rwkv, visual


def main(argv=None):
    p = argparse.ArgumentParser("visualrwkv_torch.apps.export")
    p.add_argument("input", type=str, help="a reference .pth, or a Trainer checkpoint")
    p.add_argument("--out_prefix", default="", type=str)
    args = p.parse_args(argv)

    import torch

    from visualrwkv_torch.convert.pth_import import export_visualrwkv_checkpoint

    inp = Path(args.input)
    prefix = args.out_prefix or str(inp.with_suffix(""))
    sd = torch.load(inp, map_location="cpu", weights_only=True)
    if "params" in sd and isinstance(sd["params"], dict):  # Trainer.save_checkpoint's payload
        sd = export_visualrwkv_checkpoint(sd["params"])
    rwkv_half, visual_half = split_state_dict(sd)
    half = lambda d: {k: torch.as_tensor(v).half() for k, v in d.items()}
    torch.save(half(rwkv_half), f"{prefix}_rwkv.pth")
    torch.save(half(visual_half), f"{prefix}_visual.pth")
    print(f"wrote {prefix}_rwkv.pth ({len(rwkv_half)}) and {prefix}_visual.pth ({len(visual_half)})")


if __name__ == "__main__":
    main()
