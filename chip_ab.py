#!/usr/bin/env python3
"""Two checkouts of the port on one card, in turns: the serving and training
runs of their own ``chip_smoke.py`` and its K3 check, each side in a fresh
process.

    python3 chip_ab.py PARENT_DIR CHANGE_DIR     # parent, change, change, parent

Each side builds its kernels into its own ``build/``, then measures on the
flagship VisualRWKV-7 1B5 (seeded random bf16 weights, full width): K3's
device time at the phase-2 shapes, the TTFT and decode rate of one request
and of four, and the step times of the main training run (1 + 3 steps),
the packed run (1 + 3) and ``grad_cp="wkv"`` (1 + 2). One ``AB {json}``
line a side; the card's name and power limit first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def child(tree: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from visualrwkv_torch import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build(force=True)
    dev = torch.device("cuda", 0)
    out = {"tree": tree}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    relpos, mha = cs.check_attention(gen, dev)
    out["k3_ms"] = [r["kernel_ms"] for r in relpos[:1] + mha]
    cfg = cs.flagship_cfg()
    params = cs.build(cfg, 0, dev)
    runs, _, _, _ = cs.run_serving(cfg, params, dev, cs.NEW_TOKENS, 0)
    out["serving"] = [{k: r[k] for k in ("run", "ttft_ms", "decode_tok_per_s")} for r in runs]
    for name, grad_cp, packed, steps in (("main", True, False, 3), ("packed", True, True, 3),
                                         ("wkv", "wkv", False, 2)):
        training, _, _ = cs.run_training(cfg, params, dev, 0, steps=steps, grad_cp=grad_cp,
                                         packed=packed)
        out[name] = [s["step_ms"] for s in training["steps"]]
        torch.cuda.empty_cache()
    print("AB " + json.dumps(out), flush=True)


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        child(argv[1])
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = argv
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for tree in (parent, change, change, parent):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree],
                           capture_output=True, text=True)
        print("\n".join(l for l in r.stdout.splitlines() if l.startswith("AB ")), flush=True)
        if r.returncode:
            print(r.stdout[-4000:], r.stderr[-4000:], flush=True)
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
