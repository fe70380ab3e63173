"""The PyTorch port stands alone: importing every module of
``visualrwkv_torch`` pulls in neither JAX nor the JAX package, and the
public entry points run on CUDA unless the caller asks for the CPU.

The import check runs in a subprocess, because tests/conftest.py imports
JAX into this process."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import visualrwkv_torch
names = [m.name for m in pkgutil.walk_packages(visualrwkv_torch.__path__, "visualrwkv_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "visualrwkv_tpu"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 24, out.stdout  # every subpackage was walked, train/ and data/ included


def test_entry_points_default_to_cuda():
    from visualrwkv_torch.config import RWKVConfig, VisionConfig, VLMConfig
    from visualrwkv_torch.infer.engine import InferenceEngine
    from visualrwkv_torch.models.visualrwkv import init_visualrwkv_params, vlm_forward

    cfg = VLMConfig(rwkv=RWKVConfig(n_layer=1, n_embd=64, vocab_size=512, head_size=32),
                    vision=VisionConfig(towers=()))
    if torch.cuda.is_available():
        assert InferenceEngine({}, cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_visualrwkv_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vlm_forward({}, cfg, [[1, 2]])
    from visualrwkv_torch.config import TrainConfig
    from visualrwkv_torch.models.visualrwkv import training_loss
    from visualrwkv_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        training_loss({}, cfg, [[1, 2]], [[1, 2]])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, TrainConfig(), {})
    # the CPU, when asked for, works
    params = init_visualrwkv_params(cfg, device="cpu")
    logits = vlm_forward(params, cfg, [[1, 2, 3]], device="cpu")
    assert logits.shape == (1, 3, 512) and torch.isfinite(logits).all()


def test_unported_options_raise():
    from visualrwkv_torch.config import RWKVConfig, VLMConfig
    from visualrwkv_torch.infer.engine import InferenceEngine

    with pytest.raises(NotImplementedError):
        RWKVConfig(version="x060")
    for kw in ({"uhd_fusion": True}, {"n_vtc_layer": 1}, {"grid_size": 4},
               {"bidirectional_image": True}, {"image_scanning": "zigzag"}):
        with pytest.raises(NotImplementedError):
            VLMConfig(**kw)
    with pytest.raises(ValueError):
        InferenceEngine({}, VLMConfig(), state_layout="rows", device="cpu")
    assert InferenceEngine({}, VLMConfig(), state_layout="flat", device="cpu").state_layout == "flat"
