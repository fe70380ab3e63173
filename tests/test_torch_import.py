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

import torch_port_helpers  # noqa: F401  (caps torch's CPU threads)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import visualrwkv_torch
names = [m.name for m in pkgutil.walk_packages(visualrwkv_torch.__path__, "visualrwkv_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "visualrwkv_tpu"))
print(len(names), bad)
print(" ".join(names))
assert not bad, bad
"""

# the later slices' modules, which the walk must reach
SERVING_MODULES = ("convert.pth_import", "convert.vision_import", "infer.quant", "infer.strategy",
                   "infer.server", "apps.demo", "apps.serve", "apps.export", "infer.speculative",
                   "apps.benchmark", "models.rwkv5", "models.rwkv4", "ops.wkv4", "ops.wkv4_cuda",
                   "multimodal.insertion", "multimodal.vtc", "multimodal.scanning", "multimodal.uhd",
                   "data.tiling", "train.offload", "models.vrwkv", "evals.imagenet",
                   "multimodal.image_as_state", "multimodal.hybrid", "multimodal.contrastive",
                   "multimodal.adapter_v4", "evals.loaders", "evals.converters", "evals.score",
                   "evals.runner", "evals.cli", "evals.hfds", "evals.rank", "evals.lm_harness",
                   "evals.metrics.vqa", "evals.metrics.simple", "evals.metrics.gqa", "evals.metrics.m4c",
                   "evals.metrics.interleave", "evals.metrics.videomme", "utils.observability",
                   "utils.calc_ctxlen", "utils.scan_hyperparameter", "utils.timing", "ops.kernel_bench",
                   "data.tools", "native.fast_tokenizer", "parallel.distributed", "parallel.mesh",
                   "parallel.collectives", "parallel.zero", "ops.wkv_sp")


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 24, out.stdout  # every subpackage was walked, train/ and data/ included
    walked = set(out.stdout.splitlines()[1].split())
    assert {f"visualrwkv_torch.{m}" for m in SERVING_MODULES} <= walked, out.stdout


def test_entry_points_default_to_cuda(tmp_path):
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
        Trainer(cfg, TrainConfig(), {}, proj_dir=str(tmp_path))
    from visualrwkv_torch.ops import kernel_bench
    from visualrwkv_torch.utils.observability import device_memory

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kernel_bench.main(["wkv7", "--B", "1", "--T", "16", "--H", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_memory()
    # the CPU, when asked for, works
    params = init_visualrwkv_params(cfg, device="cpu")
    logits = vlm_forward(params, cfg, [[1, 2, 3]], device="cpu")
    assert logits.shape == (1, 3, 512) and torch.isfinite(logits).all()


def test_unported_options_raise():
    from visualrwkv_torch.config import RWKVConfig, VisionConfig, VLMConfig
    from visualrwkv_torch.infer.engine import InferenceEngine

    from visualrwkv_tpu.config import RWKVConfig as JaxRWKVConfig

    for version in ("x052", "x040"):  # ported: they build with the JAX package's dim_ffn
        cfg = RWKVConfig(version=version, n_embd=2048)
        assert cfg.dim_ffn == JaxRWKVConfig(version=version, n_embd=2048).dim_ffn
        assert cfg.dim_ffn == (8192 if version == "x040" else 7168)
    # the published variants' options are ported: they build (their paths
    # are held against JAX in test_torch_{insertion,variants}.py); values
    # the JAX package has no path for raise ValueError
    for kw in ({"uhd_fusion": True}, {"n_vtc_layer": 1}, {"bidirectional_image": True},
               {"image_scanning": "zigzag"}, {"insertion_mode": "leftpad"}):
        VLMConfig(**kw)
    assert VLMConfig(uhd_fusion=True).projector_in_dim == 2 * VLMConfig().projector_in_dim
    for kw in ({"insertion_mode": "splice"}, {"image_scanning": "diagonal"}):
        with pytest.raises(ValueError):
            VLMConfig(**kw)
    with pytest.raises(NotImplementedError):  # a tower the port has not
        VLMConfig(vision=VisionConfig(towers=("convnext",)))
    with pytest.raises(ValueError):
        InferenceEngine({}, VLMConfig(), state_layout="rows", device="cpu")
    assert InferenceEngine({}, VLMConfig(), state_layout="flat", device="cpu").state_layout == "flat"
    x060 = VLMConfig(rwkv=RWKVConfig(version="x060"))  # x060 carries the flat state too
    assert InferenceEngine({}, x060, state_layout="flat", device="cpu").state_layout == "flat"


_IMPORT_SCRIPTS = """
import sys
import chip_ab, chip_smoke, chip_variants
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "visualrwkv_tpu"))
assert not bad, bad
"""


def test_chip_scripts_import_no_jax_and_refuse_without_cuda():
    """The card's scripts import neither JAX nor the JAX package, and
    without CUDA ``chip_smoke.py`` exits non-zero and prints no result."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _IMPORT_SCRIPTS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    if torch.cuda.is_available():
        return
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout, out.stdout + out.stderr


def test_chip_smoke_reads_ptxas_report():
    """``chip_smoke.parse_ptxas`` keys each kernel instantiation of an
    ``-Xptxas -v`` report by its name and template arguments (the
    attention backward's case log reads registers and spills from it)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    report = (
        "ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__d8087c1d_16_attention_bwd_cu_"
        "e1c8fcb123attention_bwd_dq_kernelILi64ELi48ELi1EEEvNS_4MapsEiif' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN49_GLOBAL__N__d8087c1d\n"
        "    56 bytes stack frame, 52 bytes spill stores, 52 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 16 barriers, 56 bytes cumulative stack size\n"
        "ptxas info    : Compiling entry function '_Z16wkv7_step_kernelIfLb1EEviii' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers, used 1 barriers\n"
    )
    chip_smoke.PTXAS.clear()
    chip_smoke.parse_ptxas("attention_bwd", report)
    assert chip_smoke.PTXAS[("attention_bwd", "attention_bwd_dq_kernel", (64, 48, 1))] == {
        "spill_bytes": 52, "registers": 168}
    assert chip_smoke.PTXAS[("attention_bwd", "wkv7_step_kernel", ())] == {"registers": 40}
    chip_smoke.PTXAS.clear()
