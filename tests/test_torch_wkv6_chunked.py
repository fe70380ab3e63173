"""The launch side of the chunked WKV6 forward kernels K7 ``wkv6_fwd`` and K8
``wkv6_fwd_res`` (``visualrwkv_torch/csrc/wkv6.cu``), which the CPU reaches:
the row-slice plan ``wkv6_cuda.fwd_plan`` that the wrappers pass to the
kernel, the wrappers' refusals (checked before any library is loaded), and
how ``chip_smoke.py`` names the kernels' instantiations in a profile and in
ptxas's report. The kernels' arithmetic is held against the plain versions
on the card by ``chip_smoke.py``; the plain versions against the JAX package
in ``tests/test_torch_wkv6.py``."""

import os
import sys

import pytest
import torch

import torch_port_helpers  # noqa: F401  (caps torch's CPU threads)
from visualrwkv_torch.ops import wkv6_cuda

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
BF, F32 = torch.bfloat16, torch.float32
SMEM_PER_SM = 233472  # bytes of shared memory of an H100 multiprocessor
SMEM_RESERVED = 1024  # kept back by CUDA for each resident block


def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


# (B, H, stream dtype) -> (value rows a block, blocks, threads, shared bytes):
# the smoke's shapes (x060 1.6B training B=2 H=32; x060 7B prefill B=1 and
# B=4, H=64), B*H = 128, and B*H that 32 or 64 rows would leave far below
# one block a multiprocessor.
PLANS = {
    (2, 32, BF): (32, 128, 256, 66816),
    (2, 32, F32): (32, 128, 256, 88320),
    (1, 64, BF): (32, 128, 256, 66816),
    (1, 64, F32): (32, 128, 256, 88320),
    (4, 64, BF): (64, 256, 256, 87296),
    (2, 64, BF): (64, 128, 256, 87296),
    (3, 5, F32): (16, 60, 128, 76544),
    (3, 5, BF): (16, 60, 128, 56576),
    (1, 1, F32): (16, 4, 128, 76544),
}


@pytest.mark.parametrize("B,H,dtype", list(PLANS), ids=[f"B{b}H{h}-{str(d)[6:]}" for b, h, d in PLANS])
def test_fwd_plan(B, H, dtype):
    """Rows a block, blocks, threads and shared memory at each shape; every
    value row of every head in exactly one block, 8 threads a row (4 at 64
    rows), and two blocks fit on a multiprocessor."""
    plan = wkv6_cuda.fwd_plan(B, H, dtype)
    assert (plan["rows"], plan["blocks"], plan["threads"], plan["smem_bytes"]) == PLANS[(B, H, dtype)]
    assert plan["rows"] in wkv6_cuda.FWD_ROWS and plan["blocks"] * plan["rows"] == B * H * 64
    assert plan["threads"] == plan["rows"] * (4 if plan["rows"] == 64 else 8)
    assert 2 * (plan["smem_bytes"] + SMEM_RESERVED) <= SMEM_PER_SM


def _streams(B, T, H, dtype=F32):
    xs = [torch.zeros(B, T, H, 64, dtype=dtype) for _ in range(4)]
    return xs, torch.zeros(H, 64)


@pytest.mark.parametrize("name", ["wkv6_fwd", "wkv6_fwd_res"])
def test_wrappers_refuse_cpu_tensors(name):
    xs, u = _streams(1, 32, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(wkv6_cuda, name)(*xs, u, None, 16)


@pytest.mark.parametrize("name", ["wkv6_fwd", "wkv6_fwd_res"])
@pytest.mark.parametrize("chunk", [8, 15])
def test_wrappers_refuse_a_floor_below_minus_5(name, chunk):
    """A model chunk_len below 16 floors the log decay below -5 a step. K7 /
    K8 take every such floor (a factor form for each range of it:
    ``csrc/wkv6_chunk.cuh``), so the wrappers do not refuse it: CPU tensors
    get as far as the device check."""
    xs, u = _streams(1, 32, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(wkv6_cuda, name)(*xs, u, None, chunk)


@pytest.mark.parametrize("T", [0, 24])
def test_k8_refuses_t_not_a_multiple_of_16(T):
    xs, u = _streams(1, T, 2)
    with pytest.raises(ValueError, match="multiple of 16"):
        wkv6_cuda.wkv6_fwd_res(*xs, u, None, 16)


@pytest.mark.parametrize("save", [0, 1])
@pytest.mark.parametrize("dt", [0, 1])
@pytest.mark.parametrize("rows", [16, 32, 64])
def test_chip_smoke_names_the_instantiations(save, dt, rows):
    """A profiler's demangled kernel name ``wkv6_fwd_kernel<DT, SAVE, ROWS>``
    is K8 with SAVE 1, else K7, at every stream dtype and row count."""
    cs = _chip_smoke()
    stream = "__nv_bfloat16" if dt else "float"
    name = (f"void (anonymous namespace)::wkv6_fwd_kernel<{dt}, {save}, {rows}>(int, int, float, "
            f"{stream} const*, {stream} const*, {stream} const*, {stream} const*, float const*, "
            f"float const*, {stream}*, float*, float*)")
    assert cs._category(name) == ("K8 wkv6_fwd_res" if save else "K7 wkv6_fwd")


def test_chip_smoke_other_categories_unchanged():
    cs = _chip_smoke()
    step = "void (anonymous namespace)::step::wkv_step_kernel<{}>(int, float const*)"
    assert cs._category(step.format("7, 0, 1, 8")) == "K4 wkv7_step_flat"
    assert cs._category(step.format("7, 1, 0, 16")) == "K2 wkv7_step"
    assert cs._category(step.format("6, 0, 0, 32")) == "K10 wkv6_step"
    assert cs._category("void wkv6_bwd_kernel<__nv_bfloat16>(int)") == "K9 wkv6_bwd"


def test_chip_smoke_keys_ptxas_report_of_k7_k8():
    """``parse_ptxas`` keys K7 / K8 by (dtype code, SAVE, ROWS), as phase 1's
    no-spill check and the plans' log read them."""
    cs = _chip_smoke()
    report = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115wkv6_fwd_kernelILi1ELi1ELi32EEEviif"
        "PK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_PfS7_' for 'sm_90a'\n"
        "ptxas info    : Used 128 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115wkv6_fwd_kernelILi0ELi0ELi64EEEviif"
        "PKfS2_S2_S2_S2_S2_PfS3_S3_' for 'sm_90a'\n"
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 64 registers, used 1 barriers, 8 bytes cumulative stack size\n"
    )
    cs.PTXAS.clear()
    cs.parse_ptxas("wkv6", report)
    assert cs.PTXAS[("wkv6", "wkv6_fwd_kernel", (1, 1, 32))] == {"registers": 128}
    assert cs.PTXAS[("wkv6", "wkv6_fwd_kernel", (0, 0, 64))] == {"spill_bytes": 8, "registers": 64}
    cs.PTXAS.clear()
