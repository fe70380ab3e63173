"""The WKV dispatchers take what the plain versions and the JAX package's
``wkv7_step`` / ``wkv6_step`` take: vectors ``[..., H, N]`` of any float
dtype and layout (bf16, strided slices of a wider tensor, more leading
dimensions than B), and streams of mixed dtypes. On CUDA they hand the
kernels fp32 (or the streams' common dtype), contiguous, 16-byte aligned
operands with the leading dimensions folded into B, and return y in the
dtype and shape the plain path returns (``wkv7_cuda.run_step`` /
``run_streams``). Here on the CPU the normalisation is driven through
stand-in kernels that check the kernels' contract and compute with the
plain versions; ``chip_smoke.py`` holds the CUDA kernels on the card."""

import numpy as np
import pytest
import torch

from visualrwkv_torch.ops import wkv6 as p6
from visualrwkv_torch.ops import wkv7 as p7
from visualrwkv_torch.ops import wkv7_cuda

H, N = 2, 64


def _contract(*xs, state=None, flat=False):
    """What the CUDA wrappers accept: fp32 [B, H, 64] vectors, contiguous
    and 16-byte aligned; a state fp32 or bf16 [B, H, 64, 64] (flat
    [B, 64, H*64])."""
    B = xs[0].shape[0]
    for x in xs:
        assert x.dtype == torch.float32 and tuple(x.shape) == (B, H, N), (x.dtype, x.shape)
        assert x.is_contiguous() and x.data_ptr() % 16 == 0
    if state is not None:
        assert state.dtype in (torch.float32, torch.bfloat16) and state.is_contiguous()
        assert tuple(state.shape) == ((B, N, H * N) if flat else (B, H, N, N))
        assert state.data_ptr() % 16 == 0


def _k2(state, *vecs):
    _contract(*vecs, state=state)
    s, y = p7.wkv7_step(state, *vecs)
    return s.to(state.dtype), y


def _k4(state, *vecs):
    _contract(*vecs, state=state, flat=True)
    s, y = p7.wkv7_step_flat(state, *vecs)
    return s, y.float()


def _k10(state, r, w, k, v, u):
    _contract(r, w, k, v, state=state)
    assert u.dtype == torch.float32 and tuple(u.shape) == (H, N) and u.is_contiguous()
    s, y = p6.wkv6_step(state, r, w, k, v, u)
    return s.to(state.dtype), y


def _k10_flat(state, r, w, k, v, u):
    _contract(r, w, k, v, state=state, flat=True)
    return p6.wkv6_step_flat(state, r, w, k, v, u)


def _vectors(lead, n, seed, dtype=torch.float32, strided=False):
    """n vectors [*lead, H, N]; strided: every other channel of a wider
    tensor (a non-contiguous slice along the last axis)."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for i in range(n):
        x = torch.randn(*lead, H, 2 * N if strided else N, generator=gen) * 0.5
        if i == 1:
            x = -torch.nn.functional.softplus(-x) - 0.5  # w_raw
        x = x[..., ::2] if strided else x
        out.append(x.to(dtype))
    return out


CASES = [((3,), torch.bfloat16, False), ((3,), torch.float32, True), ((2, 3), torch.float32, False),
         ((2, 3), torch.bfloat16, True), ((1,), torch.float16, False)]


@pytest.mark.parametrize("lead,dtype,strided", CASES)
@pytest.mark.parametrize("family", ["x070", "x060"])
def test_step_normalised_for_the_kernels(family, lead, dtype, strided):
    """run_step with a stand-in kernel gives the plain step's results on the
    same inputs: y in the vectors' dtype and shape, the new state the
    kernel's (carried dtype), bit for bit. The plain step sees the state as
    run_step hands it to the kernel, a contiguous copy in its carried
    dtype: on the transposed view its sums run in another order, and the
    last bit of an fp16 y can differ."""
    vecs = _vectors(lead, 6 if family == "x070" else 4, seed=len(lead) + strided, dtype=dtype,
                    strided=strided)
    gen = torch.Generator().manual_seed(5)
    s0 = torch.randn(*lead, H, N, N, generator=gen) * 0.3
    s0 = s0.transpose(-1, -2).to(torch.bfloat16)  # a non-contiguous carried state
    extra = () if family == "x070" else (torch.randn(H, N, generator=gen, dtype=torch.float64),)
    kernel = _k2 if family == "x070" else _k10
    plain = p7.wkv7_step if family == "x070" else p6.wkv6_step
    s, y = wkv7_cuda.run_step(kernel, s0, vecs, extra)
    s_ref, y_ref = plain(s0.contiguous(), *vecs, *extra)
    assert y.dtype == dtype and y.shape == vecs[0].shape
    assert s.dtype == torch.bfloat16 and s.shape == s0.shape
    assert torch.equal(y, y_ref)
    assert torch.equal(s, s_ref.to(torch.bfloat16))


@pytest.mark.parametrize("family", ["x070", "x060"])
def test_flat_step_normalised_for_the_kernels(family):
    vecs = _vectors((4,), 6 if family == "x070" else 4, seed=9, dtype=torch.bfloat16, strided=True)
    s0 = torch.randn(4, N, H * N, generator=torch.Generator().manual_seed(6)) * 0.3
    extra = () if family == "x070" else (torch.randn(H, N),)
    kernel = _k4 if family == "x070" else _k10_flat
    plain = p7.wkv7_step_flat if family == "x070" else p6.wkv6_step_flat
    s, y = wkv7_cuda.run_step(kernel, s0, vecs, extra)
    s_ref, y_ref = plain(s0, *vecs, *extra)
    assert y.dtype == torch.bfloat16 and torch.equal(y, y_ref) and torch.equal(s, s_ref)


def test_streams_normalised_for_the_kernels():
    """run_streams: the streams' common dtype (bf16 with bf16, fp32 with a
    mix, fp32 for fp16, which no kernel takes), contiguous and aligned;
    y back in r's dtype; the initial state fp32."""
    seen = []

    def kernel(*args):
        *xs, s0 = args
        dt = xs[0].dtype
        assert all(x.dtype == dt and x.is_contiguous() and x.data_ptr() % 16 == 0 for x in xs)
        assert s0 is None or (s0.dtype == torch.float32 and s0.is_contiguous())
        seen.append(dt)
        return p7.wkv7_plain(*xs, s0)

    gen = torch.Generator().manual_seed(1)
    wide = [torch.randn(2, 16, H, 2 * N, generator=gen) * 0.3 for _ in range(6)]
    wide[1] = -torch.nn.functional.softplus(-wide[1]) - 0.5
    strided = [x[..., 1::2] for x in wide]
    s0 = (torch.randn(2, H, N, N, generator=gen) * 0.1).transpose(-1, -2)
    for xs, want in (([x.bfloat16() for x in strided], torch.bfloat16),
                     ([strided[0].bfloat16()] + strided[1:], torch.float32),
                     ([x.half() for x in strided], torch.float32)):
        y, s = wkv7_cuda.run_streams(kernel, xs, s0)
        y_ref, s_ref = p7.wkv7_plain(*(x.to(want).contiguous() for x in xs), s0.contiguous())
        assert seen[-1] == want and y.dtype == xs[0].dtype and s.dtype == torch.float32
        assert torch.equal(y, y_ref.to(xs[0].dtype)) and torch.equal(s, s_ref)


def test_operand_aligns_and_casts():
    base = torch.arange(64, dtype=torch.float32)
    x = base[1:33]  # contiguous, 4 bytes past a 16-byte boundary
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    y = wkv7_cuda.operand(x, torch.float32)
    assert y.data_ptr() % 16 == 0 and torch.equal(y, x)
    z = base.reshape(8, 8)
    assert wkv7_cuda.operand(z, torch.float32) is z  # already an operand: no copy
    assert wkv7_cuda.stream_dtype([z.bfloat16(), z.bfloat16()]) == torch.bfloat16
    assert wkv7_cuda.stream_dtype([z.half(), z.half()]) == torch.float32


@pytest.mark.parametrize("family", ["x070", "x060"])
def test_cpu_dispatchers_take_narrow_inputs(family):
    """The public step and sequence dispatchers on the CPU take bf16,
    strided and [..., H, N] inputs: bf16 gives the plain result on the
    rounded inputs, a strided slice its contiguous copy's, bit for bit."""
    nv = 6 if family == "x070" else 4
    extra = () if family == "x070" else (torch.randn(H, N, generator=torch.Generator().manual_seed(2)),)
    step = p7.wkv7_step_auto if family == "x070" else p6.wkv6_step_auto
    vecs = _vectors((2, 3), nv, seed=3, strided=True)
    s0 = torch.randn(2, 3, H, N, N, generator=torch.Generator().manual_seed(4)) * 0.3
    s, y = step(s0, *vecs, *extra)
    s_c, y_c = step(s0, *(v.contiguous() for v in vecs), *extra)
    assert torch.equal(y, y_c) and torch.equal(s, s_c) and y.shape == (2, 3, H, N)
    vb = [v.bfloat16() for v in vecs]
    s_b, y_b = step(s0, *vb, *extra)
    s_r, y_r = step(s0, *(v.float() for v in vb), *extra)
    assert y_b.dtype == torch.bfloat16 and torch.equal(y_b, y_r.bfloat16()) and torch.equal(s_b, s_r)

    seq = p7.wkv7 if family == "x070" else p6.wkv6
    streams = _vectors((2, 16), nv, seed=5, strided=True)  # [B, T, H, N], strided
    y, st = seq(*(x.bfloat16() for x in streams), *extra)
    y_r, st_r = seq(*(x.bfloat16().contiguous() for x in streams), *extra)
    assert y.dtype == torch.bfloat16 and torch.equal(y, y_r) and torch.equal(st, st_r)
    assert np.isfinite(y.float().numpy()).all()
