"""Kernel validation and benchmark harness. Counterpart of
``visualrwkv_tpu/ops/kernel_bench.py`` (reference v6.xx/test_kernel.py: the
fp32 sequential scan as golden, each implementation's relative RMS error on
the outputs and on all gradients, and its time).

    python -m visualrwkv_torch.ops.kernel_bench [wkv7|wkv6|all] [--B 8 --T 512 --H 32 --N 64]
        [--dtype bfloat16] [--device cuda|cpu]

Rows of a family:

- ``chunked16`` / ``chunked64``: the chunked plain PyTorch form at that
  chunk (``wkv7_chunked`` / ``wkv6_chunked``);
- ``cuda`` (CUDA only): the dispatcher ``wkv7`` / ``wkv6`` on CUDA
  tensors, that is the hand-written kernel K1 / K7, which runs its 16-step
  chunk whatever ``chunk`` is;
- ``dispatch grads``: ``torch.autograd.grad`` of ``sum(y^2) + sum(s^2)``
  through ``wkv7`` / ``wkv6`` on fp32 streams (``WKV7Function``: K5 + K6,
  ``WKV6Function``: K8 + K9 on CUDA; their plain versions on the CPU)
  against the same gradient of the sequential scan.

On CUDA a row's ms is the device time of one call (CUDA events over CUDA
graph replays, :func:`visualrwkv_torch.utils.timing.cuda_ms`); on the CPU
(``--device cpu``, the plain rows only) the host clock's mean. A row that
raises prints ``FAILED``; the run exits non-zero when a row of the CUDA
kernels failed.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.nn.functional as F

from visualrwkv_torch.config import resolve_device


def rel_err(x, y) -> float:
    x, y = x.double(), y.double()
    return float(((x - y) ** 2).sum().sqrt() / (y**2).sum().sqrt().clamp_min(1e-30))


def _time_ms(fn, device, reps: int = 10) -> float:
    if device.type == "cuda":
        from visualrwkv_torch.utils.timing import cuda_ms

        return cuda_ms(fn, reps=reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen).to(device)


def _run_rows(family, impls, inputs, y_ref, s_ref, device):
    """Times each implementation and measures its errors; returns the rows
    (``FAILED`` rows carry ``error``)."""
    rows = []
    for name, fn in impls.items():
        try:
            y, s = fn(*inputs)
            row = {"family": family, "impl": name, "ms": _time_ms(lambda: fn(*inputs), device),
                   "y_err": rel_err(y.float(), y_ref), "s_err": rel_err(s, s_ref)}
            print(f"  {name:<10} {row['ms']:8.3f} ms  y_err {row['y_err']:.2e}  s_err {row['s_err']:.2e}")
        except Exception as e:
            row = {"family": family, "impl": name, "error": f"{type(e).__name__}: {e}"}
            print(f"  {name:<10} FAILED: {type(e).__name__}: {str(e)[:80]}")
        rows.append(row)
    return rows


def _grad_row(family, names, fn, ref_fn, f32_inputs):
    """The gradient of ``sum(y^2) + sum(s^2)`` through ``fn`` against the
    same gradient through ``ref_fn`` (every input, fp32)."""
    def grads(f):
        leaves = [x.clone().requires_grad_(True) for x in f32_inputs]
        with torch.enable_grad():
            y, s = f(*leaves)
            loss = (y.float() ** 2).sum() + (s**2).sum()
            return torch.autograd.grad(loss, leaves)

    try:
        g_ref = grads(ref_fn)
        errs = {f"d{n}": rel_err(gd, gr) for n, gr, gd in zip(names, g_ref, grads(fn))}
        print("  dispatch grads vs golden: " + "  ".join(f"{k} {v:.1e}" for k, v in errs.items()))
        return {"family": family, "impl": "dispatch grads", "grad_err": errs}
    except Exception as e:
        print(f"  dispatch grads FAILED: {type(e).__name__}: {str(e)[:80]}")
        return {"family": family, "impl": "dispatch grads", "error": f"{type(e).__name__}: {e}"}


def _header(family, B, T, H, N, dtype, device):
    where = ("cuda: the plain forms and the CUDA kernels" if device.type == "cuda"
             else "cpu: the plain PyTorch versions only")
    print(f"{family}  B={B} T={T} H={H} N={N} dtype={str(dtype).replace('torch.', '')} device={where}")


def bench_wkv7(B, T, H, N, dtype, device):
    from visualrwkv_torch.ops.wkv7 import wkv7, wkv7_chunked, wkv7_reference

    gen = torch.Generator().manual_seed(0)
    shape = (B, T, H, N)
    r, k, v = (_normal(gen, shape, device) * 0.5 for _ in range(3))
    kk = _normal(gen, shape, device)
    kk = kk / kk.norm(dim=-1, keepdim=True)
    a = -kk
    b = kk * torch.sigmoid(_normal(gen, shape, device))
    w = -0.5 - F.softplus(-_normal(gen, shape, device))
    inputs = tuple(x.to(dtype) for x in (r, w, k, v, a, b))
    f32_inputs = tuple(x.float() for x in inputs)
    y_ref, s_ref = wkv7_reference(*f32_inputs)
    impls = {
        "chunked16": lambda *x: wkv7_chunked(*x, chunk=16),
        "chunked64": lambda *x: wkv7_chunked(*x, chunk=64),
    }
    if device.type == "cuda":
        impls["cuda"] = wkv7  # K1
    _header("wkv7", B, T, H, N, dtype, device)
    rows = _run_rows("wkv7", impls, inputs, y_ref, s_ref, device)
    rows.append(_grad_row("wkv7", "rwkvab", wkv7, wkv7_reference, f32_inputs))
    return rows


def bench_wkv6(B, T, H, N, dtype, device):
    from visualrwkv_torch.ops.wkv6 import wkv6, wkv6_chunked, wkv6_reference

    gen = torch.Generator().manual_seed(0)
    shape = (B, T, H, N)
    r, k, v = (_normal(gen, shape, device) * 0.5 for _ in range(3))
    w = -0.3 - F.softplus(-_normal(gen, shape, device))
    u = _normal(gen, (H, N), device) * 0.3
    inputs = tuple(x.to(dtype) for x in (r, w, k, v)) + (u,)
    f32_inputs = tuple(x.float() for x in inputs)
    y_ref, s_ref = wkv6_reference(*f32_inputs)
    impls = {"chunked16": lambda *x: wkv6_chunked(*x, chunk=16)}
    if device.type == "cuda":
        impls["cuda"] = wkv6  # K7
    _header("wkv6", B, T, H, N, dtype, device)
    rows = _run_rows("wkv6", impls, inputs, y_ref, s_ref, device)
    rows.append(_grad_row("wkv6", "rwkvu", wkv6, wkv6_reference, f32_inputs))
    return rows


def main(argv=None):
    """Runs the benchmark; returns its rows. Exits with status 1 (after
    printing every row) when a CUDA kernel's row failed."""
    p = argparse.ArgumentParser("visualrwkv_torch.ops.kernel_bench")
    p.add_argument("kernel", nargs="?", default="wkv7", choices=["wkv7", "wkv6", "all"])
    p.add_argument("--B", default=8, type=int)
    p.add_argument("--T", default=512, type=int)
    p.add_argument("--H", default=32, type=int)
    p.add_argument("--N", default=64, type=int)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    rows = []
    if args.kernel in ("wkv7", "all"):
        rows += bench_wkv7(args.B, args.T, args.H, args.N, dtype, device)
    if args.kernel in ("wkv6", "all"):
        rows += bench_wkv6(args.B, args.T, args.H, args.N, dtype, device)
    failed = [f"{r['family']} {r['impl']}" for r in rows
              if "error" in r and device.type == "cuda" and r["impl"] in ("cuda", "dispatch grads")]
    if failed:
        print(f"kernel_bench: the CUDA kernels' rows failed: {failed}", file=sys.stderr)
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()
