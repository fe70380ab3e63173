"""Identity steps that fill a WKV call to its kernels' 16-step chunks.

Shared by the x060 and x070 autograd Functions (:mod:`visualrwkv_torch.ops.wkv6`,
:mod:`visualrwkv_torch.ops.wkv7`), whose training kernels take T a multiple
of 16 while the models pad T only to ``chunk_len``."""

from __future__ import annotations

import torch

# w_raw of a padding step: exp(-exp(-60)) is exactly 1 in fp32, and the
# backward's factor -exp(w_raw) stays finite (no inf * 0, as -inf would give)
PAD_W_RAW = -60.0


def pad_steps(xs, w_index: int, steps: int):
    """Streams ``[B, T, H, N]`` right-padded to ``steps`` steps with identity
    steps: zeros, and ``PAD_W_RAW`` in the stream at ``w_index`` (the log
    decay's input; -1 for none). With r = k = v = a = b = 0 (WKV7) or
    r = k = v = 0 (WKV6) and a decay of exactly 1 such a step leaves the
    state as it is and gives y = 0, so the real steps' outputs, the final
    state and every gradient of the real steps are those of the unpadded
    call. The streams come back contiguous, as the kernels take them (a
    T-slice of a stream, as a token split gives, is strided)."""
    T = xs[0].shape[1]
    if steps == T:
        return tuple(x.contiguous() for x in xs)
    return tuple(torch.cat([x, x.new_full((x.shape[0], steps - T) + tuple(x.shape[2:]),
                                          PAD_W_RAW if i == w_index else 0.0)], 1)
                 for i, x in enumerate(xs))
