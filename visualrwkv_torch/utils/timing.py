"""Device timing on the GPU, by CUDA events: ``cuda_ms`` (the device time of
a call, replayed from a CUDA graph) and ``eager_ms`` (back-to-back eager
calls, the host's cost of issuing them included)."""

from __future__ import annotations

import torch


def eager_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back eager calls (CUDA events
    around the run): the larger of the device time and the host's cost of
    issuing the call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


_SIDE_STREAM = []


def cuda_ms(fn, reps: int = 20, warmup: int = 2, replays: int = 3) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    cost of issuing the launches is not in it. One side stream serves every
    capture: cuBLAS keeps a workspace for each stream it has run on, which
    would otherwise stay allocated through a caller's later peaks."""
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    side = _SIDE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)
