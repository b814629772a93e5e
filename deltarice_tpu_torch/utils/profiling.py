"""Profiling helpers: a ``torch.profiler`` device trace, a throughput
measurement timed with CUDA events, and device times of short kernels
from CUDA graphs, warm or over rotated buffers."""

from __future__ import annotations

import collections
import contextlib
import time

import torch


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace host and CUDA activity around a block with ``torch.profiler``
    and write a Chrome trace (``trace.json``, view in Perfetto or
    chrome://tracing) into ``logdir``. Yields the profiler, whose
    ``key_averages()`` give device time by kernel."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def throughput(fn, *args, nbytes: int, iters: int = 20,
               device="cuda") -> dict:
    """Throughput of ``fn(*args)``: one warm-up call, then ``iters`` calls
    between two CUDA events on the current stream, synchronised (a CPU
    device uses the host clock). Returns {"seconds_per_call", "gbps"}."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("throughput on a CUDA device needs a CUDA card")
        fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / iters
    else:
        fn(*args)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        dt = (time.perf_counter() - t0) / iters
    return {"seconds_per_call": dt, "gbps": nbytes / max(dt, 1e-12) / 1e9}


def graph_ms(fns, reps: int = 20) -> float:
    """Mean milliseconds per call on the card's timeline of ``reps`` calls,
    call i being ``fns[i % len(fns)]()``, captured in one CUDA graph and
    replayed (after one warm-up call of each and one warm-up replay): no
    host time between launches, so a kernel shorter than its wrapper's
    host cost is timed all the same. The graph and its memory pool are
    released before it returns."""
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
        side.synchronize()
        with torch.cuda.graph(graph, stream=side):
            for i in range(reps):
                fns[i % len(fns)]()
    torch.cuda.synchronize()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (5 * reps)


def rotated(fn, inputs) -> list:
    """Calls of ``fn`` over ``inputs`` in turn, each output kept until
    ``len(inputs) - 1`` later calls have run, so that consecutive calls
    also write to different buffers (a cold timing's rotation)."""
    kept = collections.deque(maxlen=len(inputs) - 1)
    return [lambda x=x: kept.append(fn(x)) for x in inputs]
