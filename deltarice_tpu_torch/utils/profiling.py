"""Profiling helpers: a ``torch.profiler`` device trace and a throughput
measurement timed with CUDA events."""

from __future__ import annotations

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
