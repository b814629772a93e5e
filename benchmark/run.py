"""Runs one cell of BENCHMARK.json on the card this process finds.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from process start to the first timed call) builds nothing but
what the cell's traffic uses: the program's kernels (built inside the
checkout on its first run), the resident batches made on the card from the
seed, and for a decode the reference's stream words. The window then
issues codec calls for ``--seconds`` with a fixed number in flight. With
``--trace 1`` the middle of the window holds a stretch under the profiler,
and the run prints the per-layer metrics in place of the end-to-end ones.
Once the window has closed, a sample of the calls drawn from the seed is
compared with the plain reference. The last line of standard output is the
result, a JSON object; the last lines of standard error are the numbers
compared, each beside its limit.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import numpy as np  # noqa: E402

from drbench import check, data, engine, spec, trace  # noqa: E402

#: seconds of calls under the profiler before its traced stretch opens
LEAD_S = 0.05
#: seconds of the traced stretch, in the middle of the window
TRACE_S = 0.5
#: calls of the window whose outputs the check compares
CHECKED_CALLS = 8
#: top-level modules that no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "deltarice_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_loaded() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _note(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _keep(seed: int, seconds: float, per_batch: float, n: int) -> set:
    """Indices of the calls whose outputs the check compares: every
    ``stride``-th call from an offset drawn from the seed, ``n`` of them
    over the window's expected calls."""
    expected = max(1, int(seconds / max(per_batch, 1e-6)))
    stride = max(1, expected // n)
    offset = int(np.random.default_rng(seed).integers(stride))
    return set(range(offset, offset + stride * n, stride))


def power_limit() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return res.stdout.strip() or "not read"


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
        program, t_start: float) -> dict:
    """One run of ``cell``: the result's fields and the check's readings."""
    import torch

    t_made = time.perf_counter()
    work = engine.Workload(program, cell.config, cell.traffic, seed, device,
                           tracing=traced)
    t_warm = time.perf_counter()
    per_batch = work.warm(hold=CHECKED_CALLS)
    cuda = work.dev.cuda
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    if traced:  # the profiler's own start-up belongs to set-up
        with torch.profiler.profile(activities=activities):
            work.complete(work.issue(0))
        work.reencoded = 0
    keep = _keep(seed, seconds, per_batch, CHECKED_CALLS)
    rec = engine.Records()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    summary = None
    if not traced:
        elapsed = engine.window(work, seconds, rec, keep)
    else:
        elapsed = engine.window(work, seconds / 2, rec, keep)
        with torch.profiler.profile(activities=activities) as prof:
            # the profiler's first launches stall the host: they fall in a
            # lead-in that the traced stretch leaves out
            work.phase = "lead"
            engine.window(work, LEAD_S, rec, keep)
            work.phase = "trace"
            with torch.profiler.record_function(trace.WINDOW):
                engine.window(work, TRACE_S, rec, keep)
        work.phase = "window"
        elapsed += engine.window(work, seconds / 2, rec, keep)
        summary = trace.from_profiler(prof)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window_calls = len(rec.latency_s)

    got = check.run(work, rec.kept)
    rec.kept.clear()
    counts = got.pop("stream_words")
    words = {b: int(c.sum()) for b, c in counts.items()}
    ratio = data.ratio(torch.cat(list(counts.values())), work.rows * len(counts),
                       work.length)
    lat = np.asarray(rec.latency_s)
    slow = [c for c, t in zip(rec.latency_call, lat) if t > 2 * np.median(lat)]
    _note(f"{cell.name}: {window_calls} calls in {elapsed:.4f} s; "
          f"compressed ratio {ratio:.5f} (published "
          f"{cell.config['published_ratio']}); "
          + (f"word cap {work.cap}, rows encoded again {work.reencoded}; "
             if work.op == "encode" else
             f"plane widths {[p.shape[1] for p in work.planes]}; ")
          + f"longest stream {max(int(c.max()) for c in counts.values())} "
          f"words; per batch at warm-up {per_batch * 1e3:.4f} ms; batch latency "
          f"median {np.median(lat) * 1e3:.4f} max {lat.max() * 1e3:.4f} ms, "
          f"{len(slow)} over twice the median ({sum(c in keep for c in slow)} "
          f"of them kept for the check, {sum(c - 1 in keep for c in slow)} "
          f"just after one); "
          f"set-up: to the cell {t_made - t_start:.3f} s, data "
          f"{t_warm - t_made:.3f} s, warm-up {setup_s - (t_warm - t_start):.3f} s")

    if traced:
        ctx = {"op": work.op, "enqueue_s": rec.enqueue_s, "trace": summary,
               "rows": work.rows, "length": work.length,
               "traced_calls": len(rec.traced_buffers),
               "traced_stream_words": sum(words[b] for b in rec.traced_buffers)}
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        gbps = window_calls * work.batch_bytes / elapsed / 1e9
        values = {"encode_GBps": gbps if work.op == "encode" else None,
                  "decode_GBps": gbps if work.op == "decode" else None,
                  "batch_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                  "setup_s": setup_s}
        metrics = {}
        for m in cell.end_to_end:
            if values.get(m["name"]) is None:
                raise KeyError(f"{cell.name} has no reading of {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(work.dev.device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    checks = {name: {"value": v, "limit": check.LIMITS[name]}
              for name, v in got["compared"].items()}
    checks["calls_checked"] = {"value": got["calls_checked"], "at_least": 1}
    correct = (all(c["value"] <= c["limit"] for n, c in checks.items()
                   if "limit" in c)
               and got["calls_checked"] >= 1)
    result = {"correct": correct, "attempted": rec.calls,
              "failed": got["calls_wrong"], "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = trace.breakdown(summary)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _note(f"{cell.name} needs {cell.chips} CUDA card(s); this process "
              f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import deltarice_tpu_torch as program

    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                 program, T0)
    _note(f"card {power_limit()}")
    found = forbidden_loaded()
    if found:
        _note(f"loaded by this run and not allowed: {', '.join(found)}")
        return 1
    for name, c in result["checks"].items():
        bound = (f"limit {c['limit']}" if "limit" in c
                 else f"at least {c['at_least']}")
        _note(f"check {name} {c['value']} {bound}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
