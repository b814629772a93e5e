"""Where the time goes on the long-segment path, on one CUDA card.

Run from the repository root: ``python -m deltarice_tpu_torch.profile_long``.
For each profile it encodes and decodes the published geometry as
``chip_smoke.py`` does (nEDM 1024 x 81920 as 32 chunks of (32, 81920);
NOPTREX 256 x 500000 as 8 chunks of (32, 500000); synthetic data, seed 0)
and prints:

* the host-clock milliseconds of ``*_dispatch`` and ``*_collect`` for
  three repeats, each started on a synchronised card;
* one ``torch.profiler`` window per direction (encode; decode with the split
  switch off and on): the wall milliseconds, the device time summed over
  kernel and memcpy rows only (the profiler's ``aten::`` rows repeat them),
  its share of the wall, and the ten largest device rows.
"""

from __future__ import annotations

import os
import time

import torch

from .utils.profiling import device_rows as _device_rows

SPLIT_ENV = "DELTARICE_TPU_SPLIT_DECODE"
CHUNK_ROWS = 32
REPS = 3
WAVEFORMS = {"nedm": 1024, "noptrex": 256}


def _window(label: str, fn) -> None:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy = sum(ms for ms, _n, _k in rows)
    print(f"  {label}: wall {wall:.1f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f} %)")
    for ms, n, key in rows[:10]:
        print(f"    {ms:9.3f} ms x {n:3d}  {key[:90]}")


def profile_one(name: str) -> None:
    import deltarice_tpu_torch as dt
    from deltarice_tpu_torch import codec
    from deltarice_tpu_torch.models import get_profile

    cfg = get_profile(name).config
    x = get_profile(name).synthetic(WAVEFORMS[name], seed=0)
    chunks = list(x.reshape(-1, CHUNK_ROWS, cfg.waveform_length))
    print(f"== {name} {x.shape} M={cfg.m}")
    os.environ[SPLIT_ENV] = "0"
    streams = dt.compress_batch(chunks, cfg, device="cuda")  # warm-up
    for split in (False, True):
        os.environ[SPLIT_ENV] = "1" if split else "0"
        dt.decompress_batch(streams, cfg, device="cuda")
    for r in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = codec.compress_batch_dispatch(chunks, cfg, "cuda")
        t1 = time.perf_counter()
        codec.compress_batch_collect(h, cfg)
        t2 = time.perf_counter()
        print(f"  encode rep {r}: dispatch {(t1 - t0) * 1e3:.1f} ms, "
              f"collect {(t2 - t1) * 1e3:.1f} ms")
    for split in (False, True):
        os.environ[SPLIT_ENV] = "1" if split else "0"
        for r in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = codec.decompress_batch_dispatch(streams, cfg, "cuda")
            t1 = time.perf_counter()
            codec.decompress_batch_collect(h)
            t2 = time.perf_counter()
            print(f"  decode split={split} rep {r}: dispatch "
                  f"{(t1 - t0) * 1e3:.1f} ms, collect {(t2 - t1) * 1e3:.1f} ms")
    os.environ[SPLIT_ENV] = "0"
    _window("encode", lambda: dt.compress_batch(chunks, cfg, device="cuda"))
    for split in (False, True):
        os.environ[SPLIT_ENV] = "1" if split else "0"
        _window(f"decode split {'on' if split else 'off'}",
                lambda: dt.decompress_batch(streams, cfg, device="cuda"))
    os.environ[SPLIT_ENV] = "0"


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_long: needs a CUDA card")
        return 2
    for name in WAVEFORMS:
        profile_one(name)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
