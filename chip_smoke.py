#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deltarice_tpu_torch``) on one card.

Run from the repository root: ``python3 chip_smoke.py``. It builds the CUDA
kernels from ``deltarice_tpu_torch/csrc`` and the native C codec from
``deltarice_tpu/native/src``, then, in order:

1. prints the card's name and power limit (nvidia-smi) and the build time;
2. holds each kernel against its plain torch version (run on a CPU copy of
   the same inputs) at the main path's shapes — 2048 Nab segments of 7000
   samples, M=8 — exact equality, and times kernel and plain version on
   the card with CUDA events;
3. round-trips the 8 committed golden vectors with ``device="cuda"``;
4. drives the main path: ``compress_batch`` / ``decompress_batch`` of 64
   Nab chunks of (32, 7000) int16; every stream must equal the native C
   codec's byte for byte, every chunk must decode exactly, and the pack,
   unpack and transpose kernels must each have launched;
5. prints a JSON line of the kernels, then the JSON ``ok`` line last.

Any failed phase exits nonzero before the ``ok`` line. Without a CUDA card,
or outside a checkout of the repository, it exits nonzero at once. Imports
no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "golden"
ROWS, LENGTH, CHUNK_ROWS = 2048, 7000, 32
REF_C_GBPS = 2.0 / (1.0 / 2.387 + 1.0 / 1.782)  # reference C write/read, hmean


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card's timeline, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def signed(t):
    """uint32 tensors as int32 bit patterns (torch's uint32 has no
    arithmetic); other tensors as they are."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def max_err(got, want) -> int:
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"shape/dtype {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.cpu().to(torch.int64) - want.cpu().to(torch.int64))
               .abs().max())


def phase_device() -> None:
    from deltarice_tpu_torch import native
    from deltarice_tpu_torch.ops import _kernels


    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    _kernels.library()
    t1 = time.perf_counter()
    check(native.codec_lib() is not None, "native C codec did not build")
    t2 = time.perf_counter()
    print(f"[1 device] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__} CUDA {torch.version.cuda}; kernels built in "
          f"{t1 - t0:.3f} s, native codec in {t2 - t1:.3f} s")


def phase_kernels(x_np) -> list[dict]:
    """Each kernel vs its plain version at the main path's shapes."""
    import deltarice_tpu_torch as dt
    from deltarice_tpu_torch.codec import (
        _words_hint, frame_stream, gather_segments, walk_headers)
    from deltarice_tpu_torch.ops.concentrate_cuda import (
        concentrate_packed, concentrate_packed_plain, staged_planes)
    from deltarice_tpu_torch.ops.pack_cuda import pack_encode, pack_encode_plain
    from deltarice_tpu_torch.ops.prefilter import prefilter_encode
    from deltarice_tpu_torch.ops.rice import codeword_lengths_values, zigzag
    from deltarice_tpu_torch.ops.transpose_cuda import (
        transpose2d, transpose2d_plain)
    from deltarice_tpu_torch.ops.unpack_cuda import (
        unpack_decode, unpack_decode_plain)

    cfg = dt.RiceConfig(8, LENGTH)
    k = cfg.k
    x = torch.from_numpy(x_np)
    xc = x.cuda()
    nv = torch.full((ROWS,), LENGTH, dtype=torch.int32)
    nvc = nv.cuda()
    cap = _words_hint(x_np, cfg, LENGTH)
    rows = []

    def record(name, src, replaces, err, ms, plain_ms, shape):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "shape": shape})
        print(f"[2 kernels] {name} {shape}: max_abs_err {err}, kernel "
              f"{ms:.4f} ms, plain torch on the card {plain_ms:.4f} ms")
        check(err == 0, f"{name} disagrees with its plain version")

    # B4 on the int16 samples and on uint32 words
    gen = torch.Generator().manual_seed(0)
    words_u32 = torch.randint(-2**31, 2**31, (ROWS, 1280), generator=gen,
                              dtype=torch.int64).to(torch.int32).view(torch.uint32)
    err = 0
    for a in (x, words_u32):
        got = transpose2d(a.cuda())
        torch.cuda.synchronize()
        want = transpose2d(a)  # CPU copy: the plain version
        err = max(err, max_err(signed(got), signed(want)))
    record("transpose2d", "deltarice_tpu_torch/csrc/transpose.cu",
           "deltarice_tpu/ops/transpose_pallas.py:21", err,
           cuda_ms(lambda: transpose2d(xc), 20),
           cuda_ms(lambda: transpose2d_plain(xc), 20),
           [ROWS, LENGTH])

    # B1 at the main path's hint cap
    xt = x.t().contiguous()
    xtc = xt.cuda()
    got = pack_encode(xtc, nvc, None, k, True, cap)
    torch.cuda.synchronize()
    want = pack_encode(xt, nv, None, k, True, cap)
    err = max(max_err(g, w) for g, w in zip(got, want))
    record("pack_encode", "deltarice_tpu_torch/csrc/pack.cu",
           "deltarice_tpu/ops/pack_pallas.py:62", err,
           cuda_ms(lambda: pack_encode(xtc, nvc, None, k, True, cap), 20),
           cuda_ms(lambda: pack_encode_plain(xtc, nvc, None, k, True,
                                                    cap), 5),
           [LENGTH, ROWS])

    # B2 on the framed streams as the decoder gathers them (word-major,
    # >= 1 zero pad word)
    words_t, nwords, _ = want
    check(int(nwords.max()) <= cap, "Nab rows overflowed the hint cap")
    words_i32 = words_t.t().contiguous()
    buf = np.frombuffer(frame_stream(ROWS * LENGTH,
                                     words_i32.numpy().view(np.uint32),
                                     nwords.numpy()), dtype="<u4")
    counts, starts = walk_headers(buf, ROWS)
    g = gather_segments(buf, counts, starts)
    wt = torch.from_numpy(np.ascontiguousarray(g.T).view(np.int32))
    wtc = wt.cuda()
    got = unpack_decode(wtc, LENGTH, k)
    torch.cuda.synchronize()
    want = unpack_decode(wt, LENGTH, k)
    err = max_err(got, want)
    check(torch.equal(want, xt), "plain decode does not return the samples")
    record("unpack_decode", "deltarice_tpu_torch/csrc/unpack.cu",
           "deltarice_tpu/ops/unpack_pallas.py:171", err,
           cuda_ms(lambda: unpack_decode(wtc, LENGTH, k), 20),
           cuda_ms(lambda: unpack_decode_plain(wtc, LENGTH, k, True), 1),
           [int(wt.shape[0]), ROWS])

    # B3 on TPU-encoder staging: slot = sample index, one live slot per word
    lens, _ = codeword_lengths_values(zigzag(prefilter_encode(x)), k)
    slots = (LENGTH // 512 + 1) * 512
    lead, follow = staged_planes(lens, words_i32, slots)
    leadc, followc = lead.cuda(), follow.cuda()
    got = concentrate_packed((leadc, followc), cap, True)
    torch.cuda.synchronize()
    want = concentrate_packed((lead, follow), cap, True)
    err = max_err(got, want)
    check(torch.equal(want, words_i32), "plain concentration lost words")
    record("concentrate_packed", "deltarice_tpu_torch/csrc/concentrate.cu",
           "deltarice_tpu/ops/concentrate_pallas.py:69", err,
           cuda_ms(lambda: concentrate_packed((leadc, followc), cap,
                                                     True), 20),
           cuda_ms(lambda: concentrate_packed_plain((leadc, followc),
                                                           cap, True), 5),
           [ROWS, slots])
    return rows


def phase_golden() -> None:
    import deltarice_tpu_torch as dt

    cases = json.loads((GOLDEN / "manifest.json").read_text())
    for case in cases:
        cfg = dt.RiceConfig.from_cd_values(case["cd_values"])
        data = np.load(GOLDEN / f"{case['name']}.npy")
        blob = (GOLDEN / f"{case['name']}.bin").read_bytes()
        check(dt.compress(data, cfg, device="cuda") == blob,
              f"golden {case['name']}: compressed bytes differ")
        check(np.array_equal(dt.decompress(blob, cfg, device="cuda"), data),
              f"golden {case['name']}: decoded samples differ")
    print(f"[3 golden] {len(cases)} of {len(cases)} cases byte-identical "
          f"both ways on the card")


def phase_main_path(x_np) -> dict:
    import deltarice_tpu_torch as dt
    from deltarice_tpu_torch import native
    from deltarice_tpu_torch.ops import _kernels

    cfg = dt.RiceConfig(8, LENGTH)
    chunks = list(x_np.reshape(ROWS // CHUNK_ROWS, CHUNK_ROWS, LENGTH))
    _kernels.reset_launches()
    streams = dt.compress_batch(chunks, cfg, device="cuda")
    back = dt.decompress_batch(streams, cfg, device="cuda")
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    cd = cfg.to_cd_values()
    for i, (c, s, b) in enumerate(zip(chunks, streams, back)):
        check(s == native.native_compress(c, cd),
              f"chunk {i}: stream differs from native dr_compress")
        check(np.array_equal(b, c.ravel()), f"chunk {i}: decode differs")
        check(np.array_equal(native.native_decompress(s, cd), c.ravel()),
              f"chunk {i}: native dr_decompress disagrees")
    print(f"[4 main path] {len(chunks)} chunks of ({CHUNK_ROWS}, {LENGTH}) "
          f"int16: every stream equals native dr_compress, every chunk "
          f"decodes exactly; launches {json.dumps(launches, sort_keys=True)}")
    for name in ("pack_encode", "unpack_decode", "transpose2d"):
        check(launches.get(name, 0) > 0, f"main path never launched {name}")
    raw = x_np.nbytes
    comp = sum(len(s) for s in streams)
    enc_ms = cuda_ms(lambda: dt.compress_batch(chunks, cfg,
                                                      device="cuda"), 3)
    dec_ms = cuda_ms(lambda: dt.decompress_batch(streams, cfg,
                                                        device="cuda"), 3)
    enc, dec = raw / enc_ms / 1e6, raw / dec_ms / 1e6
    hmean = 2.0 / (1.0 / enc + 1.0 / dec)
    print(f"[4 main path] {raw} raw bytes, ratio {comp / raw:.6f}; encode "
          f"{enc_ms:.3f} ms = {enc:.4f} GB/s, decode {dec_ms:.3f} ms = "
          f"{dec:.4f} GB/s, harmonic mean {hmean:.4f} GB/s = "
          f"{hmean / REF_C_GBPS:.4f}x the reference C's {REF_C_GBPS:.3f}")
    return launches


def run() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this run needs one", file=sys.stderr)
        return 2
    if not (ROOT / "deltarice_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: run from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from deltarice_tpu_torch.models import get_profile

    try:
        phase_device()
        x_np = get_profile("nab").synthetic(ROWS, seed=0)
        kernels = phase_kernels(x_np)
        phase_golden()
        launches = phase_main_path(x_np)
        check("jax" not in sys.modules and "deltarice_tpu" not in sys.modules,
              "the port imported JAX or the JAX package")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for row in kernels:
        row["launches"] = launches.get(row["name"], 0)
        row["on_main_path"] = row["name"] != "concentrate_packed"
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
