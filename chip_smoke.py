#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deltarice_tpu_torch``) on one card.

Run from the repository root: ``python3 chip_smoke.py``. It builds the CUDA
kernels from ``deltarice_tpu_torch/csrc`` and the native C codec from
``deltarice_tpu_torch/native/src``, then, in order:

1. prints the card's name and power limit (nvidia-smi) and the build time;
2. holds B1-B4 against their plain torch versions (run on a CPU copy of
   the same inputs, B4's on the card) at the Nab path's shapes — 2048 Nab
   segments of 7000 samples, M=8 — exact equality, and times kernel and
   plain version with CUDA events; B4 also at the JAX package's batched
   shapes of its transpose (``profile_transpose.SHAPES``) and on two edge
   inputs (a ragged shape, a view off its 16-byte boundary), timed in CUDA
   graphs warm and cold (rotated over buffer pairs, at least
   ``profile_transpose.COLD_BYTES`` between reuses) beside its one-call
   PyTorch yardstick and the card's copy rate, and its SASS checked for
   128-bit accesses (``cuobjdump``);
3. round-trips the 8 committed golden vectors with ``device="cuda"``;
4. drives the Nab path: ``compress_batch`` / ``decompress_batch`` of 64
   Nab chunks of (32, 7000) int16; every stream must equal the native C
   codec's byte for byte, every chunk must decode exactly, and the pack
   and unpack kernels must each have launched;
5. drives the long-segment path on nEDM (1024 x 81920, M=16, as 32 chunks
   of (32, 81920)) and NOPTREX (256 x 500000, M=8, as 8 chunks of
   (32, 500000)): the sub-block split encode with its device merge (B3 for
   nEDM, B5 for NOPTREX), the exact decode (B2) with the split switch off
   and the speculative split decode (B9 + B6) with it on; every stream
   must equal native ``dr_compress``, every chunk must decode exactly both
   ways and through native ``dr_decompress``, the split decode must flag
   the segments it flagged before (nEDM 3, NOPTREX 98), and each kernel of
   the path must have launched;
6. holds B3, B5, B6 and B9 against their plain versions on the inputs the
   long-segment path gave them (B9's plain loop on its first 64 segments),
   times B9's passes with one ``torch.profiler`` repeat of launches
   stopped after each pass and splits the split decode layer's device
   time into B9, B6 and the merge's torch glue,
   B1 at the NOPTREX split's sub-row shape and B2 at one NOPTREX h5
   bucket's shape (64 segments; its plain version there is the plain model
   of its tiled passes, ``ops/tiled_model.py``), and B7 (nEDM) and B8
   (NOPTREX) on the tiled staging the JAX decode kernel emits for the same
   decode buckets, which must concentrate back into the decoded samples
   (the port's own decode makes no staging, so its path launches neither),
   with the split of B7's and B8's time (all-dead, all-at-displacement-0
   and staging inputs, the staging also in one ``torch.profiler`` repeat
   split into the intermediate's memset, pass 1 and pass 2, and pass 1's
   stores as the plain model of their walk counts them), B7 in packed and
   u32-with-follower modes, and a check of their SASS (``cuobjdump``): no
   call to a division routine;
7. drives the HDF5 entry point on an in-memory direct-chunk store
   (``tools.memstore.MemGroup``; the card's machine has no h5py):
   ``h5.write_dataset``
   and ``h5.read_dataset`` of Nab 2000 x 7000 in (32, 7000) chunks (the
   last an edge chunk), nEDM 1024 x 81920 and NOPTREX 256 x 500000 in
   (32, L) chunks, in 4 windows each, on the data of phases 4-5; every
   stored blob must equal native ``dr_compress`` of its zero-padded chunk,
   and the read must give back the input with the split switch off and on;
8. checks the one-window-deep pipeline: collect of a Nab encode window
   must return while the decode of a later NOPTREX bucket, queued behind
   a spin kernel of about 0.2 s, is still running on the card;
9. runs ``optimize`` over the whole Nab dataset on the card (and on its
   first 64 rows against ``device="cpu"``; phase 13 takes its n_taps=3
   choice), then the CLI's ``warmup`` and ``install-plugin`` as
   subprocesses;
10. checks that no counted window launched B4 (every codec kernel reads
   segment-major arrays), then prints a JSON line of the kernels — each
   row with its launches on the path, its time, its plain version's, the
   one-call PyTorch yardstick's where there is one, and its bound: the
   bytes its inputs need and its outputs take over the H100's 3.35 TB/s;
   B3 has a row at the Nab staging and one at the nEDM merge;
11. drives the chunk data parallelism (``deltarice_tpu_torch.parallel``):
   a world of one rank over NCCL (a ``file://`` store) encodes and decodes
   phase 4's 64 Nab chunks and phase 5's 8 NOPTREX chunks through
   ``encode_chunks_multihost`` / ``decode_chunks_multihost`` (whole
   segments, worst-case width, no split) and ``roundtrip_check_step``;
   every stream must equal native ``dr_compress``, every decode the input,
   no lossless sample may mismatch, and B1 and B2 must launch; it prints the
   one-rank overhead on the Nab chunks as JSON
   (``tools.singlechip_scaling.mesh_of_one_overhead``: the sharded path
   against ``encode_segments`` / ``decode_segments`` and the multihost path
   against ``compress_batch`` / ``decompress_batch``). Then two ranks over
   gloo share the
   card through ``python -m deltarice_tpu_torch.examples.sharded_encode``
   on 64 and 63 Nab chunks (63 pads with an empty chunk): rank 0's streams
   and decode must be exact, rank 1 gets None, B1 and B2 launch in both
   ranks, and a lossy round-trip check (filter ``LOSSY_FILTER``) must give
   both ranks the count one rank gives on the whole batch. Where the
   machine has several cards, the example runs again over NCCL on 64 and
   63 chunks, one rank per card (up to 4); this phase's launches join the
   counted windows;
12. runs the port's measurement tools in this process, each tool's JSON on
   a line of its own, every launch in a counted window: ``bench.run`` at
   2048 x 7000 and one subprocess ``python -m deltarice_tpu_torch.bench``
   whose last line must parse, its output then handed to
   ``tools.perf_gate.main`` three times, each verdict on a line of its own:
   against the committed baselines (exit 0 or 1, a ``FAIL`` fails nothing
   here: the gate's mechanics are checked, not the card's speed that day;
   the fresh value it prints must be the line's), against a baseline of
   this card 25 % above the fresh value (exit 1, ``FAIL``) and against one
   of another card (exit 0, no baseline); ``tools.bench_geometries`` on its
   seven configs (nEDM and NOPTREX with the split switch off and on), whose
   ratios and split parts must equal ``GEOMETRY_BENCH.json``'s;
   ``tools.fuzz_native`` on 60 cases of seed 0 with no failure (2-6 s on
   an H100 since the generic inverse became a kernel; its ``slowest``
   cases, 28, 31 and 43, take 0.1-0.5 s each, where cases 31 and 58 took
   12-13 s each through the per-sample loop);
   ``tools.bench_file`` on the in-memory store, three geometries at 64 MB;
   ``tools.profile_stages`` at Nab and nEDM; ``tools.singlechip_scaling``;
   ``tools.scaling_bench`` over NCCL on the cards present, 64 Nab chunks of
   (32, 7000) a rank. No window may launch B4, and B1, B2, B3, B5, B6 and
   B9 must each launch;
13. drives the generic-filter path, whose decode ends in the generic
   pre-filter inverse's kernels (``iir_decode``, ``csrc/prefilter.cu``,
   the counterpart of the JAX package's ``lax.scan``: the blocked scan for
   lossless filters of up to 8 history taps, the serial walk for the
   rest), every launch in a counted window: ``compress_batch`` /
   ``decompress_batch`` of phase 4's 64 Nab chunks with the (M, filter)
   that phase 9's ``optimize(n_taps=3)`` chose, with (-1, 1) and with
   ``LOSSY_FILTER``, ``h5.write_dataset`` / ``h5.read_dataset`` of Nab
   2000 x 7000 with the optimizer's choice (split switch off and on), and
   phase 5's 8 NOPTREX chunks with ``NOPTREX_FILTER`` at
   ``NOPTREX_FILTER_M`` (the split encode's FIR halo; the decode after B2
   and, switch on, after B9 + B6); every stream and blob must equal native
   ``dr_compress``, every lossless decode the input and the lossy one
   native ``dr_decompress``'s output, every decode and read must launch
   ``iir_decode`` by the path its filter calls for (the lossy one serial,
   the others blocked), and a spy on the plain version
   (``ops/prefilter.py::iir_decode_plain``) must see no CUDA tensor. Then
   the kernels against their plain version (on a CPU copy), exactly, each
   call by the path ``ops/prefilter_model.py::plan`` gives: the blocked
   scan at Nab (2048, 7000) with the optimizer's filter and at one NOPTREX
   h5 bucket (64, 500000) (the plain version on its first
   ``NOPTREX_PLAIN`` rows x samples), the serial walk on a seeded 12-tap
   filter, on the division's edges (``IIR_EDGES``: a leading tap that
   wraps to 0 gives -1 everywhere, -32768 / -1) and on filters of
   ``IIR_LONG_TAPS`` taps (history in shared, then global memory); their
   times in CUDA graphs and in a host loop at Nab, with the lossy filter,
   at the bucket and at one chunk (32, 500000), the blocked ones split
   into passes A, B and C by a ``torch.profiler`` repeat, beside the
   serial walk on the same inputs (``iir_decode_serial``, the design the
   blocked scan replaced) and the plain version on the card; and the
   inverse's share of the NOPTREX generic decode;
14. feeds the port hostile streams at the full chunk shapes of Nab, nEDM
   and NOPTREX (``tests/hostile_cases.py``, imported by path, the corpus
   ``tests/test_torch_robustness.py`` holds against the JAX package on the
   CPU): truncations, single-bit flips, lying totals, the empty stream,
   one segment credited with every word, bad payloads behind valid
   headers, and flips of Nab's generic-filter streams. Each stream that
   fails the header walk goes through ``decompress`` on the card alone;
   the rest go through one ``decompress_batch`` with the split switch off
   and on. Every outcome must equal the reference's (both raise
   ``ValueError``, or both return equal arrays): the port's CPU decode
   for Nab, native ``dr_decompress`` for nEDM and NOPTREX (whose plain
   decode takes minutes a corpus; the CPU tests hold the two equal). A
   valid decode after each corpus must be exact. Then verify-retry: a
   transient payload fault and a cut header through ``compress_batch
   (verify=True)`` (Nab, and 8 chunks of each long geometry, whose
   re-encodes merge through B3 and B5) recover to native ``dr_compress``'s
   bytes, split switch off and on, and a persistent fault raises
   ``RuntimeError``; ``h5.write_dataset(verify=True)`` repairs a fault in
   the second of three windows, a read with a truncated chunk raises
   ``ValueError`` and the next read is exact. These runs are counted
   (path ``hostile``) and must launch B1, B2, B3, B5, B6, B9 and the
   generic inverse. Then B2, B9 + B6 and the inverse on hostile words
   with each input before two random guard tails (equal outputs; equal to
   the plain version at Nab), and a subprocess (``chip_smoke.py
   --memcheck``: one corrupt bucket of each geometry, split off and on,
   and a verify-retry each) under ``compute-sanitizer --tool memcheck``,
   whose summary must be 0 errors; where the toolkit has no
   compute-sanitizer, or it refuses the card, it prints "not checked".
15. holds every kernel's global-memory accesses to the buffers its
   wrapper hands it, under the guard-page allocator of
   ``deltarice_tpu_torch/testing/guard.py`` (each allocation its own
   reservation, poison-filled, with a never-mapped granule after it,
   ``end``, or before it, ``front``): first the positive control (two
   children that must die with an illegal address one byte past an end
   buffer and one before a front buffer, after reading the last and the
   first byte), then ``chip_smoke.py --guard end --fill 165`` and
   ``--guard front --fill 90`` as two children run together
   (:func:`guard_child`), each over every case of :func:`guard_cases`
   (a: the memcheck set; b: B2, B9 + B6 and the inverse on the hostile
   planes and on planes of width 1 and 2 and full rows; c: every kernel
   at ragged shapes against its plain version, B4, B7 and B8 included;
   d: ``compress_batch`` over the cap at every geometry), with every
   kernel input an allocation of its own. Every output must equal its
   reference and hash alike in both children, each child must launch all
   13 wrappers and the inverse's three paths, and a child that dies is
   named by the case it left unfinished and its CUDA error;
   then the JSON line of the kernels and the JSON ``ok`` line last.

Each phase prints its seconds. Before the last lines it checks that no
process it started (a rank, a subprocess, multiprocessing's resource
tracker) is left running or unreaped. Any failed phase exits nonzero
before the ``ok`` line. Without a CUDA card, or outside a checkout of the repository,
it exits nonzero at once. Imports no JAX.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "golden"
ROWS, LENGTH, CHUNK_ROWS = 2048, 7000, 32
LONG = {"nedm": 1024, "noptrex": 256}  # waveforms of each long profile
B9_PLAIN_SEGMENTS = 64  # segments B9's plain loop decodes on the card
B9_PASSES = ("staging", "A (phase-0 walks)", "B (joins, resolve)",
             "C (decode, stores, zeros)")
# segments the split decode flags for an exact re-decode (data of seed 0)
FLAGGED = {"nedm": 3, "noptrex": 98}
# the HDF5 phase: rows of each dataset and chunks per window (4 windows)
H5_ROWS = {"nab": 2000, "nedm": 1024, "noptrex": 256}
H5_WINDOW = {"nab": 16, "nedm": 8, "noptrex": 2}
SPLIT_ENV = "DELTARICE_TPU_SPLIT_DECODE"
# B7 and B8 compact TPU decode staging, which the port's decode never makes
STAGING_KERNELS = ("concentrate_tiled", "concentrate_tiled_vd")
REF_C_GBPS = 2.0 / (1.0 / 2.387 + 1.0 / 1.782)  # reference C write/read, hmean
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
OPT_BUCKET = 64  # segments of one NOPTREX h5 decode bucket (2 chunks of 32)
SPIN_CYCLES = 400_000_000  # phase 8's torch.cuda._sleep: about 0.2 s
# phase 11: a pre-filter whose inverse divides by 8, so 8x wraps int16 on
# Nab's largest samples (|x| > 4096) and the round trip loses samples; with
# filt[0] = 2 Nab's amplitude (at most 4324) would round-trip exactly
LOSSY_FILTER = (8, -1)
MAX_WORLD = 4  # ranks of the NCCL run over several cards
# phase 13, the generic-filter path: NOPTREX's filter, the rows x samples of
# NOPTREX's input the plain version checks (the inverse is causal, so a
# prefix of the input gives a prefix of the output) and times, and the
# division's edges (a leading tap that wraps to 0, -32768 / -1, large
# divisors)
NOPTREX_FILTER = (1, -1, 0, 1)
# its M: the filter widens NOPTREX's residuals, so at the profile's M=8 the
# streams grow to ~24 bits a sample and the split decode's router declines
# them; at M=512 they take ~11 bits and the router splits them in 32
NOPTREX_FILTER_M = 512
NOPTREX_PLAIN = (OPT_BUCKET, 50_000)
NOPTREX_PLAIN_TIMED = 5_000
IIR_EDGES = ((65536, -1), (65536,), (-1,), (-32768, 5, -7), (65535, 3))
# filters longer than the 1024 taps the card once refused: history in
# shared memory, then (past the device's opt-in) in global memory
IIR_LONG_TAPS = (1100, 2500)
# the blocked scan's passes by kernel name, for the profiler's split
IIR_PASSES = {"A": "exit_kernel", "B": "carry_kernel", "C": "walk_kernel"}
FUZZ_CASES = 60  # phase 12's differential fuzz against the native codec
# phase 14, hostile streams at the full chunk shapes: single-bit flips of
# each geometry's stream (NOPTREX's batch must stay within the split
# router's 16384 sub-rows at 32 parts), at most this many truncations, the
# flips of each generic filter's stream, and the memcheck subprocess's
# flips a stream and time limit
HOSTILE_FLIPS = {"nab": 300, "nedm": 32, "noptrex": 12}
HOSTILE_CUTS = 64
HOSTILE_FILTER_FLIPS = 24
MEMCHECK_FLIPS = 6
MEMCHECK_TIMEOUT = 600
GUARD = 1 << 16  # random elements after a kernel's input in phase 14
# phase 15, guard pages and poison fills: the two placements with their
# poison bytes, a child's time before it is killed, every kernel wrapper (by
# its module under ops/) and each path of the generic inverse, all of which
# each child must launch, and the ragged lengths of case c (one sample past
# B1's 1024-sample tile, ...)
GUARD_RUNS = (("end", 0xA5), ("front", 0x5A))
GUARD_TIMEOUT = 300
GUARD_WRAPPERS = {
    "pack_cuda": ("pack_encode",),
    "unpack_cuda": ("unpack_decode", "unpack_tables"),
    "concentrate_cuda": ("concentrate_packed", "concentrate_wide",
                         "concentrate_wide16"),
    "concentrate_tiled_cuda": ("concentrate_tiled", "concentrate_tiled_vd"),
    "split_decode_cuda": ("split_decode", "split_decode_passes"),
    "transpose_cuda": ("transpose2d",),
    "prefilter_cuda": ("iir_decode", "iir_decode_serial"),
}
GUARD_KERNELS = tuple(n for names in GUARD_WRAPPERS.values() for n in names)
IIR_PATHS = ("iir_decode.blocked", "iir_decode.one_walk", "iir_decode.serial")
RAGGED_N = (1, 7, 9, 1025, 4099, 7001)
GUARD_MADE_ROWS = 2  # rows of case b's planes of width 1, 2 and full rows
# why no single PyTorch call computes a kernel's function (library_ms null)
NO_LIBRARY = {
    "pack_encode": "no PyTorch call Rice-codes or bit-packs",
    "unpack_decode": "no PyTorch call decodes a Rice stream",
    "split_decode": "no PyTorch call decodes a Rice stream",
    "iir_decode": "no PyTorch call runs a recurrence with int16 wrap and "
                  "truncating division",
    "concentrate_packed": "a scatter needs the destination plane slot - disp "
                          "and a dump slot for dead slots built first",
}
for _name in ("concentrate_wide", "concentrate_wide16", "concentrate_tiled",
              "concentrate_tiled_vd"):
    NO_LIBRARY[_name] = NO_LIBRARY["concentrate_packed"]


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def child_processes() -> list[str]:
    """Each child of this process that is still running or not reaped:
    its pid and command line (zombies have an empty one)."""
    task = Path(f"/proc/{os.getpid()}/task")
    pids = {pid for t in task.iterdir()
            for pid in (t / "children").read_text().split()}
    out = []
    for pid in sorted(pids):
        try:
            cmd = (Path("/proc") / pid / "cmdline").read_bytes()
        except OSError:
            continue  # ended and reaped since the listing
        cmd = cmd.replace(b"\0", b" ").decode(errors="replace").strip()
        out.append(f"{pid} {cmd}")
    return out


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n: int) -> float:
    """Least milliseconds for the card to move ``n`` bytes (each input
    read once, each output written once) at its memory rate."""
    return n / HBM_BYTES_PER_S * 1e3


def max_err(got, want) -> int:
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"shape/dtype {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.cpu().to(torch.int64) - want.cpu().to(torch.int64))
               .abs().max())


def phase_device() -> str:
    """Build the kernels and the native codec; returns the card's name
    and power limit as nvidia-smi gives them."""
    from deltarice_tpu_torch import native
    from deltarice_tpu_torch.ops import _kernels
    from deltarice_tpu_torch.utils.profiling import card as card_of

    try:
        card = card_of("cuda:0")
    except RuntimeError as e:
        raise SmokeFailure(str(e)) from e
    print(card)
    t0 = time.perf_counter()
    _kernels.library()
    t1 = time.perf_counter()
    check(native.codec_lib() is not None, "native C codec did not build")
    t2 = time.perf_counter()
    print(f"[1 device] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__} CUDA {torch.version.cuda}; kernels built in "
          f"{t1 - t0:.3f} s, native codec in {t2 - t1:.3f} s")
    return card


def phase_kernels(x_np, card: str) -> list[dict]:
    """Each kernel vs its plain version at the main path's shapes."""
    import deltarice_tpu_torch as dt
    from deltarice_tpu_torch.codec import (
        _words_hint, frame_stream, gather_segments, walk_headers)
    from deltarice_tpu_torch.ops.concentrate_cuda import (
        concentrate_packed, concentrate_packed_plain, staged_planes)
    from deltarice_tpu_torch.ops.pack_cuda import pack_encode, pack_encode_plain
    from deltarice_tpu_torch.ops.prefilter import prefilter_encode
    from deltarice_tpu_torch.ops.rice import codeword_lengths_values, zigzag
    from deltarice_tpu_torch.ops.unpack_cuda import (
        unpack_decode, unpack_decode_plain)
    from deltarice_tpu_torch.utils.profiling import graph_ms

    cfg = dt.RiceConfig(8, LENGTH)
    k = cfg.k
    x = torch.from_numpy(x_np)
    xc = x.cuda()
    nv = torch.full((ROWS,), LENGTH, dtype=torch.int32)
    nvc = nv.cuda()
    cap = _words_hint(x_np, cfg, LENGTH)
    rows = []

    def record(name, src, replaces, err, fn, plain, plain_reps, shape,
               moved):
        """The kernel's row: ``fn`` timed by ``cuda_ms`` (20 calls, the
        wrapper's host cost included, like for like with earlier runs) and
        in a CUDA graph (its device time alone), then ``plain``."""
        ms = cuda_ms(fn, 20)
        plain_ms = cuda_ms(plain, plain_reps)
        graph = graph_ms([fn])
        row = kernel_row(name, src, replaces, err, ms, plain_ms, shape,
                         moved, None, "nab")
        row["graph_ms"] = graph
        rows.append(row)
        print(f"[2 kernels] {name} {shape}: max_abs_err {err}, kernel "
              f"{ms:.4f} ms (in a CUDA graph {graph:.4f} ms), plain torch "
              f"on the card {plain_ms:.4f} ms, bound {bound_ms(moved):.4f} "
              f"ms")
        check(err == 0, f"{name} disagrees with its plain version")

    # B1 at the main path's hint cap, segment-major
    got = pack_encode(xc, nvc, None, k, True, cap)
    torch.cuda.synchronize()
    want = pack_encode(x, nv, None, k, True, cap)
    err = max(max_err(g, w) for g, w in zip(got, want))
    words, nwords, _ = want
    record("pack_encode", "deltarice_tpu_torch/csrc/pack.cu",
           "deltarice_tpu/ops/pack_pallas.py:62", err,
           lambda: pack_encode(xc, nvc, None, k, True, cap),
           lambda: pack_encode_plain(xc, nvc, None, k, True, cap), 5,
           [ROWS, LENGTH], pack_bytes(nv, nwords))

    # B2 on the framed streams as the decoder gathers them (segment-major,
    # >= 1 zero pad word)
    check(int(nwords.max()) <= cap, "Nab rows overflowed the hint cap")
    buf = np.frombuffer(frame_stream(ROWS * LENGTH,
                                     words.numpy().view(np.uint32),
                                     nwords.numpy()), dtype="<u4")
    counts, starts = walk_headers(buf, ROWS)
    wt = torch.from_numpy(gather_segments(buf, counts, starts).view(np.int32))
    wtc = wt.cuda()
    got = unpack_decode(wtc, LENGTH, k)
    torch.cuda.synchronize()
    want = unpack_decode(wt, LENGTH, k)
    err = max_err(got, want)
    check(torch.equal(want, x), "plain decode does not return the samples")
    record("unpack_decode", "deltarice_tpu_torch/csrc/unpack.cu",
           "deltarice_tpu/ops/unpack_pallas.py:171", err,
           lambda: unpack_decode(wtc, LENGTH, k),
           lambda: unpack_decode_plain(wtc, LENGTH, k, True), 1,
           [ROWS, int(wt.shape[1])], unpack_bytes(counts, got))

    # B3 on TPU-encoder staging: slot = sample index, one live slot per word
    lens, _ = codeword_lengths_values(zigzag(prefilter_encode(x)), k)
    slots = (LENGTH // 512 + 1) * 512
    lead, follow = staged_planes(lens, words, slots)
    leadc, followc = lead.cuda(), follow.cuda()
    got = concentrate_packed((leadc, followc), cap, True)
    torch.cuda.synchronize()
    want = concentrate_packed((lead, follow), cap, True)
    err = max_err(got, want)
    check(torch.equal(want, words), "plain concentration lost words")
    record("concentrate_packed", "deltarice_tpu_torch/csrc/concentrate.cu",
           "deltarice_tpu/ops/concentrate_pallas.py:69", err,
           lambda: concentrate_packed((leadc, followc), cap, True),
           lambda: concentrate_packed_plain((leadc, followc), cap, True), 5,
           [ROWS, slots], nbytes(lead, follow, got))
    # B4 last: its graphs and rotated buffers come after B1-B3's timings
    del lead, follow, leadc, followc, got, want
    rows += b4_rows(x, card)
    return rows


def b4_rows(x, card: str) -> list[dict]:
    """B4 at each of ``profile_transpose.SHAPES`` (the Nab samples ``x``, then
    seeded random data made on the card): equal to its plain version, the
    edge inputs too, then its bound and its times: warm (one buffer pair,
    CUDA graph; and the host loop of ``cuda_ms``, the wrapper's cost
    included), cold (CUDA graph over enough buffer pairs that at least
    ``profile_transpose.COLD_BYTES`` move between two uses of one), the
    plain version,
    the one PyTorch call ``x.transpose(-2, -1).contiguous()`` (the same
    function as the plain version) and, as the card's practical copy rate
    and not the same function, ``torch.empty_like(x).copy_(x)``."""
    from deltarice_tpu_torch.ops.transpose_cuda import (
        transpose2d, transpose2d_plain)
    from deltarice_tpu_torch.profile_transpose import (
        SHAPES, cold_inputs, random)
    from deltarice_tpu_torch.utils.profiling import graph_ms, rotated

    gen = torch.Generator(device="cuda").manual_seed(0)

    def one_call(t):
        return t.transpose(-2, -1).contiguous()

    def copy(t):
        return torch.empty_like(t).copy_(t)

    # edge inputs: a ragged shape, and the Nab shape less one column as a
    # contiguous view 2 bytes off a 16-byte boundary
    flat = random((ROWS * (LENGTH - 1) + 1,), torch.int16, gen)
    edges = [random((33, 65), torch.int16, gen),
             flat[1:].view(ROWS, LENGTH - 1)]
    check(edges[1].data_ptr() % 16 == 2, "the misaligned view is aligned")
    err = 0
    for t in edges:
        err = max(err, max_err(signed(transpose2d(t)),
                               signed(transpose2d_plain(t))))
    check(err == 0, "transpose2d disagrees with its plain version on the "
          "edge inputs")
    print(f"[2 kernels] transpose2d edge inputs (33, 65) int16 and a (2048,"
          f" 6999) int16 view 2 bytes off 16-byte alignment: equal to the "
          f"plain version")
    rows = []
    for label, shape, dtype in SHAPES:
        a = (x.cuda() if shape == (ROWS, LENGTH)
             else random(shape, dtype, gen))
        got = transpose2d(a)
        want = transpose2d_plain(a)
        torch.cuda.synchronize()
        e = max_err(signed(got), signed(want))
        check(e == 0, f"transpose2d disagrees with its plain version at "
              f"{shape}")
        del got, want
        moved = 2 * nbytes(a)
        inputs = cold_inputs(a)
        pairs = len(inputs)
        t = {"warm": graph_ms([lambda: transpose2d(a)]),
             "cold": graph_ms(rotated(transpose2d, inputs)),
             "host": cuda_ms(lambda: transpose2d(a), 20),
             "plain": graph_ms([lambda: transpose2d_plain(a)]),
             "call": graph_ms([lambda: one_call(a)]),
             "call cold": graph_ms(rotated(one_call, inputs)),
             "copy": graph_ms([lambda: copy(a)]),
             "copy cold": graph_ms(rotated(copy, inputs))}
        del inputs
        row = kernel_row("transpose2d", "deltarice_tpu_torch/csrc/transpose.cu",
                         "deltarice_tpu/ops/transpose_pallas.py:21", e,
                         t["warm"], t["plain"], list(shape), moved,
                         t["call"], "nab" if shape == (ROWS, LENGTH)
                         else "jax layout")
        row.update({"dtype": str(dtype).split(".")[-1], "label": label,
                    "cold_ms": t["cold"], "host_loop_ms": t["host"],
                    "library_cold_ms": t["call cold"], "copy_ms": t["copy"],
                    "copy_cold_ms": t["copy cold"],
                    "timing": "CUDA graph of 20 calls, 5 replays"})
        rows.append(row)
        bound = bound_ms(moved)
        print(f"[2 kernels] transpose2d {label} {tuple(shape)} "
              f"{row['dtype']}: equal to the plain version; bound "
              f"{bound:.4f} ms ({moved} B over 3.35 TB/s); kernel warm "
              f"{t['warm']:.4f} ms ({bound / t['warm']:.0%} of the bound), "
              f"cold {t['cold']:.4f} ms ({bound / t['cold']:.0%}; {pairs} "
              f"buffer pairs, {(pairs - 1) * moved / 1e6:.1f} MB between "
              f"reuses), host loop (cuda_ms, the wrapper's host cost "
              f"included) {t['host']:.4f} ms; plain {t['plain']:.4f} ms; "
              f"x.transpose(-2, -1).contiguous() warm {t['call']:.4f} ms, "
              f"cold {t['call cold']:.4f} ms; the card's copy rate "
              f"(empty_like(x).copy_(x), not the same function) warm "
              f"{t['copy']:.4f} ms, cold {t['copy cold']:.4f} ms = "
              f"{moved / t['copy cold'] / 1e9:.3f} TB/s; {card}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    transpose_sass()
    return rows


def sass_functions() -> dict | None:
    """``cuobjdump -sass`` of the kernels' library, by function: its
    lines. None where the toolkit has no cuobjdump."""
    import shutil

    from deltarice_tpu_torch.ops import _kernels

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return None
    res = subprocess.run([tool, "-sass", str(_kernels.build())],
                         capture_output=True, text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr.strip()}")
    funcs, name = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return funcs


def transpose_sass() -> None:
    """B4's vector kernels must load and store device memory 128 bits a
    thread (``LDG.E...128``, ``STG.E.128``) and stage through shared memory
    128 bits a thread (``STS.128``, ``LDS.128``)."""
    funcs = sass_functions()
    if funcs is None:
        print("[2 kernels] SASS: cuobjdump not found, not checked")
        return
    vec = {n: b for n, b in funcs.items() if "transpose_vec_kernel" in n}
    check(len(vec) == 2, f"cuobjdump shows {len(vec)} B4 vector kernels")
    said = []
    for name, body in vec.items():
        ops = collections.Counter(
            m.group(1) for ln in body for m in [re.search(
                r"\b((?:LDGSTS|LDG|STG|LDS|STS)(?:\.[^\s;]+)?)[\s;]", ln)]
            if m)
        wide = {op: n for op, n in ops.items() if op.endswith(".128")}
        for kind in ("LDG", "STG", "LDS", "STS"):
            check(any(op.startswith(kind) for op in wide),
                  f"B4 kernel {name} has no 128-bit {kind}: {dict(ops)}")
        check(wide == dict(ops), f"B4 kernel {name} has narrower accesses: "
              f"{dict(ops)}")
        kind = "int16" if "IsE" in name else "32-bit"
        said.append(f"{kind} {dict(sorted(ops.items()))}, CALL "
                    f"{sum('CALL' in ln for ln in body)}")
    print(f"[2 kernels] SASS of B4's vector kernels: every global and shared "
          f"access 128 bits: " + "; ".join(said))


def pack_bytes(nvalid, nwords) -> int:
    """B1's bytes: the valid samples in, the stream words and per-segment
    counts out (words past each stream are the caller's zeros)."""
    return (2 * int(nvalid.to(torch.int64).sum())
            + 4 * int(nwords.to(torch.int64).sum()) + 12 * nvalid.numel())


def unpack_bytes(counts, out) -> int:
    """B2's bytes: the stream words in (their counts; the bucket's zero
    padding needs no read), the samples out."""
    return 4 * int(np.asarray(counts, dtype=np.int64).sum()) + nbytes(out)


def kernel_row(name, src, replaces, err, ms, plain_ms, shape, moved,
               library_ms, path) -> dict:
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms(moved),
            "bound_by": "bytes", "bytes": moved, "library_ms": library_ms,
            "shape": shape, "path": path}


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
    for name in ("pack_encode", "unpack_decode"):
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


@contextlib.contextmanager
def captured(targets):
    """Record the positional arguments and the host milliseconds of every
    call to each ``(module, name)`` made inside the block, and pass the
    call through: yields ({name: [args, ...]}, {name: [ms, ...]})."""
    calls = {name: [] for _, name in targets}
    ms = {name: [] for _, name in targets}
    saved = []
    for mod, name in targets:
        orig = getattr(mod, name)

        def spy(*args, _orig=orig, _name=name, **kw):
            calls[_name].append(args)
            t0 = time.perf_counter()
            try:
                return _orig(*args, **kw)
            finally:
                ms[_name].append((time.perf_counter() - t0) * 1e3)

        saved.append((mod, name, orig))
        setattr(mod, name, spy)
    try:
        yield calls, ms
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def split_switch(on: bool) -> None:
    os.environ[SPLIT_ENV] = "1" if on else "0"


def phase_long(name: str, x_np) -> tuple[dict, dict]:
    """The long-segment path on one profile: returns (launches of each
    counted window, the kernels' inputs captured in a warm-up run)."""
    import deltarice_tpu_torch as dt
    from deltarice_tpu_torch import codec, native
    from deltarice_tpu_torch.models import get_profile
    from deltarice_tpu_torch.ops import _kernels
    from deltarice_tpu_torch.ops import concentrate as conc_router
    from deltarice_tpu_torch.ops import split_decode as sd

    t0 = time.perf_counter()
    cfg = get_profile(name).config
    length = cfg.waveform_length
    chunks = list(x_np.reshape(-1, CHUNK_ROWS, length))
    parts_enc = codec._split_parts(CHUNK_ROWS, length, cfg)
    # warm-up, capturing what the path hands each kernel
    with captured([(conc_router, "concentrate_packed"),
                   (conc_router, "concentrate_wide"),
                   (sd, "concentrate_wide16"),
                   (sd, "split_decode"),
                   (codec, "pack_encode"),
                   (codec, "unpack_decode"),
                   (codec, "unpack_decode_split")]) as (calls, _ms):
        streams = dt.compress_batch(chunks, cfg, device="cuda")
        dt.decompress_batch(streams, cfg, device="cuda")
        split_switch(True)
        dt.decompress_batch(streams, cfg, device="cuda")
        split_switch(False)
        torch.cuda.synchronize()
    parts_dec = sorted({c[2] for c in calls["split_decode"]})
    # counted windows: encode + decode with the switch off, then on
    windows = {}
    _kernels.reset_launches()
    streams = dt.compress_batch(chunks, cfg, device="cuda")
    back_off = dt.decompress_batch(streams, cfg, device="cuda")
    torch.cuda.synchronize()
    windows["encode+decode(off)"] = dict(_kernels.launches)
    split_switch(True)
    _kernels.reset_launches()
    handle = codec.decompress_batch_dispatch(streams, cfg, "cuda")
    back_on = codec.decompress_batch_collect(handle)
    torch.cuda.synchronize()
    # the flags sit in pinned memory, complete once collect has returned
    flagged = sum(int(bad.sum()) for _i, _d, bad, _w in handle[3]
                  if bad is not None)
    windows["decode(on)"] = dict(_kernels.launches)
    split_switch(False)
    cd = cfg.to_cd_values()
    for i, (c, s, b0, b1) in enumerate(zip(chunks, streams, back_off,
                                           back_on)):
        check(s == native.native_compress(c, cd),
              f"{name} chunk {i}: stream differs from native dr_compress")
        check(np.array_equal(b0, c.ravel()),
              f"{name} chunk {i}: decode (split off) differs")
        check(np.array_equal(b1, c.ravel()),
              f"{name} chunk {i}: decode (split on) differs")
        check(np.array_equal(native.native_decompress(s, cd), c.ravel()),
              f"{name} chunk {i}: native dr_decompress disagrees")
    merge = "concentrate_packed" if name == "nedm" else "concentrate_wide"
    need = {"encode+decode(off)": ("pack_encode", merge, "unpack_decode"),
            "decode(on)": ("split_decode", "concentrate_wide16")}
    for window, names in need.items():
        for kernel in names:
            check(windows[window].get(kernel, 0) > 0,
                  f"{name} {window} never launched {kernel}")
    check(flagged == FLAGGED[name], f"{name}: the split decode flagged "
          f"{flagged} segments, {FLAGGED[name]} before")
    print(f"[5 long {name}] {len(chunks)} chunks of ({CHUNK_ROWS}, {length})"
          f" M={cfg.m}: encode split P={parts_enc}, split decode P="
          f"{parts_dec}; every stream equals native dr_compress, every chunk"
          f" decodes exactly with the split switch off and on; {flagged} "
          f"flagged rows re-decoded; launches "
          f"{json.dumps(windows, sort_keys=True)}")
    raw = x_np.nbytes
    comp = sum(len(s) for s in streams)
    enc_ms = cuda_ms(lambda: dt.compress_batch(chunks, cfg, device="cuda"), 3)
    dec_off = cuda_ms(lambda: dt.decompress_batch(streams, cfg,
                                                  device="cuda"), 3)
    split_switch(True)
    dec_on = cuda_ms(lambda: dt.decompress_batch(streams, cfg,
                                                 device="cuda"), 3)
    split_switch(False)
    print(f"[5 long {name}] {raw} raw bytes, ratio {comp / raw:.6f}; encode "
          f"{enc_ms:.3f} ms = {raw / enc_ms / 1e6:.4f} GB/s; decode split "
          f"off {dec_off:.3f} ms = {raw / dec_off / 1e6:.4f} GB/s, on "
          f"{dec_on:.3f} ms = {raw / dec_on / 1e6:.4f} GB/s; "
          f"{time.perf_counter() - t0:.1f} s")
    return windows, calls, streams


def phase_long_kernels(calls_by_path: dict, card: str) -> tuple[list, list]:
    """B5, B6 and B9 against their plain versions on the inputs the
    long-segment path gave them (B3 too, at the nEDM merge's shape), and B7
    and B8 on the JAX decode's staging of the same buckets, with the split
    of their time (:func:`tiled_split`). B9's shape is (sub-rows, words per
    sub-row). Returns (their rows, the rows of B1 at the NOPTREX split's
    sub-row shape and B2 at one NOPTREX h5 bucket's)."""
    from deltarice_tpu_torch.ops.concentrate_cuda import (
        concentrate_packed, concentrate_packed_plain, concentrate_wide,
        concentrate_wide_plain, concentrate_wide16, concentrate_wide16_plain)
    from deltarice_tpu_torch.ops.concentrate_tiled_cuda import (
        concentrate_tiled, concentrate_tiled_plain, concentrate_tiled_vd,
        concentrate_tiled_vd_plain, decode_staging, staging_route, untile)
    from deltarice_tpu_torch.ops.split_decode import unpack_decode_split
    from deltarice_tpu_torch.ops.split_decode_cuda import (
        split_decode, split_decode_plain)
    from deltarice_tpu_torch.ops.unpack_cuda import unpack_decode

    rows = {}

    def compare(kernel, err, ms, plain_ms, shape, plain_shape, path, moved):
        print(f"[6 long kernels] {kernel} {path} {shape}: max_abs_err {err},"
              f" kernel {ms:.4f} ms, plain torch on the card {plain_ms:.4f}"
              f" ms (plain on {plain_shape}), bound {bound_ms(moved):.4f} ms")
        check(err == 0, f"{kernel} ({path}) disagrees with its plain version")
        row = rows.get(kernel)
        err_all = err if row is None else max(err, row["max_abs_err"])
        if path == "noptrex" or row is None:
            rows[kernel] = {"max_abs_err": err_all, "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms(moved),
                            "bound_by": "bytes", "bytes": moved,
                            "library_ms": None, "shape": shape,
                            "plain_shape": plain_shape, "path": path}
        else:
            row["max_abs_err"] = err_all

    for path, calls in calls_by_path.items():
        # the decode layer, switch off against on, on one bucket's streams
        b2 = calls["unpack_decode"][0]
        split = calls["unpack_decode_split"][0]
        _out, bad = unpack_decode_split(*split)
        b2_ms = cuda_ms(lambda: unpack_decode(*b2), 5)
        split_ms = cuda_ms(lambda: unpack_decode_split(*split), 5)
        print(f"[6 long kernels] decode layer {path}, {b2[0].shape[0]} "
              f"segments of {b2[0].shape[1]} words: B2 {b2_ms:.4f} ms; split "
              f"P={split[5]} (B9 + merge + B6) {split_ms:.4f} ms, "
              f"{int(bad.sum())} segments flagged for B2 re-decode")
        split_layer_parts(path, split, bad)
        # B7 / B8 on the staging the JAX decode kernel emits for the bucket
        words, n_samples, k = b2[:3]
        nseg, w = words.shape
        samples = unpack_decode(*b2)
        route = staging_route(nseg, w, k)
        check(route is not None, f"{path}: the JAX decode makes no staging")
        mode, j, wc, sb = route
        planes = decode_staging(samples, k, w, j, wc, sb, mode)
        if mode == "vd":
            kernel = "concentrate_tiled_vd"
            run = lambda: concentrate_tiled_vd(*planes, n_samples, sb)
            run_plain = lambda: concentrate_tiled_vd_plain(*planes,
                                                           n_samples, sb)
        else:
            kernel, bias = "concentrate_tiled", mode == "bias"
            run = lambda: concentrate_tiled(planes, n_samples, sb, bias=bias)
            run_plain = lambda: concentrate_tiled_plain(planes, n_samples, sb,
                                                        bias=bias)
        got = run()
        err = max_err(got, run_plain())
        check(torch.equal(untile(got, nseg, sb)[:, :n_samples], samples),
              f"{kernel} ({path}) does not give back the decoded samples")
        print(f"[6 long kernels] {kernel} {path}: JAX decode staging "
              f"({mode}, {j} slots per word, {wc}-word chunks, sb={sb}) of "
              f"{nseg} segments, {planes[0].shape[1] // sb} slots each")
        compare(kernel, err, cuda_ms(run, 20), cuda_ms(run_plain, 3),
                list(planes[0].shape), list(planes[0].shape), path,
                nbytes(*planes, got))
        rows[kernel]["split"] = tiled_split(kernel, path, planes, n_samples,
                                            sb, mode == "bias", card)
        del planes, got, samples
        for args in calls["concentrate_packed"][:1]:
            got = concentrate_packed(*args)
            err = max_err(got, concentrate_packed_plain(*args))
            compare("concentrate_packed", err,
                    cuda_ms(lambda: concentrate_packed(*args), 20),
                    cuda_ms(lambda: concentrate_packed_plain(*args), 3),
                    list(args[0][0].shape), list(args[0][0].shape), path,
                    nbytes(*args[0], got))
        for args in calls["concentrate_wide"][:1]:
            got = concentrate_wide(*args)
            err = max_err(got, concentrate_wide_plain(*args))
            compare("concentrate_wide", err,
                    cuda_ms(lambda: concentrate_wide(*args), 20),
                    cuda_ms(lambda: concentrate_wide_plain(*args), 3),
                    list(args[0].shape), list(args[0].shape), path,
                    nbytes(*args[:2], got))
        for args in calls["concentrate_wide16"][:1]:
            got = concentrate_wide16(*args)
            err = max_err(got, concentrate_wide16_plain(*args))
            compare("concentrate_wide16", err,
                    cuda_ms(lambda: concentrate_wide16(*args), 20),
                    cuda_ms(lambda: concentrate_wide16_plain(*args), 3),
                    list(args[0].shape), list(args[0].shape), path,
                    nbytes(args[0], got))
        for args in calls["split_decode"][:1]:
            words, wv, parts = args[:3]
            nseg = min(B9_PLAIN_SEGMENTS, words.shape[0])
            sub = (words[:nseg].contiguous(),
                   wv[: nseg * parts].contiguous(), *args[2:])
            local, meta = split_decode(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = split_decode_plain(*sub)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = max(max_err(local[: nseg * parts], want[0]),
                      max_err(meta[:, : nseg * parts], want[1]))
            # the words each sub-row owns in, its samples and scalars out
            moved = 4 * int(wv.to(torch.int64).sum()) + nbytes(local, meta)
            compare("split_decode", err,
                    cuda_ms(lambda: split_decode(*args), 20), plain_ms,
                    [int(words.shape[0]) * parts, args[3]],
                    [nseg * parts, args[3]], path, moved)
            b9_passes(path, args)
    src = {"concentrate_packed": ("deltarice_tpu_torch/csrc/concentrate.cu",
                                  "deltarice_tpu/ops/concentrate_pallas.py:69"),
           "concentrate_wide": ("deltarice_tpu_torch/csrc/concentrate_wide.cu",
                                "deltarice_tpu/ops/concentrate_pallas.py:781"),
           "concentrate_wide16": (
               "deltarice_tpu_torch/csrc/concentrate_wide.cu",
               "deltarice_tpu/ops/concentrate_pallas.py:856"),
           "split_decode": ("deltarice_tpu_torch/csrc/split_decode.cu",
                            "deltarice_tpu/ops/split_decode.py:82"),
           "concentrate_tiled": (
               "deltarice_tpu_torch/csrc/concentrate_tiled.cu",
               "deltarice_tpu/ops/concentrate_pallas.py:238"),
           "concentrate_tiled_vd": (
               "deltarice_tpu_torch/csrc/concentrate_tiled.cu",
               "deltarice_tpu/ops/concentrate_pallas.py:511")}
    for kernel in ("concentrate_wide", "concentrate_wide16", "split_decode",
                   "concentrate_tiled", "concentrate_tiled_vd"):
        check(kernel in rows, f"the long-segment path never called {kernel}")
    tiled_sass()
    return ([{"name": k, "route": "cuda", "source": src[k][0],
              "replaces": src[k][1], **v} for k, v in rows.items()],
            phase_long_codec(calls_by_path["noptrex"]))


def profiled_rows(run, names) -> list:
    """(device ms, count, name) rows of one ``torch.profiler`` repeat of
    ``run()``, taken again (up to three in all) while a row name holds
    none of some ``names``. A trace late in this script has lost every
    launch of one kernel of ``run()`` while it kept the copies and kernels
    around it (B9 in the NOPTREX split layer), or its first launches (B9
    in :func:`b9_passes`); the cause is not known. So ``run()`` launches
    each kernel more than once, :func:`per_call` takes a kernel's time
    from the launches a trace kept, and a kernel that every repeat lost
    is printed as not measured."""
    from deltarice_tpu_torch.utils.profiling import device_rows, device_trace

    for _attempt in range(3):
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            with device_trace(tmp) as prof:
                run()
                torch.cuda.synchronize()
        rows = device_rows(prof)
        if all(any(holds(key, name) for _t, _n, key in rows)
               for name in names):
            break
    return rows


def holds(key: str, name: str) -> bool:
    return name.lower() in key.lower()


def per_call(rows, name, launches: float):
    """Device ms per call of the kernel whose row names hold ``name``: its
    mean over the launches the trace kept, times its ``launches`` per
    call; None where the trace kept none."""
    kept = [(t, n) for t, n, key in rows if holds(key, name)]
    seen = sum(n for _t, n in kept)
    return sum(t for t, _n in kept) / seen * launches if seen else None


def ms_text(v) -> str:
    return "not measured (the trace lost it)" if v is None else f"{v:.4f} ms"


def tiled_parts(fn, reps: int = 5) -> dict:
    """Device ms per call of ``fn`` (one B7 or B8 call) in one
    ``torch.profiler`` repeat of ``reps`` calls: the memset of the
    intermediate, pass 1 (``walk_kernel``), pass 2 (``untile_kernel``),
    one launch each per call, and the rest; None for a part the trace
    lost."""
    names = {"memset": "memset", "pass 1": "walk_kernel",
             "pass 2": "untile_kernel"}
    rows = profiled_rows(lambda: [fn() for _ in range(reps)], names.values())
    parts = {part: per_call(rows, name, 1) for part, name in names.items()}
    parts["rest"] = sum(t for t, _n, key in rows
                        if not any(holds(key, n) for n in names.values())) / reps
    return parts


def tiled_split(kernel, path, staging, n_out, sb, bias, card) -> dict:
    """What B7 or B8 waits on, at the shape of the staging it was just held
    on: the wrapper's time on (a) all-dead planes (the reads, the memset of
    the intermediate and pass 2; pass 1 stores nothing), (b) every slot
    live at displacement 0 with non-zero halfwords (every pass-1 store one
    aligned run of 32 slots) and (c) the JAX decode staging, (c) also in
    one ``torch.profiler`` repeat (:func:`tiled_parts`); pass 1's store
    instructions and the 32-byte sectors they touch, counted by the plain
    model of the walk on the card (which must give the kernels' output);
    for B7, also packed int16 and u32-with-follower planes of random
    monotone rows at the same shape. Each input must give its plain
    version's output exactly. The counts and the read bound are printed;
    the returned row holds only what this run timed, each time with its
    bound."""
    from deltarice_tpu_torch.ops.concentrate_cuda import DEAD
    from deltarice_tpu_torch.ops.concentrate_tiled_cuda import (
        concentrate_tiled, concentrate_tiled_plain, concentrate_tiled_vd,
        concentrate_tiled_vd_plain)
    from deltarice_tpu_torch.ops.concentrate_tiled_model import (
        concentrate_tiled_model, concentrate_tiled_vd_model)

    shape = staging[0].shape
    dev = staging[0].device
    gen = torch.Generator(device=dev).manual_seed(7)
    half = torch.randint(1, 1 << 16, shape, generator=gen, device=dev,
                         dtype=torch.int32)
    if kernel == "concentrate_tiled_vd":
        def run(p):
            return concentrate_tiled_vd(*p, n_out, sb)

        def plain(p):
            return concentrate_tiled_vd_plain(*p, n_out, sb)

        def model(p):
            return concentrate_tiled_vd_model(*p, n_out, sb)

        inputs = {
            "a all dead": (torch.zeros(shape, dtype=torch.int16, device=dev),
                           torch.full(shape, -1, dtype=torch.int32,
                                      device=dev)),
            "b all home": (half.to(torch.int16),
                           torch.zeros(shape, dtype=torch.int32, device=dev)),
        }
    else:
        def run(p, emit="int16", bias=bias):
            return concentrate_tiled(p, n_out, sb, emit, bias)

        def plain(p, emit="int16", bias=bias):
            return concentrate_tiled_plain(p, n_out, sb, emit, bias)

        def model(p):
            return concentrate_tiled_model(p, n_out, sb, bias=bias)

        # the biased image of a live halfword at displacement 0 is
        # INT32_MIN + halfword
        inputs = {
            "a all dead": (torch.full(shape, DEAD, dtype=torch.int32,
                                      device=dev),),
            "b all home": (half + DEAD if bias else half,),
        }
    inputs["c decode staging"] = staging
    del half
    ms, stats = {}, {}
    for name, p in inputs.items():
        got = run(p)
        check(max_err(got, plain(p)) == 0,
              f"{kernel} ({path}, {name}) disagrees with its plain version")
        want, stats[name] = model(p)
        check(torch.equal(got, want),
              f"{kernel} ({path}, {name}) disagrees with the model of its walk")
        out_bytes = nbytes(got)
        del got, want
        torch.cuda.empty_cache()
        ms[name] = cuda_ms(lambda: run(p), 20)
    parts = tiled_parts(lambda: run(staging))
    reads = nbytes(*staging)
    print(f"[6 long kernels] split {kernel} {path} {list(shape)}, {card}: "
          + "; ".join(f"({k}) {v:.4f} ms" for k, v in ms.items())
          + f"; bound {bound_ms(reads + out_bytes):.4f} ms, of which reads "
          f"{bound_ms(reads):.4f} and the output {bound_ms(out_bytes):.4f}")
    print(f"[6 long kernels] split {kernel} {path} (c) in torch.profiler, "
          "5 repeats: " + ", ".join(f"{k} {ms_text(v)}"
                                    for k, v in parts.items()))
    for name, st in stats.items():
        print(f"[6 long kernels] split {kernel} {path} ({name}) pass-1 "
              f"stores (plain model of the walk, a count): {json.dumps(st)}")
    bound = bound_ms(reads + out_bytes)
    split = {name: {"ms": v, "bound_ms": bound} for name, v in ms.items()}
    split["c decode staging"]["profiler_ms"] = parts
    if kernel == "concentrate_tiled":
        split["modes"] = tiled_modes(shape, dev, n_out, sb, run, plain, card)
    return split


def tiled_modes(shape, dev, n_out, sb, run, plain, card) -> dict:
    """B7 at the staging's shape in packed int16 and u32-with-follower
    modes: random monotone rows, each slot live with the chance that puts
    ``n_out`` live slots in a row, random halfwords and followers."""
    from deltarice_tpu_torch.ops.concentrate_cuda import DEAD

    blocks, rows_in, lanes = shape
    r, cols = rows_in // sb, sb * lanes
    gen = torch.Generator(device=dev).manual_seed(8)
    valid = torch.rand((blocks, r, cols), generator=gen, device=dev) < (
        n_out / r)
    disp = (torch.arange(r, device=dev, dtype=torch.int32)[None, :, None]
            - (torch.cumsum(valid, 1, dtype=torch.int32) - 1))
    check(int(disp[valid].max()) < (1 << 15),
          "a random monotone row's displacement exceeds the packed field")
    half = torch.randint(0, 1 << 16, disp.shape, generator=gen, device=dev,
                         dtype=torch.int32)
    lead = torch.where(valid, (disp << 16) | half, DEAD).reshape(shape)
    follow = torch.randint(-2**15, 2**15, shape, generator=gen, device=dev,
                           dtype=torch.int16)
    del valid, disp, half
    out = {}
    for mode, planes, emit in (("packed int16", (lead,), "int16"),
                               ("u32 with follower", (lead, follow), "u32")):
        got = run(planes, emit, False)
        check(max_err(got, plain(planes, emit, False)) == 0,
              f"concentrate_tiled ({mode}) disagrees with its plain version")
        ms = cuda_ms(lambda: run(planes, emit, False), 20)
        bound = bound_ms(nbytes(*planes, got))
        print(f"[6 long kernels] concentrate_tiled {mode} {list(shape)}, "
              f"random monotone rows, {card}: {ms:.4f} ms, bound "
              f"{bound:.4f} ms")
        out[mode] = {"ms": ms, "bound_ms": bound}
        del got
    return out


def tiled_sass() -> None:
    """``cuobjdump -sass`` of the kernels' library: B7's and B8's kernels
    (the memset aside, ``walk_kernel`` and ``untile_kernel`` of
    ``csrc/concentrate_tiled.cu``) must call no routine (a 64-bit division
    or modulo is one)."""
    funcs = sass_functions()
    if funcs is None:
        print("[6 long kernels] SASS: cuobjdump not found, not checked")
        return
    tiled = {n: body for n, body in funcs.items() if "tiled_" in n}
    check(len(tiled) > 0, "cuobjdump shows no B7 or B8 kernel")
    calls = {n: sum("CALL" in ln for ln in body) for n, body in tiled.items()}
    check(not any(calls.values()),
          f"a B7/B8 kernel calls a routine: {calls}")
    rcp = sorted({sum("MUFU.RCP" in ln for ln in b) for b in tiled.values()})
    print(f"[6 long kernels] SASS: {len(tiled)} B7/B8 kernels, no CALL in "
          f"any; MUFU.RCP (a 32-bit division's reciprocal) per kernel "
          f"{rcp}; instructions per kernel "
          f"{sorted({sum(';' in ln for ln in b) for b in tiled.values()})}")


def split_layer_parts(path, split, bad, reps: int = 3) -> None:
    """One ``torch.profiler`` repeat of ``reps`` calls of the split decode
    layer (``unpack_decode_split``): its device ms per call in B9 and in
    B6 (:func:`per_call`, with their launches per call counted on a
    call before) and in the rest (the merge's torch glue and copies), then
    the B2 re-decode of the segments it flagged, timed with CUDA events."""
    from deltarice_tpu_torch.ops import _kernels
    from deltarice_tpu_torch.ops.split_decode import unpack_decode_split
    from deltarice_tpu_torch.ops.unpack_cuda import unpack_decode

    words, _counts, n_samples, k, delta = split[:5]
    kernels = {"B9": ("split_decode_kernel", "split_decode"),
               "B6": ("wide16_kernel", "concentrate_wide16")}
    before = _kernels.launches.copy()
    unpack_decode_split(*split)
    per = {w: _kernels.launches[w] - before[w] for _n, w in kernels.values()}
    rows = profiled_rows(lambda: [unpack_decode_split(*split)
                                  for _ in range(reps)],
                         [name for name, _w in kernels.values()])
    ms = {label: per_call(rows, name, per[wrapper])
          for label, (name, wrapper) in kernels.items()}
    rest = [(t, n) for t, n, key in rows
            if not any(holds(key, name) for name, _w in kernels.values())]
    rest_ms = sum(t for t, _n in rest) / reps
    total = None if None in ms.values() else sum(ms.values()) + rest_ms
    flagged = torch.nonzero(bad.to(words.device)).flatten()
    redo = words[flagged].contiguous()
    redo_ms = (cuda_ms(lambda: unpack_decode(redo, n_samples, k, delta), 5)
               if len(flagged) else 0.0)
    print(f"[6 long kernels] decode layer {path} parts (torch.profiler, "
          f"{reps} calls, per call): device {ms_text(total)} = B9 "
          f"{ms_text(ms['B9'])} + B6 {ms_text(ms['B6'])} + merge glue and "
          f"copies {rest_ms:.4f} ms ({sum(n for _t, n in rest) / reps:g} "
          f"launches); B2 re-decode of the {len(flagged)} flagged segments "
          f"{redo_ms:.4f} ms")


def b9_passes(path, args, reps: int = 5) -> None:
    """One ``torch.profiler`` repeat of B9 launched whole and stopped after
    each earlier pass (``split_decode_passes``), ``reps`` launches each:
    the device ms of each launch (:func:`per_call`), and of each pass as
    the difference of two."""
    from deltarice_tpu_torch.ops.split_decode_cuda import (
        PASSES, split_decode_passes)

    for passes in range(1, PASSES + 1):  # warm-up
        split_decode_passes(*args, passes)
    names = [f"split_decode_kernel<{p}>" for p in range(1, PASSES + 1)]
    rows = profiled_rows(
        lambda: [split_decode_passes(*args, passes)
                 for passes in range(1, PASSES + 1) for _ in range(reps)],
        names)
    ms = [per_call(rows, name, 1) for name in names]
    each = [ms[0]] + [None if None in (a, b) else b - a
                      for a, b in zip(ms, ms[1:])]
    print(f"[6 long kernels] split_decode {path} passes (torch.profiler, "
          f"{reps} launches each): "
          + ", ".join(f"{n} {ms_text(v)}" for n, v in zip(B9_PASSES, each))
          + f"; whole {ms_text(ms[-1])}")


def phase_long_codec(calls) -> list[dict]:
    """B1 on the NOPTREX split encode's sub-rows and B2 on one NOPTREX h5
    bucket (the first OPT_BUCKET segments of a decode bucket), each against
    its plain version on the card: B1's serial oracle, and for B2 the plain
    model of its tiled passes (the serial oracle would step 500,000 samples
    one torch call at a time)."""
    from deltarice_tpu_torch.ops.pack_cuda import pack_encode, pack_encode_plain
    from deltarice_tpu_torch.ops.tiled_model import decode_tiled
    from deltarice_tpu_torch.ops.unpack_cuda import unpack_decode

    out = []
    args = calls["pack_encode"][0]
    got = pack_encode(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = pack_encode_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(max_err(g, w) for g, w in zip(got, want))
    del want
    out.append(kernel_row(
        "pack_encode", "deltarice_tpu_torch/csrc/pack.cu",
        "deltarice_tpu/ops/pack_pallas.py:62", err,
        cuda_ms(lambda: pack_encode(*args), 20), plain_ms,
        list(args[0].shape), pack_bytes(args[1], got[1]), None,
        "noptrex split sub-rows"))
    words, n_samples, k, delta = calls["unpack_decode"][0]
    words = words[:OPT_BUCKET].contiguous()
    got = unpack_decode(words, n_samples, k, delta)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = decode_tiled(words, n_samples, k, delta)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_err(got, want)
    del want
    # each stream's words: up to its last nonzero word
    counts = (words != 0).to(torch.int64).cumsum(dim=1).argmax(dim=1) + 1
    out.append(kernel_row(
        "unpack_decode", "deltarice_tpu_torch/csrc/unpack.cu",
        "deltarice_tpu/ops/unpack_pallas.py:171", err,
        cuda_ms(lambda: unpack_decode(words, n_samples, k, delta), 20),
        plain_ms, list(words.shape), unpack_bytes(counts.cpu().numpy(), got),
        None, "noptrex h5 bucket"))
    for row in out:
        print(f"[6 long kernels] {row['name']} {row['path']} {row['shape']}: "
              f"max_abs_err {row['max_abs_err']}, kernel {row['ms']:.4f} ms, "
              f"plain torch on the card {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms")
        check(row["max_abs_err"] == 0,
              f"{row['name']} ({row['path']}) disagrees with its plain version")
    return out


def phase_h5(name: str, x_np) -> dict:
    """Write and read one profile's dataset through ``h5`` on the in-memory
    store, in 4 windows; returns the launches of each counted run."""
    from deltarice_tpu_torch import h5, native
    from deltarice_tpu_torch.models import get_profile
    from deltarice_tpu_torch.ops import _kernels
    from deltarice_tpu_torch.tools.memstore import MemGroup

    cfg = get_profile(name).config
    x = x_np[: H5_ROWS[name]]
    chunks = (CHUNK_ROWS, x.shape[1])
    batch = H5_WINDOW[name]
    store = MemGroup()
    runs = {}
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    dset = h5.write_dataset(store, name, x, cfg, chunks, batch_chunks=batch,
                            device="cuda")
    t_write = time.perf_counter() - t0
    runs["write"] = dict(_kernels.launches)
    nchunks = len(dset.id.chunks)
    windows = -(-nchunks // batch)
    check(windows >= 4, f"{name}: {windows} h5 windows, want at least 4")
    cd = cfg.to_cd_values()
    comp = 0
    for off, (mask, blob) in dset.id.chunks.items():
        full = np.zeros(chunks, np.int16)
        part = x[off[0]: off[0] + CHUNK_ROWS]
        full[: part.shape[0]] = part
        check(mask == 0 and blob == native.native_compress(full, cd),
              f"{name} h5 chunk {off}: blob differs from native dr_compress")
        comp += len(blob)
    reads = {}
    for on in (False, True):
        split_switch(on)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        back = h5.read_dataset(store[name], batch_chunks=batch,
                               device="cuda")
        reads[on] = time.perf_counter() - t0
        runs[f"read(split {'on' if on else 'off'})"] = dict(_kernels.launches)
        check(np.array_equal(back, x),
              f"{name} h5 read (split {'on' if on else 'off'}) differs")
    split_switch(False)
    check(runs["write"].get("pack_encode", 0) > 0,
          f"{name} h5 write never launched pack_encode")
    h5_breakdown(name, store, x, cfg, chunks, batch)
    check(runs["read(split off)"].get("unpack_decode", 0) > 0,
          f"{name} h5 read never launched unpack_decode")
    raw = x.nbytes
    print(f"[7 h5 {name}] {x.shape} in {nchunks} chunks of {chunks}, "
          f"{windows} windows of {batch}: every blob equals native "
          f"dr_compress, read exact with the split switch off and on; ratio "
          f"{comp / raw:.6f}; write {t_write * 1e3:.1f} ms = "
          f"{raw / t_write / 1e9:.4f} GB/s, read off {reads[False] * 1e3:.1f}"
          f" ms = {raw / reads[False] / 1e9:.4f} GB/s, on "
          f"{reads[True] * 1e3:.1f} ms = {raw / reads[True] / 1e9:.4f} GB/s;"
          f" launches {json.dumps(runs, sort_keys=True)}")
    return runs


def h5_breakdown(name, store, x, cfg, chunks, batch) -> None:
    """Where an h5 write and read (split switch off) spend their time: the
    host milliseconds of each window's dispatch and collect, then one
    ``torch.profiler`` repeat for the device's busy share of the wall
    (kernel and memcpy rows; the profiler's own cost is in that wall)."""
    from deltarice_tpu_torch import codec, h5
    from deltarice_tpu_torch.utils.profiling import device_rows, device_trace

    runs = {
        "write": (("compress_batch_dispatch", "compress_batch_collect"),
                  lambda: h5.write_dataset(store, f"{name}-b", x, cfg, chunks,
                                           batch_chunks=batch,
                                           device="cuda")),
        "read": (("decompress_batch_dispatch", "decompress_batch_collect"),
                 lambda: h5.read_dataset(store[name], batch_chunks=batch,
                                         device="cuda")),
    }
    for label, (fns, fn) in runs.items():
        torch.cuda.synchronize()
        with captured([(codec, f) for f in fns]) as (_calls, ms):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        with tempfile.TemporaryDirectory() as tmp:
            with device_trace(tmp) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                pwall = (time.perf_counter() - t0) * 1e3
        rows = device_rows(prof)
        busy = sum(r[0] for r in rows)
        d, c = (ms[f] for f in fns)
        top = "; ".join(f"{k[:40]} {v:.2f} ms x {n}" for v, n, k in rows[:4])
        print(f"[7 h5 {name}] {label} breakdown: wall {wall:.1f} ms; host "
              f"dispatch {' '.join(f'{v:.1f}' for v in d)} ms, collect "
              f"{' '.join(f'{v:.1f}' for v in c)} ms, the rest "
              f"{wall - sum(d) - sum(c):.1f} ms; profiled repeat: wall "
              f"{pwall:.1f} ms, device busy {busy:.2f} ms "
              f"({100 * busy / pwall:.1f} %): {top}")


def phase_overlap(nab_np, noptrex_streams) -> None:
    """Collect of window i-1 must not wait for window i's kernels: dispatch
    a Nab encode window, then a NOPTREX decode bucket (split switch off)
    queued behind a spin kernel of about 0.2 s, so that it is still running
    however fast B2 is, then collect the Nab window."""
    from deltarice_tpu_torch import codec, native
    from deltarice_tpu_torch.models import get_profile

    nab_cfg = get_profile("nab").config
    opt_cfg = get_profile("noptrex").config
    chunks = list(nab_np[: 16 * CHUNK_ROWS].reshape(16, CHUNK_ROWS, -1))
    blobs = noptrex_streams[:2]
    split_switch(False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = codec.compress_batch_dispatch(chunks, nab_cfg, "cuda")
    torch.cuda._sleep(SPIN_CYCLES)
    dec = codec.decompress_batch_dispatch(blobs, opt_cfg, "cuda")
    t1 = time.perf_counter()
    streams = codec.compress_batch_collect(enc, nab_cfg)
    t2 = time.perf_counter()
    later_running = not dec[2][3].query()
    t3 = time.perf_counter()
    back = codec.decompress_batch_collect(dec)
    t4 = time.perf_counter()
    print(f"[8 overlap] dispatch Nab encode window (16 chunks) + spin + "
          f"NOPTREX decode bucket (2 chunks) {(t1 - t0) * 1e3:.1f} ms; Nab "
          f"collect "
          f"took {(t2 - t1) * 1e3:.1f} ms and returned with the NOPTREX "
          f"bucket {'still running' if later_running else 'already done'}; "
          f"NOPTREX collect waited {(t4 - t3) * 1e3:.1f} ms more")
    check(later_running, "collect of the Nab window waited for the later "
          "NOPTREX decode's kernels")
    cd = nab_cfg.to_cd_values()
    for c, s in zip(chunks, streams):
        check(s == native.native_compress(c, cd),
              "overlap: Nab stream differs from native dr_compress")
    for b, s in zip(back, blobs):
        check(np.array_equal(b, native.native_decompress(
            s, opt_cfg.to_cd_values())), "overlap: NOPTREX decode differs")


def phase_tools(nab_np) -> tuple[int, tuple[int, ...]]:
    """``optimize`` on the card against the CPU, then the CLI; returns the
    (M, filter) that ``optimize(n_taps=3)`` chose over the whole dataset."""
    import deltarice_tpu_torch as dt
    from deltarice_tpu_torch import optimize as opt
    from deltarice_tpu_torch.native import LIB

    x = nab_np[: H5_ROWS["nab"]]
    chosen = None
    for n_taps in (2, 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cfg = opt.optimize(x, n_taps=n_taps, device="cuda")
        torch.cuda.synchronize()
        t_opt = time.perf_counter() - t0
        bits = opt.expected_bits(x, cfg.m, cfg.filt, device="cuda")
        full = dt.RiceConfig(cfg.m, x.shape[1], cfg.filt)
        # 125 chunks of 16 rows: the whole dataset, no zero padding
        streams = dt.compress_batch(list(x.reshape(-1, 16, x.shape[1])),
                                    full, device="cuda")
        measured = sum(len(s) for s in streams) * 8 / x.size
        small_gpu = opt.optimize(x[:64], n_taps=n_taps, device="cuda")
        small_cpu = opt.optimize(x[:64], n_taps=n_taps, device="cpu")
        check(small_gpu == small_cpu,
              f"optimize n_taps={n_taps}: {small_gpu} on the card, "
              f"{small_cpu} on the CPU")
        b_gpu = opt.expected_bits(x[:64], small_gpu.m, small_gpu.filt,
                                  device="cuda")
        b_cpu = opt.expected_bits(x[:64], small_cpu.m, small_cpu.filt,
                                  device="cpu")
        check(abs(b_gpu - b_cpu) <= 1e-6 * b_cpu,
              f"optimize n_taps={n_taps}: bits {b_gpu} vs {b_cpu}")
        print(f"[9 tools] optimize n_taps={n_taps} over {x.shape}: "
              f"{t_opt * 1e3:.1f} ms, M={cfg.m} filter={list(cfg.filt)}, "
              f"predicted {bits:.6f} bits/sample, the port's stream "
              f"{measured:.6f} bits/sample; 64 rows: "
              f"card == CPU ({small_cpu.m}, {list(small_cpu.filt)}, "
              f"{b_gpu:.9f} bits)")
        chosen = (cfg.m, cfg.filt)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    with tempfile.TemporaryDirectory() as tmp:
        for argv in (["warmup", "--device", "cuda"],
                     ["install-plugin", "--dir", tmp]):
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "deltarice_tpu_torch", *argv],
                capture_output=True, text=True, timeout=300, cwd=tmp, env=env)
            check(res.returncode == 0, f"CLI {argv[0]} exited "
                  f"{res.returncode}: {res.stderr.strip()[-500:]}")
            print(f"[9 tools] CLI {' '.join(argv[:1])}: exit 0 in "
                  f"{time.perf_counter() - t0:.1f} s: "
                  f"{(res.stdout + res.stderr).strip().splitlines()[-1]}")
        check((Path(tmp) / LIB.name).is_file(),
              "install-plugin left no plugin file")
    return chosen


def phase_multi_device(data: dict) -> dict:
    """Phase 11: the chunk data parallelism on the card. Returns the
    launches of each counted window (one per rank)."""
    import torch.distributed as dist

    from deltarice_tpu_torch import RiceConfig, native
    from deltarice_tpu_torch.models import get_profile
    from deltarice_tpu_torch.ops import _kernels
    from deltarice_tpu_torch.parallel import chunk_mesh, roundtrip_check_step
    from deltarice_tpu_torch.parallel.multihost import (
        decode_chunks_multihost, encode_chunks_multihost,
        initialize_distributed)
    from deltarice_tpu_torch.parallel.sharded import put_sharded
    from deltarice_tpu_torch.tools.singlechip_scaling import (
        mesh_of_one_overhead)

    windows = {}
    nab = data["nab"].reshape(-1, CHUNK_ROWS, LENGTH)
    nab_cfg = get_profile("nab").config
    lossy = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        initialize_distributed(device="cuda:0", backend="nccl",
                               init_method=f"file://{tmp}/store", rank=0,
                               world_size=1)
        try:
            mesh = chunk_mesh()
            check(mesh.group is not None and mesh.comm.type == "cuda",
                  "the world of one has no NCCL group")
            torch.cuda.synchronize()
            _kernels.reset_launches()
            for name in ("nab", "noptrex"):
                cfg = get_profile(name).config
                x = data[name].reshape(-1, CHUNK_ROWS, cfg.waveform_length)
                streams = encode_chunks_multihost(x, cfg, mesh)
                back = decode_chunks_multihost(streams, cfg, mesh)
                nvalid = np.full(x.shape[:2], x.shape[2], np.int32)
                *_, bad = roundtrip_check_step(
                    put_sharded(x, mesh), put_sharded(nvalid, mesh), cfg,
                    mesh, cfg.max_words(x.shape[2]))
                cd = cfg.to_cd_values()
                for i, (c, blob) in enumerate(zip(x, streams)):
                    check(blob == native.native_compress(c, cd),
                          f"world 1 {name} chunk {i}: stream differs from "
                          f"native dr_compress")
                check(np.array_equal(back, x.reshape(len(x), -1)),
                      f"world 1 {name}: decode differs")
                check(bad == 0, f"world 1 {name}: {bad} lossless samples "
                      f"mismatched")
                print(f"[11 multi-device] world 1 (NCCL) {name}: {len(x)} "
                      f"chunks of {x.shape[1:]} M={cfg.m}: every stream "
                      f"equals native dr_compress, decode exact, "
                      f"round-trip check 0 mismatches")
            lossy_cfg = RiceConfig(nab_cfg.m, LENGTH, LOSSY_FILTER)
            for n in (64, 63):
                nvalid = np.full((n, CHUNK_ROWS), LENGTH, np.int32)
                lossy[n] = roundtrip_check_step(
                    put_sharded(nab[:n], mesh), put_sharded(nvalid, mesh),
                    lossy_cfg, mesh, lossy_cfg.max_words(LENGTH))[2]
                check(lossy[n] > 0, f"filter {LOSSY_FILTER} lost no sample "
                      f"of {n} Nab chunks")
            torch.cuda.synchronize()
            windows["world 1 (nccl)"] = dict(_kernels.launches)
            over = mesh_of_one_overhead(nab, nab_cfg, mesh)
            print(f"[11 multi-device] one-rank overhead on {len(nab)} Nab "
                  f"chunks (singlechip_scaling.mesh_of_one_overhead; ms a "
                  f"call, median of windows taken in turns):")
            print(json.dumps(over))
        finally:
            dist.destroy_process_group()
        print(f"[11 multi-device] world 1 (NCCL): launches "
              f"{json.dumps(windows['world 1 (nccl)'], sort_keys=True)}; "
              f"lossy one-rank mismatches {lossy}; "
              f"{time.perf_counter() - t:.1f} s")
        src = Path(tmp) / "nab.npy"
        np.save(src, nab)
        windows.update(run_ranks(2, "gloo", src, (64, 63), nab, lossy,
                                 Path(tmp) / "gloo"))
        cards = torch.cuda.device_count()
        if cards >= 2:
            windows.update(run_ranks(min(cards, MAX_WORLD), "nccl", src,
                                     (64, 63), nab, lossy,
                                     Path(tmp) / "nccl"))
        else:
            print(f"[11 multi-device] NCCL over several cards: not run, "
                  f"the machine has {cards} card")
    for window, n in windows.items():
        for kernel in ("pack_encode", "unpack_decode"):
            check(n.get(kernel, 0) > 0, f"multi-device {window} never "
                  f"launched {kernel}")
        check(n.get("transpose2d", 0) == 0,
              f"multi-device {window} launched transpose2d")
    return windows


def run_ranks(world, backend, src, counts, nab, lossy, out) -> dict:
    """The example over ``world`` ranks (its ``main``, so the ranks spawn
    from this process); checks rank 0's streams and decode, that the
    others get None, the lossy mismatch sums and each rank's launches
    (returned, one window per rank)."""
    from deltarice_tpu_torch import native
    from deltarice_tpu_torch.examples import sharded_encode
    from deltarice_tpu_torch.models import get_profile

    t = time.perf_counter()
    said = io.StringIO()
    try:
        with contextlib.redirect_stdout(said):
            sharded_encode.main([
                "--world", str(world), "--backend", backend, "--device",
                "cuda", "--out", str(out), "--input", str(src),
                "--chunks", ",".join(map(str, counts)),
                "--check-filter", ",".join(map(str, LOSSY_FILTER))])
    except Exception as e:  # a rank failed or hung: report it as a check
        raise SmokeFailure(f"{world} {backend} ranks failed: {e!r}") from e
    reports = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(world)]
    cd = get_profile("nab").config.to_cd_values()
    label = f"world {world} ({backend})"
    for n in counts:
        key = str(n)
        blob = (out / f"streams_{n}.bin").read_bytes()
        ends = np.cumsum(reports[0]["chunks"][key]["streams"])
        streams = [blob[a:b] for a, b in zip(np.r_[0, ends[:-1]], ends)]
        check(len(streams) == n, f"{label}: {len(streams)} streams of {n}")
        for i, s in enumerate(streams):
            check(s == native.native_compress(nab[i], cd),
                  f"{label} {n} chunks: stream {i} differs from native "
                  f"dr_compress")
        check(np.array_equal(np.load(out / f"decoded_{n}.npy"),
                             nab[:n].reshape(n, -1)),
              f"{label} {n} chunks: decode differs")
        for r in reports[1:]:
            check(r["chunks"][key]["streams"] is None
                  and not r["chunks"][key]["decoded"],
                  f"{label}: rank {r['rank']} got a result")
        counts_all = [r["chunks"][key]["mismatches"] for r in reports]
        check(counts_all == [lossy[n]] * world,
              f"{label} {n} chunks: lossy mismatches {counts_all}, one rank "
              f"{lossy[n]}")
        r0 = reports[0]["chunks"][key]
        raw = r0["raw_bytes"]
        print(f"[11 multi-device] {label} {n} chunks: rank 0's streams "
              f"equal native dr_compress, decode exact, the other ranks got "
              f"None; lossy mismatches {counts_all} (one rank {lossy[n]}); "
              f"rank 0 encode {r0['encode_s'] * 1e3:.2f} ms = "
              f"{raw / r0['encode_s'] / 1e9:.4f} GB/s, decode "
              f"{r0['decode_s'] * 1e3:.2f} ms = "
              f"{raw / r0['decode_s'] / 1e9:.4f} GB/s")
    check(all(r["jax_loaded"] == [] for r in reports),
          f"{label}: a rank imported JAX")
    windows = {f"{label} rank {r['rank']}": r["launches"] for r in reports}
    print(f"[11 multi-device] {label}: devices "
          f"{[r['device'] for r in reports]}; launches "
          f"{json.dumps(windows, sort_keys=True)}; "
          f"{said.getvalue().strip().splitlines()[-1]}; "
          f"{time.perf_counter() - t:.1f} s")
    return windows


def gate_verdicts(bench_stdout: str, last: dict) -> None:
    """Phase 12's perf gate: ``tools.perf_gate.main`` on the bench
    subprocess's output against the committed baselines, a baseline of this
    card 25 % above the fresh value, and a baseline of another card; each
    verdict printed. Exceptions are not caught: a gate that breaks fails the
    run."""
    from deltarice_tpu_torch.tools import perf_gate

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        log = Path(tmp) / "bench.log"
        log.write_text(bench_stdout)

        def gate(label, baseline=None):
            extra = []
            if baseline is not None:
                directory = Path(tmp) / label.replace(" ", "_")
                directory.mkdir()
                (directory / "BENCH_r01.json").write_text(
                    json.dumps({**last, **baseline}))
                extra = ["--baselines", str(directory)]
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = perf_gate.main([str(log), *extra])
            verdict = out.getvalue().strip()
            print(f"[12 tools] perf_gate {label}: exit {rc}: {verdict}")
            fresh = re.search(r"fresh =? ?([0-9.]+)", verdict)
            check(fresh is not None
                  and fresh.group(1) == f"{last['value']:.3f}",
                  f"perf_gate {label} printed another fresh value than the "
                  f"bench line's {last['value']}: {verdict!r}")
            return rc, verdict

        rc, _ = gate("committed")
        check(rc in (0, 1), f"perf_gate against the committed baselines "
              f"exited {rc}")
        rc, verdict = gate("+25 %", {"value": last["value"] * 1.25})
        check(rc == 1 and verdict.startswith("perf gate [FAIL]"),
              f"perf_gate against a baseline 25 % above the fresh value: "
              f"exit {rc}, {verdict!r}")
        rc, verdict = gate("another card", {"card": "another card, 1.00 W"})
        check(rc == 0 and "no committed baseline" in verdict,
              f"perf_gate against another card's baseline: exit {rc}, "
              f"{verdict!r}")
    print(f"[12 tools] perf_gate: three verdicts in "
          f"{time.perf_counter() - t:.3f} s")


def phase_measurement_tools(card: str) -> dict:
    """Phase 12: the port's measurement tools (``deltarice_tpu_torch.bench``
    and ``deltarice_tpu_torch.tools``) in this process, each tool's JSON on
    a line of its own; returns the launches of each counted window."""
    from deltarice_tpu_torch import bench
    from deltarice_tpu_torch.ops import _kernels
    from deltarice_tpu_torch.tools import (bench_file, bench_geometries,
                                           fuzz_native, profile_stages,
                                           scaling_bench, singlechip_scaling)

    windows = {}

    def counted(label, fn):
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        windows[label] = dict(_kernels.launches)
        print(f"[12 tools] {label}: {time.perf_counter() - t:.1f} s, "
              f"launches {json.dumps(windows[label], sort_keys=True)}")
        print(json.dumps(out))
        return out

    rep = counted("bench", bench.run)
    check(rep["detail"]["round_trip"] == "exact" and rep["value"] > 0,
          "bench gave no exact round trip")
    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "deltarice_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)})
    check(res.returncode == 0, f"python -m deltarice_tpu_torch.bench exited "
          f"{res.returncode}: {res.stderr.strip()[-500:]}")
    last = json.loads(res.stdout.strip().splitlines()[-1])
    check(last["unit"] == "GB/s" and last["value"] > 0,
          "python -m deltarice_tpu_torch.bench: no result on its last line")
    print(f"[12 tools] python -m deltarice_tpu_torch.bench: exit 0 in "
          f"{time.perf_counter() - t:.1f} s, last line parses: value "
          f"{last['value']} GB/s, card {last['card']!r}")
    gate_verdicts(res.stdout, last)

    published = {r["config"]: r for r in json.loads(
        (ROOT / "GEOMETRY_BENCH.json").read_text())["rows"]}

    def geometries():
        rows = []
        for name in bench_geometries.CONFIGS:
            x, cfg = bench_geometries.make_config(name)
            iters = bench_geometries.iters_for(x.nbytes, 20)
            splits = (False, True) if x.shape[1] > 16384 else (False,)
            for on in splits:
                split_switch(on)
                rows.append(bench_geometries.bench_config(name, x, cfg,
                                                          iters, 5, "cuda"))
            split_switch(False)
            del x
        return bench_geometries.report(rows, card, 20, 5)

    rep = counted("bench_geometries", geometries)
    for row in rep["rows"]:
        want = published[row["config"]]
        check(row["ratio"] == want["ratio"],
              f"bench_geometries {row['config']}: ratio {row['ratio']}, "
              f"GEOMETRY_BENCH.json {want['ratio']}")
        check(row.get("split_parts") == want.get("split_parts"),
              f"bench_geometries {row['config']}: split_parts "
              f"{row.get('split_parts')}, GEOMETRY_BENCH.json "
              f"{want.get('split_parts')}")
    print(f"[12 tools] bench_geometries: the {len(published)} ratios and "
          f"split_parts equal GEOMETRY_BENCH.json's; every round trip exact "
          f"with the split switch off and (nedm, noptrex) on")

    rep = counted("fuzz_native", lambda: fuzz_native.run(
        FUZZ_CASES, 0, "cuda", log=print))
    check(rep["failures"] == 0, f"fuzz_native: {rep['failures']} failures")
    rep = counted("bench_file", lambda: bench_file.run(
        64, "all", store="memory", device="cuda"))
    check(all(g["torch_direct_chunk"]["stored_bytes"] > 0
              for g in rep["detail"]["geometries"].values()),
          "bench_file stored nothing")
    for shape in ((1024, 7000, 8), (1024, 81920, 16)):
        counted(f"profile_stages {shape}",
                lambda: profile_stages.run(*shape, device="cuda"))
    counted("singlechip_scaling", lambda: singlechip_scaling.run(
        store="memory", device="cuda"))
    rep = counted("scaling_bench", lambda: scaling_bench.run(
        nseg=CHUNK_ROWS, chunks_per_dev=ROWS // CHUNK_ROWS, device="cuda"))
    windows.update({f"scaling_bench {k}": v
                    for k, v in rep["launches"].items()})
    for window, n in windows.items():
        check(n.get("transpose2d", 0) == 0, f"phase 12 {window} launched "
              f"transpose2d")
    for kernel in ("pack_encode", "unpack_decode", "concentrate_packed",
                   "concentrate_wide", "concentrate_wide16", "split_decode"):
        check(any(n.get(kernel) for n in windows.values()),
              f"phase 12 never launched {kernel}")
    return windows


def phase_generic(data: dict, nab_choice, card: str) -> tuple[dict, list]:
    """Phase 13, the generic-filter path: the codec and ``h5`` with filters
    other than the delta, whose decode ends in the generic inverse's kernel
    (``iir_decode``); then the kernel against its plain version and timed.
    Returns the launches of each counted window and the kernel's rows."""
    import deltarice_tpu_torch as dt
    from deltarice_tpu_torch.ops import prefilter
    from deltarice_tpu_torch.ops.prefilter_model import blocked

    m, nab_filt = nab_choice
    nab_filt = tuple(nab_filt)
    check(nab_filt != (1, -1), "phase 9's optimize chose the delta filter")
    nab = data["nab"]
    windows = {}
    with captured([(prefilter, "iir_decode_plain")]) as (plain_calls, _ms):
        for label, cfg in (
                (f"nab optimize {list(nab_filt)}",
                 dt.RiceConfig(m, LENGTH, nab_filt)),
                ("nab [-1, 1]", dt.RiceConfig(8, LENGTH, (-1, 1))),
                (f"nab lossy {list(LOSSY_FILTER)}",
                 dt.RiceConfig(8, LENGTH, LOSSY_FILTER))):
            windows.update(generic_batch(label, nab, cfg, (False,))[0])
        windows.update(generic_h5(nab[: H5_ROWS["nab"]],
                                  dt.RiceConfig(m, LENGTH, nab_filt)))
        noptrex = data["noptrex"]
        cfg = dt.RiceConfig(NOPTREX_FILTER_M, noptrex.shape[1],
                            NOPTREX_FILTER)
        label = f"noptrex {list(NOPTREX_FILTER)}"
        noptrex_windows, noptrex_times = generic_batch(label, noptrex, cfg,
                                                       (False, True))
        windows.update(noptrex_windows)
    for kernel in ("split_decode", "concentrate_wide16"):
        check(windows[f"{label} decode(split on)"].get(kernel, 0) > 0,
              f"phase 13 {label} decode(split on) never launched {kernel}")
    on_card = [a for args in plain_calls["iir_decode_plain"] for a in args
               if isinstance(a, torch.Tensor) and a.is_cuda]
    check(not on_card, f"the plain inverse ran on {len(on_card)} CUDA "
          f"tensors in the counted windows")
    for window, n in windows.items():
        check(n.get("iir_decode", 0) > 0 or "encode" in window
              or "write" in window, f"phase 13 {window} never launched "
              f"iir_decode")
        check(n.get("transpose2d", 0) == 0, f"phase 13 {window} launched "
              f"transpose2d")
        # the path of each call follows the filter alone: the lossless
        # filters of up to 8 history taps take the blocked scan
        filt = (LOSSY_FILTER if "lossy" in window else NOPTREX_FILTER
                if window.startswith("noptrex") else (-1, 1)
                if "[-1, 1]" in window else nab_filt)
        want = "blocked" if blocked(filt) else "serial"
        took = {k: v for k, v in n.items() if k.startswith("iir_decode.")}
        check(set(took) <= {f"iir_decode.{want}"}, f"phase 13 {window} took "
              f"{took}, not iir_decode.{want}")
    print(f"[13 generic] every counted decode and read launched iir_decode, "
          f"the lossy filter's by the serial walk and every other by the "
          f"blocked scan; the plain inverse saw no CUDA tensor "
          f"({len(plain_calls['iir_decode_plain'])} calls)")
    decode = {"ms": noptrex_times["decode(split off)"],
              "launches": noptrex_windows[f"{label} decode(split off)"]
              ["iir_decode"]}
    return windows, iir_rows(nab, noptrex, nab_filt, card, decode)


def generic_batch(label, x_np, cfg, splits) -> tuple[dict, dict]:
    """``compress_batch`` / ``decompress_batch`` of ``x_np`` in chunks of
    32 rows, the decode with the split switch off (and on): every stream
    must equal native ``dr_compress``, every decode the input (native
    ``dr_decompress``'s output where the filter is lossy). Returns the
    launches of each window and the ms of each call."""
    import deltarice_tpu_torch as dt
    from deltarice_tpu_torch import native
    from deltarice_tpu_torch.ops import _kernels

    chunks = list(x_np.reshape(-1, CHUNK_ROWS, x_np.shape[1]))
    cd = cfg.to_cd_values()
    windows = {}
    torch.cuda.synchronize()
    _kernels.reset_launches()
    streams = dt.compress_batch(chunks, cfg, device="cuda")
    torch.cuda.synchronize()
    windows[f"{label} encode"] = dict(_kernels.launches)
    for i, (c, s) in enumerate(zip(chunks, streams)):
        check(s == native.native_compress(c, cd),
              f"{label} chunk {i}: stream differs from native dr_compress")
    times = {"encode": cuda_ms(lambda: dt.compress_batch(chunks, cfg,
                                                         device="cuda"), 3)}
    lost = 0
    for on in splits:
        switch = "on" if on else "off"
        split_switch(on)
        _kernels.reset_launches()
        back = dt.decompress_batch(streams, cfg, device="cuda")
        torch.cuda.synchronize()
        windows[f"{label} decode(split {switch})"] = dict(_kernels.launches)
        for i, (c, s, b) in enumerate(zip(chunks, streams, back)):
            want = (c.ravel() if cfg.lossless
                    else native.native_decompress(s, cd))
            check(np.array_equal(b, want), f"{label} chunk {i}: decode "
                  f"(split {switch}) differs from "
                  f"{'the input' if cfg.lossless else 'dr_decompress'}")
            lost += int((b != c.ravel()).sum())
        times[f"decode(split {switch})"] = cuda_ms(
            lambda: dt.decompress_batch(streams, cfg, device="cuda"), 3)
    split_switch(False)
    check(cfg.lossless == (lost == 0), f"{label}: {lost} samples lost")
    raw = x_np.nbytes
    comp = sum(len(s) for s in streams)
    rates = ", ".join(f"{k} {v:.3f} ms = {raw / v / 1e6:.4f} GB/s"
                      for k, v in times.items())
    print(f"[13 generic] {label}: {len(chunks)} chunks of ({CHUNK_ROWS}, "
          f"{x_np.shape[1]}) M={cfg.m}: every stream equals native "
          f"dr_compress, every decode "
          f"{'the input' if cfg.lossless else 'native dr_decompress'}"
          f"{'' if cfg.lossless else f' ({lost} samples lost)'}; ratio "
          f"{comp / raw:.6f}; {rates}; launches "
          f"{json.dumps(windows, sort_keys=True)}")
    return windows, times


def generic_h5(x, cfg) -> dict:
    """``h5.write_dataset`` / ``h5.read_dataset`` of ``x`` on the in-memory
    store with a generic filter: blobs equal to native ``dr_compress`` of
    the zero-padded chunks, the read equal to the input."""
    from deltarice_tpu_torch import h5, native
    from deltarice_tpu_torch.ops import _kernels
    from deltarice_tpu_torch.tools.memstore import MemGroup

    chunks = (CHUNK_ROWS, x.shape[1])
    batch = H5_WINDOW["nab"]
    store = MemGroup()
    windows, wall = {}, {}
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    dset = h5.write_dataset(store, "nab", x, cfg, chunks, batch_chunks=batch,
                            device="cuda")
    wall["write"] = time.perf_counter() - t0
    windows["nab h5 write"] = dict(_kernels.launches)
    cd = cfg.to_cd_values()
    for off, (mask, blob) in dset.id.chunks.items():
        full = np.zeros(chunks, np.int16)
        part = x[off[0]: off[0] + CHUNK_ROWS]
        full[: part.shape[0]] = part
        check(mask == 0 and blob == native.native_compress(full, cd),
              f"nab h5 chunk {off}: blob differs from native dr_compress")
    for on in (False, True):
        switch = "on" if on else "off"
        split_switch(on)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        back = h5.read_dataset(store["nab"], batch_chunks=batch,
                               device="cuda")
        wall[f"read(split {switch})"] = time.perf_counter() - t0
        windows[f"nab h5 read(split {switch})"] = dict(_kernels.launches)
        check(np.array_equal(back, x), f"nab h5 read (split {switch}) "
              f"differs")
    split_switch(False)
    rates = ", ".join(f"{k} {v * 1e3:.1f} ms = {x.nbytes / v / 1e9:.4f} GB/s"
                      for k, v in wall.items())
    print(f"[13 generic] nab h5 {x.shape} M={cfg.m} filter "
          f"{list(cfg.filt)} in {len(dset.id.chunks)} chunks of {chunks}: "
          f"every blob equals native dr_compress, the read is exact with "
          f"the split switch off and on; {rates}; launches "
          f"{json.dumps(windows, sort_keys=True)}")
    return windows


def iir_rows(nab, noptrex, nab_filt, card, decode) -> list[dict]:
    """The generic inverse's kernels against their plain version (run on a
    CPU copy) on the inputs the path gives them, the forward filter's
    output: the blocked scan at Nab (2048, 7000) with phase 9's filter and
    at one NOPTREX h5 bucket (64, 500000) with ``NOPTREX_FILTER`` (its
    plain version on the first ``NOPTREX_PLAIN`` rows x samples); the
    serial walk on a seeded 12-tap filter, the division's edges and filters
    of ``IIR_LONG_TAPS`` taps (history in shared, then global memory). Each
    call's path must be the one ``prefilter_model.plan`` gives. Then the
    times in CUDA graphs (device time) and in a host loop of CUDA events
    (the wrapper's host cost included, as the times before the blocked
    scan were taken): Nab, the lossy filter, the bucket and one chunk,
    each blocked case split into passes A, B and C (``IIR_PASSES``) by one
    ``torch.profiler`` repeat, beside the serial walk on the same inputs;
    and the inverse's share of the NOPTREX decode (``decode``: its ms and
    its launches of the inverse). Returns the Nab and NOPTREX rows."""
    from deltarice_tpu_torch.ops import _kernels
    from deltarice_tpu_torch.ops.prefilter import (
        iir_decode_plain, prefilter_decode, prefilter_encode)
    from deltarice_tpu_torch.ops.prefilter_cuda import iir_decode_serial
    from deltarice_tpu_torch.ops.prefilter_model import plan
    from deltarice_tpu_torch.utils.profiling import graph_ms

    paths = collections.Counter()

    def held(d, filt, want_samples=None, prefix=None):
        before = dict(_kernels.launches)
        got = prefilter_decode(d, filt)
        torch.cuda.synchronize()
        took = [k.split(".", 1)[1] for k, v in _kernels.launches.items()
                if k.startswith("iir_decode.") and v != before.get(k, 0)]
        want_path = plan(filt, d.shape[0], d.shape[1])[0]
        check(took == [want_path], f"iir_decode {tuple(d.shape)} filter "
              f"{list(filt)[:12]} took {took}, not {want_path}")
        paths[want_path] += 1
        part = d if prefix is None else d[: prefix[0], : prefix[1]]
        want = iir_decode_plain(part.cpu(), filt)
        err = max_err(got[: part.shape[0], : part.shape[1]], want)
        check(err == 0, f"iir_decode {tuple(d.shape)} filter "
              f"{list(filt)[:12]} disagrees with its plain version by {err}")
        if want_samples is not None:
            check(torch.equal(got.cpu(), want_samples),
                  f"iir_decode {tuple(d.shape)} filter {list(filt)[:12]} "
                  f"does not give back the samples")
        return err

    rng = np.random.default_rng(0)
    long_filt = (1,) + tuple(int(c) for c in rng.integers(-8, 9, 11))
    x = torch.from_numpy(nab)
    xc = x.cuda()
    d_nab = prefilter_encode(xc, nab_filt)
    errs = [held(d_nab, nab_filt, x if abs(nab_filt[0]) == 1 else None),
            held(prefilter_encode(xc, long_filt), long_filt, x)]
    edge = torch.from_numpy(nab[:256].copy())
    edge[:, ::97] = -32768
    edge[:, 1::89] = 32767
    edgec = edge.cuda()
    for filt in IIR_EDGES:
        errs.append(held(edgec, filt))
    xs = x[:64, :2000].contiguous()
    for ntaps in IIR_LONG_TAPS:
        filt = (1,) + tuple(int(c) for c in rng.integers(-3, 4, ntaps - 1))
        errs.append(held(prefilter_encode(xs.cuda(), filt), filt, xs))
    xo = torch.from_numpy(noptrex[:OPT_BUCKET])
    d_opt = prefilter_encode(xo.cuda(), NOPTREX_FILTER)
    errs.append(held(d_opt, NOPTREX_FILTER, xo, NOPTREX_PLAIN))
    print(f"[13 generic] iir_decode equals its plain version: Nab "
          f"{tuple(d_nab.shape)} filter {list(nab_filt)} and a 12-tap "
          f"filter {list(long_filt)} (both give back the samples), the "
          f"edges {[list(f) for f in IIR_EDGES]} on {tuple(edge.shape)}, "
          f"filters of {list(IIR_LONG_TAPS)} taps on {tuple(xs.shape)} "
          f"(give back the samples), NOPTREX {tuple(d_opt.shape)} filter "
          f"{list(NOPTREX_FILTER)} (the plain version on {NOPTREX_PLAIN}; "
          f"the whole bucket gives back the samples); paths "
          f"{json.dumps(dict(sorted(paths.items())))}")

    cases = {"nab": (d_nab, nab_filt),
             "nab lossy": (prefilter_encode(xc, LOSSY_FILTER), LOSSY_FILTER),
             "noptrex": (d_opt, NOPTREX_FILTER),
             # one chunk's rows: what each launch of a batch decode takes
             # where every chunk fills a word bucket of its own
             "noptrex chunk": (d_opt[:CHUNK_ROWS], NOPTREX_FILTER)}
    timed = {}
    for key, (d, filt) in cases.items():
        path, block, nb = plan(filt, *d.shape)
        inverse = functools.partial(prefilter_decode, d, filt)
        serial = functools.partial(iir_decode_serial, d, filt)
        t = {"path": path, "block": block, "nblocks": nb,
             "ms": graph_ms([inverse]), "host_loop_ms": cuda_ms(inverse, 20),
             "serial_ms": graph_ms([serial], reps=5),
             "serial_host_loop_ms": cuda_ms(serial, 5)}
        passes = ""
        if path == "blocked":
            prof = profiled_rows(lambda: [inverse() for _ in range(5)],
                                 IIR_PASSES.values())
            t["passes_ms"] = {k: per_call(prof, name, 1)
                              for k, name in IIR_PASSES.items()}
            passes = " = passes " + ", ".join(
                f"{k} {ms_text(v)}" for k, v in t["passes_ms"].items()) + (
                " (torch.profiler, 5 calls)")
        timed[key] = t
        print(f"[13 generic] iir_decode {key} {tuple(d.shape)} filter "
              f"{list(filt)}: {path}, blocks of {block} x {nb}: "
              f"{t['ms']:.4f} ms in a CUDA graph{passes}, "
              f"{t['host_loop_ms']:.4f} ms in a host loop; the serial walk "
              f"(the design before the blocked scan) on the same input "
              f"{t['serial_ms']:.4f} ms in a graph, "
              f"{t['serial_host_loop_ms']:.4f} ms in a host loop; {card}")
    plain = {"nab": cuda_ms(lambda: iir_decode_plain(d_nab, nab_filt), 1),
             "noptrex": cuda_ms(lambda: iir_decode_plain(
                 d_opt[:, :NOPTREX_PLAIN_TIMED], NOPTREX_FILTER), 1)}
    chunk = timed["noptrex chunk"]
    share = decode["launches"] * chunk["ms"] / decode["ms"]
    print(f"[13 generic] the inverse's share of the NOPTREX generic decode "
          f"(split off): {decode['launches']} launches x {chunk['ms']:.4f} "
          f"ms (one chunk, in a graph) = "
          f"{decode['launches'] * chunk['ms']:.4f} ms of "
          f"{decode['ms']:.4f} ms = {100 * share:.2f} %; {card}")
    rows = []
    for key, d, filt in (("nab", d_nab, nab_filt),
                         ("noptrex", d_opt, NOPTREX_FILTER)):
        moved = 2 * nbytes(d)  # each sample read once and written once
        t = timed[key]
        row = kernel_row("iir_decode", "deltarice_tpu_torch/csrc/prefilter.cu",
                         "deltarice_tpu/ops/prefilter.py:81", max(errs),
                         t["ms"], plain[key], list(d.shape), moved, None,
                         key)
        row.update({k: v for k, v in t.items() if k != "ms"})
        row.update({"filter": list(filt), "ms_by": "cuda graph",
                    "design_bytes": 3 * nbytes(d)})  # A reads, C reads+writes
        if key == "noptrex":
            row.update({"plain_shape": [OPT_BUCKET, NOPTREX_PLAIN_TIMED],
                        "chunk": {k: v for k, v in chunk.items()},
                        "chunk_shape": [CHUNK_ROWS, d.shape[1]],
                        "decode_ms": decode["ms"],
                        "decode_launches": decode["launches"],
                        "decode_share": share})
        else:
            row.update({"lossy": timed["nab lossy"],
                        "lossy_filter": list(LOSSY_FILTER)})
        rows.append(row)
        print(f"[13 generic] iir_decode {tuple(d.shape)} filter {list(filt)}"
              f": {t['ms']:.4f} ms, bound {bound_ms(moved):.4f} ms "
              f"({moved} B over 3.35 TB/s; the blocked design moves "
              f"{3 * nbytes(d)} B), plain on the card {plain[key]:.4f} ms"
              f"{'' if key == 'nab' else f' on {NOPTREX_PLAIN_TIMED} samples'}"
              f"; {card}")
    return rows


def tests_module(name: str):
    """``tests/<name>.py``, imported by path: the card's machine runs this
    script from the root of a checkout, where ``tests`` is no package."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hostile_cases():
    """``tests/hostile_cases.py``: the corpus of hostile streams."""
    return tests_module("hostile_cases")


@contextlib.contextmanager
def faulty_frames(hc, fault: str, calls: set):
    """``codec.frame_stream`` wrapped by ``hostile_cases.faulty_frames``
    inside the block: the numbered calls' streams get a payload bit flipped
    or are cut to 6 bytes. Yields the count of calls made."""
    from deltarice_tpu_torch import codec

    real = codec.frame_stream
    codec.frame_stream = hc.faulty_frames(calls, real, fault)
    try:
        yield codec.frame_stream.count
    finally:
        codec.frame_stream = real


def hostile_reference(name, cfg):
    """What a card decode of a hostile stream is held to, one stream and a
    batch: the port's CPU decode for Nab; for nEDM and NOPTREX, whose plain
    decode steps through 81920 and 500000 samples a call (minutes for the
    corpus), native ``dr_decompress``, which
    ``tests/test_torch_robustness.py`` holds equal to the port's CPU decode
    and the JAX package's on every family of the corpus."""
    import deltarice_tpu_torch as dt
    from deltarice_tpu_torch.native import native_decompress

    if name.startswith("nab"):
        return ("the port's CPU decode",
                lambda s: dt.decompress(s, cfg, device="cpu"),
                lambda b: dt.decompress_batch(b, cfg, device="cpu"))
    cd = cfg.to_cd_values()
    return ("native dr_decompress",
            lambda s: native_decompress(s, cd),
            lambda b: [native_decompress(s, cd) for s in b])


def hostile_corpus(hc, name, cfg, chunk, flips, generic=False) -> dict:
    """The corpus of one valid stream of ``chunk`` through ``decompress``
    (a stream a call) and ``decompress_batch`` (the walkable streams of the
    original total, split switch off and on) on the card, against
    :func:`hostile_reference`; a valid decode after each case is exact."""
    import deltarice_tpu_torch as dt
    from deltarice_tpu_torch import codec
    from deltarice_tpu_torch.native import native_compress

    t0 = time.perf_counter()
    cd = cfg.to_cd_values()
    blob = dt.compress(chunk, cfg, device="cuda")
    check(blob == native_compress(chunk, cd), f"hostile {name} {cfg.filt}: "
          f"the clean stream differs from native")
    total, nseg = chunk.size, cfg.segments(chunk.size)[0]
    if generic:
        cases = hc.flips(blob, flips) + hc.bad_payloads(blob, nseg)
    else:
        stride = 97 * max(1, -(-len(blob) // (97 * HOSTILE_CUTS)))
        cases = hc.corpus(blob, nseg, flips, stride)
    label, ref_one, ref_batch = hostile_reference(name, cfg)
    kinds = collections.Counter()
    batch = hc.batchable([s for _c, s in cases], nseg, total)
    for case, s in cases:
        if s in batch:
            continue
        got = hc.outcome(lambda b: dt.decompress(b, cfg, device="cuda"), s)
        want = hc.outcome(ref_one, s)
        check(hc.same(got, want), f"hostile {name} {case}: the card "
              f"{got[0]}, {label} {want[0]}")
        kinds[got[0]] += 1
    torch.cuda.synchronize()
    want = [("returned", np.asarray(r)) for r in ref_batch(batch)]
    for on in (False, True):
        split_switch(on)
        with captured([(codec, "unpack_decode_split")]) as (calls, _ms):
            handle = codec.decompress_batch_dispatch(batch, cfg, "cuda")
            got = codec.decompress_batch_collect(handle)
        for i, (g, w) in enumerate(zip(got, want)):
            check(hc.same(("returned", g), w), f"hostile {name} batch "
                  f"stream {i} (split {'on' if on else 'off'}) differs from "
                  f"{label}")
    split_switch(False)
    kinds["returned"] += len(batch)
    valid = dt.decompress(blob, cfg, device="cuda")
    check(np.array_equal(valid, ref_one(blob)) and (
        not cfg.lossless or np.array_equal(valid, chunk.ravel())),
          f"hostile {name}: a valid decode after the corpus is not exact")
    # the flags sit in pinned memory, complete once collect has returned
    parts = sorted({c[5] for c in calls["unpack_decode_split"]})
    bad = sum(int(f.sum()) for _i, _d, f, _w in handle[3] if f is not None)
    print(f"[14 hostile] {name} ({CHUNK_ROWS}, {cfg.waveform_length}) M="
          f"{cfg.m} filter {list(cfg.filt)}: {len(cases)} cases, "
          f"{kinds['raised']} raised ValueError, {kinds['returned']} "
          f"returned, every one equal to {label}; {len(batch)} in one "
          f"decompress_batch, equal with the split switch off and on (split "
          f"decode P={parts or 'not taken'}, B9 flagged {bad} segments); a "
          f"valid decode after it exact; {time.perf_counter() - t0:.1f} s")
    return {"cases": len(cases), "raised": kinds["raised"],
            "returned": kinds["returned"], "batch": len(batch),
            "split_parts": parts, "flagged": bad}


def hostile_verify(hc, name, cfg, chunks) -> None:
    """Verify-retry on the card: a transient payload fault and a cut header
    in the third chunk framed recover to native ``dr_compress``'s bytes,
    split switch off and on; a fault on every frame raises RuntimeError."""
    import deltarice_tpu_torch as dt
    from deltarice_tpu_torch.native import native_compress

    cd = cfg.to_cd_values()
    want = [native_compress(c, cd) for c in chunks]
    for on in (False, True):
        split_switch(on)
        for fault in ("payload", "header"):
            with faulty_frames(hc, fault, {2}) as count:
                got = dt.compress_batch(chunks, cfg, verify=True,
                                        device="cuda")
            check(got == want, f"hostile verify {name} {fault} (split "
                  f"{'on' if on else 'off'}): streams differ from native")
            check(count[0] == len(chunks) + 1,
                  f"hostile verify {name} {fault}: {count[0]} frames")
    split_switch(False)
    with faulty_frames(hc, "payload", set(range(1000))):
        try:
            dt.compress_batch(chunks[:2], cfg, verify=True, retries=1,
                              device="cuda")
            raised = ""
        except RuntimeError as e:
            raised = str(e)
    check("round-trip verification" in raised,
          f"hostile verify {name}: a persistent fault did not raise")


def hostile_h5(hc, name, cfg, x) -> None:
    """``write_dataset(verify=True)`` with a fault in the second of three
    windows (every blob native ``dr_compress``'s), a read with a truncated
    chunk (ValueError), then an exact read of the repaired dataset."""
    from deltarice_tpu_torch import h5
    from deltarice_tpu_torch.native import native_compress
    from deltarice_tpu_torch.tools.memstore import MemGroup

    chunks = (CHUNK_ROWS, x.shape[1])
    store = MemGroup()
    with faulty_frames(hc, "payload", {2}):
        dset = h5.write_dataset(store, name, x, cfg, chunks, batch_chunks=2,
                                verify=True, device="cuda")
    cd = cfg.to_cd_values()
    for off, (_mask, blob) in dset.id.chunks.items():
        check(blob == native_compress(x[off[0]: off[0] + CHUNK_ROWS], cd),
              f"hostile h5 {name} chunk {off}: blob differs from native")
    off = (2 * CHUNK_ROWS, 0)
    mask, blob = dset.id.read_direct_chunk(off)
    dset.id.write_direct_chunk(off, blob[:-4], mask)
    try:
        h5.read_dataset(dset, cfg, 2, device="cuda")
        raised = False
    except ValueError:
        raised = True
    check(raised, f"hostile h5 {name}: a truncated chunk read without error")
    dset.id.write_direct_chunk(off, blob, mask)
    check(np.array_equal(h5.read_dataset(dset, cfg, 2, device="cuda"), x),
          f"hostile h5 {name}: the read after the damaged one is not exact")


def phase_hostile(data: dict) -> dict:
    """Phase 14: corrupt streams and verify-retry on the card at the full
    chunk shapes of the three geometries; returns the launches of each
    counted window."""
    import deltarice_tpu_torch as dt
    from deltarice_tpu_torch.models import get_profile
    from deltarice_tpu_torch.ops import _kernels

    hc = hostile_cases()
    cfgs = {name: get_profile(name).config for name in HOSTILE_FLIPS}
    windows, t = {}, time.perf_counter()
    _kernels.reset_launches()
    for name, flips in HOSTILE_FLIPS.items():
        hostile_corpus(hc, name, cfgs[name], data[name][:CHUNK_ROWS], flips)
    for filt in hc.GENERIC_FILTERS:
        cfg = dt.RiceConfig(8, LENGTH, filt)
        hostile_corpus(hc, "nab", cfg, data["nab"][:CHUNK_ROWS],
                       HOSTILE_FILTER_FLIPS, generic=True)
    torch.cuda.synchronize()
    windows["corpus"] = dict(_kernels.launches)
    print(f"[14 hostile] corpus {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    _kernels.reset_launches()
    for name, cfg in cfgs.items():
        n = 4 if name == "nab" else 8  # 8 long chunks: the split router
        hostile_verify(hc, name, cfg, list(data[name][: n * CHUNK_ROWS].reshape(
            n, CHUNK_ROWS, -1)))
    torch.cuda.synchronize()
    windows["verify"] = dict(_kernels.launches)
    print(f"[14 hostile] verify-retry: a payload fault and a cut header "
          f"recover to native dr_compress's bytes on Nab (4 chunks), nEDM "
          f"and NOPTREX (8 chunks each), split switch off and on; a "
          f"persistent fault raises RuntimeError; "
          f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    _kernels.reset_launches()
    for name, cfg in cfgs.items():
        hostile_h5(hc, name, cfg, data[name][: 6 * CHUNK_ROWS])
    torch.cuda.synchronize()
    windows["h5"] = dict(_kernels.launches)
    print(f"[14 hostile] h5: write_dataset(verify=True) repairs a fault in "
          f"the second of three windows (every blob native's), a truncated "
          f"chunk raises ValueError, the next read is exact; "
          f"{time.perf_counter() - t:.1f} s")
    need = {"corpus": ("unpack_decode", "split_decode", "concentrate_wide16",
                       "iir_decode", "pack_encode", "concentrate_packed",
                       "concentrate_wide"),
            "verify": ("pack_encode", "unpack_decode", "concentrate_packed",
                       "concentrate_wide", "split_decode"),
            "h5": ("pack_encode", "unpack_decode")}
    for window, names in need.items():
        for kernel in names:
            check(windows[window].get(kernel, 0) > 0,
                  f"hostile {window} never launched {kernel}")
    print(f"[14 hostile] launches {json.dumps(windows, sort_keys=True)}")
    hostile_kernels(hc, data)
    phase_memcheck()
    return windows


def guarded(t: torch.Tensor, seed: int) -> torch.Tensor:
    """``t`` on the card at the front of a buffer whose tail holds
    ``GUARD`` random elements of ``seed``: a contiguous tensor of ``t``'s
    shape. A kernel that read past its input would see the tail."""
    n = t.numel()
    buf = torch.empty(n + GUARD, dtype=t.dtype, device="cuda")
    info = np.iinfo(np.int16 if t.dtype == torch.int16 else np.int32)
    tail = np.random.default_rng(seed).integers(info.min, info.max, GUARD)
    buf[n:] = torch.from_numpy(tail.astype(info.dtype)).cuda()
    view = buf[:n].view(t.shape)
    view.copy_(t)
    return view


def guard_equal(fn, inputs, plain=None) -> bool:
    """``fn`` on ``inputs`` (tensors) placed before two different guard
    tails gives the same output both times, and the plain version's where
    ``plain`` is given (run on CPU copies)."""
    outs = []
    for seed in (1, 2):
        got = fn(*[guarded(a, seed + i) for i, a in enumerate(inputs)])
        torch.cuda.synchronize()
        outs.append(got if isinstance(got, tuple) else (got,))
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    if plain is not None:
        want = plain(*[a.cpu() for a in inputs])
        want = want if isinstance(want, tuple) else (want,)
        same = same and all(torch.equal(a.cpu(), b)
                            for a, b in zip(outs[0], want))
    return same


def plane(blob: bytes, nseg: int):
    """A stream's segments as the decode kernels take them: (nseg, W) int32
    words, zero past each segment's words and one pad word (a CPU tensor),
    and the word counts of the header walk."""
    from deltarice_tpu_torch import codec

    buf = np.frombuffer(blob, dtype="<u4")
    counts, starts = codec.walk_headers(buf, nseg)
    w = codec.gather_segments(buf, counts, starts)
    return torch.from_numpy(w.view(np.int32)), counts


def hostile_planes(hc, cfg, chunk) -> list:
    """(case, words, counts, stream) of the one-segment and bad-payload
    streams of ``chunk``'s native stream: the planes phases 14 and 15 hand
    the decode kernels."""
    from deltarice_tpu_torch.native import native_compress

    nseg = cfg.segments(chunk.size)[0]
    blob = native_compress(chunk, cfg.to_cd_values())
    return [(case, *plane(s, nseg), s) for case, s in
            hc.one_segment(blob, nseg) + hc.bad_payloads(blob, nseg)]


def garbage_words(hc, cfg, chunk) -> torch.Tensor:
    """One word plane (a CPU tensor) of the walkable flipped and
    bad-payload streams of ``chunk`` under a generic filter, every row
    padded to one width: what B2 decodes into the generic inverse's
    garbage input."""
    from deltarice_tpu_torch.native import native_compress

    nseg = cfg.segments(chunk.size)[0]
    blob = native_compress(chunk, cfg.to_cd_values())
    cases = hc.flips(blob, 8) + hc.bad_payloads(blob, nseg)
    rows = [plane(s, nseg)[0] for s in hc.batchable(
        [s for _c, s in cases], nseg, chunk.size)]
    width = max(r.shape[1] for r in rows)
    return torch.cat([torch.nn.functional.pad(r, (0, width - r.shape[1]))
                      for r in rows])


def hostile_kernels(hc, data) -> None:
    """The decode kernels on hostile words, each input before two random
    guard tails: B2 on the one-segment and bad-payload planes of every
    geometry, B9 + B6 on the nEDM and NOPTREX hostile batches, the generic
    inverse on Nab's garbage decodes. Equal across the tails, and to the
    plain version at Nab, where it runs in seconds."""
    import deltarice_tpu_torch as dt
    from deltarice_tpu_torch.models import get_profile
    from deltarice_tpu_torch.ops import prefilter
    from deltarice_tpu_torch.ops.split_decode import unpack_decode_split
    from deltarice_tpu_torch.ops.unpack_cuda import (
        unpack_decode, unpack_decode_plain)

    t0 = time.perf_counter()
    said = []
    for name in HOSTILE_FLIPS:
        cfg = get_profile(name).config
        n = cfg.waveform_length
        for case, words, counts, _s in hostile_planes(
                hc, cfg, data[name][:CHUNK_ROWS]):
            for delta in (True, False):
                check(guard_equal(
                    lambda w: unpack_decode(w, n, cfg.k, delta), [words],
                    (lambda w: unpack_decode_plain(w, n, cfg.k, delta))
                    if name == "nab" else None),
                    f"B2 on the {name} {case} plane")
            if name != "nab":
                nv = np.full(CHUNK_ROWS, n)
                for parts in (8, 32):
                    check(guard_equal(
                        lambda w: unpack_decode_split(w, counts, n, cfg.k,
                                                      True, parts, nv),
                        [words]), f"B9 + B6 on the {name} {case} plane, "
                        f"{parts} parts")
        said.append(name)
    for filt in hc.GENERIC_FILTERS:
        cfg = dt.RiceConfig(8, LENGTH, filt)
        words = garbage_words(hc, cfg, data["nab"][:CHUNK_ROWS]).cuda()
        values = unpack_decode(words, LENGTH, cfg.k, False)
        check(guard_equal(lambda v: prefilter.prefilter_decode(v, cfg.filt),
                          [values],
                          lambda v: prefilter.prefilter_decode(v, cfg.filt)),
              f"the generic inverse on the garbage decodes of {filt}")
    print(f"[14 hostile] kernels on hostile words, each input before two "
          f"random guard tails of {GUARD} elements: B2 on the one-segment "
          f"and bad-payload planes of {', '.join(said)} (delta and not), B9 "
          f"+ B6 on nEDM's and NOPTREX's at 8 and 32 parts, the generic "
          f"inverse (blocked and serial) on Nab's garbage decodes of "
          f"{list(hc.GENERIC_FILTERS)}: equal across the tails, and to the "
          f"plain version at Nab; {time.perf_counter() - t0:.1f} s")


def phase_memcheck() -> None:
    """Run :func:`memcheck_child` under ``compute-sanitizer --tool
    memcheck``; its error summary must say 0 errors. The caching allocator
    is off there, so every tensor is an allocation of its own and a read
    past one is seen. Where the toolkit has no compute-sanitizer, says so:
    "not checked"."""
    import shutil

    tool = (shutil.which("compute-sanitizer")
            or "/usr/local/cuda/bin/compute-sanitizer")
    if not Path(tool).is_file():
        print("[14 hostile] memcheck: compute-sanitizer not found, not "
              "checked")
        return
    t0 = time.perf_counter()
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    res = subprocess.run(
        [tool, "--tool", "memcheck", "--error-exitcode", "1",
         sys.executable, str(ROOT / "chip_smoke.py"), "--memcheck"],
        capture_output=True, text=True, timeout=MEMCHECK_TIMEOUT, env=env,
        cwd=ROOT)
    out = res.stdout + res.stderr
    if "Device not supported" in out:
        version = re.findall(r"Version (\S+)", subprocess.run(
            [tool, "--version"], capture_output=True, text=True).stdout)
        print(f"[14 hostile] memcheck: not checked: compute-sanitizer "
              f"{version[0] if version else ''} refuses this card (\"Device "
              f"not supported\"); the guard tails above stand in for it")
        return
    summary = re.findall(r"ERROR SUMMARY: (\d+) error", out)
    said = [ln for ln in res.stdout.splitlines() if ln.startswith("[memcheck]")]
    for ln in said:
        print(f"[14 hostile] {ln}")
    if res.returncode != 0 or summary != ["0"]:
        tail = "\n".join(out.splitlines()[-40:])
        raise SmokeFailure(f"memcheck: rc {res.returncode}, summary "
                           f"{summary}:\n{tail}")
    print(f"[14 hostile] memcheck: ERROR SUMMARY: 0 errors over B1, B2, B3, "
          f"B5, B6, B9 and the generic inverse; "
          f"{time.perf_counter() - t0:.1f} s")


def memcheck_runs(hc, geoms) -> list:
    """The streams of the memcheck set: (name, cfg, chunk) of each
    geometry's chunk and of the Nab chunk under each generic filter.
    ``geoms`` maps each geometry to its (cfg, chunk)."""
    import deltarice_tpu_torch as dt

    nab_cfg, nab = geoms["nab"]
    return ([(name, cfg, chunk) for name, (cfg, chunk) in geoms.items()]
            + [(f"nab.{'_'.join(map(str, f))}",
                dt.RiceConfig(8, nab_cfg.waveform_length, f), nab)
               for f in hc.GENERIC_FILTERS])


def memcheck_stream(hc, name, cfg, chunk, device="cuda") -> list:
    """One stream of the memcheck set on ``device``: its encode (native
    ``dr_compress``'s bytes), a bucket of its corrupt streams (flips and bad
    payloads) through ``decompress_batch`` with the split switch off and on
    (native ``dr_decompress``'s samples), its one-segment stream through
    ``decompress``, and, lossless, a verify-retry of a cut header. Returns
    what came out."""
    import deltarice_tpu_torch as dt
    from deltarice_tpu_torch.native import native_compress, native_decompress

    cd = cfg.to_cd_values()
    nseg = cfg.segments(chunk.size)[0]
    blob = dt.compress(chunk, cfg, device=device)
    check(blob == native_compress(chunk, cd), f"{name}: encode")
    cases = hc.flips(blob, MEMCHECK_FLIPS) + hc.bad_payloads(blob, nseg)
    batch = hc.batchable([s for _n, s in cases], nseg, chunk.size)
    want = [native_decompress(s, cd) for s in batch]
    outs = [blob]
    for on in (False, True):
        split_switch(on)
        got = dt.decompress_batch(batch, cfg, device=device)
        check(all(np.array_equal(g, w) for g, w in zip(got, want)),
              f"{name} {list(cfg.filt)}: a hostile decode differs")
        outs += got
    split_switch(False)
    wide = hc.one_segment(blob, nseg)[0][1]
    got = dt.decompress(wide, cfg, device=device)
    check(np.array_equal(got, native_decompress(wide, cd)),
          f"{name}: the one-segment stream differs")
    outs.append(got)
    if cfg.lossless:  # a lossy filter never round-trips
        with faulty_frames(hc, "header", {0}):
            got = dt.compress_batch([chunk], cfg, verify=True, device=device)
        check(got == [blob], f"{name}: verify-retry")
    return outs


def memcheck_child() -> int:
    """What phase 14 runs under compute-sanitizer: the memcheck set (one
    bucket of corrupt streams of each geometry, split switch off and on, the
    generic filters' flips on Nab, and a verify-retry with a cut header on
    each geometry). Prints its launches; exits nonzero on a mismatch."""
    sys.path.insert(0, str(ROOT))
    from deltarice_tpu_torch.ops import _kernels

    hc = hostile_cases()
    _kernels.reset_launches()
    try:
        runs = memcheck_runs(hc, guard_geometries())
        for name, cfg, chunk in runs:
            memcheck_stream(hc, name, cfg, chunk)
            torch.cuda.synchronize()
        for kernel in ("pack_encode", "concentrate_packed", "concentrate_wide",
                       "unpack_decode", "split_decode", "concentrate_wide16",
                       "iir_decode.blocked", "iir_decode.serial"):
            check(_kernels.launches.get(kernel, 0) > 0,
                  f"the memcheck run never launched {kernel}")
    except SmokeFailure as e:
        print(f"[memcheck] FAILED: {e}")
        return 1
    print(f"[memcheck] {len(runs)} streams' corrupt buckets (split off and "
          f"on), one-segment streams and verify-retries; launches "
          f"{json.dumps(dict(_kernels.launches), sort_keys=True)}")
    return 0


class GuardCase(NamedTuple):
    """One case of phase 15: ``run(device)`` runs it on ``device`` and
    returns what came out, or raises :class:`SmokeFailure` where an output
    differs from its reference; ``launches`` are the kernel wrappers it
    launches on the card."""

    name: str
    launches: tuple
    run: Callable


def guard_geometries(rows: int = CHUNK_ROWS) -> dict:
    """(cfg, chunk) of each geometry: ``rows`` synthetic waveforms of seed
    0 at the profile's own length and M."""
    from deltarice_tpu_torch.models import get_profile

    return {name: (get_profile(name).config,
                   get_profile(name).synthetic(rows, seed=0))
            for name in HOSTILE_FLIPS}


def _on(a, device):
    """Tensors (also inside tuples and lists) on ``device``; other values
    as they are."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    if isinstance(a, (tuple, list)):
        return type(a)(_on(b, device) for b in a)
    return a


def _same(got, want) -> bool:
    """Equal tensors, arrays, bytes (also inside tuples and lists): dtype,
    shape and every element."""
    if isinstance(got, (tuple, list)):
        return (isinstance(want, (tuple, list)) and len(got) == len(want)
                and all(_same(g, w) for g, w in zip(got, want)))
    if isinstance(got, torch.Tensor):
        return (isinstance(want, torch.Tensor) and got.dtype == want.dtype
                and got.shape == want.shape
                and torch.equal(signed(got.cpu()), signed(want.cpu())))
    if isinstance(got, np.ndarray):
        return (isinstance(want, np.ndarray) and got.dtype == want.dtype
                and np.array_equal(got, want))
    return got == want


def _digest(out, h=None) -> str:
    """A short hash of a case's outputs: two runs that differ in anything
    (an output that depends on the poison byte) give two hashes."""
    top = h is None
    h = hashlib.sha1() if top else h
    if isinstance(out, (tuple, list)):
        for o in out:
            _digest(o, h)
    elif isinstance(out, torch.Tensor):
        h.update(str((out.dtype, tuple(out.shape))).encode())
        h.update(signed(out.detach().cpu().contiguous()).numpy().tobytes())
    elif isinstance(out, np.ndarray):
        h.update(str((out.dtype, out.shape)).encode())
        h.update(np.ascontiguousarray(out).tobytes())
    else:
        h.update(repr(out).encode() if not isinstance(out, (bytes, bytearray))
                 else bytes(out))
    return h.hexdigest()[:12] if top else ""


def kernel_case(name, launches, fn, inputs, plain=None) -> GuardCase:
    """``fn`` on ``inputs`` moved to the device, held to ``plain`` (``fn``
    where not given: its wrapper's plain version) on CPU copies. On the CPU
    ``fn`` is its plain version, so that comparison runs on the card."""
    def run(device):
        got = fn(*_on(inputs, device))
        if plain is None and device == "cpu":
            return got
        want = (plain or fn)(*_on(inputs, "cpu"))
        check(_same(got, want), f"{name}: the output differs from the "
              f"plain version's")
        return got
    return GuardCase(name, tuple(launches), run)


def _signal(rows, n, seed, k):
    """(rows, n) int16 of seed: smooth rows (a random walk, small
    residuals) and, for rows 1 and 4 mod 5, uniform noise (escapes)."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(0, 2 ** max(k, 1), (rows, n)), axis=1)
    x = np.clip(np.round(x), -32768, 32767).astype(np.int16)
    noisy = np.arange(rows) % 5 % 3 == 1
    x[noisy] = rng.integers(-32768, 32768, (int(noisy.sum()), n))
    return x


def _packed(x, k):
    """Plain B1 of ``x`` (delta, every sample valid) at the full bound:
    (words with one zero pad word, nwords), CPU tensors."""
    from deltarice_tpu_torch.ops.pack_cuda import pack_encode_plain

    nv = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32)
    cap = -(-25 * x.shape[1] // 32) + 1
    words, nwords, _ = pack_encode_plain(torch.from_numpy(x), nv, None, k,
                                         True, cap)
    w = int(nwords.max()) + 1
    return words[:, :w].contiguous(), nwords


def ragged_cases(tc) -> list[GuardCase]:
    """Case c: every kernel at ragged shapes against its plain version,
    B4, B7 and B8 (on no codec path) included. ``tc`` is
    ``tests/tiled_cases.py``."""
    from deltarice_tpu_torch.ops import prefilter_cuda
    from deltarice_tpu_torch.ops.concentrate_cuda import (
        DEAD, biased_plane, concentrate_packed, concentrate_wide,
        concentrate_wide16)
    from deltarice_tpu_torch.ops.concentrate_tiled_cuda import (
        concentrate_tiled, concentrate_tiled_vd)
    from deltarice_tpu_torch.ops.pack_cuda import pack_encode
    from deltarice_tpu_torch.ops.prefilter import iir_decode_plain
    from deltarice_tpu_torch.ops.prefilter_model import plan
    from deltarice_tpu_torch.ops.split_decode import _local_width
    from deltarice_tpu_torch.ops.split_decode_cuda import (
        split_decode, split_decode_passes)
    from deltarice_tpu_torch.ops.transpose_cuda import transpose2d
    from deltarice_tpu_torch.ops.unpack_cuda import (
        unpack_decode, unpack_tables)

    cases = []
    for i, n in enumerate(RAGGED_N):
        nseg = 33 if i % 2 == 0 else 1
        for k in (0, 15):
            x = _signal(nseg, n, i, k)
            rng = np.random.default_rng(100 + i)
            nv = np.full(nseg, n, np.int32)
            nv[::3] = rng.integers(0, n + 1, len(nv[::3]))
            prev0 = rng.integers(-32768, 32768, nseg).astype(np.int32)
            full = -(-25 * n // 32) + 1
            for cap, diff, p0 in ((full, True, prev0), (max(1, full // 3),
                                                        k == 0, None)):
                cases.append(kernel_case(
                    f"c.pack_encode.n{n}.s{nseg}.k{k}.cap{cap}",
                    ("pack_encode",),
                    lambda a, b, c, k=k, d=diff, cap=cap: pack_encode(
                        a, b, c, k, d, cap),
                    [torch.from_numpy(x), torch.from_numpy(nv),
                     None if p0 is None else torch.from_numpy(p0)]))
            words, _nw = _packed(x, k)
            deltas = (True, False) if n < 4096 else (k == 15,)
            for delta in deltas:
                cases.append(kernel_case(
                    f"c.unpack_decode.n{n}.s{nseg}.k{k}.d{int(delta)}",
                    ("unpack_decode",),
                    lambda w, n=n, k=k, d=delta: unpack_decode(w, n, k, d),
                    [words]))
            cases.append(kernel_case(
                f"c.unpack_tables.n{n}.s{nseg}.k{k}", ("unpack_tables",),
                lambda w, k=k: unpack_tables(w, k), [words]))
    # concentration: slot counts off the 16-byte paths' width (8 slots)
    for i, (rows, r) in enumerate(((1, 1), (33, 7), (1, 9), (33, 1025),
                                   (1, 4099), (33, 7001))):
        vals, disp = tc.random_rows(rows, r, 0.6, 200 + i, gaps=True)
        count = int((disp >= 0).sum(axis=1).max(initial=0))
        v = torch.from_numpy(vals)
        d = torch.from_numpy(disp)
        lead = torch.where(d >= 0, (d << 16) | (v.to(torch.int32) & 0xFFFF),
                           DEAD)
        plane16 = torch.where(d >= 0, biased_plane(
            d.clamp(min=0), v.to(torch.int32) & 0xFFFF), DEAD)
        for n_out in (max(1, count // 2), r + 5):
            cases.append(kernel_case(
                f"c.concentrate_packed.r{r}.s{rows}.o{n_out}",
                ("concentrate_packed",),
                lambda a, b, n_out=n_out: concentrate_packed((a, b), n_out,
                                                             True),
                [lead, v]))
            cases.append(kernel_case(
                f"c.concentrate_packed.narrow.r{r}.s{rows}.o{n_out}",
                ("concentrate_packed",),
                lambda a, n_out=n_out: concentrate_packed((a,), n_out, False),
                [lead]))
            for dtype in (torch.int16, torch.int32):
                cases.append(kernel_case(
                    f"c.concentrate_wide.{str(dtype)[6:]}.r{r}.s{rows}."
                    f"o{n_out}", ("concentrate_wide",),
                    lambda a, b, n_out=n_out: concentrate_wide(a, b, n_out),
                    [v.to(dtype), d]))
            cases.append(kernel_case(
                f"c.concentrate_wide16.r{r}.s{rows}.o{n_out}",
                ("concentrate_wide16",),
                lambda a, n_out=n_out: concentrate_wide16(a, n_out),
                [plane16]))
    # B4: one element, ragged pitches off the vector path, a 3-D batch
    for dtype, shape in ((torch.int16, (1, 1)), (torch.int16, (7, 9)),
                         (torch.uint32, (3, 5)), (torch.int16, (33, 65)),
                         (torch.int32, (9, 1025)), (torch.int16, (2, 7, 9)),
                         (torch.int16, (16, 24))):
        x = torch.from_numpy(np.random.default_rng(7).integers(
            0, 1 << 15, shape).astype(str(dtype)[6:]))
        cases.append(kernel_case(
            f"c.transpose2d.{str(dtype)[6:]}.{'x'.join(map(str, shape))}",
            ("transpose2d",), transpose2d, [x]))
    # B7 and B8 on tiled_cases' ragged slot axes, one-element lanes, and
    # more and fewer output slots than staged
    for case in ("ragged", "scalar_lanes", "n_out_wide", "past_out"):
        for kind in tc.KINDS:
            ps, _rows, sb, n_out, _lanes = tc.planes(case, kind)
            if kind == "vd":
                fn, name = (lambda a, b, n_out=n_out, sb=sb:
                            concentrate_tiled_vd(a, b, n_out, sb)), \
                    "concentrate_tiled_vd"
            else:
                emit = "u32" if kind == "u32" else "int16"
                fn, name = (lambda *p, n_out=n_out, sb=sb, e=emit, b=kind:
                            concentrate_tiled(p, n_out, sb, e, b == "bias")), \
                    "concentrate_tiled"
            cases.append(kernel_case(f"c.{name}.{case}.{kind}", (name,), fn,
                                     list(ps)))
    # B9: one segment and 33, one part and several, with and without a halo,
    # a local width that cuts the rows
    for nseg, n, k, parts, halo in ((1, 1025, 3, 1, 0), (33, 1025, 3, 3, 5),
                                    (1, 7001, 15, 8, 2), (33, 9, 0, 2, 1)):
        words, nw = _packed(_signal(nseg, n, nseg + parts, k), k)
        counts = nw.numpy().astype(np.int64)
        wsub = -(-int(counts.max(initial=1)) // parts)
        wv = np.clip(counts[:, None] - np.arange(parts)[None, :] * wsub, 0,
                     wsub).astype(np.int32).reshape(-1)
        for lw in (_local_width(n, parts), max(1, n // (2 * parts))):
            args = (parts, wsub, halo, lw, k, True)
            cases.append(kernel_case(
                f"c.split_decode.n{n}.s{nseg}.p{parts}.h{halo}.lw{lw}",
                ("split_decode",),
                lambda w, v, a=args: split_decode(w, v, *a),
                [words, torch.from_numpy(wv)]))
        cases.append(GuardCase(
            f"c.split_decode_passes.n{n}.s{nseg}.p{parts}",
            ("split_decode_passes",),
            functools.partial(_passes_run, split_decode_passes, words,
                              torch.from_numpy(wv), args)))
    # the generic inverse: the scalar path (n % 8), n = 8, the blocked scan
    # with one block a row and two, the serial walk with 9 taps and with
    # 1100 (ring in shared memory) and 2500 (ring in global memory)
    rng = np.random.default_rng(11)
    taps_1100 = (1,) + tuple(int(t) for t in rng.integers(-3, 4, 1099))
    taps_2500 = (1,) + tuple(int(t) for t in rng.integers(-3, 4, 2499))
    for label, filt, shape, block in (
            ("scalar", (1, 0, -1), (3, 1001), None),
            ("n8", (1, 0, -1), (5, 8), None),
            ("nb1", (1, -1, 0, 1), (4, 1000), 1024),
            ("nb2", (1, -1, 0, 1), (4, 1000), 504),
            ("serial9", (3, 1, -2, 4, 0, -1, 2, 5, -3), (2, 333), None),
            ("serial1100", taps_1100, (2, 500), None),
            ("serial2500", taps_2500, (2, 700), None)):
        d = torch.from_numpy(rng.integers(-32768, 32768, shape)
                             .astype(np.int16))
        path = plan(filt, *shape, block)[0]
        cases.append(kernel_case(
            f"c.iir_decode.{label}", ("iir_decode", f"iir_decode.{path}"),
            lambda t, f=filt, b=block: (
                prefilter_cuda.iir_decode(t, f, b) if t.is_cuda
                else iir_decode_plain(t, f)), [d]))
    d = torch.from_numpy(rng.integers(-32768, 32768, (3, 1001))
                         .astype(np.int16))
    cases.append(kernel_case(
        "c.iir_decode_serial", ("iir_decode_serial",),
        lambda t: (prefilter_cuda.iir_decode_serial(t, (1, 0, -1))
                   if t.is_cuda else iir_decode_plain(t, (1, 0, -1))), [d]))
    return cases


def _passes_run(passes_fn, words, wv, args, device):
    """B9 stopped after each of its passes on the card (what a stopped
    launch writes is no result: the guard pages and the poison are what
    hold it); nothing on the CPU, where the launch has no plain version."""
    if device == "cpu":
        return []
    for passes in range(1, 5):
        passes_fn(words.to(device), wv.to(device), *args, passes)
    return []


def hostile_guard_cases(hc, geoms) -> list[GuardCase]:
    """Case b: the decode kernels on the hostile planes of phase 14 at each
    geometry's chunk (the one-segment and bad-payload streams), and on
    planes of width 1 (the pad word alone) and 2 and rows full up to the
    pad word. B2 (delta on and off) is held to native ``dr_decompress`` of
    the stream a plane came from (delta off: its wrapped differences), and
    on the made-up planes (``GUARD_MADE_ROWS`` rows) to the plain model of
    its tiled passes (``ops/tiled_model.py``: the serial plain decode takes
    minutes at nEDM and NOPTREX); B9 + B6 (8 and 32 parts) to B2 on every
    segment they do not flag; the generic inverse (blocked and serial) on
    Nab's garbage decodes to its plain version."""
    import deltarice_tpu_torch as dt
    from deltarice_tpu_torch.ops.split_decode import unpack_decode_split
    from deltarice_tpu_torch.ops.unpack_cuda import unpack_decode

    cases = []
    for name, (cfg, chunk) in geoms.items():
        n, k = cfg.waveform_length, cfg.k
        planes = hostile_planes(hc, cfg, chunk)
        rng = np.random.default_rng(3)
        full = rng.integers(1, 1 << 32, (GUARD_MADE_ROWS,
                                         planes[1][1].shape[1]),
                            dtype=np.uint64)
        full[:, -1] = 0
        two = np.zeros((GUARD_MADE_ROWS, 2), np.uint64)
        two[:, 0] = rng.integers(0, 1 << 32, GUARD_MADE_ROWS, dtype=np.uint64)
        for label, words in (
                ("width1", np.zeros((GUARD_MADE_ROWS, 1), np.uint64)),
                ("width2", two), ("full_rows", full)):
            words = torch.from_numpy(words.astype(np.uint32).view(np.int32))
            planes.append((label, words, np.full(GUARD_MADE_ROWS,
                                                 words.shape[1] - 1), None))
        for case, words, counts, stream in planes:
            case = case.replace(" ", "_")
            for delta in (True, False):
                ref = functools.partial(_b2_reference, cfg, len(counts),
                                        stream, delta)
                cases.append(kernel_case(
                    f"b.{name}.{case}.B2.d{int(delta)}", ("unpack_decode",),
                    lambda w, n=n, k=k, d=delta: unpack_decode(w, n, k, d),
                    [words], ref))
            if name == "nab":
                continue
            for parts in (8, 32):
                cases.append(GuardCase(
                    f"b.{name}.{case}.B9.p{parts}",
                    ("split_decode", "concentrate_wide16", "unpack_decode"),
                    functools.partial(_split_run, unpack_decode_split,
                                      unpack_decode, words, counts, n, k,
                                      parts)))
    nab_cfg, nab = geoms["nab"]
    for filt in hc.GENERIC_FILTERS:
        cfg = dt.RiceConfig(8, nab_cfg.waveform_length, filt)
        path = "blocked" if abs(filt[0]) == 1 else "serial"
        cases.append(GuardCase(
            f"b.nab.garbage.{'_'.join(map(str, filt))}",
            ("unpack_decode", "iir_decode", f"iir_decode.{path}"),
            functools.partial(_garbage_run, unpack_decode, cfg,
                              garbage_words(hc, cfg, nab))))
    return cases


def _b2_reference(cfg, nseg, stream, delta, words):
    """What B2 must give on a hostile plane: native ``dr_decompress`` of its
    stream (delta off: the wrapped differences of those samples, which
    B2's delta inverse sums back), or, for a plane made without a stream,
    the plain model of B2's tiled passes (on the CPU: its loop of small
    torch ops would cost the guard allocator a mapping each)."""
    from deltarice_tpu_torch.native import native_decompress
    from deltarice_tpu_torch.ops.tiled_model import decode_tiled

    n = cfg.waveform_length
    if stream is None:
        return decode_tiled(words, n, cfg.k, delta)
    x = native_decompress(stream, cfg.to_cd_values()).reshape(nseg, n)
    if not delta:
        x = np.diff(x.astype(np.int64), axis=1, prepend=0)
        x = (((x + 32768) & 0xFFFF) - 32768).astype(np.int16)
    return torch.from_numpy(np.ascontiguousarray(x))


def _garbage_run(unpack_fn, cfg, words, device):
    """The generic inverse on B2's decode of garbage words, held to its
    plain version on a CPU copy of the same values."""
    from deltarice_tpu_torch.ops import prefilter

    values = unpack_fn(words.to(device), cfg.waveform_length, cfg.k, False)
    got = prefilter.prefilter_decode(values, cfg.filt)
    want = prefilter.iir_decode_plain(values.cpu(), cfg.filt)
    check(_same(got, want), f"the generic inverse {cfg.filt} on garbage "
          f"decodes differs from its plain version")
    return got


def _split_run(split_fn, exact_fn, words, counts, n, k, parts, device):
    """B9 + B6 on a hostile plane: every segment they do not flag must
    equal B2's exact decode of it."""
    w = words.to(device)
    got, bad = split_fn(w, counts, n, k, True, parts,
                        np.full(len(counts), n))
    exact = exact_fn(w, n, k, True)
    ok = ~bad.cpu()
    check(torch.equal(got.cpu()[ok], exact.cpu()[ok]),
          f"B9 + B6 at {parts} parts: a segment they did not flag differs "
          f"from B2's decode")
    return [got[ok.to(got.device)], bad]


def encode_cases(geoms) -> list[GuardCase]:
    """Case d: ``compress_batch`` at every geometry against native
    ``dr_compress``, of the chunk and, in a batch of its own, of the chunk
    with every fifth row uniform noise: Nab with its rows forced over a
    word cap of 256 (so that every row re-encodes at the full bound), nEDM
    and NOPTREX by the split encode, whose merge takes B3 (nEDM's smooth
    chunk) and B5 (NOPTREX, and nEDM's noisy sub-streams, too wide for
    B3's packed planes)."""
    from deltarice_tpu_torch import codec

    cases = []
    for name, (cfg, chunk) in geoms.items():
        noisy = chunk.copy()
        noisy[1::5] = np.random.default_rng(5).integers(
            -32768, 32768, noisy[1::5].shape)
        merge = {"nab": (), "nedm": ("concentrate_packed",
                                     "concentrate_wide"),
                 "noptrex": ("concentrate_wide",)}[name]
        cases.append(GuardCase(
            f"d.{name}", ("pack_encode",) + merge,
            functools.partial(_encode_run, codec, cfg, [chunk, noisy],
                              name == "nab")))
    return cases


def _encode_run(codec, cfg, chunks, capped, device):
    from deltarice_tpu_torch.native import native_compress

    real = codec._words_hint
    if capped:
        codec._words_hint = lambda x, c, n: min(256, c.max_words(n))
    try:
        got = [s for c in chunks
               for s in codec.compress_batch([c], cfg, device=device)]
    finally:
        codec._words_hint = real
    want = [native_compress(c, cfg.to_cd_values()) for c in chunks]
    check([bytes(g) for g in got] == want,
          "compress_batch differs from native dr_compress")
    return got


def guard_cases(hc, tc, geoms) -> list[GuardCase]:
    """Every case of phase 15 in order: a (the memcheck set), b (the
    hostile planes), c (ragged shapes), d (encode)."""
    cases = [GuardCase(f"a.{name}", ("pack_encode", "unpack_decode"),
                       functools.partial(memcheck_stream, hc, name, cfg,
                                         chunk))
             for name, cfg, chunk in memcheck_runs(hc, geoms)]
    return (cases + hostile_guard_cases(hc, geoms) + ragged_cases(tc)
            + encode_cases(geoms))


def own_allocations() -> None:
    """Hand every kernel wrapper clones of its CUDA tensor arguments (also
    inside tuples and lists), wherever the port bound the wrapper's name:
    each input is then an allocation of its own under the guard
    allocator, never a view into a larger buffer."""
    import importlib

    # the modules that bind wrapper names, imported before the rebinding
    importlib.import_module("deltarice_tpu_torch.h5")

    def own(a):
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return a.clone()
        if isinstance(a, (tuple, list)):
            return type(a)(own(b) for b in a)
        return a

    for module, names in GUARD_WRAPPERS.items():
        mod = importlib.import_module(f"deltarice_tpu_torch.ops.{module}")
        for name in names:
            orig = getattr(mod, name)

            @functools.wraps(orig)
            def cloned(*args, _orig=orig, **kw):
                return _orig(*own(args), **{k: own(v) for k, v in kw.items()})

            for m in list(sys.modules.values()):
                port = getattr(m, "__name__", "").startswith(
                    "deltarice_tpu_torch")
                if port and getattr(m, name, None) is orig:
                    setattr(m, name, cloned)


def guard_child(mode: str, fill: int, only: str | None = None) -> int:
    """One placement of phase 15 (``chip_smoke.py --guard MODE --fill N``):
    the guard allocator installed before the first CUDA allocation, every
    kernel input an allocation of its own, then the cases, each announced
    before it runs and confirmed, with a hash of its outputs, after its
    ``torch.cuda.synchronize()``, which must have launched each wrapper
    the case names. Ends with the launches (every wrapper and each path of
    the generic inverse must have launched), the case count and the
    allocator's peak mappings."""
    sys.path.insert(0, str(ROOT))
    from deltarice_tpu_torch.testing import guard

    t0 = time.perf_counter()
    guard.install(mode, fill)
    from deltarice_tpu_torch.ops import _kernels

    own_allocations()
    cases = [c for c in guard_cases(hostile_cases(), tests_module(
        "tiled_cases"), guard_geometries())
             if only is None or c.name.startswith(only)]
    print(f"[guard] {mode} placement, poison 0x{fill:02X}: {len(cases)} "
          f"cases built in {time.perf_counter() - t0:.1f} s", flush=True)
    _kernels.reset_launches()
    try:
        for case in cases:
            print(f"{guard.CASE}{case.name}", flush=True)
            t, n = time.perf_counter(), guard.stats()["allocs"]
            before = collections.Counter(_kernels.launches)
            out = case.run("cuda")
            torch.cuda.synchronize()
            idle = [k for k in case.launches
                    if _kernels.launches[k] == before[k]]
            check(not idle, f"{case.name} never launched {idle}")
            print(f"{guard.OK}{case.name} {_digest(out)} "
                  f"{time.perf_counter() - t:.3f} s "
                  f"{guard.stats()['allocs'] - n} allocations", flush=True)
        if only is None:
            missing = sorted(k for k in GUARD_KERNELS + IIR_PATHS
                             if not _kernels.launches.get(k))
            check(not missing, f"never launched {missing}")
    except SmokeFailure as e:
        print(f"[guard] FAILED {e}", flush=True)
        return 1
    s = guard.stats()
    print(f"[guard] {mode}: {len(cases)} cases, 0 faults, every output equal "
          f"to its reference; launches "
          f"{json.dumps(dict(_kernels.launches), sort_keys=True)}; "
          f"allocations {s['allocs']}, peak {s['peak']} mappings of "
          f"{s['peak_bytes']} bytes; {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 0


def guard_process(args: list[str]) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *args], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def guard_wait(proc: subprocess.Popen, what: str) -> tuple[str, float]:
    """A child's output and seconds; kills and reaps it past
    ``GUARD_TIMEOUT``."""
    t0 = time.perf_counter()
    try:
        out = proc.communicate(timeout=GUARD_TIMEOUT)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        out = proc.communicate()[0]
        raise SmokeFailure(f"{what} ran past {GUARD_TIMEOUT} s:\n"
                           + "\n".join(out.splitlines()[-20:]))
    return out, time.perf_counter() - t0


def control_verdict(fault: str, rc: int, out: str) -> str:
    """What a positive-control child must show: the last byte of an end
    buffer and the first of a front buffer read back, then death in case
    ``control.<fault>`` with an illegal address. Returns the error line;
    raises :class:`SmokeFailure` otherwise."""
    from deltarice_tpu_torch.testing import guard

    unfinished, error = guard.read_child(out)
    check(rc not in (0, None) and unfinished == f"control.{fault}"
          and guard.illegal_address(error)
          and f"{guard.OK}control.end_last" in out
          and f"{guard.OK}control.front_first" in out,
          f"positive control {fault}: rc {rc}, died in {unfinished} with "
          f"{error}:\n" + "\n".join(out.splitlines()[-20:]))
    return error


def guard_verdict(mode: str, rc: int, out: str) -> dict:
    """A placement child's output: the hash of every case's outputs by case
    name. A child that exited nonzero raises :class:`SmokeFailure` naming
    the case it started and did not finish, and its error."""
    from deltarice_tpu_torch.testing import guard

    if rc != 0:
        unfinished, error = guard.read_child(out)
        raise SmokeFailure(f"guard {mode}: the child exited {rc} in case "
                           f"{unfinished} with {error}:\n"
                           + "\n".join(out.splitlines()[-30:]))
    return dict(ln.split()[2:4] for ln in out.splitlines()
                if ln.startswith(guard.OK))


def phase_guard() -> dict:
    """Phase 15: the positive control (two children, run together), then
    both placements as child processes (run together; see
    :func:`guard_child`), whose outputs must also hash alike under their
    two poison bytes; returns each placement's case count and seconds."""
    from deltarice_tpu_torch.testing import guard

    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the children need the card's memory
    guard.build()
    ctl = {fault: guard_process(["-m", "deltarice_tpu_torch.testing.guard",
                                 "control", "--fault", fault])
           for fault in ("past_end", "before_start")}
    said = []
    for fault, proc in ctl.items():
        out, _s = guard_wait(proc, f"the positive control {fault}")
        said.append(f"{fault} died in control.{fault} with "
                    f"\"{control_verdict(fault, proc.returncode, out)}\"")
    print(f"[15 guard] positive control: the last byte of an end buffer and "
          f"the first of a front buffer read back; {'; '.join(said)}; "
          f"{time.perf_counter() - t0:.1f} s")
    procs = {mode: guard_process([str(ROOT / "chip_smoke.py"), "--guard",
                                  mode, "--fill", str(fill)])
             for mode, fill in GUARD_RUNS}
    results, digests = {}, {}
    for mode, proc in procs.items():
        out, secs = guard_wait(proc, f"the guard child {mode}")
        digests[mode] = guard_verdict(mode, proc.returncode, out)
        for ln in out.splitlines():
            if ln.startswith(f"[guard] {mode}"):
                print(f"[15 guard] {ln[8:]}")
        took = re.findall(r"; ([0-9.]+) s$", out.strip())
        results[mode] = {"cases": len(digests[mode]),
                         "seconds": float(took[-1]) if took else secs}
    (a, da), (b, db) = digests.items()
    differ = sorted(k for k in da if da[k] != db.get(k))
    check(da.keys() == db.keys() and not differ,
          f"guard: outputs differ between the {a} and {b} runs (their "
          f"poison bytes differ) in {differ[:10]}")
    took = ", ".join(f"{m} {r['seconds']} s" for m, r in results.items())
    print(f"[15 guard] {len(da)} cases a placement, the children took "
          f"{took}; every output hashes alike under both poison bytes; "
          f"{time.perf_counter() - t0:.1f} s")
    return results


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

    split_switch(False)
    t_all = time.perf_counter()
    try:
        t = time.perf_counter()
        card = phase_device()
        x_np = get_profile("nab").synthetic(ROWS, seed=0)
        kernels = phase_kernels(x_np, card)
        phase_golden()
        counted = {"nab": {"encode+decode": phase_main_path(x_np)}}
        print(f"[1-4] {time.perf_counter() - t:.1f} s")
        calls, data, streams = {}, {"nab": x_np}, {}
        for name, n in LONG.items():
            t = time.perf_counter()
            data[name] = get_profile(name).synthetic(n, seed=0)
            print(f"[5 long {name}] set-up: {n} synthetic waveforms in "
                  f"{time.perf_counter() - t:.1f} s")
            counted[name], calls[name], streams[name] = phase_long(
                name, data[name])
        t = time.perf_counter()
        long_rows, codec_rows = phase_long_kernels(calls, card)
        print(f"[6 long kernels] {time.perf_counter() - t:.1f} s")
        del calls
        for name in H5_ROWS:
            t = time.perf_counter()
            counted[f"{name} h5"] = phase_h5(name, data[name])
            print(f"[7 h5 {name}] {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_overlap(x_np, streams["noptrex"])
        print(f"[8 overlap] {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        nab_choice = phase_tools(x_np)
        print(f"[9 tools] {time.perf_counter() - t:.1f} s")
        check("jax" not in sys.modules and "deltarice_tpu" not in sys.modules,
              "the port imported JAX or the JAX package")
        for path, windows in counted.items():
            for window, n in windows.items():
                check(n.get("transpose2d", 0) == 0,
                      f"{path} {window} launched transpose2d")
        print("[10 layout] no counted window of phases 4-7 launched B4")
        t = time.perf_counter()
        counted["multi-device"] = phase_multi_device(data)
        print(f"[11 multi-device] {card}; {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        counted["tools"] = phase_measurement_tools(card)
        print(f"[12 tools] {card}; no window launched B4; perf_gate's "
              f"three verdicts as they must be; "
              f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        counted["generic"], generic_rows = phase_generic(data, nab_choice,
                                                         card)
        print(f"[13 generic] {card}; {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        counted["hostile"] = phase_hostile(data)
        print(f"[14 hostile] {card}; {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_guard()
        print(f"[15 guard] {card}; {time.perf_counter() - t:.1f} s")
        left = child_processes()
        check(not left, f"processes left running: {left}")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # B1, B2 and B3 have a row at each of two shapes
    rows = kernels + long_rows + codec_rows + generic_rows
    for row in rows:
        paths = {f"{path} {window}": n[row["name"]]
                 for path, windows in counted.items()
                 for window, n in windows.items() if n.get(row["name"])}
        row["launches"] = sum(paths.values())
        row["paths"] = paths
        row["card"] = card
        if row["library_ms"] is None:
            row["library_note"] = NO_LIBRARY[row["name"]]
        if row["name"] == "iir_decode":
            row["note"] = ("the counterpart of an XLA lax.scan, not of a "
                           "Pallas kernel")
        if row["name"] in STAGING_KERNELS:
            row["note"] = ("not on the port's path: B2 and B9 store samples "
                           "at their final index and make no staging")
    print(f"[total] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv: list[str]) -> int:
    """No arguments: the smoke run. ``--memcheck``: phase 14's child under
    compute-sanitizer. ``--guard end|front --fill BYTE [--cases PREFIX]``:
    one placement of phase 15 (the cases whose names start with PREFIX)."""
    if not argv:
        return run()
    if argv == ["--memcheck"]:
        return memcheck_child()
    import argparse

    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--guard", choices=("end", "front"), required=True)
    ap.add_argument("--fill", type=int, required=True)
    ap.add_argument("--cases", default=None)
    args = ap.parse_args(argv)
    if not (torch.cuda.is_available()
            and (ROOT / "deltarice_tpu_torch" / "__init__.py").is_file()):
        print("chip_smoke: the guard child needs a CUDA card and a checkout",
              file=sys.stderr)
        return 2
    return guard_child(args.guard, args.fill, args.cases)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
