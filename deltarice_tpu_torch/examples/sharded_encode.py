"""Chunk-parallel encode and decode over ``torch.distributed`` ranks.

Run from the repository root::

    python -m deltarice_tpu_torch.examples.sharded_encode --world 2 \\
        --backend gloo --device cpu --out DIR

It starts ``--world`` ranks with ``torch.multiprocessing.spawn`` (one
OpenMP thread each unless ``OMP_NUM_THREADS`` says otherwise, as under
torchrun); they meet on a ``file://`` store in DIR, so no rendezvous port
is needed. Every rank is handed the same chunk batch (``--input``, an .npy
of (chunks, segments, L) int16, or a seeded random walk of 16 chunks of
(8, 1024)), codes it at M=8 and, for each count of ``--chunks`` (leading
slices of the batch), runs ``encode_chunks_multihost``,
``decode_chunks_multihost`` of the streams rank 0 got, and
``roundtrip_check_step`` with the pre-filter ``--check-filter`` (the
codec's own by default; a leading tap other than +-1 can lose samples, so
the check counts them). Rank 0 writes the streams (``streams_N.bin`` and
their lengths) and the decoded samples (``decoded_N.npy``) to DIR; every
rank writes ``rank{r}.json`` with its results, its seconds and its kernel
launches, and fails if JAX or the JAX package was imported.

NCCL refuses two ranks on one card: over NCCL give each rank its own card
(``--world`` at most the card count); ranks that share a card use gloo.
Under torchrun, call :func:`.multihost.initialize_distributed` and the same
functions directly.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from deltarice_tpu_torch.config import RiceConfig
from deltarice_tpu_torch.ops import _kernels
from deltarice_tpu_torch.parallel.multihost import (
    decode_chunks_multihost,
    encode_chunks_multihost,
    initialize_distributed,
    spawn_ranks,
)
from deltarice_tpu_torch.parallel.sharded import (
    chunk_mesh,
    put_sharded,
    roundtrip_check_step,
)

M = 8  # Rice parameter of the codec and of the round-trip check
JOIN_TIMEOUT_S = 120  # a rank that hangs fails the run instead


def _batch(path: str | None) -> np.ndarray:
    if path:
        return np.load(path, mmap_mode="r")
    rng = np.random.default_rng(0)
    return np.round(np.cumsum(rng.normal(0, 10, (16, 8, 1024)), axis=-1)
                    ).astype(np.int16)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _rank_main(rank: int, args) -> None:
    device = (f"cuda:{rank % torch.cuda.device_count()}"
              if args.device == "cuda" else "cpu")
    initialize_distributed(device=device, backend=args.backend,
                           init_method=f"file://{Path(args.out) / 'store'}",
                           rank=rank, world_size=args.world)
    try:
        mesh = chunk_mesh(device=device)
        batch = _batch(args.input)
        length = batch.shape[-1]
        cfg = RiceConfig(M, length)
        taps = (tuple(int(t) for t in args.check_filter.split(","))
                if args.check_filter else cfg.filt)
        check_cfg = RiceConfig(M, length, taps)
        counts = ([int(n) for n in args.chunks.split(",")] if args.chunks
                  else [batch.shape[0]])
        # warm-up at the first count's size: NCCL connects its channels for
        # a message size at the first collective of that size
        warm = np.asarray(batch[:counts[0]])
        decode_chunks_multihost(
            _from_root(encode_chunks_multihost(warm, cfg, mesh), mesh), cfg,
            mesh)
        dist.barrier()
        _kernels.reset_launches()  # count the counted runs' launches only
        report = {"rank": mesh.rank, "world": mesh.size,
                  "backend": args.backend, "device": str(mesh.device),
                  "chunks": {}}
        out = Path(args.out)
        for n in counts:
            x = np.asarray(batch[:n])
            dist.barrier()
            t0 = time.perf_counter()
            streams = encode_chunks_multihost(x, cfg, mesh)
            t1 = time.perf_counter()
            everyone = _from_root(streams, mesh)
            dist.barrier()
            t2 = time.perf_counter()
            decoded = decode_chunks_multihost(everyone, cfg, mesh)
            _sync(mesh.device)
            t3 = time.perf_counter()
            pad = (-n) % mesh.size
            xp = np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)])
            nvalid = np.full(xp.shape[:2], length, dtype=np.int32)
            nvalid[n:] = 0
            _w, _nw, mism = roundtrip_check_step(
                put_sharded(xp, mesh), put_sharded(nvalid, mesh), check_cfg,
                mesh, check_cfg.max_words(length))
            report["chunks"][n] = {
                "streams": None if streams is None
                else [len(s) for s in streams],
                "decoded": decoded is not None, "mismatches": mism,
                "encode_s": t1 - t0, "decode_s": t3 - t2,
                "raw_bytes": x.nbytes}
            if streams is not None:
                (out / f"streams_{n}.bin").write_bytes(b"".join(streams))
                np.save(out / f"decoded_{n}.npy", decoded)
        report["launches"] = dict(_kernels.launches)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "deltarice_tpu"))
        report["jax_loaded"] = loaded
        (out / f"rank{mesh.rank}.json").write_text(json.dumps(report))
        if loaded:
            raise RuntimeError(f"rank {rank} imported {loaded[:5]}")
    finally:
        dist.destroy_process_group()


def _from_root(streams, mesh) -> list[bytes]:
    """Rank 0's streams on every rank (each rank of a real deployment reads
    them from the file instead)."""
    box = [streams]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deltarice_tpu_torch.examples.sharded_encode")
    p.add_argument("--world", type=int, default=2, help="ranks to start")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="default: nccl on cuda, gloo on cpu")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", required=True, help="directory for the results")
    p.add_argument("--input", default=None,
                   help=".npy of (chunks, segments, L) int16")
    p.add_argument("--chunks", default=None,
                   help="comma-separated chunk counts (leading slices)")
    p.add_argument("--check-filter", default=None,
                   help="comma-separated pre-filter taps of the round-trip "
                        "check")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu")
    if args.backend is None:
        args.backend = "nccl" if args.device == "cuda" else "gloo"
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "store").unlink(missing_ok=True)
    t0 = time.perf_counter()
    spawn_ranks(_rank_main, args.world, (args,), JOIN_TIMEOUT_S)
    root = json.loads((out / "rank0.json").read_text())
    for n, r in root["chunks"].items():
        print(f"{n} chunks over {args.world} ranks ({args.backend}, "
              f"{args.device}): encode {r['encode_s']:.4f} s, decode "
              f"{r['decode_s']:.4f} s, round-trip mismatches "
              f"{r['mismatches']}")
    print(f"ok: {args.world} ranks in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
