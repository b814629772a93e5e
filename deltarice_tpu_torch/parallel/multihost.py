"""Multi-process chunk pipeline over ``torch.distributed``.

The counterpart of ``deltarice_tpu/parallel/multihost.py``. Every rank is
handed the same global chunk batch (or stream list), encodes or decodes its
own contiguous shard on its device (:mod:`.sharded`), and the only
collectives gather the results to rank 0 in file order: the per-segment
word counts first, then the words cut to the largest count, so the gather
moves about the compressed size and not the worst-case width; on the read
side, the decoded samples. Collectives move device tensors under NCCL and
host tensors under gloo (the gather ends on the host anyway).

Without a process group the same calls run on one rank with no
collective. :func:`initialize_distributed` brings a group up from
torchrun's (or SLURM's) environment or from explicit arguments.
"""

from __future__ import annotations

import os
import time
from multiprocessing import resource_tracker

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..codec import (
    _WORD_BUCKET,
    _is_cuda,
    _segment_layout,
    frame_stream,
    gather_segments,
    walk_headers,
)
from ..config import RiceConfig
from .sharded import (
    ChunkMesh,
    _decode_local,
    chunk_mesh,
    encode_chunks_sharded,
    rank_device,
)


def _launch_kwargs() -> dict | None:
    """``init_process_group`` arguments for a recognised multi-process
    launch: torchrun's (``WORLD_SIZE`` > 1 with ``MASTER_ADDR``) or a
    multi-task SLURM job (rank and size from ``SLURM_PROCID`` /
    ``SLURM_NTASKS``; ``MASTER_ADDR`` / ``MASTER_PORT`` from the job
    script). None on a plain single-process host."""
    if int(os.environ.get("WORLD_SIZE") or 1) > 1 and os.environ.get(
            "MASTER_ADDR"):
        return {"init_method": "env://"}
    if (os.environ.get("SLURM_JOB_ID")
            and int(os.environ.get("SLURM_NTASKS") or 1) > 1):
        return {"init_method": "env://",
                "rank": int(os.environ["SLURM_PROCID"]),
                "world_size": int(os.environ["SLURM_NTASKS"])}
    return None


def initialize_distributed(device=None, **kwargs) -> None:
    """Bring up the default process group (idempotent).

    With explicit ``kwargs`` (``init_method``, ``rank``, ``world_size``,
    ``backend``, ...) this is ``dist.init_process_group(**kwargs)`` and any
    failure propagates: a misconfigured cluster must not fall back to one
    process. Without kwargs it initialises from the environment when a
    multi-process launch is recognised (:func:`_launch_kwargs`), and a
    failure there propagates too, since running such a cluster
    uninitialised would return per-rank partial results; otherwise it does
    nothing.

    The backend, unless named, is NCCL when the rank's device
    (:func:`.sharded.rank_device` of ``device``; the rank's card by
    default) is CUDA, else gloo. A CUDA device without a card raises.
    """
    if dist.is_initialized():
        return
    if not kwargs:
        kwargs = _launch_kwargs()
        if kwargs is None:
            return
    dev = rank_device(device, kwargs.get("rank"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs.setdefault("backend", "nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(**kwargs)


def spawn_ranks(fn, world: int, args=(), timeout_s: float = 120.0) -> None:
    """Run ``fn(rank, *args)`` in ``world`` processes started by
    ``torch.multiprocessing.spawn`` and wait for them. Each gets one OpenMP
    thread unless ``OMP_NUM_THREADS`` says otherwise, as under torchrun:
    every rank's native host helpers otherwise start a team as wide as the
    host, and the teams and NCCL's polling threads oversubscribe it. A rank
    that fails raises here; ranks still running after ``timeout_s`` are
    killed and TimeoutError is raised.

    The spawn also starts multiprocessing's resource tracker, a process
    that would otherwise outlive the caller and be left for init to reap;
    it is stopped and reaped here once the ranks are done (the next spawn
    starts it again)."""
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    try:
        ctx = mp.spawn(fn, args=args, nprocs=world, join=False)
    finally:
        if saved is None:
            del os.environ["OMP_NUM_THREADS"]
    try:
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                for proc in ctx.processes:
                    proc.kill()
                    proc.join()
                raise TimeoutError(
                    f"the ranks did not finish in {timeout_s} s")
    finally:
        resource_tracker._resource_tracker._stop()


def _local_chunks(batch: np.ndarray, mesh: ChunkMesh):
    """This rank's contiguous block of the batch padded with zero chunks to
    a multiple of the mesh size: (chunks (per, S, L), nvalid (per, S) with 0
    on pad chunks). Only the local block is copied."""
    nchunks, nseg, length = batch.shape
    per = -(-nchunks // mesh.size)
    lo = min(mesh.rank * per, nchunks)
    real = batch[lo:min(lo + per, nchunks)]
    nvalid = np.zeros((per, nseg), dtype=np.int32)
    nvalid[:real.shape[0]] = length
    if real.shape[0] < per:
        x = np.zeros((per, nseg, length), dtype=np.int16)
        x[:real.shape[0]] = real
        real = x
    return real, nvalid


def _all_gather(t: torch.Tensor, mesh: ChunkMesh) -> torch.Tensor:
    """Every rank's ``t`` concatenated in rank order, on the host, on every
    rank."""
    if mesh.group is None:
        return t.contiguous().cpu()
    t = t.to(mesh.comm).contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts).cpu()


def _gather_to_root(t: torch.Tensor, mesh: ChunkMesh) -> torch.Tensor | None:
    """Every rank's ``t`` concatenated in rank order, on the host of rank 0;
    None on the other ranks. The tensors travel as bytes (gloo has no
    int16)."""
    if mesh.group is None:
        return t.contiguous().cpu()
    raw = t.to(mesh.comm).contiguous().view(-1).view(torch.uint8)
    parts = ([torch.empty_like(raw) for _ in range(mesh.size)]
             if mesh.rank == 0 else None)
    dist.gather(raw, parts, dst=0, group=mesh.group)
    if parts is None:
        return None
    return (torch.cat(parts).cpu().view(t.dtype)
            .reshape(mesh.size * t.shape[0], *t.shape[1:]))


def encode_chunks_multihost(batch: np.ndarray, cfg: RiceConfig,
                            mesh: ChunkMesh | None = None
                            ) -> list[bytes] | None:
    """Encode a GLOBAL (num_chunks, segments, L) int16 batch across the
    mesh's ranks and return the framed per-chunk streams on rank 0 (None on
    the others).

    Every rank passes the same shapes; only its own block's values are
    read. The chunk count pads to a multiple of the mesh size with empty
    chunks, whose words never reach the output. Each rank encodes at the
    worst-case width ``cfg.max_words(L)``, so no row is cut."""
    mesh = chunk_mesh() if mesh is None else mesh
    nchunks, nseg, length = batch.shape
    if nchunks == 0:
        return [] if mesh.rank == 0 else None
    x, nvalid = _local_chunks(batch, mesh)
    words, nwords = encode_chunks_sharded(x, nvalid, cfg, mesh,
                                          cfg.max_words(length))
    nwords = _all_gather(nwords, mesh).numpy()
    w = max(int(nwords.max(initial=0)), 1)
    words = _gather_to_root(words[:, :, :w], mesh)
    if words is None:
        return None
    words = words.numpy().view(np.uint32)
    return [frame_stream(nseg * length, words[c], nwords[c])
            for c in range(nchunks)]


def decode_chunks_multihost(streams, cfg: RiceConfig,
                            mesh: ChunkMesh | None = None
                            ) -> np.ndarray | None:
    """Decode per-chunk framed streams across the mesh's ranks: the read
    side of :func:`encode_chunks_multihost`.

    Every rank passes the same ``streams``. The header walk runs on the
    host over every stream (it sets the common word bucket: the largest
    count plus a pad word, rounded up to 256); each rank gathers only its
    own block's segments into that bucket (pinned on a card), decodes them
    with B2, and the samples gather to rank 0. Returns ``(num_chunks,
    total_samples)`` int16 there and None on the other ranks; an empty
    list gives a (0, 0) array on every rank.
    """
    mesh = chunk_mesh() if mesh is None else mesh
    streams = list(streams)
    if not streams:
        return np.zeros((0, 0), dtype=np.int16)
    bufs = [np.frombuffer(memoryview(s), dtype="<u4") for s in streams]
    if any(b.size == 0 for b in bufs):
        raise ValueError("truncated Delta-Rice stream")
    total = int(bufs[0][0])
    if any(int(b[0]) != total for b in bufs):
        raise ValueError("multihost decode requires equal-sized chunks")
    nchunks = len(bufs)
    nseg, length = _segment_layout(total, cfg)[:2]
    per_chunk = [walk_headers(buf, nseg) for buf in bufs]
    if total == 0:
        return np.zeros((nchunks, 0), dtype=np.int16) if mesh.rank == 0 \
            else None
    maxw = max(int(c.max(initial=0)) for c, _ in per_chunk)
    bucket = -(-(maxw + 1) // _WORD_BUCKET) * _WORD_BUCKET
    per = -(-nchunks // mesh.size)
    lo = mesh.rank * per
    shape = (per, nseg, bucket)
    if _is_cuda(mesh.device):
        staged = torch.zeros(shape, dtype=torch.int32, pin_memory=True)
        words = staged.numpy().view(np.uint32)
    else:
        staged = words = np.zeros(shape, dtype=np.uint32)
    for j, i in enumerate(range(lo, min(lo + per, nchunks))):
        counts, starts = per_chunk[i]
        gather_segments(bufs[i], counts, starts, bucket, out=words[j])
    # the bucket's last column is past every count: no device check for it
    out = _gather_to_root(_decode_local(staged, length, cfg, mesh.device,
                                        has_pad_word=True), mesh)
    if out is None:
        return None
    return out.reshape(-1, nseg * length)[:nchunks, :total].numpy()
