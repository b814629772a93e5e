"""Chunk-level data parallelism over ``torch.distributed``.

The counterpart of ``deltarice_tpu/parallel/sharded.py``. Every HDF5 chunk
is an independent bitstream, so chunks shard over a 1-D ``"chunks"`` mesh
with one rank per device (torchrun's model): each rank runs the port's
single-device codec (B1 to encode, B2 to decode) on its contiguous block
of chunks, which is what ``P("chunks")`` gives a JAX mesh, and no
collective is needed until the mismatch count or the compressed words
leave the ranks. NCCL carries the collectives between cards, gloo on the
host (and between ranks that share one card, which NCCL refuses).

Every function here takes and returns THIS rank's local shard;
:func:`put_sharded` cuts it out of the global batch.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..codec import _on, decode_segments, encode_segments
from ..config import RiceConfig

CHUNK_AXIS = "chunks"


@dataclasses.dataclass(frozen=True)
class ChunkMesh:
    """This process's place on the 1-D chunk mesh.

    ``device`` runs the codec; ``group`` carries the collectives (None: one
    rank and no collective) and ``comm`` is where their tensors live: the
    card under NCCL, the host under gloo. The codec's device stays separate
    from the ``DeviceMesh`` the group comes from, because two gloo ranks
    may share one card.
    """

    device: torch.device
    rank: int = 0
    size: int = 1
    group: "dist.ProcessGroup | None" = None
    comm: torch.device = torch.device("cpu")


def rank_device(device=None, rank: int | None = None) -> torch.device:
    """The codec device of this rank: ``device`` when given, else
    ``cuda:{local_rank % device_count}``, the local rank read from
    ``LOCAL_RANK``, else ``rank``, else the process group's rank. A CUDA
    device without a card raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: pass device='cpu' to run the "
                               "kernels' plain versions")
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA card is "
                           f"available")
    return dev


def chunk_mesh(device=None) -> ChunkMesh:
    """The 1-D chunk mesh of this process.

    With a default process group up, a ``DeviceMesh`` over all its ranks
    (``mesh_dim_names=(CHUNK_AXIS,)``) on the group's device type (``cuda``
    for NCCL, ``cpu`` for gloo); without one, a one-rank mesh with no
    collective. ``device`` is the codec's device (:func:`rank_device`)."""
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        return ChunkMesh(dev)
    from torch.distributed.device_mesh import DeviceMesh

    nccl = dist.get_backend() == "nccl"
    if nccl and dev.type != "cuda":
        raise ValueError(f"NCCL collectives need a CUDA device, not {dev}")
    mesh = DeviceMesh("cuda" if nccl else "cpu",
                      torch.arange(dist.get_world_size()),
                      mesh_dim_names=(CHUNK_AXIS,))
    return ChunkMesh(dev, mesh.get_local_rank(), mesh.size(),
                     mesh.get_group(), dev if nccl else torch.device("cpu"))


def _to_device(a, device) -> torch.Tensor:
    """Array or tensor -> contiguous tensor on ``device`` of the same dtype;
    uint32 words become their int32 bit patterns."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.uint32:
            a = a.view(torch.int32)
        return _on(a, device, a.dtype)
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = np.ascontiguousarray(a).view(np.int32)
    return _on(a, device, torch.from_numpy(np.empty(0, a.dtype)).dtype)


def put_sharded(batch, mesh: ChunkMesh) -> torch.Tensor:
    """This rank's contiguous shard of ``batch``'s leading axis, on its
    device. The leading axis must divide by the mesh size (pad with empty
    chunks, ``nvalid == 0``, to round up)."""
    n = batch.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} chunks do not divide over {mesh.size} ranks; "
                         f"pad with empty chunks")
    per = n // mesh.size
    return _to_device(batch[mesh.rank * per:(mesh.rank + 1) * per],
                      mesh.device)


def _encode_local(x, nvalid, cfg: RiceConfig, max_words: int, device):
    """Encode a local (c, s, L) batch of chunks: :func:`encode_segments`
    (B1, after any FIR pre-filter) on its (c*s, L) segments. Returns words
    (c, s, max_words) int32 bit patterns and nwords (c, s) on ``device``."""
    c, s, length = x.shape
    words, nwords = encode_segments(x.reshape(c * s, length),
                                    nvalid.reshape(-1), cfg, max_words,
                                    device)
    return words.reshape(c, s, max_words), nwords.reshape(c, s)


def _decode_local(words, n_samples: int, cfg: RiceConfig, device,
                  j_eff: int | None = None, has_pad_word: bool = False):
    """Decode a local (c, s, W) batch through :func:`decode_segments` (B2,
    exact; never the split decode). B2 needs a zero pad word past each
    stream: unless the caller knows the last column is one
    (``has_pad_word``), a zero column is appended when it holds bits.
    With ``j_eff`` an all-false (c, s) flag plane comes back too: B2 is exact
    at every rate, so nothing is ever flagged for a re-decode."""
    c, s, w = words.shape
    flat = _to_device(words, device).reshape(c * s, w)
    if not has_pad_word and (w == 0 or bool(flat[:, -1].any())):
        flat = torch.nn.functional.pad(flat, (0, 1))
    out = decode_segments(flat, n_samples, cfg, device)
    out = out.reshape(c, s, n_samples)
    if j_eff is not None:
        return out, torch.zeros((c, s), dtype=torch.bool, device=out.device)
    return out


def encode_chunks_sharded(batch, nvalid, cfg: RiceConfig, mesh: ChunkMesh,
                          max_words: int):
    """Encode this rank's (c, segments, L) int16 shard of a chunk batch.

    Returns its ``words (c, S, max_words)`` (int32 bit patterns) and
    ``nwords (c, S)`` on the rank's device. No collective."""
    return _encode_local(_on(batch, mesh.device, torch.int16),
                         _on(nvalid, mesh.device, torch.int32), cfg,
                         max_words, mesh.device)


def decode_chunks_sharded(words, n_samples: int, cfg: RiceConfig,
                          mesh: ChunkMesh, j_eff: int | None = None):
    """Decode this rank's (c, segments, W) shard of words to (c, S,
    n_samples) int16 samples on its device. With ``j_eff`` (the JAX
    package's service rate) also returns the (c, S) lag flags, all false."""
    return _decode_local(words, n_samples, cfg, mesh.device, j_eff)


def roundtrip_check_step(batch, nvalid, cfg: RiceConfig, mesh: ChunkMesh,
                         max_words: int):
    """Encode -> decode -> compare this rank's shard.

    Returns (words, nwords, mismatches): the local encode, and the global
    count of valid samples (``nvalid`` masks each segment) that failed to
    round-trip, the same on every rank: an all-reduce (sum) over the
    mesh's group, or the local sum on a mesh with no group."""
    x = _on(batch, mesh.device, torch.int16)
    nv = _on(nvalid, mesh.device, torch.int32)
    words, nwords = _encode_local(x, nv, cfg, max_words, mesh.device)
    out = _decode_local(words, x.shape[-1], cfg, mesh.device)
    pos = torch.arange(x.shape[-1], device=x.device)
    bad = ((out != x) & (pos < nv[..., None])).sum(dtype=torch.int64)
    if mesh.group is not None:
        bad = bad.to(mesh.comm)
        dist.all_reduce(bad, op=dist.ReduceOp.SUM, group=mesh.group)
    return words, nwords, int(bad)
