"""B2: exact Rice decode with the fused delta inverse — CUDA kernel
``csrc/unpack.cu``, the counterpart of ``unpack_decode_pallas`` (exact,
any length, no reduced service rate), parallel inside each segment.

Layout: ``words`` is (nseg, W) segment-major and the samples come back as
(nseg, n_samples), the codec's own layout. :mod:`.tiled_model` is the plain
model of the kernel's passes (tile tables, their composition, the decode
from resolved phases); :func:`unpack_decode_plain` is the serial oracle.
"""

from __future__ import annotations

import torch

from . import _kernels
from .pack_ref import unpack_bits
from .prefilter import prefilter_decode
from .rice import unzigzag
from .tiled_model import PHASES, TILE_WORDS, decode_tables


def unpack_decode_plain(words, n_samples: int, k: int, delta: bool):
    """Plain torch version of :func:`unpack_decode`: the serial walk."""
    v = unzigzag(unpack_bits(words, n_samples, k))
    return prefilter_decode(v) if delta else v


def _check(words: torch.Tensor, k: int) -> None:
    _kernels.require(words, "words", torch.int32, 2)
    w = words.shape[1]
    if w < 1:
        raise ValueError("words needs at least one (pad) word per stream")
    if 32 * w >= 1 << 31:
        raise ValueError(f"{w} words per segment overflow the int32 bit cursor")
    if not 0 <= k <= 15:
        raise ValueError(f"k must be in 0..15, got {k}")


def unpack_decode(words: torch.Tensor, n_samples: int, k: int,
                  delta: bool = True) -> torch.Tensor:
    """Decode each row of ``words`` into ``n_samples`` samples.

    Args:
      words: (nseg, W) int32 uint32 bit patterns, row s one stream, with at
        least one zero pad word past each stream.
      n_samples: samples per segment (past a segment's true length the
        output is garbage by contract, the same garbage as the serial
        decode's clamped cursor).
      k: log2(M), 0..15.
      delta: fuse the [1,-1] inverse (prefix sum); otherwise return the
        un-zigzagged values for a generic-filter inverse.

    Returns:
      (nseg, n_samples) int16.

    A CUDA tensor launches the kernel's passes on the current stream; a CPU
    tensor takes :func:`unpack_decode_plain`.
    """
    _check(words, k)
    if n_samples < 0:
        raise ValueError(f"n_samples must be >= 0, got {n_samples}")
    if not _kernels.route(words):
        return unpack_decode_plain(words, n_samples, k, delta)
    nseg, w = words.shape
    out = torch.empty((nseg, n_samples), dtype=torch.int16,
                      device=words.device)
    lib = _kernels.library()
    nbytes = lib.dr_unpack_scratch_bytes(w, nseg)
    scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                          device=words.device)
    rc = lib.dr_unpack_decode(
        words.data_ptr(), out.data_ptr(), scratch.data_ptr(), nbytes, w,
        nseg, n_samples, k, int(delta), _kernels.stream(),
    )
    _kernels.check(rc, "unpack_decode")
    _kernels.launches["unpack_decode"] += 1
    return out


def unpack_tables(words: torch.Tensor, k: int) -> torch.Tensor:
    """B2's first pass alone: (nseg, ntiles, 25, 3) int32 (exit phase,
    codewords, wrapping int16 sum) of every tile of ``TILE_WORDS`` words and
    entry phase, as :func:`.tiled_model.decode_tables` computes them. A CUDA
    tensor launches the pass; a CPU tensor takes the plain model."""
    _check(words, k)
    if not _kernels.route(words):
        return decode_tables(words, k)
    nseg, w = words.shape
    ntiles = -(-(w - 1) // TILE_WORDS)
    raw = torch.empty((nseg, ntiles, PHASES, 2), dtype=torch.int32,
                      device=words.device)
    rc = _kernels.library().dr_unpack_tables(
        words.data_ptr(), raw.data_ptr(), w, nseg, k, _kernels.stream())
    _kernels.check(rc, "unpack_tables")
    _kernels.launches["unpack_tables"] += 1
    return torch.stack([raw[..., 1] & 0xFF, raw[..., 0], raw[..., 1] >> 16],
                       dim=-1)
