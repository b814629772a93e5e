"""B1: fused delta + zigzag + Rice code + bit pack — CUDA kernel
``csrc/pack.cu``, the counterpart of ``pack_encode_pallas_bits`` at rate 1.

Layout: ``xt`` is (L, nseg) sample-major and the words come back as
(cap, nseg) word-major, so the kernel's one thread per segment reads and
writes coalesced; :mod:`.transpose_cuda` converts at the boundary.
"""

from __future__ import annotations

import torch

from ..config import DELTA_FILTER, ESCAPE_LEN
from . import _kernels
from .pack_ref import pack_bits
from .prefilter import prefilter_encode
from .rice import codeword_lengths_values, zigzag


def pack_encode_plain(xt, nvalid, prev0, k: int, diff: bool, cap: int):
    """Plain torch version of :func:`pack_encode`."""
    x = xt.t()
    d = prefilter_encode(x, DELTA_FILTER, prev0) if diff else x
    lens, vals = codeword_lengths_values(zigzag(d), k)
    pos = torch.arange(x.shape[1], device=x.device)
    lens = torch.where(pos[None, :] < nvalid.to(torch.int64)[:, None], lens, 0)
    words, nwords, nbits = pack_bits(lens, vals, cap)
    return words.t().contiguous(), nwords, nbits.to(torch.int32)


def pack_encode(xt: torch.Tensor, nvalid: torch.Tensor,
                prev0: torch.Tensor | None, k: int, diff: bool, cap: int):
    """Encode each column of ``xt`` into a Rice word stream.

    Args:
      xt: (L, nseg) int16 samples, sample-major (column s is segment s).
      nvalid: (nseg,) int32 valid samples per segment.
      prev0: None or (nseg,) int32 delta state before each segment's first
        sample (``diff`` only).
      k: log2(M), 0..15.
      diff: apply the wrapping delta filter; False takes already
        prefiltered int16 values.
      cap: output rows; words at or past it are dropped.

    Returns:
      words_t: (cap, nseg) int32 uint32 bit patterns, zero past each
        stream (and past ``cap``);
      nwords, nbits: (nseg,) int32, exact regardless of ``cap``.

    A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`pack_encode_plain`.
    """
    _kernels.require(xt, "xt", torch.int16, 2)
    length, nseg = xt.shape
    _kernels.require(nvalid, "nvalid", torch.int32, 1, xt.device)
    if nvalid.shape[0] != nseg:
        raise ValueError("nvalid must have one entry per column of xt")
    if prev0 is not None:
        _kernels.require(prev0, "prev0", torch.int32, 1, xt.device)
        if prev0.shape[0] != nseg:
            raise ValueError("prev0 must have one entry per column of xt")
    if not 0 <= k <= 15:
        raise ValueError(f"k must be in 0..15, got {k}")
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    if length * ESCAPE_LEN >= 1 << 31:
        raise ValueError(f"segment length {length} overflows the int32 bit count")
    if not _kernels.route(xt):
        return pack_encode_plain(xt, nvalid, prev0, k, diff, cap)
    words_t = torch.zeros((cap, nseg), dtype=torch.int32, device=xt.device)
    nwords = torch.empty(nseg, dtype=torch.int32, device=xt.device)
    nbits = torch.empty(nseg, dtype=torch.int32, device=xt.device)
    rc = _kernels.library().dr_pack_encode(
        xt.data_ptr(), nvalid.data_ptr(),
        None if prev0 is None else prev0.data_ptr(),
        words_t.data_ptr(), nwords.data_ptr(), nbits.data_ptr(),
        length, nseg, cap, k, int(diff), _kernels.stream(),
    )
    _kernels.check(rc, "pack_encode")
    _kernels.launches["pack_encode"] += 1
    return words_t, nwords, nbits
