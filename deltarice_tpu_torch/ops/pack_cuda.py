"""B1: fused delta + zigzag + Rice code + bit pack — CUDA kernel
``csrc/pack.cu``, the counterpart of ``pack_encode_pallas_bits`` at rate 1,
parallel inside each segment.

Layout: ``x`` is (nseg, L) segment-major and the words come back as
(nseg, cap), the codec's own layout. :mod:`.tiled_model` is the plain model
of the kernel's tiled passes; :func:`pack_encode_plain` is the serial
oracle.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..config import DELTA_FILTER, ESCAPE_LEN
from . import _kernels
from .pack_ref import pack_bits
from .prefilter import prefilter_encode
from .rice import codeword_lengths_values, zigzag


def pack_encode_plain(x, nvalid, prev0, k: int, diff: bool, cap: int):
    """Plain torch version of :func:`pack_encode`."""
    d = prefilter_encode(x, DELTA_FILTER, prev0) if diff else x
    lens, vals = codeword_lengths_values(zigzag(d), k)
    pos = torch.arange(x.shape[1], device=x.device)
    lens = torch.where(pos[None, :] < nvalid.to(torch.int64)[:, None], lens, 0)
    words, nwords, nbits = pack_bits(lens, vals, cap)
    return words, nwords, nbits.to(torch.int32)


def pack_encode(x: torch.Tensor, nvalid: torch.Tensor,
                prev0: torch.Tensor | None, k: int, diff: bool, cap: int):
    """Encode each row of ``x`` into a Rice word stream.

    Args:
      x: (nseg, L) int16 samples, row s segment s.
      nvalid: (nseg,) int32 valid samples per segment.
      prev0: None or (nseg,) int32 delta state before each segment's first
        sample (``diff`` only).
      k: log2(M), 0..15.
      diff: apply the wrapping delta filter; False takes int16 values
        already pre-filtered.
      cap: output width; words at or past it are dropped.

    Returns:
      words: (nseg, cap) int32 uint32 bit patterns, zero past each stream
        (and past ``cap``);
      nwords, nbits: (nseg,) int32, exact regardless of ``cap``.

    A CUDA tensor launches the kernel's passes on the current stream; a CPU
    tensor takes :func:`pack_encode_plain`.
    """
    with tracing.span("pack_encode", words=cap):
        _kernels.require(x, "x", torch.int16, 2)
        nseg, length = x.shape
        _kernels.require(nvalid, "nvalid", torch.int32, 1, x.device)
        if nvalid.shape[0] != nseg:
            raise ValueError("nvalid must have one entry per row of x")
        if prev0 is not None:
            _kernels.require(prev0, "prev0", torch.int32, 1, x.device)
            if prev0.shape[0] != nseg:
                raise ValueError("prev0 must have one entry per row of x")
        if not 0 <= k <= 15:
            raise ValueError(f"k must be in 0..15, got {k}")
        if cap < 0:
            raise ValueError(f"cap must be >= 0, got {cap}")
        if length * ESCAPE_LEN >= 1 << 31:
            raise ValueError(
                f"segment length {length} overflows the int32 bit count")
        if not _kernels.route(x):
            return pack_encode_plain(x, nvalid, prev0, k, diff, cap)
        lib = _kernels.library()
        with tracing.span("alloc", rows=nseg, length=length, words=cap):
            words = torch.empty((nseg, cap), dtype=torch.int32,
                                device=x.device)
            with tracing.device("fill"):
                words.zero_()
            nwords = torch.empty(nseg, dtype=torch.int32, device=x.device)
            nbits = torch.empty(nseg, dtype=torch.int32, device=x.device)
            scratch = torch.empty(
                max(lib.dr_pack_scratch_words(length, nseg), 1),
                dtype=torch.int32, device=x.device)
        with tracing.span("launch"), tracing.device("kernels"):
            rc = lib.dr_pack_encode(
                x.data_ptr(), nvalid.data_ptr(),
                None if prev0 is None else prev0.data_ptr(),
                words.data_ptr(), nwords.data_ptr(), nbits.data_ptr(),
                scratch.data_ptr(), length, nseg, cap, k, int(diff),
                _kernels.stream(),
            )
        _kernels.check(rc, "pack_encode")
        _kernels.launches["pack_encode"] += 1
        return words, nwords, nbits
