"""B9: speculative split decode — CUDA kernel ``csrc/split_decode.cu``, the
counterpart of ``deltarice_tpu/ops/split_decode.py::_split_kernel``.

Each segment's word stream is cut into ``parts`` ranges of ``wsub`` words;
each (segment, part) sub-block decodes its range after a ``halo``-word
warm-up at bit phase 0 and reports what :func:`.split_decode._compose_merge`
needs to prove and stitch the pieces: entry and exit cursor phases, local
sample count and final delta state. Layout: ``words_t`` is (W, nseg)
word-major (B4 makes it from the codec's segment-major words).
"""

from __future__ import annotations

import torch

from . import _kernels
from .pack_ref import as_u32, decode_codeword
from .rice import wrap16


def codewords_per_word(k: int) -> int:
    """Max codeword starts in one 32-bit word: a codeword is >= k+1 bits."""
    return min(-(-32 // (k + 1)), 32)


def split_decode_plain(words_t, wv, parts: int, wsub: int, halo: int,
                       lw: int, k: int, delta: bool):
    """Plain torch version of :func:`split_decode`: the TPU kernel's
    word-synchronous loop (``split_decode.py:121-167``) over every
    sub-block at once — at word t each row decodes up to
    :func:`codewords_per_word` codewords while its cursor is in the word."""
    w, nseg = words_t.shape
    rows = nseg * parts
    dev = words_t.device
    width = halo + wsub + 2  # word t reads (t, t+1) for t <= halo + wsub
    g = (torch.arange(parts, device=dev)[:, None] * wsub - halo
         + torch.arange(width, device=dev)[None, :])
    words = as_u32(words_t.t())
    subs = words[:, g.clamp(0, w - 1)]
    subs = torch.where((g >= 0) & (g < w), subs, 0).reshape(rows, width)
    wv = wv.to(torch.int64)
    hw = halo + wv
    ridx = torch.arange(rows, device=dev)
    first = ridx % parts == 0
    zero = torch.zeros(rows, dtype=torch.int64, device=dev)
    pos, n, acc, ent, ext = zero, zero, zero, zero, zero
    local = torch.zeros((rows, lw + 1), dtype=torch.int16, device=dev)
    t_end = halo + int(wv.max()) + 1 if rows else 0  # last: every exit phase
    for t in range(t_end):
        if t == halo:
            pos = torch.where(first, 0, pos)
            ent = pos
        ext = torch.where(hw == t, pos, ext)
        rec = (t >= halo) & (t < hw)
        w0, w1 = subs[:, t], subs[:, t + 1]
        for _ in range(codewords_per_word(k)):
            active = pos < 32
            u, clen = decode_codeword(w0, w1, pos & 31, k)
            valid = active & rec
            x = (u >> 1) ^ -(u & 1)
            if delta:
                acc = torch.where(valid, wrap16(acc + x), acc)
                x = acc
            col = torch.where(valid & (n < lw), n, lw)
            local[ridx, col] = wrap16(x).to(torch.int16)
            pos = torch.where(active, pos + clen, pos)
            n = n + valid
        pos = pos - 32
    meta = torch.stack([ent, ext, n, acc]).to(torch.int32)
    return local[:, :lw].contiguous(), meta


def split_decode(words_t: torch.Tensor, wv: torch.Tensor, parts: int,
                 wsub: int, halo: int, lw: int, k: int, delta: bool = True):
    """Speculatively decode ``parts`` sub-blocks of every segment.

    Args:
      words_t: (W, nseg) int32 uint32 bit patterns, column s one stream,
        zero past each stream's words.
      wv: (nseg * parts,) int32 words owned by sub-block row
        ``s * parts + p`` (its range is words [p*wsub, p*wsub + wv)).
      parts, wsub: sub-blocks per segment and words per sub-block.
      halo: warm-up words decoded before each range (phase 0 at their
        start; sub-block 0 resets to its known phase 0 at its range).
      lw: local output width; samples at or past it are dropped (their
        count stays exact, so the caller flags the overrun).
      k: log2(M), 0..15.
      delta: fuse the wrapping delta inverse, starting from 0 per row.

    Returns:
      local: (nseg * parts, lw) int16, sample n of row r at [r, n], zero
        past the row's count;
      meta: (4, nseg * parts) int32 — entry phase (cursor bit entering
        word p*wsub), exit phase (entering word p*wsub + wv), local sample
        count (phantom codewords of trailing zero fill included), final
        delta state.

    A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`split_decode_plain`.
    """
    _kernels.require(words_t, "words_t", torch.int32, 2)
    w, nseg = words_t.shape
    _kernels.require(wv, "wv", torch.int32, 1, words_t.device)
    if wv.shape[0] != nseg * parts:
        raise ValueError("wv must have one entry per (segment, part)")
    if w < 1:
        raise ValueError("words_t needs at least one word per stream")
    if parts < 1 or wsub < 0 or halo < 0 or lw < 0:
        raise ValueError("parts >= 1 and wsub, halo, lw >= 0 are required")
    if not 0 <= k <= 15:
        raise ValueError(f"k must be in 0..15, got {k}")
    if not _kernels.route(words_t):
        return split_decode_plain(words_t, wv, parts, wsub, halo, lw, k,
                                  delta)
    rows = nseg * parts
    local = torch.zeros((rows, lw), dtype=torch.int16, device=words_t.device)
    meta = torch.empty((4, rows), dtype=torch.int32, device=words_t.device)
    rc = _kernels.library().dr_split_decode(
        words_t.data_ptr(), wv.data_ptr(), local.data_ptr(), meta.data_ptr(),
        w, nseg, parts, wsub, halo, lw, k, int(delta), _kernels.stream(),
    )
    _kernels.check(rc, "split_decode")
    _kernels.launches["split_decode"] += 1
    return local, meta
