"""B9: speculative split decode — CUDA kernel ``csrc/split_decode.cu``, the
counterpart of ``deltarice_tpu/ops/split_decode.py::_split_kernel``.

Each segment's word stream is cut into ``parts`` ranges of ``wsub`` words;
each (segment, part) sub-block decodes its range after a ``halo``-word
warm-up at bit phase 0 and reports what :func:`.split_decode._compose_merge`
needs to prove and stitch the pieces: entry and exit cursor phases, local
sample count and final delta state. Layout: ``words`` is (nseg, W)
segment-major, as the codec holds it. The kernel walks each sub-block with
one warp in three passes (:mod:`.split_model` is their plain model); its
result is the serial walk of :func:`split_decode_plain`.
"""

from __future__ import annotations

import torch

from . import _kernels
from .pack_ref import as_u32, decode_codeword
from .rice import wrap16

#: the kernel's passes, for :func:`split_decode_passes`: staging, A
#: (phase-0 walks), B (joins and the resolve), C (decode and stores)
PASSES = 4


def codewords_per_word(k: int) -> int:
    """Max codeword starts in one 32-bit word: a codeword is >= k+1 bits."""
    return min(-(-32 // (k + 1)), 32)


def split_decode_plain(words, wv, parts: int, wsub: int, halo: int,
                       lw: int, k: int, delta: bool):
    """Plain torch version of :func:`split_decode`: the TPU kernel's
    word-synchronous loop (``split_decode.py:121-167``) over every
    sub-block at once — at word t each row decodes up to
    :func:`codewords_per_word` codewords while its cursor is in the word."""
    nseg, w = words.shape
    rows = nseg * parts
    dev = words.device
    width = halo + wsub + 2  # word t reads (t, t+1) for t <= halo + wsub
    g = (torch.arange(parts, device=dev)[:, None] * wsub - halo
         + torch.arange(width, device=dev)[None, :])
    subs = as_u32(words)[:, g.clamp(0, w - 1)]
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


def _check(words, wv, parts, wsub, halo, lw, k):
    _kernels.require(words, "words", torch.int32, 2)
    nseg, w = words.shape
    _kernels.require(wv, "wv", torch.int32, 1, words.device)
    if wv.shape[0] != nseg * parts:
        raise ValueError("wv must have one entry per (segment, part)")
    if w < 1:
        raise ValueError("words needs at least one word per stream")
    if parts < 1 or wsub < 0 or halo < 0 or lw < 0:
        raise ValueError("parts >= 1 and wsub, halo, lw >= 0 are required")
    if not 0 <= k <= 15:
        raise ValueError(f"k must be in 0..15, got {k}")


def _launch(words, wv, parts, wsub, halo, lw, k, delta, passes):
    nseg, w = words.shape
    rows = nseg * parts
    local = torch.empty((rows, lw), dtype=torch.int16, device=words.device)
    meta = torch.empty((4, rows), dtype=torch.int32, device=words.device)
    rc = _kernels.library().dr_split_decode(
        words.data_ptr(), wv.data_ptr(), local.data_ptr(), meta.data_ptr(),
        w, nseg, parts, wsub, halo, lw, k, int(delta), passes,
        _kernels.stream(),
    )
    _kernels.check(rc, "split_decode")
    return local, meta


def split_decode(words: torch.Tensor, wv: torch.Tensor, parts: int,
                 wsub: int, halo: int, lw: int, k: int, delta: bool = True):
    """Speculatively decode ``parts`` sub-blocks of every segment.

    Args:
      words: (nseg, W) int32 uint32 bit patterns, row s one stream, zero
        past each stream's words.
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
    _check(words, wv, parts, wsub, halo, lw, k)
    if not _kernels.route(words):
        return split_decode_plain(words, wv, parts, wsub, halo, lw, k, delta)
    out = _launch(words, wv, parts, wsub, halo, lw, k, delta, PASSES)
    _kernels.launches["split_decode"] += 1
    return out


def split_decode_passes(words: torch.Tensor, wv: torch.Tensor, parts: int,
                        wsub: int, halo: int, lw: int, k: int, delta: bool,
                        passes: int) -> None:
    """Launch the kernel stopped after its first ``passes`` passes (1:
    staging, 2: + A, 3: + B, 4: whole), on a CUDA tensor, so that a
    profiler can time each pass as the difference of two launches. What it
    writes is not a result."""
    _check(words, wv, parts, wsub, halo, lw, k)
    if words.device.type != "cuda" or not 1 <= passes <= PASSES:
        raise ValueError("split_decode_passes times the kernel on a CUDA "
                         "tensor, passes 1..4")
    _launch(words, wv, parts, wsub, halo, lw, k, delta, passes)
    _kernels.launches["split_decode_passes"] += 1
