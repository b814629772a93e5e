"""MSB-first bitstream packing and unpacking as plain torch ops — the plain
versions behind the CUDA codec kernels (:mod:`.pack_cuda`,
:mod:`.unpack_cuda`), and the path a CPU tensor takes through them.

The packer turns per-sample Rice codewords (value, bit length) into the
reference's uint32 word stream: codewords laid end to end MSB-first, the
final partial word zero-padded at its low end. Every codeword's bit offset
is a prefix sum of the lengths; a codeword of at most 32 bits starting at
offset ``o`` in word ``w`` touches only words ``w`` and ``w+1``, and every
bit belongs to exactly one codeword, so OR == ADD and the pack is a dual
scatter-add.

The unpacker is the inverse bit-cursor walk: each codeword's position
depends on all previous lengths, so it steps over samples with all rows
advancing in lockstep.

Words are int64 values in [0, 2**32) while computed and int32 bit patterns
at the interface: torch's uint32 has no shifts, adds or comparisons.
"""

from __future__ import annotations

import torch

from ..config import ESCAPE_LEN, ESCAPE_Q


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor of the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return x.to(torch.int64) & 0xFFFFFFFF


def pack_bits(lens: torch.Tensor, vals: torch.Tensor, max_words: int):
    """Pack codewords into per-row uint32 word streams.

    Args:
      lens: (rows, L) codeword bit lengths; 0 marks padding samples (they
        contribute nothing).
      vals: (rows, L) right-aligned codeword bit patterns.
      max_words: output width. Words at or past it are dropped; ``nwords``
        and ``nbits`` stay exact.

    Returns:
      words: (rows, max_words) int32 bit patterns, zero beyond each stream.
      nwords: (rows,) int32 true word counts.
      nbits: (rows,) int64 exact bit counts.
    """
    lens = lens.to(torch.int64)
    vals = torch.where(lens > 0, vals.to(torch.int64), 0)
    ends = torch.cumsum(lens, dim=-1)
    starts = ends - lens
    off = starts & 31
    sh = 32 - off - lens
    hi = torch.where(sh >= 0, vals << sh.clamp(min=0), vals >> (-sh).clamp(min=0))
    lo = torch.where(sh >= 0, 0, (vals << (32 + sh).clamp(min=0)) & 0xFFFFFFFF)
    w0 = starts >> 5
    # one dump column past max_words takes every dropped contribution
    words = torch.zeros(lens.shape[0], max_words + 1, dtype=torch.int64,
                        device=lens.device)
    words.scatter_add_(1, w0.clamp(max=max_words), hi)
    words.scatter_add_(1, (w0 + 1).clamp(max=max_words), lo)
    nbits = ends[:, -1] if lens.shape[1] else torch.zeros_like(lens[:, 0])
    nwords = (nbits + 31) >> 5
    return as_i32(words[:, :max_words]), nwords.to(torch.int32), nbits


def unpack_bits(words: torch.Tensor, n_samples: int, k: int) -> torch.Tensor:
    """Decode Rice codewords from per-row word streams.

    Args:
      words: (rows, W) int32 bit patterns; each row one stream, zero-padded,
        with W at least (stream words + 1).
      n_samples: samples to decode per row (past a stream's end the result
        is garbage that callers mask).
      k: log2(M).

    Returns:
      (rows, n_samples) int64 zigzag values.

    The cursor is clamped at ``32 * (W - 1)``, so no read leaves the row.
    """
    rows, w = words.shape
    wu = as_u32(words)
    maxbit = 32 * (w - 1)
    bit = torch.zeros(rows, dtype=torch.int64, device=words.device)
    out = torch.empty(rows, n_samples, dtype=torch.int64, device=words.device)
    for i in range(n_samples):
        wi = (bit >> 5).unsqueeze(1)
        w0 = torch.gather(wu, 1, wi).squeeze(1)
        w1 = torch.gather(wu, 1, (wi + 1).clamp(max=w - 1)).squeeze(1)
        out[:, i], clen = decode_codeword(w0, w1, bit & 31, k)
        bit = (bit + clen).clamp(max=maxbit)
    return out


def decode_codeword(w0: torch.Tensor, w1: torch.Tensor, off: torch.Tensor,
                    k: int):
    """(zigzag value, bit length), both int64, of the codeword starting at
    bit ``off`` (< 32) of the window (w0, w1) — int64 words in [0, 2**32).
    The plain twin of the kernels' ``csrc/rice_decode.h``.

    The quotient is min(clz(window), 8), 8 marking the escape: the leading
    zeros of the window's top byte come from the float32 exponent of that
    byte (exact for 1..255; 0 gives the escape), as the TPU kernel's
    ``_decode_one`` computes them.
    """
    win = ((w0 << off) | ((w1 >> (31 - off)) >> 1)) & 0xFFFFFFFF
    top8 = (win >> 24).to(torch.float32)
    exp = top8.view(torch.int32).to(torch.int64) >> 23
    q = (134 - exp).clamp(max=ESCAPE_Q)
    esc = q == ESCAPE_Q
    kmask = (1 << k) - 1
    u_plain = (q << k) | ((win >> (31 - k - q).clamp(min=0)) & kmask)
    u_esc = (win >> (32 - ESCAPE_LEN)) & 0xFFFF
    return (torch.where(esc, u_esc, u_plain),
            torch.where(esc, ESCAPE_LEN, q + 1 + k))
