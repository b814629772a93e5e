"""Rice (Golomb power-of-2) codeword math: zigzag mapping, per-sample
codeword lengths and bit patterns, as plain torch ops.

Bitstream contract (frozen; the reference filter's):

* zigzag: ``u = 2x`` for ``x >= 0``, ``u = -2x - 1`` for ``x < 0`` — u in
  [0, 65535].
* codeword: with ``q = u >> k``, ``r = u & (M-1)``: ``q`` zeros, a ``1``,
  then the k-bit remainder — unless ``q >= 8``, in which case the *escape*:
  8 zeros, a ``1``, then u verbatim in 16 bits.
* un-zigzag: even ``u`` -> ``u >> 1``; odd -> ``-((u+1) >> 1)``.

Codes are int64 tensors: torch's uint32 has no shifts or comparisons, and
every value here fits 17 bits.
"""

from __future__ import annotations

import torch

from ..config import ESCAPE_LEN, ESCAPE_Q


def wrap16(x: torch.Tensor) -> torch.Tensor:
    """Reduce an integer tensor mod 2**16 into the int16 range (same dtype)."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def zigzag(x: torch.Tensor) -> torch.Tensor:
    """int16 -> int64 zigzag code in [0, 65535]."""
    xi = x.to(torch.int64)
    return (xi << 1) ^ (xi >> 63)


def unzigzag(u: torch.Tensor) -> torch.Tensor:
    """Zigzag code -> int16."""
    ui = u.to(torch.int64)
    return ((ui >> 1) ^ -(ui & 1)).to(torch.int16)


def codeword_lengths_values(u: torch.Tensor, k: int):
    """Per-sample codeword (length in bits, right-aligned bit pattern), both
    int64.

    Non-escape = ``(1 << k) | r`` over ``q+1+k`` bits, escape =
    ``(1 << 16) | u`` over 25 bits.
    """
    u = u.to(torch.int64)
    q = u >> k
    esc = q >= ESCAPE_Q
    lens = torch.where(esc, ESCAPE_LEN, q + 1 + k)
    vals = torch.where(esc, (1 << 16) | u, (1 << k) | (u & ((1 << k) - 1)))
    return lens, vals
