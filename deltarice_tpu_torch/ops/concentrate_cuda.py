"""B3: packed concentration of "sorted with gaps" rows — CUDA kernel
``csrc/concentrate.cu``, the counterpart of ``concentrate_packed``.

The port's codec kernels store words and samples at their final offsets
and do not need it; it serves kernels that stage (slot = sample index, one
live slot per completed word) as the TPU encoder does.
"""

from __future__ import annotations

import torch

from . import _kernels
from .pack_ref import as_i32

DEAD = -(1 << 31)


def _shift_left(x: torch.Tensor, s: int, fill: int) -> torch.Tensor:
    """x[:, i] <- x[:, i+s], filled on the right."""
    out = torch.full_like(x, fill)
    out[:, : x.shape[1] - s] = x[:, s:]
    return out


def concentrate_packed_plain(planes, n_out: int, wide: bool):
    """Plain torch version of :func:`concentrate_packed`: the Nassimi-Sahni
    butterfly of ``deltarice_tpu/ops/concentrate.py`` — LSB-first, move
    left by 2^b where bit b of the remaining displacement is set."""
    lead = planes[0]
    follow = planes[1] if wide else None
    rows, r = lead.shape
    passes = [b for b in range(min(15, max(1, (r - 1).bit_length())))
              if (1 << b) < r]
    for b in passes:
        s = 1 << b
        sh = _shift_left(lead, s, DEAD)
        moved = (sh >= 0) & (((sh >> 16) & s) != 0)
        stay = (lead >= 0) & (((lead >> 16) & s) == 0)
        lead = torch.where(moved, sh - (s << 16), torch.where(stay, lead, DEAD))
        if follow is not None:
            follow = torch.where(moved, _shift_left(follow, s, 0), follow)
    if r < n_out:
        pad = (0, n_out - r)
        lead = torch.nn.functional.pad(lead, pad, value=DEAD)
        if follow is not None:
            follow = torch.nn.functional.pad(follow, pad)
    lead = lead[:, :n_out]
    alive = lead != DEAD
    hi = torch.where(alive, lead & 0xFFFF, 0)
    if follow is None:
        return hi.contiguous()
    lo = torch.where(alive, follow[:, :n_out].to(torch.int32) & 0xFFFF, 0)
    return as_i32((hi.to(torch.int64) << 16) | lo.to(torch.int64))


def staged_planes(lens: torch.Tensor, words: torch.Tensor, slots: int):
    """Stage packed streams as the TPU encoder does, for B3's input.

    Slot i of a row holds the word that sample i completes (at most one:
    a codeword is at most 25 bits), slot ``L`` the partial tail word; every
    other slot is dead. ``lens`` is (rows, L) codeword bit lengths (0 past
    a segment's end), ``words`` (rows, W) the packed streams as int32 bit
    patterns, W >= every row's word count, and ``slots`` > L.
    Returns (lead (rows, slots) int32, follow (rows, slots) int16) whose
    concentration is ``words``.
    """
    rows, length = lens.shape
    if slots <= length:
        raise ValueError("the tail word needs a slot past the last sample")
    ends = torch.cumsum(lens.to(torch.int64), dim=1)
    before = (ends - lens) >> 5  # words completed before sample i
    emit = (ends >> 5) > before
    nbits = ends[:, -1:]
    n = torch.cat([before, nbits >> 5], dim=1)
    emit = torch.cat([emit, (nbits & 31) != 0], dim=1)
    w = torch.gather(words.to(torch.int64) & 0xFFFFFFFF, 1,
                     n.clamp(max=words.shape[1] - 1))
    disp = torch.arange(length + 1, device=lens.device)[None, :] - n
    lead = torch.full((rows, slots), DEAD, dtype=torch.int32,
                      device=lens.device)
    follow = torch.zeros((rows, slots), dtype=torch.int16, device=lens.device)
    lead[:, : length + 1] = torch.where(
        emit, (disp << 16) | (w >> 16), DEAD).to(torch.int32)
    low = torch.where(emit, w & 0xFFFF, 0)
    follow[:, : length + 1] = (((low + 0x8000) & 0xFFFF) - 0x8000).to(torch.int16)
    return lead, follow


def concentrate_packed(planes, n_out: int, wide: bool) -> torch.Tensor:
    """Concentrate pre-packed ``disp << 16 | halfword`` planes.

    Args:
      planes: ``(lead,)`` or ``(lead, follow)``. ``lead`` is (rows, R)
        int32: ``disp << 16 | halfword`` for live slots (destination
        ``slot - disp``, 0 <= disp < 2^15, destinations strictly increasing
        along the row), INT32_MIN for dead ones. ``follow`` is (rows, R)
        int16, the low halfword of a 32-bit payload.
      n_out: output columns.
      wide: reassemble 32-bit payloads from both planes (requires the
        follower); otherwise the leader's halfword comes back.

    Returns:
      (rows, n_out) int32: destination j at column j (as uint32 bit
      patterns when ``wide``); columns nothing reaches are zero.

    A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`concentrate_packed_plain`.
    """
    if len(planes) != (2 if wide else 1):
        raise ValueError("wide takes (lead, follow); narrow takes (lead,)")
    lead = planes[0]
    _kernels.require(lead, "lead", torch.int32, 2)
    if wide:
        _kernels.require(planes[1], "follow", torch.int16, 2, lead.device)
        if planes[1].shape != lead.shape:
            raise ValueError("lead and follow planes differ in shape")
    if n_out < 0:
        raise ValueError(f"n_out must be >= 0, got {n_out}")
    if not _kernels.route(lead):
        return concentrate_packed_plain(planes, n_out, wide)
    rows, r = lead.shape
    out = torch.zeros((rows, n_out), dtype=torch.int32, device=lead.device)
    rc = _kernels.library().dr_concentrate_packed(
        lead.data_ptr(), planes[1].data_ptr() if wide else None,
        out.data_ptr(), rows, r, n_out, _kernels.stream(),
    )
    _kernels.check(rc, "concentrate_packed")
    _kernels.launches["concentrate_packed"] += 1
    return out
