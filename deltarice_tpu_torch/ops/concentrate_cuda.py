"""Concentration of "sorted with gaps" rows: every live slot moves left by
its displacement (slot - destination; destinations distinct and strictly
increasing along the row), and slots nothing reaches come out zero.

* B3 ``concentrate_packed`` — CUDA kernel ``csrc/concentrate.cu``, the
  counterpart of ``concentrate_packed``: packed ``disp << 16 | halfword``
  planes, slot axes and displacements below 2^15. No codec path takes it
  (the encode merges no sub-streams); :mod:`.concentrate` routes to it.
* B5 ``concentrate_wide`` — ``csrc/concentrate_wide.cu``, the counterpart
  of ``_concentrate_wide``: two int32 planes, any width. No codec path
  takes it either.
* B6 ``concentrate_wide16`` — ``csrc/concentrate_wide.cu``, the
  counterpart of ``concentrate_wide16_plane``: one sign-biased plane. The
  split decode's row merge takes it.

Each kernel is a scatter to ``slot - disp``; each plain version is the
Nassimi-Sahni butterfly the TPU kernels run, in torch.
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


def _fit_cols(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """First ``n_out`` columns, zero-padded where the slot axis is
    narrower."""
    if x.shape[1] < n_out:
        x = torch.nn.functional.pad(x, (0, n_out - x.shape[1]))
    return x[:, :n_out].contiguous()


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


def concentrate_wide_plain(values: torch.Tensor, disp: torch.Tensor,
                           n_out: int) -> torch.Tensor:
    """Plain torch version of :func:`concentrate_wide`: the LSB-first
    two-plane butterfly of ``deltarice_tpu/ops/concentrate.py:90-102``,
    keeping what arrived home (displacement 0) as the TPU kernel does."""
    v = values.to(torch.int32)
    d = disp
    r = v.shape[1]
    for b in range(max(1, (r - 1).bit_length())):
        s = 1 << b
        if s >= r:
            break
        vs = _shift_left(v, s, 0)
        ds = _shift_left(d, s, -1)
        moving = (ds >= 0) & ((ds & s) != 0)
        staying = (d >= 0) & ((d & s) == 0)
        v = torch.where(moving, vs, torch.where(staying, v, 0))
        d = torch.where(moving, ds - s, torch.where(staying, d, -1))
    return _fit_cols(torch.where(d == 0, v, 0), n_out).to(values.dtype)


def concentrate_wide(values: torch.Tensor, disp: torch.Tensor,
                     n_out: int) -> torch.Tensor:
    """Concentrate a (payload, displacement) pair of planes of any width.

    Args:
      values: (rows, R) int16, or int32 (32-bit payloads as uint32 bit
        patterns).
      disp: (rows, R) int32 ``slot - destination`` for live slots (>= 0,
        destinations strictly increasing along the row), negative for dead.
      n_out: output columns; destinations at or past it are dropped.

    Returns:
      (rows, n_out) of ``values``' dtype, destination j at column j; columns
      nothing reaches are zero.

    A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`concentrate_wide_plain`.
    """
    if values.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"values must be int16 or int32, got {values.dtype}")
    _kernels.require(values, "values", values.dtype, 2)
    _kernels.require(disp, "disp", torch.int32, 2, values.device)
    if disp.shape != values.shape:
        raise ValueError("values and disp planes differ in shape")
    if n_out < 0:
        raise ValueError(f"n_out must be >= 0, got {n_out}")
    if not _kernels.route(values):
        return concentrate_wide_plain(values, disp, n_out)
    rows, r = values.shape
    v = values.to(torch.int32).contiguous()
    out = torch.zeros((rows, n_out), dtype=torch.int32, device=values.device)
    rc = _kernels.library().dr_concentrate_wide(
        v.data_ptr(), disp.data_ptr(), out.data_ptr(), rows, r, n_out,
        _kernels.stream(),
    )
    _kernels.check(rc, "concentrate_wide")
    _kernels.launches["concentrate_wide"] += 1
    # int16 payloads came in sign-extended; their low halfword goes back
    return out.to(values.dtype)


def biased_plane(disp: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    """``((disp << 16) | half) ^ 2^31`` as int32, for 0 <= disp < 2^16 and
    0 <= half < 2^16, computed as ``(disp - 2^15) * 2^16 + half`` so that
    no int32 operation overflows. Dead slots are :data:`DEAD`, the image of
    (disp 0, half 0)."""
    return ((disp.to(torch.int32) - (1 << 15)) * (1 << 16)
            + half.to(torch.int32))


def _w16_pass(p: torch.Tensor, sh: torch.Tensor, disp_bit: int):
    """One butterfly pass on the sign-biased plane routing on displacement
    bit ``disp_bit`` (``concentrate_pallas.py:826-847``): signed max of the
    staying and the arriving element realises the unsigned order, and dead
    (INT32_MIN) loses every max."""
    bit = 16 + disp_bit
    if bit == 31:
        stay = torch.where((p & DEAD) != 0, p, DEAD)
        move = torch.where((sh & DEAD) == 0, sh ^ DEAD, DEAD)
    else:
        m = 1 << bit
        stay = torch.where((p & m) == 0, p, DEAD)
        move = torch.where((sh & m) != 0, sh ^ m, DEAD)
    return torch.maximum(stay, move)


def concentrate_wide16_plain(plane: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain torch version of :func:`concentrate_wide16`: the sign-biased
    one-plane butterfly of ``_wide16_low_kernel`` / ``_wide16_high_kernel``,
    then the home select of ``_w16_home``."""
    p = plane
    r = p.shape[1]
    for b in range(16):
        s = 1 << b
        if s >= r:
            break
        p = _w16_pass(p, _shift_left(p, s, DEAD), b)
    home = torch.where((p & -65536) == DEAD, p & 0xFFFF, 0)
    return _fit_cols(home, n_out)


def concentrate_wide16(plane: torch.Tensor, n_out: int) -> torch.Tensor:
    """Concentrate one sign-biased plane (see :func:`biased_plane`).

    Args:
      plane: (rows, R) int32 ``((disp << 16) | halfword) ^ 2^31`` for live
        slots (disp < 2^16, destinations ``slot - disp`` strictly
        increasing along the row), INT32_MIN for dead ones. A live 0 at
        displacement 0 equals the dead marker and still reads back 0.
      n_out: output columns; destinations at or past it are dropped.

    Returns:
      (rows, n_out) int32 halfwords, zero-extended (the caller casts);
      columns nothing reaches are zero.

    A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`concentrate_wide16_plain`.
    """
    _kernels.require(plane, "plane", torch.int32, 2)
    if n_out < 0:
        raise ValueError(f"n_out must be >= 0, got {n_out}")
    if not _kernels.route(plane):
        return concentrate_wide16_plain(plane, n_out)
    rows, r = plane.shape
    out = torch.zeros((rows, n_out), dtype=torch.int32, device=plane.device)
    rc = _kernels.library().dr_concentrate_wide16(
        plane.data_ptr(), out.data_ptr(), rows, r, n_out, _kernels.stream(),
    )
    _kernels.check(rc, "concentrate_wide16")
    _kernels.launches["concentrate_wide16"] += 1
    return out
