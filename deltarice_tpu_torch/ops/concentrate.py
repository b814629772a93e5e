"""Concentration router: the counterpart of ``concentrate_pallas``
(``deltarice_tpu/ops/concentrate_pallas.py:1069-1106``), choosing among
the port's three concentration kernels (:mod:`.concentrate_cuda`) by slot
axis, displacement bound and payload width exactly as the TPU router does:

* slot axis < 2^15: the packed planes of B3 — a ``disp << 16 | halfword``
  leader, plus an int16 follower for 32-bit payloads;
* wider, with ``disp_bound < 2^16`` and 16-bit payloads: B6's sign-biased
  plane;
* otherwise: B5's two planes.
"""

from __future__ import annotations

import torch

from .concentrate_cuda import (
    DEAD,
    biased_plane,
    concentrate_packed,
    concentrate_wide,
    concentrate_wide16,
)

PACKED_SLOTS = 1 << 15  # slot axes below this ride the packed planes


def _low16(v: torch.Tensor) -> torch.Tensor:
    """Low halfword of int32 values as int16 (no int32 overflow)."""
    return (((v & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)


def concentrate(values: torch.Tensor, disp: torch.Tensor, n_out: int,
                disp_bound: int | None = None) -> torch.Tensor:
    """Pack the live elements of each row to its front.

    Args:
      values: (rows, R) int16 (16-bit payloads) or int32 (32-bit payloads,
        uint32 bit patterns).
      disp: (rows, R) int32 ``slot - destination`` (>= 0 live, destinations
        strictly increasing along the row; negative dead).
      n_out: output columns.
      disp_bound: optional upper bound on every displacement; lets wide
        16-bit payloads take the one-plane kernel.

    Returns:
      (rows, n_out) of ``values``' dtype, destination j at column j.
    """
    if values.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"values must be int16 or int32, got {values.dtype}")
    narrow = values.dtype == torch.int16
    live = disp >= 0
    if values.shape[1] >= PACKED_SLOTS:
        if disp_bound is not None and disp_bound < (1 << 16) and narrow:
            plane = torch.where(live, biased_plane(disp.clamp(min=0),
                                                   values.to(torch.int32)
                                                   & 0xFFFF), DEAD)
            return _low16(concentrate_wide16(plane, n_out))
        return concentrate_wide(values, disp, n_out)
    base = torch.where(live, disp.clamp(min=0) << 16, DEAD)
    v = values.to(torch.int32)
    if narrow:
        lead = base | torch.where(live, v & 0xFFFF, 0)
        out = concentrate_packed((lead,), n_out, False)
        return _low16(out)
    lead = base | torch.where(live, (v >> 16) & 0xFFFF, 0)
    follow = _low16(v)  # payload only, dead or alive
    return concentrate_packed((lead, follow), n_out, True)
