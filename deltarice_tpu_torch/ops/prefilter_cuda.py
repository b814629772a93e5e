"""The generic pre-filter inverse (every filter but the delta) — CUDA
kernel ``csrc/prefilter.cu``, the counterpart of
``deltarice_tpu/ops/prefilter.py::_iir_decode``. That is no Pallas kernel
but a jitted ``lax.scan``, which XLA compiles into one device loop over the
samples of the whole batch; here one launch inverts every row, a thread a
row.

Layout: the leading axes of ``d`` flatten into rows, as JAX flattens them.
The taps travel as a small int16 tensor on the card, so any filter length
from ``cd_values`` up to :data:`MAX_TAPS` works.
:func:`.prefilter.iir_decode_plain` is the plain version;
:func:`.prefilter.prefilter_decode` routes between the two.
"""

from __future__ import annotations

import functools

import torch

from . import _kernels

#: longest filter the kernel takes (``DR_IIR_MAX_TAPS`` in csrc/kernels.h)
MAX_TAPS = 1024


@functools.lru_cache(maxsize=64)
def _taps(filt: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """filt[1:] mod 2**16 as int16 on ``device`` (the cast wraps)."""
    return torch.tensor(filt[1:], dtype=torch.int64).to(torch.int16).to(device)


def iir_decode(d: torch.Tensor, filt: tuple[int, ...]) -> torch.Tensor:
    """Invert the generic pre-filter ``filt`` along the last axis of the
    CUDA tensor ``d`` in one launch of the kernel; returns int16 of ``d``'s
    shape. ``filt[0]`` is taken mod 2**16 like every tap: +-1 inverts
    exactly, other values divide with truncation, 0 gives -1 everywhere."""
    if d.device.type != "cuda":
        raise ValueError(f"iir_decode launches on a CUDA tensor, got {d.device}")
    filt = tuple(int(c) for c in filt)
    if not 1 <= len(filt) <= MAX_TAPS:
        raise ValueError(f"the kernel takes 1 to {MAX_TAPS} taps, got "
                         f"{len(filt)}")
    if d.dim() == 0:
        raise ValueError("d needs a sample axis")
    if d.numel() == 0:
        return torch.empty(d.shape, dtype=torch.int16, device=d.device)
    flat = d.to(torch.int16).reshape(-1, d.shape[-1]).contiguous()
    _kernels.require(flat, "d", torch.int16, 2)
    out = torch.empty_like(flat)
    rows, n = flat.shape
    rc = _kernels.library().dr_iir_decode(
        flat.data_ptr(), out.data_ptr(), _taps(filt, d.device).data_ptr(),
        len(filt) - 1, filt[0] & 0xFFFF, rows, n, _kernels.stream())
    _kernels.check(rc, "iir_decode")
    _kernels.launches["iir_decode"] += 1
    return out.reshape(d.shape)
