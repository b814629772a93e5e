"""B4: 2-D transpose (A, B) -> (B, A) — CUDA kernel ``csrc/transpose.cu``.

Counterpart of ``deltarice_tpu/ops/transpose_pallas.py``. The TPU kernels
needed it between segment-major rows and their lane layout; the port's
kernels (B1, B2, B9) all read the codec's segment-major arrays, so no
codec path calls it.
"""

from __future__ import annotations

import torch

from . import _kernels

#: element types the kernel moves (it copies 2- or 4-byte elements)
DTYPES = (torch.int16, torch.int32, torch.uint32)


def transpose2d_plain(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


def transpose2d(x: torch.Tensor) -> torch.Tensor:
    """(A, B) -> (B, A), contiguous. A CUDA tensor launches the kernel; a
    CPU tensor takes :func:`transpose2d_plain`."""
    if not isinstance(x, torch.Tensor) or x.dtype not in DTYPES:
        raise TypeError(f"transpose2d takes a tensor of {DTYPES}")
    if x.dim() != 2:
        raise ValueError(f"transpose2d takes a 2-D tensor, got {tuple(x.shape)}")
    if not _kernels.route(x):
        return transpose2d_plain(x)
    _kernels.require(x, "x", x.dtype, 2)
    a, b = x.shape
    out = torch.empty((b, a), dtype=x.dtype, device=x.device)
    rc = _kernels.library().dr_transpose2d(
        x.data_ptr(), out.data_ptr(), a, b, x.element_size(),
        _kernels.stream(),
    )
    _kernels.check(rc, "transpose2d")
    _kernels.launches["transpose2d"] += 1
    return out
