"""B4: transpose (A, B) -> (B, A), or (N, A, B) -> (N, B, A) — CUDA kernel
``csrc/transpose.cu``.

Counterpart of ``deltarice_tpu/ops/transpose_pallas.py::transpose2d`` and,
for 3-D inputs, of the ``jax.vmap`` of it that the JAX package applies to
blocks of 1024 segments (``pack_pallas.py``, ``unpack_pallas.py``,
``split_decode.py``). The TPU kernels needed it between segment-major rows
and their lane layout; the port's kernels (B1, B2, B9) all read the
codec's segment-major arrays, so no codec path calls it.
``ops/transpose_model.py`` walks the kernel's tiles in plain torch.
"""

from __future__ import annotations

import torch

from . import _kernels

#: element types the kernel moves (it copies 2- or 4-byte elements)
DTYPES = (torch.int16, torch.int32, torch.uint32)


def transpose2d_plain(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-2, -1).contiguous()


def transpose2d(x: torch.Tensor) -> torch.Tensor:
    """The last two axes of a 2-D or 3-D tensor swapped, contiguous. A CUDA
    tensor launches the kernel (it must be contiguous; any storage offset);
    a CPU tensor takes :func:`transpose2d_plain`."""
    if not isinstance(x, torch.Tensor) or x.dtype not in DTYPES:
        raise TypeError(f"transpose2d takes a tensor of {DTYPES}")
    if x.dim() not in (2, 3):
        raise ValueError(
            f"transpose2d takes a 2-D or 3-D tensor, got {tuple(x.shape)}")
    if not _kernels.route(x):
        return transpose2d_plain(x)
    _kernels.require(x, "x", x.dtype, x.dim())
    n = x.shape[0] if x.dim() == 3 else 1
    a, b = x.shape[-2:]
    out = torch.empty(x.shape[:-2] + (b, a), dtype=x.dtype, device=x.device)
    rc = _kernels.library().dr_transpose2d(
        x.data_ptr(), out.data_ptr(), n, a, b, x.element_size(),
        _kernels.stream(),
    )
    _kernels.check(rc, "transpose2d")
    _kernels.launches["transpose2d"] += 1
    return out
