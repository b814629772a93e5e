"""Causal integer pre-filters (delta encoding and generic FIR) and their
inverses, as plain torch ops along the last axis.

Semantics match the reference filter byte for byte:

* encode, delta (filter ``[1,-1]``): first sample verbatim (or its
  difference from ``prev0``), then successive differences, all in wrapping
  16-bit arithmetic.
* encode, generic: causal FIR ``out[i] = sum_j x[i-j] * filt[j]`` with
  implicit zero padding for ``i-j < 0``. The reference accumulates into a C
  ``short``; addition and multiplication mod 2**16 form a ring
  homomorphism, so summing in int64 and wrapping once is bit-identical.
* decode, delta: running prefix sum with int16 wraparound.
* decode, generic: the recursive IIR inverse
  ``out[i] = (in[i] - sum_{j>=1} out[i-j]*filt[j]) / filt[0]``, the
  division being C's (truncation toward zero) applied to the *wrapped*
  int16 numerator — exact reconstruction requires |filt[0]| == 1.

The delta filter and its inverse run as torch ops on the tensor's own
device (the codec's delta path fuses them into B1 and B2 instead). Every
other filter launches the CUDA kernels of :mod:`.prefilter_cuda` on a
CUDA tensor: the forward FIR one kernel over the flattened samples, the
inverse the blocked scan of :mod:`.prefilter_model` for lossless filters
of up to 8 history taps and a serial walk for the rest.
:func:`prefilter_encode_plain` and :func:`iir_decode_plain` are their plain
versions, which a CPU tensor takes.
"""

from __future__ import annotations

import torch

from ..config import DELTA_FILTER
from . import _kernels
from .prefilter_cuda import fir_encode, iir_decode
from .prefilter_model import c16
from .rice import wrap16


def _shift_right(x: torch.Tensor, j: int) -> torch.Tensor:
    """x delayed by j samples along the last axis, zero-filled."""
    if j == 0:
        return x
    out = torch.zeros_like(x)
    if j < x.shape[-1]:
        out[..., j:] = x[..., :-j]
    return out


def prefilter_encode(x: torch.Tensor, filt: tuple[int, ...] = DELTA_FILTER,
                     prev0: torch.Tensor | None = None) -> torch.Tensor:
    """Apply the causal pre-filter along the last axis; returns int16.

    prev0: optional per-row sample preceding ``x[..., 0]``. Delta filter
    only — it is the recurrence's entire cross-block state.

    The delta is torch ops on ``x``'s device. Any other filter launches
    the CUDA kernel (:func:`.prefilter_cuda.fir_encode`) on a CUDA tensor
    and takes :func:`prefilter_encode_plain` on a CPU tensor; any other
    device raises.
    """
    if tuple(filt) == DELTA_FILTER:
        xi = x.to(torch.int64)
        prev = _shift_right(xi, 1)
        if prev0 is not None:
            prev[..., 0] = prev0.to(xi.device, torch.int64)
        return wrap16(xi - prev).to(torch.int16)
    if prev0 is not None:
        raise ValueError("prev0 is only supported for the delta filter")
    if _kernels.route(x):
        return fir_encode(x, filt)
    return prefilter_encode_plain(x, filt)


def prefilter_encode_plain(x: torch.Tensor,
                           filt: tuple[int, ...]) -> torch.Tensor:
    """Plain version of the generic forward filter: a zero-filled shifted
    copy, a multiply and an add a tap in int64, wrapped once."""
    xi = x.to(torch.int64)
    acc = xi * c16(filt[0])
    for j, c in enumerate(filt[1:], start=1):
        acc = acc + _shift_right(xi, j) * c16(c)
    return wrap16(acc).to(torch.int16)


def prefilter_decode(d: torch.Tensor,
                     filt: tuple[int, ...] = DELTA_FILTER) -> torch.Tensor:
    """Invert the causal pre-filter along the last axis; returns int16.

    The delta inverse is a prefix sum in torch ops. Any other filter
    launches the CUDA kernels (:func:`.prefilter_cuda.iir_decode`) on a
    CUDA tensor and takes :func:`iir_decode_plain` on a CPU tensor; any
    other device raises."""
    if tuple(filt) == DELTA_FILTER:
        return wrap16(torch.cumsum(d.to(torch.int64), dim=-1)).to(torch.int16)
    if _kernels.route(d):
        return iir_decode(d, filt)
    return iir_decode_plain(d, filt)


def iir_decode_plain(d: torch.Tensor, filt: tuple[int, ...]) -> torch.Tensor:
    """Plain version of the generic inverse: one step per sample,
    vectorised over the leading axes, the history's sum one int64 dot of
    the zero-prefixed outputs with the reversed taps (each product is below
    2**30 and wrapping mod 2**16 commutes with the sum, so it is wrapped
    once). filt[0] == 1 or -1 gives exact reconstruction; other leading
    coefficients replicate the reference's truncating division (lossy in
    general), and one that wraps to 0 gives -1 everywhere, as XLA's integer
    division by zero does in the JAX package."""
    d = d.to(torch.int64)
    f0 = c16(filt[0])
    nh = len(filt) - 1
    if nh == 0:
        return _finish(d, f0).to(torch.int16)
    rev = torch.tensor([c16(c) for c in filt[:0:-1]], dtype=torch.int64,
                       device=d.device)  # c_nh ... c_1
    n = d.shape[-1]
    hist = torch.zeros(d.shape[:-1] + (nh + n,), dtype=torch.int64,
                       device=d.device)  # out[i] at nh + i
    for i in range(n):
        num = wrap16(d[..., i] - (hist[..., i: i + nh] * rev).sum(-1))
        hist[..., nh + i] = _finish(num, f0)
    return hist[..., nh:].to(torch.int16)


def _finish(num: torch.Tensor, f0: int) -> torch.Tensor:
    """The quotient of the wrapped numerator by f0, wrapped to int16."""
    if f0 == 0:
        return torch.full_like(num, -1)
    if f0 != 1:
        num = torch.div(num, f0, rounding_mode="trunc")
    return wrap16(num)
