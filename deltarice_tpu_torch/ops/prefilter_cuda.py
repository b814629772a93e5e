"""The generic pre-filter (every filter but the delta): its inverse and,
in :func:`fir_encode`, the forward filter.

The inverse: CUDA kernels ``csrc/prefilter.cu``, the counterpart of
``deltarice_tpu/ops/prefilter.py::_iir_decode``. That is no Pallas kernel
but a jitted ``lax.scan``, which XLA compiles into one device loop over the
samples of the whole batch.

Two paths, chosen by the filter and the shape alone
(:func:`.prefilter_model.plan`):

* **blocked** (a leading tap of +-1 mod 2**16 and at most 8 history
  taps): the rows are cut into blocks, a thread a block. Pass A walks each
  block from a zero history, pass B carries the histories along each row
  by the block's transition matrix (:func:`.prefilter_model
  .block_transition`, computed on the host and cached), pass C walks each
  block again from its true entry history. With one block a row, or no
  history, pass C alone runs ("one_walk").
* **serial** (every other filter, of any length): a thread walks a row.
  Filters whose history ring does not fit in shared memory keep it in a
  global scratch this wrapper allocates.

Layout: the leading axes of ``d`` flatten into rows, as JAX flattens them.
The taps travel as a small int16 tensor on the card.
:func:`.prefilter.iir_decode_plain` is the plain version;
:func:`.prefilter.prefilter_decode` routes between the two. Every call
counts one ``iir_decode`` launch and one of its path
(``iir_decode.blocked``, ``iir_decode.one_walk``, ``iir_decode.serial``).
:func:`iir_decode_serial` runs the serial walk on any filter, the design
the blocked scan replaced, to time the two on the same input.

The forward filter: one launch of ``dr_fir_encode`` (``csrc/prefilter.cu``)
over the flattened samples, counted as ``fir_encode``; the taps travel as
a cached int16 tensor on the card. :func:`.prefilter
.prefilter_encode_plain` is its plain version.
"""

from __future__ import annotations

import functools

import torch

from . import _kernels
from .prefilter_model import STATE, block_transition, plan


@functools.lru_cache(maxsize=64)
def _taps(filt: tuple[int, ...], device: torch.device,
          first: int = 1) -> torch.Tensor:
    """filt[first:] (the inverse's history taps, or every tap for the
    forward filter) mod 2**16 as int16 on ``device`` (the cast wraps)."""
    return torch.tensor(filt[first:], dtype=torch.int64).to(
        torch.int16).to(device)


@functools.lru_cache(maxsize=64)
def _transition(filt: tuple[int, ...], block: int,
                device: torch.device) -> torch.Tensor:
    """The block transition M of ``filt`` (sign folded) as int16 on
    ``device``, row-major."""
    return block_transition(filt, block).to(torch.int16).to(device)


def _check(d: torch.Tensor, filt, name: str = "iir_decode",
           arg: str = "d") -> tuple[int, ...]:
    if d.device.type != "cuda":
        raise ValueError(f"{name} launches on a CUDA tensor, got {d.device}")
    filt = tuple(int(c) for c in filt)
    if not filt:
        raise ValueError("the filter needs at least one tap")
    if d.dim() == 0:
        raise ValueError(f"{arg} needs a sample axis")
    return filt


def _rows(d: torch.Tensor) -> torch.Tensor:
    flat = d.to(torch.int16).reshape(-1, d.shape[-1]).contiguous()
    _kernels.require(flat, "d", torch.int16, 2)
    return flat


def _serial(flat: torch.Tensor, filt: tuple[int, ...]) -> torch.Tensor:
    """The serial walk, a thread a row, on the rows of ``flat``."""
    rows, n = flat.shape
    out = torch.empty_like(flat)
    lib = _kernels.library()
    nhist = len(filt) - 1
    ring_bytes = lib.dr_iir_ring_bytes(nhist, rows)
    ring = (torch.empty(ring_bytes, dtype=torch.uint8, device=flat.device)
            if ring_bytes else None)
    rc = lib.dr_iir_decode(
        flat.data_ptr(), out.data_ptr(), _taps(filt, flat.device).data_ptr(),
        nhist, filt[0] & 0xFFFF, rows, n,
        None if ring is None else ring.data_ptr(), _kernels.stream())
    _kernels.check(rc, "iir_decode (serial)")
    return out


def _blocked(flat: torch.Tensor, filt: tuple[int, ...], path: str,
             block: int, nb: int) -> torch.Tensor:
    """The blocked scan (``path`` "blocked": passes A, B and C) or its
    final walk alone ("one_walk") on the rows of ``flat``."""
    rows, n = flat.shape
    out = torch.empty_like(flat)
    trans = carry = None
    if path == "blocked":
        trans = _transition(filt, block, flat.device)
        carry = torch.empty((nb - 1, rows, STATE), dtype=torch.int16,
                            device=flat.device)
    rc = _kernels.library().dr_iir_blocked(
        flat.data_ptr(), out.data_ptr(), _taps(filt, flat.device).data_ptr(),
        None if trans is None else trans.data_ptr(),
        None if carry is None else carry.data_ptr(), len(filt) - 1,
        filt[0] & 0xFFFF, rows, n, block, _kernels.stream())
    _kernels.check(rc, f"iir_decode ({path})")
    return out


def iir_decode(d: torch.Tensor, filt: tuple[int, ...],
               block: int | None = None) -> torch.Tensor:
    """Invert the generic pre-filter ``filt`` (any length) along the last
    axis of the CUDA tensor ``d``; returns int16 of ``d``'s shape.
    ``filt[0]`` is taken mod 2**16 like every tap: +-1 inverts exactly,
    other values divide with truncation, 0 gives -1 everywhere. ``block``
    (a multiple of 8) overrides the blocked path's block length, which
    changes no output."""
    filt = _check(d, filt)
    if d.numel() == 0:
        return torch.empty(d.shape, dtype=torch.int16, device=d.device)
    flat = _rows(d)
    path, block, nb = plan(filt, *flat.shape, block)
    out = (_serial(flat, filt) if path == "serial"
           else _blocked(flat, filt, path, block, nb))
    _kernels.launches["iir_decode"] += 1
    _kernels.launches[f"iir_decode.{path}"] += 1
    return out.reshape(d.shape)


def iir_decode_serial(d: torch.Tensor, filt: tuple[int, ...]) -> torch.Tensor:
    """:func:`iir_decode` by the serial walk whatever the filter: the
    design the blocked scan replaced, kept to time the two on one input.
    Counts ``iir_decode_serial``, not ``iir_decode``."""
    filt = _check(d, filt)
    if d.numel() == 0:
        return torch.empty(d.shape, dtype=torch.int16, device=d.device)
    out = _serial(_rows(d), filt)
    _kernels.launches["iir_decode_serial"] += 1
    return out.reshape(d.shape)


def fir_encode(x: torch.Tensor, filt: tuple[int, ...]) -> torch.Tensor:
    """Apply the generic pre-filter ``filt`` (any length, every tap taken
    mod 2**16) along the last axis of the CUDA tensor ``x``, each row from
    a zero history; returns int16 of ``x``'s shape. One launch, on the
    current stream."""
    filt = _check(x, filt, "fir_encode", "x")
    x = x.to(torch.int16).contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rc = _kernels.library().dr_fir_encode(
        x.data_ptr(), out.data_ptr(), _taps(filt, x.device, 0).data_ptr(),
        len(filt), x.numel(), x.shape[-1], _kernels.stream())
    _kernels.check(rc, "fir_encode")
    _kernels.launches["fir_encode"] += 1
    return out
