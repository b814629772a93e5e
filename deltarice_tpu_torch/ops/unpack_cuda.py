"""B2: exact Rice decode with the fused delta inverse — CUDA kernel
``csrc/unpack.cu``, the counterpart of ``unpack_decode_pallas`` (exact,
any length, no reduced service rate).

Layout: ``words_t`` is (W, nseg) word-major and the samples come back as
(n_samples, nseg) sample-major; :mod:`.transpose_cuda` converts at the
boundary.
"""

from __future__ import annotations

import torch

from . import _kernels
from .pack_ref import unpack_bits
from .prefilter import prefilter_decode
from .rice import unzigzag


def unpack_decode_plain(words_t, n_samples: int, k: int, delta: bool):
    """Plain torch version of :func:`unpack_decode`."""
    v = unzigzag(unpack_bits(words_t.t(), n_samples, k))
    if delta:
        v = prefilter_decode(v)
    return v.t().contiguous()


def unpack_decode(words_t: torch.Tensor, n_samples: int, k: int,
                  delta: bool = True) -> torch.Tensor:
    """Decode each column of ``words_t`` into ``n_samples`` samples.

    Args:
      words_t: (W, nseg) int32 uint32 bit patterns, column s one stream,
        with at least one zero pad word past each stream.
      n_samples: samples per segment (past a segment's true length the
        output is garbage by contract).
      k: log2(M), 0..15.
      delta: fuse the [1,-1] inverse (prefix sum); otherwise return the
        un-zigzagged values for a generic-filter inverse.

    Returns:
      (n_samples, nseg) int16.

    A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`unpack_decode_plain`.
    """
    _kernels.require(words_t, "words_t", torch.int32, 2)
    w, nseg = words_t.shape
    if w < 1:
        raise ValueError("words_t needs at least one (pad) word per stream")
    if not 0 <= k <= 15:
        raise ValueError(f"k must be in 0..15, got {k}")
    if n_samples < 0:
        raise ValueError(f"n_samples must be >= 0, got {n_samples}")
    if not _kernels.route(words_t):
        return unpack_decode_plain(words_t, n_samples, k, delta)
    out_t = torch.empty((n_samples, nseg), dtype=torch.int16,
                        device=words_t.device)
    rc = _kernels.library().dr_unpack_decode(
        words_t.data_ptr(), out_t.data_ptr(), w, nseg, n_samples, k,
        int(delta), _kernels.stream(),
    )
    _kernels.check(rc, "unpack_decode")
    _kernels.launches["unpack_decode"] += 1
    return out_t
