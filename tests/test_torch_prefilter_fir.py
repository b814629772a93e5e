"""The generic forward pre-filter on the CPU: a plain model of how its
kernel's register form (``csrc/prefilter.cu``, ``dr_fir_encode``) cuts the
samples (:func:`fir_tiles`: flat vectors of 8 samples, blocks that stage
their span and a halo, taps masked at row starts, the short last vector)
against the plain version (``ops/prefilter.py::prefilter_encode_plain``),
and that against the JAX package's ``prefilter_encode``.

Inputs come from numpy seeds (``tests/prefilter_cases.py``); every
comparison is exact (tolerance 0: the filter is integer arithmetic). The
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltarice_tpu.ops import prefilter as jpre
from deltarice_tpu_torch.ops import prefilter
from deltarice_tpu_torch.ops.rice import wrap16
from prefilter_cases import EDGES, GRID, grid_filter, samples

FIR_BLOCK_VECS = 1024  # vectors of 8 samples a block of the kernel


def fir_tiles(x: torch.Tensor, filt: tuple[int, ...],
              block_vecs: int = FIR_BLOCK_VECS) -> torch.Tensor:
    """The generic forward filter as ``dr_fir_encode``'s register form (up
    to 8 taps) cuts it, held here at every length; int16 of ``x``'s shape.
    The leading axes flatten into n samples, cut into vectors of 8 on that
    flat grid (zero past n: the last vector's tail is loaded and stored
    element by element, and nothing past n is stored). Block b stages its
    ``block_vecs`` vectors and the ``ceil((ntaps - 1) / 8)`` before them
    (zero before the input's start), and computes each of its samples e
    from that window alone, the tap j masked where it reaches past the
    row's start (``j > e mod L``). Sums of the samples' and taps' residues
    mod 2**16, wrapped once. An input off a 16-byte boundary moves the same
    vectors element by element, so it has no model of its own."""
    filt = tuple(int(c) for c in filt)
    n, length = x.numel(), x.shape[-1]
    if n == 0:
        return torch.empty(x.shape, dtype=torch.int16)
    hv = -(-(len(filt) - 1) // 8)
    nblocks = -(-n // (8 * block_vecs))
    span = 8 * block_vecs
    flat = torch.zeros(8 * hv + nblocks * span, dtype=torch.int64)
    flat[8 * hv: 8 * hv + n] = x.reshape(-1).to(torch.int64) & 0xFFFF
    vecs = flat.reshape(-1, 8)
    # block b's window: vectors b * block_vecs - hv ... of x, offset by hv
    idx = (torch.arange(nblocks)[:, None] * block_vecs
           + torch.arange(hv + block_vecs)[None, :])
    win = vecs[idx].reshape(nblocks, 8 * (hv + block_vecs))
    e = (torch.arange(nblocks)[:, None] * span
         + torch.arange(span)[None, :])
    pos = e % length
    acc = torch.zeros((nblocks, span), dtype=torch.int64)
    for j, c in enumerate(filt):
        tap = win[:, 8 * hv - j: 8 * hv - j + span]
        acc += torch.where(pos >= j, tap, 0) * (c & 0xFFFF)
    return wrap16(acc.reshape(-1)[:n]).to(torch.int16).reshape(x.shape)


def _fir_cases():
    """(filter, shape, vectors a block) of each forward-filter case: the
    grid (the forward filter takes any leading tap) on rows of 41 samples
    in blocks of 16 (rows start inside vectors and cross blocks, the last
    vector is short), the division's edges, 1100 taps with a halo of 138
    vectors over blocks of 4, rows of 1, 7, 1203 and 7000 samples, 1-D and
    3-D inputs, halos longer than a row, and empty inputs."""
    rng = np.random.default_rng(5)
    taps_1100 = (1,) + tuple(int(c) for c in rng.integers(-3, 4, 1099))
    cases = [pytest.param(grid_filter(n, f0), (3, 41), 2,
                          id=f"grid-{n}-{f0}") for n, f0 in GRID]
    cases += [pytest.param(f, (4, 64), 1024, id=f"edge-{f}") for f in EDGES]
    for label, filt, shape, block in (
            ("1100taps", taps_1100, (2, 1203), 4),
            ("1100taps-L7", taps_1100, (4, 7), 1),
            ("L1", (1, 0, -1), (50, 1), 1),
            ("L1-12taps", grid_filter(12, 1), (20, 1), 2),
            ("L7-halo-past-the-row", grid_filter(12, -1), (9, 7), 1),
            ("L1203", grid_filter(5, 1), (8, 1203), 64),
            ("L7000", (1, 0, -1), (3, 7000), 1024),
            ("L7000-small-blocks", grid_filter(9, 1), (2, 7000), 16),
            ("1d", (1, -1, 0, 1), (1001,), 8),
            ("3d", grid_filter(4, -1), (2, 3, 50), 2),
            ("17taps", grid_filter(12, 1) + (3, -2, 7, 1, 9), (5, 100), 2),
            ("no-rows", (1, 0, -1), (0, 9), 1024),
            ("empty-rows", (1, 0, -1), (4, 0), 1024)):
        cases.append(pytest.param(filt, shape, block, id=label))
    return cases


@pytest.mark.parametrize("filt,shape,block_vecs", _fir_cases())
def test_fir_model_matches_plain_and_jax(filt, shape, block_vecs):
    """The kernel's cut into vectors, blocks and halos (:func:`fir_tiles`)
    equals the plain forward filter, which
    equals the JAX package's ``prefilter_encode`` (for 1100 taps, whose
    eager JAX encode compiles a pad a tap and takes minutes, numpy's
    convolution of each row, wrapped to int16)."""
    x = torch.from_numpy(samples(shape, len(filt)))
    got = fir_tiles(x, filt, block_vecs)
    plain = prefilter.prefilter_encode_plain(x, filt)
    assert got.dtype == plain.dtype == torch.int16
    assert got.shape == plain.shape == x.shape
    assert torch.equal(got, plain)
    if not x.numel():
        return
    if len(filt) > 64:
        rows = x.numpy().reshape(-1, shape[-1]).astype(np.int64)
        taps = np.array([prefilter.c16(c) for c in filt], dtype=np.int64)
        want = np.stack([np.convolve(r, taps)[:shape[-1]] for r in rows])
        want = want.astype(np.int16).reshape(shape)  # wraps mod 2**16
    else:
        want = np.asarray(jpre.prefilter_encode(jnp.asarray(x.numpy()),
                                                tuple(filt)))
    np.testing.assert_array_equal(plain.numpy(), want)
