"""Edge cases for B7 and B8 (concentration in the tiled staging layout),
shared by the CPU tests of their plain model and the card tests of their
kernels. Imports no JAX.

Each case gives segment-major (values int16, disp int32) rows made from a
numpy seed, the segments per lane row ``sb`` and the output slots ``n_out``.
Displacements never fall along a row, as in every staging the kernels
concentrate. The cases put live slots where the kernels' spans and blocks
of slots begin and end, leave columns dead over whole spans and over all
of them (the padded lanes of a NOPTREX bucket), let neighbouring columns
drift thousands of rows apart, cut the slot axis off inside a block of 32
slots, take several blocks, ask for more output slots than were staged and
fewer than arrive, and take one element a lane where the columns do not
split into 16-byte pieces.

:func:`never_joining` makes B2's hardest words: a stream whose walk never
meets the walk from phase 0, for the repair of B2's first pass.
"""

import numpy as np
import torch

from deltarice_tpu_torch.ops.concentrate_cuda import DEAD
from deltarice_tpu_torch.ops.concentrate_tiled_cuda import tile

KINDS = ("vd", "packed", "bias", "u32")
SPAN = 2048  # the longest span of slots a pass-1 warp walks


def rows(valid, seed, gaps=False):
    """(values, disp) rows live where ``valid``; destinations increase by 1,
    or with ``gaps`` by 1-3 but never by more than the slots between two
    live ones. Halfwords are never 0 (a biased live 0 at displacement 0
    reads as dead)."""
    rng = np.random.default_rng(seed)
    step = rng.integers(1, 4, valid.shape) if gaps else np.ones(valid.shape)
    disp = np.full(valid.shape, -1, np.int32)
    for i, row in enumerate(valid):
        live = np.flatnonzero(row)
        gap = np.diff(live, prepend=-1)
        dest = np.cumsum(np.minimum(step[i, : len(live)], gap)) - 1
        disp[i, live] = live - dest
    vals = rng.integers(-2**15, 2**15, valid.shape).astype(np.int16)
    vals[vals == 0] = 1
    return vals, disp


def random_rows(nseg, r, density, seed, gaps=False):
    rng = np.random.default_rng(seed)
    return rows(rng.random((nseg, r)) < density, seed, gaps)


def _span_edges(kind, scale):
    """Live slots only at the first and last slot of each 2048: the ends
    of spans and of blocks of 32 slots, whatever the span."""
    valid = np.zeros((128, 6 * SPAN), bool)
    valid[:, ::SPAN] = True
    valid[:, SPAN - 1::SPAN] = True
    return rows(valid, 1), 1, 12


def _dead_spans(kind, scale):
    """64 segments (the other 64 lanes are padding, dead everywhere);
    columns 0-31 also dead over spans 1-3, live again after."""
    valid = np.random.default_rng(2).random((64, 6 * SPAN)) < 0.7
    valid[:32, SPAN: 4 * SPAN] = False
    return rows(valid, 2, gaps=True), 1, 6 * SPAN


def _far_lag(kind, scale):
    """Even columns live at every slot, odd ones dead for the first 2500
    slots: neighbouring columns land 2500 rows apart."""
    r = 3000 * scale
    valid = np.ones((128, r), bool)
    valid[1::2, :2500] = False
    return rows(valid, 3), 1, r


CASES = {
    "span_edges": _span_edges,
    "dead_spans": _dead_spans,
    "far_lag": _far_lag,
    # the slot axis ends inside a block of 32 slots
    "ragged": lambda kind, scale: (
        random_rows(128, 1000 * scale + 3, 0.6, 3, gaps=True), 1,
        1000 * scale + 3),
    # 2048 segments at sb = 8: two blocks
    "two_blocks": lambda kind, scale: (
        random_rows(2048, 300 * scale, 0.4, 4), 8, 300 * scale),
    # more output slots wanted than staged
    "n_out_wide": lambda kind, scale: (
        random_rows(100, 300 * scale, 0.5, 5), 8, 800 * scale),
    # ~70 % live, 30 % of the slots wanted: the rest are dropped
    "past_out": lambda kind, scale: (
        random_rows(256, 1000 * scale, 0.7, 6), 2, 300 * scale),
    # 6 lanes: the columns split into no 16-byte piece
    "scalar_lanes": lambda kind, scale: (
        random_rows(18, 700 * scale, 0.5, 7), 1, 700 * scale),
    # every slot live at displacement 0: whole runs throughout
    "all_home": lambda kind, scale: (
        rows(np.ones((128, 640 * scale), bool), 8), 1, 640 * scale),
}
LANES = {"scalar_lanes": 6}


def lead_plane(vals, disp, bias=False):
    """Packed (or sign-biased) leader, segment-major int32, dead INT32_MIN."""
    p = (disp.astype(np.int64) << 16) | (vals.astype(np.int64) & 0xFFFF)
    if bias:
        p ^= 1 << 31
    return np.where(disp >= 0, p, DEAD).astype(np.int64).astype(np.int32)


def planes(case, kind, scale=1):
    """The case's tiled planes for ``kind`` ("vd": (values, disp); else the
    leader, with the reversed values as a follower for "u32"), its
    (vals, disp) rows, ``sb``, ``n_out`` and lanes."""
    (vals, disp), sb, n_out = CASES[case](kind, scale)
    lanes = LANES.get(case, 128)

    def tiled(a, fill):
        return tile(torch.from_numpy(np.ascontiguousarray(a)), sb, fill,
                    lanes)

    if kind == "vd":
        out = (tiled(vals, 0), tiled(disp, -1))
    else:
        out = (tiled(lead_plane(vals, disp, kind == "bias"), DEAD),)
        if kind == "u32":
            out += (tiled(vals[:, ::-1], 0),)
    return out, (vals, disp), sb, n_out, lanes


def never_joining(nwords, lead=0x7FFFFFFF):
    """(nwords + 1,) uint32 words at k = 3 whose walk never meets phase
    0's: a first codeword of 5 bits (q = 1; ``lead`` 0x3FFFFFFF: q = 2, 6
    bits), then all-ones words, which hold 4-bit codewords only, and one
    zero pad word. The true walk starts codewords at bits 1 (2) mod 4 from
    then on, phase 0's walk through any later tile at 0 mod 4."""
    row = np.full(nwords + 1, 0xFFFFFFFF, np.uint32)
    row[0] = lead
    row[-1] = 0
    return row
