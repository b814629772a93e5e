"""Plain torch model of the tiled passes of B2 (``csrc/unpack.cu``) and B1
(``csrc/pack.cu``), which are parallel inside each segment.

The kernels' wrappers take the serial oracles (``unpack_decode_plain``,
``pack_encode_plain``) on a CPU tensor; this module instead computes what
each pass of the kernels computes, on the same decomposition, so that the
tests can hold every pass against the JAX package and ``chip_smoke.py``
can hold the card's first decode pass against it. Nothing on the codec's
path calls it.

Decode. A codeword is at most 25 bits, so the first codeword that starts
in a tile of ``tile_words`` words starts at bit phase 0..24 of it. A tile's
table maps each entry phase to (exit phase into the next tile, codewords
starting in the tile, wrapping int16 sum of their values). Tables compose
associatively; groups of ``group`` tables compose level by level until one
group spans the segment, and each segment's start (phase 0, sample 0,
value 0) is then walked down the levels to every tile's entry state. The
serial decode clamps its cursor at bit ``32 * (W - 1)``: every sample past
the last codeword that starts before the clamp re-decodes the codeword
there (the pad word), which the tail fills arithmetically.

Encode. A tile of ``tile`` samples sums its codeword lengths; the
exclusive prefix sum over a segment's tiles gives each tile's first bit;
each tile assembles its codewords into words from that bit's phase and ORs
them into the output (bits are disjoint, so OR is ADD).
"""

from __future__ import annotations

import torch

from ..config import DELTA_FILTER
from .pack_ref import as_i32, as_u32, decode_codeword
from .prefilter import prefilter_encode
from .rice import codeword_lengths_values, unzigzag, wrap16, zigzag

TILE_WORDS = 32   # B2: words per tile
PHASES = 25       # B2: entry phases 0..24 (a codeword is at most 25 bits)
GROUP = 32        # B2: tables composed per group
TILE_SAMPLES = 1024  # B1: samples per tile

_EXIT, _COUNT, _SUM = 0, 1, 2


def _ntiles(w: int, tile_words: int) -> int:
    return -(-(w - 1) // tile_words)


def _walk(wu, pos, lim, k, visit):
    """Step every (segment, ...) cursor in ``pos`` (int64, in bits) through
    the codewords that start before ``lim``, calling ``visit(active,
    value)`` with each step's int64 values; returns the exit positions."""
    w = wu.shape[1]
    rows = torch.arange(wu.shape[0], device=wu.device).reshape(
        -1, *([1] * (pos.dim() - 1)))
    active = pos < lim
    while bool(active.any()):
        wi = (pos >> 5).clamp(max=w - 1)
        w0 = wu[rows, wi]
        w1 = wu[rows, (wi + 1).clamp(max=w - 1)]
        u, ln = decode_codeword(w0, w1, pos & 31, k)
        if visit(active, unzigzag(u).to(torch.int64)) is False:
            break
        pos = torch.where(active, pos + ln, pos)
        active = pos < lim
    return pos


def _bounds(w: int, tile_words: int, device):
    """First bit and end bit of each tile: (ntiles,) int64 each."""
    tb = 32 * tile_words
    start = torch.arange(_ntiles(w, tile_words), dtype=torch.int64,
                         device=device) * tb
    return start, (start + tb).clamp(max=32 * (w - 1))


def decode_tables(words: torch.Tensor, k: int,
                  tile_words: int = TILE_WORDS) -> torch.Tensor:
    """B2's first pass: (nseg, ntiles, 25, 3) int32 of (exit phase,
    codewords, wrapping int16 sum) for every tile and entry phase."""
    nseg, w = words.shape
    start, end = _bounds(w, tile_words, words.device)
    lim = end[None, :, None]
    pos = (start[:, None] + torch.arange(PHASES, device=words.device)).expand(
        nseg, -1, -1)
    count = torch.zeros(pos.shape, dtype=torch.int64, device=words.device)
    total = torch.zeros_like(count)

    def visit(active, v):
        count.add_(active.to(torch.int64))
        total.add_(torch.where(active, v, 0))

    pos = _walk(as_u32(words), pos, lim, k, visit)
    return torch.stack([pos - lim, count, wrap16(total)], dim=-1).to(
        torch.int32)


def _step(tab, phase):
    """Entries (int64) of tables ``tab`` (..., 25, 3) at ``phase``: one
    entry per table for ``phase`` (...), or one per entry phase for
    ``phase`` (..., 25)."""
    one = phase.dim() == tab.dim() - 2
    idx = phase.to(torch.int64)[..., None].expand(*phase.shape, 3)
    if one:
        idx = idx.unsqueeze(-2)
    v = torch.gather(tab, -2, idx)
    return (v.squeeze(-2) if one else v).to(torch.int64)


def _grouped(tab, group):
    """(nseg, n, 25, 3) -> (nseg, ceil(n / group), group, 25, 3), padded
    with identity tables (exit = entry phase, no codewords)."""
    nseg, n = tab.shape[:2]
    nup = -(-n // group)
    ident = torch.zeros((nseg, nup * group - n, PHASES, 3), dtype=tab.dtype,
                        device=tab.device)
    ident[..., _EXIT] = torch.arange(PHASES, dtype=tab.dtype,
                                     device=tab.device)
    return torch.cat([tab, ident], dim=1).reshape(nseg, nup, group, PHASES, 3)


def compose(tab: torch.Tensor, group: int = GROUP) -> torch.Tensor:
    """One level up: the table of each group of ``group`` consecutive
    tables, composed in order."""
    g = _grouped(tab, group)
    phase = torch.arange(PHASES, device=tab.device).expand(*g.shape[:2], -1)
    count = torch.zeros(phase.shape, dtype=torch.int64, device=tab.device)
    total = torch.zeros_like(count)
    for j in range(group):
        v = _step(g[:, :, j], phase)
        phase = v[..., _EXIT]
        count = count + v[..., _COUNT]
        total = total + v[..., _SUM]
    return torch.stack([phase, count, wrap16(total)], dim=-1).to(torch.int32)


def resolve(tab: torch.Tensor, ent_up: torch.Tensor,
            group: int = GROUP) -> torch.Tensor:
    """One level down: the entry state (phase, first sample, running
    value) of every table of ``tab`` from its group's entry state
    ``ent_up`` (nseg, ceil(n / group), 3)."""
    n = tab.shape[1]
    g = _grouped(tab, group)
    phase, first, run = ent_up.to(torch.int64).unbind(-1)
    ent = []
    for j in range(group):
        ent.append(torch.stack([phase, first, run], dim=-1))
        v = _step(g[:, :, j], phase)
        phase, first, run = (v[..., _EXIT], first + v[..., _COUNT],
                             wrap16(run + v[..., _SUM]))
    return torch.stack(ent, dim=2).reshape(tab.shape[0], -1, 3)[:, :n].to(
        torch.int32)


def entry_states(tab: torch.Tensor, group: int = GROUP) -> torch.Tensor:
    """Every tile's entry state (nseg, ntiles, 3) = (phase, first sample,
    running value), by the kernel's levels: compose up until one group
    spans a segment, then resolve down from each segment's start."""
    sizes = [tab.shape[1]]
    while sizes[-1] > 1:
        sizes.append(-(-sizes[-1] // group))
    if sizes[-1] == 0:
        return torch.zeros((tab.shape[0], 0, 3), dtype=torch.int32,
                           device=tab.device)
    levels = [tab]
    for _ in range(len(sizes) - 2):  # the top level needs no table
        levels.append(compose(levels[-1], group))
    ent = torch.zeros((tab.shape[0], 1, 3), dtype=torch.int32,
                      device=tab.device)
    for t in reversed(levels[: len(sizes) - 1]):
        ent = resolve(t, ent, group)
    return ent


def entry_states_serial(tab: torch.Tensor) -> torch.Tensor:
    """The same entry states, tile after tile."""
    nseg, n = tab.shape[:2]
    phase = torch.zeros(nseg, dtype=torch.int64, device=tab.device)
    first = torch.zeros_like(phase)
    run = torch.zeros_like(phase)
    ent = torch.zeros((nseg, n, 3), dtype=torch.int64, device=tab.device)
    for t in range(n):
        ent[:, t] = torch.stack([phase, first, run], dim=-1)
        v = _step(tab[:, t], phase)
        phase, first, run = (v[:, _EXIT], first + v[:, _COUNT],
                             wrap16(run + v[:, _SUM]))
    return ent.to(torch.int32)


def decode_tiled(words: torch.Tensor, n_samples: int, k: int,
                 delta: bool = True, tile_words: int = TILE_WORDS,
                 group: int = GROUP) -> torch.Tensor:
    """The whole tiled decode: tables, entry states, each tile decoded from
    its entry phase, and the clamped tail. Equals the serial decode,
    samples past each stream's end included. Returns (nseg, n_samples)
    int16, on ``words``' device."""
    nseg, w = words.shape
    dev = words.device
    wu = as_u32(words)
    out = torch.zeros((nseg, n_samples + 1), dtype=torch.int64,
                      device=dev)  # + a dump column
    first_end = torch.zeros(nseg, dtype=torch.int64, device=dev)
    run_end = torch.zeros_like(first_end)
    if w > 1:
        tab = decode_tables(words, k, tile_words)
        ent = entry_states(tab, group).to(torch.int64)
        start, end = _bounds(w, tile_words, dev)
        idx = ent[..., 1].clone()
        run = ent[..., 2].clone()

        def visit(active, v):
            nonlocal run
            live = active & (idx < n_samples)
            if not bool(live.any()):
                return False
            run = torch.where(live, wrap16(run + v) if delta else v, run)
            out.scatter_(1, torch.where(live, idx, n_samples), run)
            idx.add_(live.to(torch.int64))

        _walk(wu, start + ent[..., 0], end[None, :], k, visit)
        last = _step(tab[:, -1], ent[:, -1, 0])
        first_end = ent[:, -1, 1] + last[:, _COUNT]
        run_end = ent[:, -1, 2] + last[:, _SUM]
    # the tail: the codeword at the clamp, once per remaining sample
    zero = torch.zeros_like(first_end)
    u, _ = decode_codeword(wu[:, -1], zero, zero, k)
    vc = unzigzag(u).to(torch.int64)
    i = torch.arange(n_samples, device=dev)[None, :]
    reps = i - first_end[:, None] + 1
    tail = run_end[:, None] + reps * vc[:, None] if delta else \
        vc[:, None].expand(-1, n_samples)
    out = torch.where(reps > 0, tail, out[:, :n_samples])
    return wrap16(out).to(torch.int16)


def encode_tiled(x: torch.Tensor, nvalid: torch.Tensor, prev0, k: int,
                 diff: bool, cap: int, tile: int = TILE_SAMPLES):
    """B1's tiled passes: tile bit totals, their exclusive prefix sum per
    segment, each tile's words assembled from its first bit's phase and
    ORed into the output. Returns (words (nseg, cap) int32, nwords, nbits)
    as :func:`.pack_cuda.pack_encode` does."""
    nseg, length = x.shape
    d = prefilter_encode(x, DELTA_FILTER, prev0) if diff else x
    lens, vals = codeword_lengths_values(zigzag(d), k)
    pos = torch.arange(length)
    lens = torch.where(pos[None, :] < nvalid.to(torch.int64)[:, None], lens, 0)
    ntiles = -(-length // tile)
    pad = ntiles * tile - length
    lens = torch.nn.functional.pad(lens, (0, pad)).reshape(nseg, ntiles, tile)
    vals = torch.nn.functional.pad(vals, (0, pad)).reshape(nseg, ntiles, tile)
    tile_bits = lens.sum(dim=2)
    tile_off = torch.cumsum(tile_bits, dim=1) - tile_bits      # pass 2
    off = torch.cumsum(lens, dim=2) - lens + (tile_off & 31)[..., None]
    # pass 3: each tile's words, from word tile_off >> 5 on
    vals = torch.where(lens > 0, vals, 0)
    sh = 32 - (off & 31) - lens
    hi = torch.where(sh >= 0, vals << sh.clamp(min=0),
                     vals >> (-sh).clamp(min=0))
    lo = torch.where(sh >= 0, 0, (vals << (32 + sh).clamp(min=0)) & 0xFFFFFFFF)
    width = (tile * 25 + 31 + 31) // 32 + 1
    local = torch.zeros((nseg, ntiles, width), dtype=torch.int64)
    local.scatter_add_(2, off >> 5, hi)
    local.scatter_add_(2, (off >> 5) + 1, lo)
    gw = (tile_off >> 5)[..., None] + torch.arange(width)
    out = torch.zeros((nseg, cap + 1), dtype=torch.int64)  # + dump column
    out.scatter_add_(1, gw.clamp(max=cap).reshape(nseg, -1),
                     torch.where(gw < cap, local, 0).reshape(nseg, -1))
    nbits = tile_bits.sum(dim=1)
    return (as_i32(out[:, :cap]), ((nbits + 31) >> 5).to(torch.int32),
            nbits.to(torch.int32))
