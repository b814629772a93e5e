"""Plain torch model of the tiled passes of B2 (``csrc/unpack.cu``) and B1
(``csrc/pack.cu``), which are parallel inside each segment.

The kernels' wrappers take the serial oracles (``unpack_decode_plain``,
``pack_encode_plain``) on a CPU tensor; this module instead computes what
each pass of the kernels computes, on the same decomposition, so that the
tests can hold every pass against the JAX package and ``chip_smoke.py``
can hold the card's first decode pass against it. Nothing on the codec's
path calls it.

Decode. A codeword is at most 25 bits, so the first codeword that starts
in a tile of ``tile_words`` words starts at bit phase 0..24 of it. A
tile's entry, walked from an entry phase, is (exit phase into the next
tile, codewords starting in the tile, wrapping int16 sum of their values);
:func:`decode_tables` gives it for all 25 entry phases, the oracle. The
kernel's first pass walks each tile twice: from phase 0, and from its
assumed entry phase, the previous tile's phase-0 exit (0 for a segment's
first tile). A walk from a wrong phase meets the true walk within a few
codewords, so the assumption is almost always right; where the previous
tile's walk exits elsewhere, the tile is walked again from its true entry,
as far as the samples asked for reach (:func:`decode_entries`). The entries then hold plain sums: groups of
``group`` compose level by level until one group spans the segment, and
each segment's start (phase 0, sample 0, value 0) is walked down the
levels to every tile's entry state (:func:`entry_states`). The serial
decode clamps its cursor at bit ``32 * (W - 1)``: every sample past the
last codeword that starts before the clamp re-decodes the codeword there
(the pad word), which the tail fills arithmetically. The decode pass gives
each warp 32 consecutive tiles, one a lane: lanes decode ``ROUND`` samples
a round into shared memory, and the warp stores each lane's round as
consecutive aligned 8-byte words (:func:`write_plan`, :func:`decode_warps`).

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
ROUND = 124       # B2's decode pass: samples a lane decodes a round
WARP = 32         # B2's decode pass: tiles a warp takes, one a lane

_EXIT, _COUNT, _SUM = 0, 1, 2


def _ntiles(w: int, tile_words: int) -> int:
    return -(-(w - 1) // tile_words)


def _walk(wu, pos, lim, k, visit, rows=None):
    """Step every (segment, ...) cursor in ``pos`` (int64, in bits) through
    the codewords that start before ``lim``, calling ``visit(active,
    value)`` with each step's int64 values; returns the exit positions.
    Cursor i walks row ``rows[i]`` of ``wu`` where given, else the rows in
    order along the first axis."""
    w = wu.shape[1]
    if rows is None:
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
    """Every tile's entry from every entry phase: (nseg, ntiles, 25, 3)
    int32 of (exit phase, codewords, wrapping int16 sum)."""
    nseg, w = words.shape
    start, end = _bounds(w, tile_words, words.device)
    entry = torch.arange(PHASES, device=words.device).expand(
        nseg, start.numel(), -1)
    return _tile_walks(as_u32(words), start[:, None], end[:, None], entry,
                       k).to(torch.int32)


def _step(tab, phase):
    """Entries (int64) of tables ``tab`` (..., 25, 3) at ``phase`` (...)."""
    idx = phase.to(torch.int64)[..., None, None].expand(*phase.shape, 1, 3)
    return torch.gather(tab, -2, idx).squeeze(-2).to(torch.int64)


def _tile_walks(wu, start, end, entry, k, rows=None):
    """(exit phase, codewords, wrapping int16 sum) int64 of the walks from
    bit ``start + entry`` of each row of ``wu`` (of row ``rows[i]`` for
    walk i, where given) over the codewords that start before ``end``;
    ``entry`` is (rows, ...)."""
    count = torch.zeros(entry.shape, dtype=torch.int64, device=wu.device)
    total = torch.zeros_like(count)

    def visit(active, v):
        count.add_(active.to(torch.int64))
        total.add_(torch.where(active, v, 0))

    pos = _walk(wu, start + entry, end, k, visit, rows)
    return torch.stack([pos - end, count, wrap16(total)], dim=-1)


def decode_entries(words: torch.Tensor, k: int, n_samples: int,
                   tile_words: int = TILE_WORDS):
    """B2's first pass with its check and repair: each tile walked from
    phase 0 and from its assumed entry phase (the previous tile's phase-0
    exit, 0 for a segment's first tile); a tile whose true entry phase
    (the previous tile's exit) differs from the assumed one, and whose
    first codeword is below ``n_samples``, walked again from its true
    entry. The kernel repairs tile after tile, or, past a long chain, from
    every tile's exit from each entry phase; here every tile whose entry
    disagrees with the exit before it is walked again at once, round after
    round until none does (each round makes right the first wrong tile of
    every chain), and past ``n_samples`` the one join stands: the same
    entries. Returns ((nseg, ntiles, 4) int32 of (entry phase walked from,
    exit phase, codewords, wrapping int16 sum), the number of tiles walked
    again)."""
    nseg, w = words.shape
    dev = words.device
    wu = as_u32(words)
    start, end = _bounds(w, tile_words, dev)
    n = start.numel()
    p0 = _tile_walks(wu, start, end, torch.zeros((nseg, n), dtype=torch.int64,
                                                 device=dev), k)
    assumed = torch.zeros((nseg, n), dtype=torch.int64, device=dev)
    assumed[:, 1:] = p0[:, :-1, _EXIT]
    joined = _tile_walks(wu, start, end, assumed, k)  # the one join a tile
    entry, ent = assumed.clone(), joined.clone()
    while True:
        prev = torch.zeros_like(entry)
        prev[:, 1:] = ent[:, :-1, _EXIT]
        s, t = (prev != entry).nonzero(as_tuple=True)
        if s.numel() == 0:
            break
        ent[s, t] = _tile_walks(wu, start[t], end[t], prev[s, t], k, rows=s)
        entry[s, t] = prev[s, t]
    first = ent[..., _COUNT].cumsum(dim=1) - ent[..., _COUNT]
    again = (entry != assumed) & (first < n_samples)
    entry = torch.where(again, entry, assumed)
    ent = torch.where(again[..., None], ent, joined)
    return (torch.cat([entry[..., None], ent], dim=-1).to(torch.int32),
            int(again.sum()))


def _grouped(ent, group):
    """(nseg, n, 3) -> (nseg, ceil(n / group), group, 3), padded with
    empty entries (no codewords)."""
    nseg, n = ent.shape[:2]
    nup = -(-n // group)
    pad = torch.zeros((nseg, nup * group - n, 3), dtype=ent.dtype,
                      device=ent.device)
    return torch.cat([ent, pad], dim=1).reshape(nseg, nup, group, 3)


def compose(ent: torch.Tensor, group: int = GROUP) -> torch.Tensor:
    """One level up: the entry of each group of ``group`` consecutive
    entries (exit phase, codewords, wrapping sum): its last member's exit
    (a padded group's last real one), its members' sums."""
    g = _grouped(ent.to(torch.int64), group)
    n = ent.shape[1]
    last = torch.clamp(n - 1 - torch.arange(g.shape[1], device=ent.device)
                       * group, max=group - 1)
    exit_ = g[:, torch.arange(g.shape[1], device=ent.device), last, _EXIT]
    return torch.stack([exit_, g[..., _COUNT].sum(dim=2),
                        wrap16(g[..., _SUM].sum(dim=2))],
                       dim=-1).to(torch.int32)


def resolve(ent: torch.Tensor, ent_up: torch.Tensor,
            group: int = GROUP) -> torch.Tensor:
    """One level down: the entry state (phase, first sample, running
    value) of every entry of ``ent`` from its group's entry state
    ``ent_up`` (nseg, ceil(n / group), 3)."""
    n = ent.shape[1]
    g = _grouped(ent.to(torch.int64), group)
    phase, first, run = ent_up.to(torch.int64).unbind(-1)
    states = []
    for j in range(group):
        states.append(torch.stack([phase, first, run], dim=-1))
        v = g[:, :, j]
        phase, first, run = (v[..., _EXIT], first + v[..., _COUNT],
                             wrap16(run + v[..., _SUM]))
    return torch.stack(states, dim=2).reshape(ent.shape[0], -1, 3)[:, :n].to(
        torch.int32)


def entry_states(ent: torch.Tensor, group: int = GROUP) -> torch.Tensor:
    """Every tile's entry state (nseg, ntiles, 3) = (phase, first sample,
    running value) from one entry a tile (nseg, ntiles, 3) = (exit phase,
    codewords, wrapping sum), by the kernel's levels: compose up until one
    group spans a segment, then resolve down from each segment's start."""
    sizes = [ent.shape[1]]
    while sizes[-1] > 1:
        sizes.append(-(-sizes[-1] // group))
    if sizes[-1] == 0:
        return torch.zeros((ent.shape[0], 0, 3), dtype=torch.int32,
                           device=ent.device)
    levels = [ent]
    for _ in range(len(sizes) - 2):  # the top level needs no entries
        levels.append(compose(levels[-1], group))
    states = torch.zeros((ent.shape[0], 1, 3), dtype=torch.int32,
                         device=ent.device)
    for t in reversed(levels[: len(sizes) - 1]):
        states = resolve(t, states, group)
    return states


def entry_states_serial(tab: torch.Tensor) -> torch.Tensor:
    """The true entry states from the tables of every entry phase
    (:func:`decode_tables`), tile after tile: the oracle."""
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
                 group: int = GROUP, oracle: bool = False) -> torch.Tensor:
    """The whole tiled decode: one entry a tile (checked and repaired),
    entry states, each tile decoded from its entry phase, and the clamped
    tail. With ``oracle`` the entry states come instead from every tile's
    walk from every entry phase chained tile after tile
    (:func:`decode_tables`, :func:`entry_states_serial`), which knows
    nothing of the pass's assumption, check and repair. Equals the serial
    decode, samples past each stream's end included. Returns (nseg,
    n_samples) int16, on ``words``' device."""
    nseg, w = words.shape
    dev = words.device
    wu = as_u32(words)
    out = torch.zeros((nseg, n_samples + 1), dtype=torch.int64,
                      device=dev)  # + a dump column
    first_end = torch.zeros(nseg, dtype=torch.int64, device=dev)
    run_end = torch.zeros_like(first_end)
    if w > 1:
        if oracle:
            tab = decode_tables(words, k, tile_words)
            states = entry_states_serial(tab).to(torch.int64)
            ent = _step(tab, states[..., 0])
        else:
            ent = decode_entries(words, k, n_samples, tile_words)[0][..., 1:]
            states = entry_states(ent, group).to(torch.int64)
        start, end = _bounds(w, tile_words, dev)
        idx = states[..., 1].clone()
        run = states[..., 2].clone()

        def visit(active, v):
            nonlocal run
            live = active & (idx < n_samples)
            if not bool(live.any()):
                return False
            run = torch.where(live, wrap16(run + v) if delta else v, run)
            out.scatter_(1, torch.where(live, idx, n_samples), run)
            idx.add_(live.to(torch.int64))

        _walk(wu, start + states[..., 0], end[None, :], k, visit)
        last = ent[:, -1].to(torch.int64)
        first_end = states[:, -1, 1] + last[:, _COUNT]
        run_end = states[:, -1, 2] + last[:, _SUM]
    return _with_tail(out[:, :n_samples], wu, first_end, run_end, k, delta)


def _with_tail(out, wu, first_end, run_end, k, delta):
    """``out`` (nseg, n_samples) int64 with the tail filled: the codeword at
    the clamp, once per sample from ``first_end`` on (the running value
    ``run_end`` before it), wrapped to int16."""
    zero = torch.zeros_like(first_end)
    u, _ = decode_codeword(wu[:, -1], zero, zero, k)
    vc = unzigzag(u).to(torch.int64)
    i = torch.arange(out.shape[1], device=out.device)[None, :]
    reps = i - first_end[:, None] + 1
    tail = run_end[:, None] + reps * vc[:, None] if delta else \
        vc[:, None].expand(-1, out.shape[1])
    return wrap16(torch.where(reps > 0, tail, out)).to(torch.int16)


def write_plan(first: torch.Tensor, count: torch.Tensor, n_samples: int,
               ph: int = 0) -> dict:
    """B2's decode pass, its stores: each 8-byte word that a lane stores.

    Warp ``g // 32`` takes tiles ``g = s * ntiles + t``; tile g's samples
    are ``out[s, first .. first + count)``, at flat sample ``q = s *
    n_samples + first + ph`` from out's 8-byte boundary at or before it
    (``ph`` = out's address / 2 mod 4). Round r of a tile holds its samples
    ``r * ROUND ..``, at most ``ROUND`` (a multiple of 4, so a round's
    first sample keeps the phase ``q & 3`` in the words); after the round,
    the warp stores the rounds of its lanes in turn, lane u storing the
    round's word ``(q + r * ROUND) // 4 + u``, which holds the round's
    samples ``lo .. lo + 3`` with ``lo = 4 u - (q & 3)``: all four (one
    8-byte store, ``full``) or those in ``[0, n)`` (sample by sample).

    Args:
      first, count: (nseg, ntiles) int64: each tile's first sample and its
        samples (its codewords clamped at n_samples; 0 past n_samples).

    Returns 1-D int64 tensors, one entry a stored word, in the warps' order
    (warp, round, the lane whose round it is, u): ``tile``, ``round``,
    ``lane`` (u), ``word``, ``lo``, ``n`` (the round's samples), ``full``
    and ``store`` (the warp's store instruction: the same for the words of
    one warp, round and tile).
    """
    nseg, ntiles = first.shape
    g = torch.arange(nseg * ntiles, dtype=torch.int64)
    s = g // max(ntiles, 1)
    first = first.reshape(-1).to(torch.int64)
    count = count.reshape(-1).to(torch.int64)
    q = s * n_samples + first + ph
    rounds = -(-count // ROUND)
    most = int(rounds.max()) if rounds.numel() else 0
    r = torch.arange(most, dtype=torch.int64)
    u = torch.arange(WARP, dtype=torch.int64)
    n = (count[:, None] - r[None, :] * ROUND).clamp(0, ROUND)    # (g, r)
    lo = 4 * u[None, None, :] - (q & 3)[:, None, None]           # (g, 1, u)
    live = (lo + 4 > 0) & (lo < n[..., None])                    # (g, r, u)
    # the warps' order: warp, round, lane j (the tile), word u
    gg, rr, uu = (a.reshape(-1) for a in torch.meshgrid(g, r, u,
                                                      indexing="ij"))
    order = torch.argsort(((gg // WARP) * most + rr) * WARP * WARP
                          + (gg % WARP) * WARP + uu)
    sel = order[live.reshape(-1)[order]]
    gg, rr, uu = gg[sel], rr[sel], uu[sel]
    lo = lo.expand(-1, most, -1).reshape(-1)[sel]
    nn = n[gg, rr]
    word = (q[gg] + rr * ROUND) // 4 + uu
    return {"tile": gg, "round": rr, "lane": uu, "word": word, "lo": lo,
            "n": nn, "full": (lo >= 0) & (lo + 4 <= nn),
            "store": ((gg // WARP) * most + rr) * WARP + gg % WARP}


def store_sectors(plan: dict, base: int = 0) -> torch.Tensor:
    """The 32-byte sectors that each warp store of :func:`write_plan`
    covers, ``base`` the 8-byte boundary's byte address mod 32: (stores,)
    int64, in the order of the stores."""
    sector = (base + 8 * plan["word"]) // 32
    store = plan["store"]
    pairs = torch.unique(torch.stack([store, sector], dim=1), dim=0)
    _, counts = torch.unique_consecutive(pairs[:, 0], return_counts=True)
    return counts


def decode_warps(words: torch.Tensor, n_samples: int, k: int,
                 delta: bool = True, ph: int = 0):
    """The tiled decode with the decode pass as the kernel's warps run it:
    each tile's entry and state from the model of passes 1-3, its samples
    decoded from its entry phase as far as its count (its codewords,
    clamped at n_samples), stored through :func:`write_plan` into a flat
    buffer that starts ``ph`` samples before out, then the tail. Returns
    ((nseg, n_samples) int16, (nseg, n_samples) int64: how many times the
    decode pass stored each sample)."""
    nseg, w = words.shape
    flat = torch.zeros(nseg * n_samples + ph + 4, dtype=torch.int64)
    stored = torch.zeros_like(flat)
    first_end = torch.zeros(nseg, dtype=torch.int64)
    run_end = torch.zeros_like(first_end)
    wu = as_u32(words)
    if w > 1:
        ent = decode_entries(words, k, n_samples)[0][..., 1:]
        states = entry_states(ent).to(torch.int64)
        ent = ent.to(torch.int64)
        first = states[..., 1]
        count = torch.where(first < n_samples,
                            torch.minimum(ent[..., _COUNT],
                                          n_samples - first), 0)
        # each tile's samples, walked from its entry phase
        start, end = _bounds(w, TILE_WORDS, words.device)
        most = max(int(count.max()), 1)
        vals = torch.zeros((nseg, start.numel(), most + 1), dtype=torch.int64)
        idx = torch.zeros_like(first)

        def visit(active, v):
            live = active & (idx < count)
            vals.scatter_(2, torch.where(live, idx, most)[..., None],
                          v[..., None])
            idx.add_(live.to(torch.int64))

        _walk(wu, start + states[..., 0], end[None, :], k, visit)
        vals = vals[..., :most]
        if delta:
            vals = wrap16(states[..., 2:3] + vals.cumsum(dim=2))
        plan = write_plan(first, count, n_samples, ph)
        tiles = vals.reshape(-1, most)
        for m in range(4):
            i = plan["lo"] + m
            ok = (i >= 0) & (i < plan["n"])
            at = 4 * plan["word"][ok] + m
            flat[at] = tiles[plan["tile"][ok], plan["round"][ok] * ROUND
                             + i[ok]]
            stored.index_add_(0, at, torch.ones_like(at))
        first_end = states[:, -1, 1] + ent[:, -1, _COUNT]
        run_end = states[:, -1, 2] + ent[:, -1, _SUM]
    out = flat[ph: ph + nseg * n_samples].reshape(nseg, n_samples)
    return (_with_tail(out, wu, first_end, run_end, k, delta),
            stored[ph: ph + nseg * n_samples].reshape(nseg, n_samples))


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
