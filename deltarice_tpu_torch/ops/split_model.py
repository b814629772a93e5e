"""Plain torch model of the passes of B9 (``csrc/split_decode.cu``), the
speculative split decode that one warp runs per (segment, part) sub-block.

The kernel's wrapper takes the serial walk (``split_decode_plain``) on a
CPU tensor; this module instead computes what each pass of the kernel
computes, on the same decomposition, so that the tests can hold the passes
against the JAX package and the serial walk. Nothing on the codec's path
calls it.

A row's window is words [p*wsub - halo, p*wsub + wv) of its segment, zero
outside [0, W). The halo (skipped by sub-block 0) and the owned words are
walked in chunks of ``CHUNK`` words, each cut into ``LANES`` stretches of
``max(MIN_STRETCH, ceil(len / LANES))`` words:

* A: every stretch is walked from bit phase 0, recording for each of its
  words where that walk first starts a codeword and the count and wrapping
  sum before it;
* B: stretch i assumes stretch i-1's phase-0 exit as its entry (stretch 0
  the chunk's known entry) and walks from it until it starts a word at the
  bit phase 0 did, then takes the recorded remainder; stretches whose true
  entry differs from the assumption are walked again, in order;
* C: prefix sums over the stretches give each its first sample index and
  running value, and each decodes from its true entry and stores.

The chunk's exit phase, count and wrapping sum carry into the next chunk.
Sums are kept mod 2^16, as the kernel keeps their low halfword.
"""

from __future__ import annotations

import torch

from .pack_ref import as_u32, decode_codeword
from .rice import unzigzag, wrap16

LANES = 32        # stretches per chunk: a warp's lanes
CHUNK = 512       # window words staged per step
MIN_STRETCH = 4   # words per stretch, at least
_MASK = 0xFFFF


def _window(words: torch.Tensor, parts: int, wsub: int, halo: int,
            width: int) -> torch.Tensor:
    """(nseg * parts, width) int64: word t of row s * parts + p is word
    p * wsub - halo + t of segment s, zero outside [0, W)."""
    nseg, w = words.shape
    g = (torch.arange(parts, device=words.device)[:, None] * wsub - halo
         + torch.arange(width, device=words.device)[None, :])
    win = as_u32(words)[:, g.clamp(0, w - 1)]
    return torch.where((g >= 0) & (g < w), win, 0).reshape(-1, width)


def _decode(win, ridx, pos, k):
    """Value (int64) and bit length of the codeword at window bit pos."""
    wi = (pos >> 5).clamp(0, win.shape[1] - 2)
    u, ln = decode_codeword(win[ridx, wi], win[ridx, wi + 1], pos & 31, k)
    return unzigzag(u).to(torch.int64), ln


def stretches(length: torch.Tensor):
    """First and end window word (relative to the chunk) of each lane's
    stretch for chunks of ``length`` (rows,) words: (b0, b1) (rows, LANES)
    int64; a lane holds words where b0 < b1."""
    st = torch.clamp((length + LANES - 1) // LANES, min=MIN_STRETCH)[:, None]
    b0 = torch.arange(LANES, device=length.device)[None, :] * st
    return b0, torch.minimum(b0 + st, length[:, None])


def phase0(win, start, lim, live, k):
    """Pass A: each stretch (bits [start, lim) of its row's window) walked
    from phase 0. Returns ((exit phase, count, sum) each (rows, LANES),
    records (bit, count, sum) of the first start in each window word, each
    (rows, width + 1) with -1 bits where no record was made)."""
    rows, width = win.shape
    ridx = torch.arange(rows, device=win.device)[:, None]
    pos = start.clone()
    count = torch.zeros_like(start)
    total = torch.zeros_like(start)
    rb = torch.full((rows, width + 1), -1, dtype=torch.int64,
                    device=win.device)  # + a dump column
    rc, rs = torch.zeros_like(rb), torch.zeros_like(rb)
    active = live & (pos < lim)
    while bool(active.any()):
        v, ln = _decode(win, ridx, pos, k)
        nxt = pos + ln
        count += active.to(torch.int64)
        total = (total + torch.where(active, v, 0)) & _MASK
        new = active & ((nxt >> 5) != (pos >> 5)) & (nxt < lim)
        col = torch.where(new, nxt >> 5, width).expand_as(pos)
        rr = ridx.expand_as(pos)
        rb[rr, col] = torch.where(new, nxt & 31, -1)
        rc[rr, col] = count
        rs[rr, col] = total
        pos = torch.where(active, nxt, pos)
        active &= pos < lim
    exit_ = torch.where(live, pos - lim, 0)
    return (exit_, count, total), (rb, rc, rs)


def joined(win, start, lim, entry, go, p0, rec, k):
    """A walk of each stretch where ``go`` from its entry phase, until it
    starts a word at the bit the phase-0 walk ``p0`` / ``rec`` did, then
    that walk's remainder; elsewhere ``p0`` itself. Returns (exit phase,
    count, sum) (rows, n)."""
    rows, width = win.shape
    ridx = torch.arange(rows, device=win.device)[:, None]
    rr = ridx.expand_as(start)
    rb, rc, rs = rec
    x0, c0, s0 = p0
    pos = start + entry
    count = torch.zeros_like(start)
    total = torch.zeros_like(start)
    met = torch.zeros_like(go)
    active = go & (pos < lim)
    while bool(active.any()):
        v, ln = _decode(win, ridx, pos, k)
        nxt = pos + ln
        count += active.to(torch.int64)
        total = (total + torch.where(active, v, 0)) & _MASK
        cross = active & ((nxt >> 5) != (pos >> 5)) & (nxt < lim)
        col = torch.where(cross, nxt >> 5, width)
        hit = cross & (rb[rr, col] == (nxt & 31))
        count += torch.where(hit, c0 - rc[rr, col], 0)
        total = (total + torch.where(hit, s0 - rs[rr, col], 0)) & _MASK
        met |= hit
        pos = torch.where(active & ~hit, nxt, pos)
        active &= ~hit & (pos < lim)
    exit_ = torch.where(met, x0, pos - lim)
    return (torch.where(go, exit_, x0), torch.where(go, count, c0),
            torch.where(go, total, s0))


def resolve(win, start, lim, live, entry, p0, rec, k):
    """Pass B: every stretch from its assumed entry (the previous
    stretch's phase-0 exit; the chunk's ``entry`` for the first), then the
    stretches whose true entry differs, in order. Returns (true entry
    phase, exit phase, count, sum) (rows, LANES) and the number of
    stretches walked again per row."""
    a = torch.cat([entry[:, None], p0[0][:, :-1]], dim=1)
    ex, cn, sm = joined(win, start, lim, a, live & (a != 0), p0, rec, k)
    a, ex, cn, sm = a.clone(), ex.clone(), cn.clone(), sm.clone()
    again = torch.zeros(win.shape[0], dtype=torch.int64, device=win.device)
    for i in range(1, LANES):
        e = ex[:, i - 1]
        need = live[:, i] & (e != a[:, i])
        if not bool(need.any()):
            continue
        one = slice(i, i + 1)
        r = joined(win, start[:, one], lim[:, one], e[:, None],
                   need[:, None] & (e[:, None] != 0),
                   tuple(x[:, one] for x in p0), rec, k)
        for t, v in zip((ex, cn, sm), r):
            t[:, i] = torch.where(need, v[:, 0], t[:, i])
        a[:, i] = torch.where(need, e, a[:, i])
        again += need.to(torch.int64)
    return (a, ex, cn, sm), again


def decode(win, start, lim, live, entry, first, run, local, k, delta):
    """Pass C: each stretch from its true entry phase, storing sample n at
    ``local[row, first + n]`` (and a running value from ``run`` with
    ``delta``) while the index is below ``local``'s last column, its dump
    column."""
    lw = local.shape[1] - 1
    ridx = torch.arange(win.shape[0], device=win.device)[:, None]
    rr = ridx.expand_as(start)
    pos = start + entry
    idx = first.clone()
    active = live & (pos < lim) & (idx < lw)
    while bool(active.any()):
        v, ln = _decode(win, ridx, pos, k)
        run = torch.where(active, ((run + v) if delta else v) & _MASK, run)
        local[rr, torch.where(active, idx, lw)] = wrap16(run).to(torch.int16)
        idx += active.to(torch.int64)
        pos = torch.where(active, pos + ln, pos)
        active &= (pos < lim) & (idx < lw)


def walk_chunk(win, c0: int, length, carry, k, delta, local=None,
               stats=None):
    """One chunk: window words [c0, c0 + length) of each row (length (rows,)
    may be 0), walked from ``carry`` = (entry phase, count, sum) through
    passes A-C (C only with ``local``); returns the carry out."""
    b0, b1 = stretches(length)
    start, lim = 32 * (c0 + b0), 32 * (c0 + b1)
    live = b0 < b1
    p0, rec = phase0(win, start, lim, live, k)
    (a, ex, cn, sm), again = resolve(win, start, lim, live, carry[0], p0,
                                     rec, k)
    cn = torch.where(live, cn, 0)
    sm = torch.where(live, sm, 0)
    first = carry[1][:, None] + torch.cumsum(cn, dim=1) - cn
    run = (carry[2][:, None] + torch.cumsum(sm, dim=1) - sm) & _MASK
    if local is not None:
        decode(win, start, lim, live, a, first, run, local, k, delta)
    if stats is not None:
        stats["lanes"] = stats.get("lanes", 0) + int(live.sum())
        stats["again"] = stats.get("again", 0) + int(again.sum())
        stats.setdefault("entries", []).append((c0, b0, b1, live, a))
    nl = live.sum(dim=1)
    last = torch.gather(ex, 1, (nl - 1).clamp(min=0)[:, None])[:, 0]
    some = nl > 0
    return (torch.where(some, last, carry[0]),
            carry[1] + cn.sum(dim=1), (carry[2] + sm.sum(dim=1)) & _MASK)


def split_decode_model(words: torch.Tensor, wv: torch.Tensor, parts: int,
                       wsub: int, halo: int, lw: int, k: int, delta: bool,
                       stats: dict | None = None):
    """B9's passes on segment-major ``words`` (nseg, W): the same
    (local (rows, lw) int16, meta (4, rows) int32) as
    :func:`.split_decode_cuda.split_decode`. ``stats``, when given,
    collects the stretches walked, those walked again in pass B, and each
    chunk's stretch bounds and true entry phases."""
    nseg = words.shape[0]
    rows = nseg * parts
    dev = words.device
    wv = wv.to(torch.int64)
    win = _window(words, parts, wsub, halo, halo + wsub + 3)
    local = torch.zeros((rows, lw + 1), dtype=torch.int16, device=dev)
    zero = torch.zeros(rows, dtype=torch.int64, device=dev)
    later = torch.arange(rows, device=dev) % parts > 0
    carry = (zero, zero, zero)
    for c0 in range(0, halo, CHUNK):  # the halo: only its exit phase counts
        length = torch.where(later, min(CHUNK, halo - c0), 0)
        carry = walk_chunk(win, c0, length, carry, k, delta)
    ent = torch.where(later, carry[0], 0)
    carry = (ent, zero, zero)
    for c0 in range(halo, halo + (int(wv.max()) if rows else 0), CHUNK):
        length = (halo + wv - c0).clamp(0, CHUNK)
        carry = walk_chunk(win, c0, length, carry, k, delta, local, stats)
    acc = wrap16(carry[2]) if delta else zero
    meta = torch.stack([ent, carry[0], carry[1], acc]).to(torch.int32)
    return local[:, :lw].contiguous(), meta
