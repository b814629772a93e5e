"""Plain torch model of the generic inverse's blocked scan
(``csrc/prefilter.cu``, ``dr_iir_blocked``), and the routing and block
transition its wrapper (:mod:`.prefilter_cuda`) takes from here.

A filter whose leading tap is +-1 mod 2**16 (every lossless filter) has
the inverse ``out[i] = s d[i] - sum_j s c16(filt[j]) out[i - j]`` with s =
c16(filt[0]): the sign folds into the input and the taps, and the
recurrence is linear over Z/2**16 in the input and the history. A row of n
samples is cut into blocks of L; each block is a "virtual row". Its exit
history (its last T = len(filt) - 1 outputs, newest first) is ``M entry +
e``: M (:func:`block_transition`, T x T, the same for every full block)
maps the entry history under zero input, and e is the block walked from a
zero history. So:

* pass A (:func:`exit_states`) walks every full block but each row's last
  from zero and keeps e;
* pass B (:func:`carry_scan`) runs ``s_{b+1} = M s_b + e_b`` along each
  row from ``s_0 = 0``, giving every later block its entry history;
* pass C (:func:`final_walk`) walks every block again from its entry.

Lossy leading taps (the truncating division is not linear), a leading tap
of 0 mod 2**16 and more than :data:`BLOCKED_TAPS` history taps keep the
serial walk (:func:`plan`). The tests hold these passes against the JAX
package's ``_iir_decode`` and the plain inverse; nothing on the codec's
path calls them.
"""

from __future__ import annotations

import torch

from .rice import wrap16

BLOCKED_TAPS = 8    # history taps of the blocked path (registers on the card)
BLOCK = 256         # the shortest block: one tile of the kernel
# the blocked path takes the longest block (BLOCK * 2**k) that still cuts
# the rows into at least this many virtual rows, a thread each: about three
# warps an SM of an H100, enough to keep passes A and C at their memory
# rate while the serial carry (pass B) gets as few blocks a row as it can.
# Timed over blocks of 256-4096 at Nab (2048, 7000) and NOPTREX (64,
# 500000) and (32, 500000) (tools/iir_blocks.py), this choice was the
# fastest at each
VIRTUAL_ROWS = 12288
STATE = 8           # int16s of a block's carried history on the card


def c16(c: int) -> int:
    """Filter coefficient reduced mod 2**16 into the int16 range."""
    return ((int(c) & 0xFFFF) ^ 0x8000) - 0x8000


def fold(filt: tuple[int, ...]) -> tuple[int, tuple[int, ...]]:
    """The sign s = c16(filt[0]) and the history taps folded by it,
    ``s * c16(filt[j])`` for j >= 1; for a leading tap of +-1 only."""
    s = c16(filt[0])
    if s not in (1, -1):
        raise ValueError(f"the blocked scan needs a leading tap of +-1 mod "
                         f"2**16, got {filt[0]}")
    return s, tuple(s * c16(c) for c in filt[1:])


def blocked(filt: tuple[int, ...]) -> bool:
    """True where the blocked scan inverts ``filt``: a leading tap of +-1
    mod 2**16 and at most :data:`BLOCKED_TAPS` history taps."""
    return c16(filt[0]) in (1, -1) and len(filt) - 1 <= BLOCKED_TAPS


def nblocks(n: int, block: int) -> int:
    return max(1, -(-n // block))


def choose_block(rows: int, n: int) -> int:
    """The block length for ``rows`` rows of ``n`` samples: the longest
    ``BLOCK * 2**k`` that still leaves :data:`VIRTUAL_ROWS` virtual rows,
    and :data:`BLOCK` where no length does. A function of the shape alone,
    so the result never depends on the card (nor, being exact, on L)."""
    block = BLOCK
    while block < n and rows * nblocks(n, 2 * block) >= VIRTUAL_ROWS:
        block *= 2
    return block


def plan(filt: tuple[int, ...], rows: int, n: int,
         block: int | None = None) -> tuple[str, int, int]:
    """The path the card takes for ``rows`` rows of ``n`` samples: "serial"
    (one thread a row), "one_walk" (the blocked kernel's final walk alone:
    one block a row, or no history to carry) or "blocked" (passes A, B and
    C); with the block length and the blocks a row."""
    if not blocked(filt):
        return "serial", n, 1
    block = choose_block(rows, n) if block is None else int(block)
    if block < 8 or block % 8:
        raise ValueError(f"the block length must be a positive multiple of "
                         f"8, got {block}")
    nb = nblocks(n, block)
    path = "blocked" if nb > 1 and len(filt) > 1 else "one_walk"
    return path, block, nb


def block_transition(filt: tuple[int, ...], block: int) -> torch.Tensor:
    """M: the (T, T) int64 map, mod 2**16 in [0, 2**16), of a block's entry
    history to its exit history under zero input, both newest first
    (column k: the exit from the k-th unit history), found by walking the
    homogeneous recurrence ``block`` steps from the T unit histories at
    once."""
    _s, taps = fold(filt)
    t = len(taps)
    # Python integers: rows are history slots, columns the unit histories
    hist = [[int(j == k) for k in range(t)] for j in range(t)]
    for _ in range(block):
        new = [-sum(c * h[k] for c, h in zip(taps, hist)) & 0xFFFF
               for k in range(t)]
        hist = [new] + hist[:-1]
    return torch.tensor(hist, dtype=torch.int64).reshape(t, t)


def _walk(x: torch.Tensor, taps: tuple[int, ...],
          hist: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Walk the folded recurrence along the last axis of x (V, L) int64
    from the histories ``hist`` (V, T), newest first; returns the outputs
    (V, L) int64 in the int16 range and the exit histories."""
    out = torch.empty_like(x)
    if not taps:
        return wrap16(x), hist
    c = torch.tensor(taps, dtype=torch.int64, device=x.device)
    for i in range(x.shape[1]):
        o = wrap16(x[:, i] - (hist * c).sum(-1))
        out[:, i] = o
        hist = torch.cat([o[:, None], hist[:, :-1]], dim=1)
    return out, hist


def _rows(d: torch.Tensor) -> torch.Tensor:
    return d.to(torch.int64).reshape(-1, d.shape[-1])


def exit_states(d: torch.Tensor, filt: tuple[int, ...],
                block: int) -> torch.Tensor:
    """Pass A: the exit history of every full block but the last of each
    row, walked from a zero history: (rows, nb - 1, T) int64."""
    s, taps = fold(filt)
    x = _rows(d)
    rows, n = x.shape
    nb = nblocks(n, block)
    full = x[:, : (nb - 1) * block].reshape(rows * (nb - 1), block) * s
    zero = torch.zeros((full.shape[0], len(taps)), dtype=torch.int64,
                       device=x.device)
    _out, exits = _walk(full, taps, zero)
    return exits.reshape(rows, nb - 1, len(taps))


def carry_scan(exits: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Pass B: ``s_0 = 0``, ``s_{b+1} = M s_b + e_b`` mod 2**16 along each
    row; entry b of the result is s_{b+1}, the entry history of block b +
    1: (rows, nb - 1, T) int64 in [0, 2**16)."""
    m = trans.to(exits.device)
    entries = torch.empty_like(exits)
    s = torch.zeros_like(exits[:, 0])
    for b in range(exits.shape[1]):
        s = ((m[None] * s[:, None, :]).sum(-1) + exits[:, b]) & 0xFFFF
        entries[:, b] = s
    return entries


def final_walk(d: torch.Tensor, filt: tuple[int, ...], block: int,
               entries: torch.Tensor | None) -> torch.Tensor:
    """Pass C: every block walked from its entry history (zero for each
    row's first; ``entries`` from :func:`carry_scan`, None for one block a
    row or no history); int16 of ``d``'s shape."""
    s, taps = fold(filt)
    x = _rows(d)
    rows, n = x.shape
    nb = nblocks(n, block)
    padded = torch.zeros((rows, nb * block), dtype=torch.int64,
                         device=x.device)
    padded[:, :n] = x * s
    hist = torch.zeros((rows, nb, len(taps)), dtype=torch.int64,
                       device=x.device)
    if entries is not None:
        hist[:, 1:] = entries
    out, _h = _walk(padded.reshape(rows * nb, block), taps,
                    hist.reshape(rows * nb, len(taps)))
    return out.reshape(rows, nb * block)[:, :n].to(torch.int16).reshape(
        d.shape)


def blocked_decode(d: torch.Tensor, filt: tuple[int, ...],
                   block: int | None = None) -> torch.Tensor:
    """The generic inverse of a lossless filter of at most
    :data:`BLOCKED_TAPS` history taps by the three passes, as the card runs
    them (:func:`plan` chooses the block length when ``block`` is None);
    int16 of ``d``'s shape."""
    filt = tuple(int(c) for c in filt)
    if d.dim() == 0:
        raise ValueError("d needs a sample axis")
    n = d.shape[-1]
    path, block, _nb = plan(filt, d.numel() // max(n, 1), n, block)
    if path == "serial":
        raise ValueError(f"filter {filt} takes the serial walk")
    if d.numel() == 0:
        return torch.empty(d.shape, dtype=torch.int16, device=d.device)
    entries = None
    if path == "blocked":
        entries = carry_scan(exit_states(d, filt, block),
                             block_transition(filt, block))
    return final_walk(d, filt, block, entries)
