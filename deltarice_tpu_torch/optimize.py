"""Rice-parameter and pre-filter optimization, on torch tensors.

The reference documents (but does not ship) an optimal-filter routine:
minimise the expected encoded bits per sample
``B(m, c) = sum_i P(x_i) * b(x_i, m, c)`` estimated from sample data, by
sweeping the Rice parameter M over powers of two and hill-climbing over
integer filter taps, examining every neighbour within +/-span per tap,
memoising evaluated filters, rejecting trailing-zero taps and stopping when
no neighbour improves. The JAX package (``deltarice_tpu/optimize.py``)
evaluates it as XLA programs with no Pallas kernel; here it is plain torch
ops on ``device``.

A codeword's length depends only on the zigzag value u (in [0, 65535]) and
k, so the cost of one filtered dataset at all 16 values of k is a 65536-bin
histogram of u times a (16, 65536) table of lengths: one pass over the
samples per candidate filter, never a (candidates, 16, S, L) tensor. Sums
are exact integers; means are float64.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .config import ESCAPE_LEN, ESCAPE_Q, RiceConfig
from .ops.prefilter import _shift_right, c16, prefilter_encode
from .ops.rice import wrap16, zigzag

_KS = 16  # candidate k values: 0..15 (M = 1..32768)


def codeword_bits(u: torch.Tensor, k) -> torch.Tensor:
    """Exact per-sample codeword length in bits for zigzag values u."""
    q = u.to(torch.int64) >> k
    return torch.where(q >= ESCAPE_Q, ESCAPE_LEN, q + 1 + k)


def _length_table(device) -> torch.Tensor:
    """(16, 65536) int64: codeword length of every zigzag value at each k."""
    u = torch.arange(1 << 16, dtype=torch.int64, device=device)
    ks = torch.arange(_KS, dtype=torch.int64, device=device)[:, None]
    return codeword_bits(u[None, :], ks)


def _bits_all_k(d: torch.Tensor) -> torch.Tensor:
    """Mean bits/sample of filtered int16 data d for every k in [0, 16):
    (16,) float64."""
    hist = torch.bincount(zigzag(d).reshape(-1), minlength=1 << 16)
    total = (_length_table(d.device) * hist[None, :]).sum(dim=1)
    return total.to(torch.float64) / max(d.numel(), 1)


def _as_samples(data, device) -> torch.Tensor:
    x = data if isinstance(data, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(data, dtype=np.int16))
    return x.to(device=device, dtype=torch.int16)


def expected_bits(data, m: int, filt=(1, -1), device="cuda") -> float:
    """Expected encoded bits/sample for the given config on sample data."""
    d = prefilter_encode(_as_samples(data, device),
                         tuple(int(c) for c in filt))
    return float(_bits_all_k(d)[RiceConfig(m).k])


def optimal_m(data, filt=(1, -1), device="cuda") -> int:
    """Best power-of-two Rice parameter for the data under ``filt``."""
    d = prefilter_encode(_as_samples(data, device),
                         tuple(int(c) for c in filt))
    return 1 << int(np.argmin(_bits_all_k(d).cpu().numpy()))


def _batch_filter_bits(x: torch.Tensor, filts: torch.Tensor,
                       n_taps: int) -> torch.Tensor:
    """Mean bits/sample for every (candidate filter, k) pair.

    x: (S, L) int16 sample waveforms on the device.
    filts: (C, n_taps) int64, coefficients already wrapped mod 2**16.
    Returns (C, 16) float64.
    """
    xs = [_shift_right(x, j).to(torch.int64) for j in range(n_taps)]
    table = _length_table(x.device)
    taps = filts.tolist()
    out = torch.empty((len(taps), _KS), dtype=torch.float64, device=x.device)
    for c, f in enumerate(taps):
        acc = xs[0] * f[0]
        for j in range(1, n_taps):
            acc = acc + xs[j] * f[j]
        # the reference accumulates each tap in a C short: the sum wraps
        # mod 2**16 once (a ring homomorphism)
        u = zigzag(wrap16(acc)).reshape(-1)
        hist = torch.bincount(u, minlength=1 << 16)
        out[c] = (table * hist[None, :]).sum(dim=1).to(torch.float64)
    return out / max(x.numel(), 1)


def _filter_costs(x: torch.Tensor,
                  cands: list[tuple[int, ...]]) -> list[tuple[int, float]]:
    """(best k, bits at best k) for each candidate filter."""
    filts = torch.tensor([[c16(c) for c in f] for f in cands],
                         dtype=torch.int64)
    bits = _batch_filter_bits(x, filts, len(cands[0])).cpu().numpy()
    ks = bits.argmin(axis=1)
    return [(int(k), float(b[k])) for k, b in zip(ks, bits)]


def _neighbors(filt: tuple[int, ...], span: int):
    """All filters within +/-span per tap, excluding trailing zeros and
    a zero leading coefficient (the inverse divides by filt[0])."""
    deltas = range(-span, span + 1)
    for offs in itertools.product(deltas, repeat=len(filt)):
        cand = tuple(c + o for c, o in zip(filt, offs))
        if cand == filt or cand[0] == 0 or (len(cand) > 1 and cand[-1] == 0):
            continue
        yield cand


def optimize(data, n_taps: int = 2, span: int = 1, start=None,
             max_rounds: int = 64, device="cuda") -> RiceConfig:
    """Greedy hill-climb over integer filter taps plus an exact M sweep.

    Returns the best :class:`RiceConfig` found (waveform_length left at the
    default; set it from your chunking). Only lossless configs
    (|filt[0]| == 1) are returned.
    """
    x = _as_samples(data, device)
    if x.dim() == 1:
        x = x[None, :]
    cur = tuple(start) if start else ((1, -1) + (0,) * (n_taps - 2))[:n_taps]
    if len(cur) != n_taps:
        cur = (cur + (0,) * n_taps)[:n_taps]
    if cur[-1] == 0 and n_taps > 1:
        cur = cur[:-1] + (-1,)
    memo: dict[tuple[int, ...], tuple[int, float]] = {}

    def costs(fs: list[tuple[int, ...]]) -> None:
        fresh = [f for f in fs if f not in memo]
        if fresh:
            memo.update(zip(fresh, _filter_costs(x, fresh)))

    costs([cur])
    best_k, best_bits = memo[cur]
    for _ in range(max_rounds):
        # lossless reconstruction requires |filt[0]| == 1
        cands = [c for c in _neighbors(cur, span) if abs(c[0]) == 1]
        costs(cands)
        improved = False
        for cand in cands:
            k, bits = memo[cand]
            if bits < best_bits:
                cur, best_k, best_bits, improved = cand, k, bits, True
        if not improved:
            break
    return RiceConfig(m=1 << best_k, filt=cur)
