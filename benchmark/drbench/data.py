"""Synthetic detector waveforms, made on the device from a seed.

A torch copy of the port's profile generator
(``deltarice_tpu_torch/models/profiles.py::synthetic``): a random walk of
rounded normal steps at the profile's ``noise_sigma``, with exponential
pulses ``amp * exp(-(t - t0) / tau)`` (``amp`` uniform in [200, 4000),
``tau`` in [50, 400), 0 to ``max(1, L // 2000)`` a row). It does not
repeat numpy's draws; it keeps each profile's compressed ratio, and gives
each count of pulses to an equal share of the rows. Every step
is integer or elementwise, so one seed gives the same samples on every
run: each pulse is rounded on its own and added with integer atomics,
whose order does not change the sum.
"""

from __future__ import annotations

import torch

#: a pulse's rounded term is 0 from ``tau * ln(2 * amp) < 3596`` samples on
PULSE_SPAN = 4096
#: samples a generator call holds at once (float32 and int32 planes)
BLOCK = 1 << 25


def synthetic(rows: int, length: int, sigma: float, seed: int,
              device) -> torch.Tensor:
    """(rows, length) int16 waveforms for ``seed``, made on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    walk = torch.empty(rows, length, dtype=torch.int32, device=device)
    step = max(1, BLOCK // length)
    for r in range(0, rows, step):
        n = min(step, rows - r)
        d = torch.randn(n, length, generator=g, device=device)
        torch.cumsum(torch.round(d * sigma).to(torch.int32), dim=1,
                     dtype=torch.int32, out=walk[r:r + n])
    _add_pulses(walk, g)
    return walk.clamp_(-32768, 32767).to(torch.int16)


def _add_pulses(walk: torch.Tensor, g: torch.Generator) -> None:
    rows, length = walk.shape
    dev = walk.device
    most = max(1, length // 2000)
    # 0..most pulses a row, in equal shares over the rows, in an order
    # drawn from the seed: every seed makes a batch of the same work
    share = torch.arange(rows, device=dev) * (most + 1) // rows
    count = share[torch.randperm(rows, generator=g, device=dev)][:, None]
    t0 = torch.randint(0, length, (rows, most), generator=g, device=dev)
    amp = torch.rand(rows, most, generator=g, device=dev) * 3800.0 + 200.0
    tau = torch.rand(rows, most, generator=g, device=dev) * 350.0 + 50.0
    live = torch.arange(most, device=dev)[None, :] < count
    row = torch.arange(rows, device=dev)[:, None].expand(rows, most)[live]
    t0, amp, tau = t0[live], amp[live], tau[live]
    flat = walk.view(-1)
    span = torch.arange(PULSE_SPAN, device=dev)
    step = max(1, BLOCK // PULSE_SPAN)
    for p in range(0, row.shape[0], step):
        sl = slice(p, p + step)
        t = t0[sl, None] + span[None, :]
        term = torch.round(amp[sl, None] * torch.exp(-span[None, :] / tau[sl, None]))
        inside = t < length
        idx = (row[sl, None] * length + t)[inside]
        flat.index_add_(0, idx, term.to(torch.int32)[inside])


def ratio(nwords: torch.Tensor, rows: int, length: int) -> float:
    """Framed bytes (a count word and the words of each stream, the chunk's
    total word) over the raw int16 bytes: the published compressed size."""
    return (4.0 * (float(nwords.sum()) + rows) + 4.0) / (2.0 * rows * length)

