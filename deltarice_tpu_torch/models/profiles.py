"""Dataset profiles for the experiments published with the reference filter
(numpy only; the same profiles and generator as the JAX package's).

Numbers come from the reference's ``docs/Performance.md`` (sizes,
throughputs, waveform lengths) and its paper (detector descriptions). The
synthetic generators' noise scales are tuned so each
family's compressed-size ratio matches the published one: Nab lands at
~0.29 (published 0.29) and NOPTREX at ~0.25 (published 0.25). nEDM is the
exception — with M=16 every codeword is at least k+1 = 5 bits, so no
int16 input can compress below 5/16 = 31.25%; the published 27% is
unreachable at these cd_values and the generator sits just above that
floor (measured 0.317 at sigma=4.0, pulses included). Good for
benchmarking, not physics.
"""

from __future__ import annotations

import dataclasses
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..config import RiceConfig

#: exp(-x) is exactly 0.0 in float64 for every x >= this
_EXP_ZERO = 750.0


@dataclasses.dataclass(frozen=True)
class DatasetProfile:
    """One experiment family's waveform geometry + codec parameters."""

    name: str
    waveform_length: int
    rice_m: int
    #: published compressed size as a fraction of raw (docs/Performance.md)
    published_ratio: float
    #: rough per-sample noise scale driving the synthetic generator
    noise_sigma: float
    description: str

    @property
    def config(self) -> RiceConfig:
        return RiceConfig(self.rice_m, self.waveform_length)

    def synthetic(self, n_waveforms: int, seed: int = 0,
                  length: int | None = None) -> np.ndarray:
        """(n_waveforms, L) int16 synthetic waveforms for benchmarks.

        The same int16 waveforms as the JAX package's generator for the
        same seed: the random draws come in its order, and each pulse term
        ``amp * exp(-(t - t0) / tau)`` is added where it is not exactly
        zero — from ``t0`` on (the term is multiplied by ``t >= t0``) and
        until ``exp`` underflows to 0.0 — with the rows filled in a thread
        pool.
        """
        length = length or self.waveform_length
        rng = np.random.default_rng(seed)
        base = rng.normal(0.0, self.noise_sigma, (n_waveforms, length))
        np.round(base, out=base)
        np.cumsum(base, axis=-1, out=base)  # random-walk baseline
        # occasional detector pulses: exponential-decay bumps
        n_pulses = max(1, length // 2000)
        pulses = [
            [(int(rng.integers(0, length)), rng.uniform(200, 4000),
              rng.uniform(50, 400))
             for _ in range(rng.integers(0, n_pulses + 1))]
            for _ in range(n_waveforms)
        ]

        def add_pulses(i: int) -> None:
            for t0, amp, tau in pulses[i]:
                end = min(length, t0 + math.ceil(_EXP_ZERO * tau) + 1)
                base[i, t0:end] += amp * np.exp(-np.arange(end - t0) / tau)

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            list(ex.map(add_pulses, range(n_waveforms)))
        return np.clip(base, -32768, 32767).astype(np.int16)


PROFILES: dict[str, DatasetProfile] = {
    "nab": DatasetProfile(
        name="nab",
        waveform_length=7000,
        rice_m=8,
        published_ratio=0.29,
        noise_sigma=5.45,
        description=(
            "Nab neutron-decay Si-detector DAQ, 14-bit digitizers in "
            "int16; the codec's home experiment (docs/Performance.md:14-25)"
        ),
    ),
    "nedm": DatasetProfile(
        name="nedm",
        waveform_length=81920,
        rice_m=16,
        published_ratio=0.27,
        noise_sigma=4.0,
        description=(
            "nEDM@SNS light-collection test DAQ (docs/Performance.md:29-36)"
        ),
    ),
    "noptrex": DatasetProfile(
        name="noptrex",
        waveform_length=500000,
        rice_m=8,
        published_ratio=0.25,
        noise_sigma=0.7,
        description=(
            "NOPTREX resonance-spectroscopy long waveforms, 500k samples "
            "(docs/Performance.md:38-47)"
        ),
    ),
}


def get_profile(name: str) -> DatasetProfile:
    try:
        return PROFILES[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown profile {name!r}; available: {sorted(PROFILES)}"
        ) from None
