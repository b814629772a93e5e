"""Randomized differential fuzzing of the port against its native C codec:
the port's counterpart of the JAX package's ``tools/fuzz_oracle.py``,
whose oracle (the reference C sources) the repository does not hold.

Run from the repository root::

    python -m deltarice_tpu_torch.tools.fuzz_native [cases] [seed]
        [--device cuda|cpu]

``random_case`` draws exactly what ``tools/fuzz_oracle.py:27-48`` draws for
the same generator: the data distribution, the sample count (63 to 100,000;
the two long counts drive the split encode and its merge), M (1 to 2^15),
the segment length (``-1``: one segment a chunk) and the pre-filter. Each
case is held three ways, with the split decode switch
(``DELTARICE_TPU_SPLIT_DECODE``) off and then on:

* the port's ``compress`` equals native ``dr_compress`` byte for byte, for
  every M (the port's C, unlike the reference's, has no M=1 quirk);
* native ``dr_decompress`` of the port's stream gives the input back;
* the port's decode of the native stream gives the input back (where the
  filter is lossless; otherwise what native ``dr_decompress`` gives).
  With the switch on the stream decodes as enough copies in one
  ``decompress_batch`` to reach ``SPLIT_ROWS`` segments, the least batch
  the split decode's router splits, so B9 and B6 run where a case's
  streams are long enough; every copy must decode the same. A stream a
  decoder rejects counts as a failure.

``main`` prints one line a failure and the JSON summary last, and exits 1
on any failure.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

from ..codec import compress, decompress_batch
from ..config import RiceConfig
from ..native import native_compress, native_decompress
from ..utils.profiling import NoCard, card

SPLIT_ENV = "DELTARICE_TPU_SPLIT_DECODE"
SPLIT_ROWS = 1024  # segments in a batch below which the split never runs
LENGTHS = [64, 200, 1024]
FILTERS = [(1, -1), (1,), (1, -2, 1), (-1, 1), (1, -1, 0, 1)]


def random_case(rng):
    """(int16 samples, RiceConfig): the draws of ``fuzz_oracle.random_case``
    in the same order."""
    n = int(rng.choice([63, 64, 200, 377, 1024, 2048, 4096, 40000, 100000]))
    dist = rng.integers(0, 4)
    if dist == 0:
        data = np.round(
            np.cumsum(rng.normal(0, rng.uniform(1, 50), n))
        )
    elif dist == 1:
        data = rng.integers(-32768, 32768, n)
    elif dist == 2:
        data = np.full(n, int(rng.integers(-32768, 32768)))
    else:
        data = rng.integers(-3, 4, n) * (
            rng.random(n) < 0.1
        ) + np.round(rng.normal(0, 2, n))
    data = np.clip(data, -32768, 32767).astype(np.int16)
    m = 1 << int(rng.integers(0, 16))
    length = int(rng.choice(LENGTHS + [-1]))
    filt = FILTERS[int(rng.integers(0, len(FILTERS)))]
    return data, RiceConfig(m, length, filt)


@contextlib.contextmanager
def split_switch(on: bool):
    saved = os.environ.get(SPLIT_ENV)
    os.environ[SPLIT_ENV] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            del os.environ[SPLIT_ENV]
        else:
            os.environ[SPLIT_ENV] = saved


def _reads(decode, want) -> bool:
    """True when ``decode()`` gives every array of ``want``; a stream the
    decoder rejects reads as False."""
    try:
        return all(np.array_equal(b, w) for b, w in zip(decode(), want,
                                                         strict=True))
    except ValueError:
        return False


def check_case(data: np.ndarray, cfg: RiceConfig, split: bool,
               device) -> dict:
    """The three checks of one case: {"bytes", "native_reads_port",
    "port_reads_native"}, each True when it held."""
    cd = cfg.to_cd_values()
    with split_switch(split):
        ours = compress(data, cfg, device)
        ref = native_compress(data, cd)
        want = data if cfg.lossless else native_decompress(ref, cd)
        copies = 1
        if split:
            nseg = cfg.segments(data.size)[0]
            copies = max(1, -(-SPLIT_ROWS // max(nseg, 1)))
        port_reads = _reads(
            lambda: decompress_batch([ref] * copies, cfg, device),
            [want] * copies)
    return {"bytes": ours == ref,
            "native_reads_port": _reads(
                lambda: [native_decompress(ours, cd)], [data]),
            "port_reads_native": port_reads}


def run(cases: int = 60, seed: int = 0, device="cuda", log=None) -> dict:
    """Draw and check ``cases`` cases from ``seed``; each failure is also
    written to ``log`` (a callable taking a line) when given."""
    name = card(device)
    rng = np.random.default_rng(seed)
    failures, seconds = [], []
    for i in range(cases):
        data, cfg = random_case(rng)
        for split in (False, True):
            t0 = time.perf_counter()
            res = check_case(data, cfg, split, device)
            seconds.append((time.perf_counter() - t0, i, split))
            if not all(res.values()):
                what = (f"case {i} split {'on' if split else 'off'}: "
                        f"n={data.size} M={cfg.m} L={cfg.waveform_length} "
                        f"filter={list(cfg.filt)} {res}")
                failures.append(what)
                if log is not None:
                    log(f"FAIL {what}")
    return {"metric": "differential fuzz of the port against native "
                      "dr_compress / dr_decompress",
            "cases": cases, "seed": seed, "checks_per_case": 6,
            "failures": len(failures), "failed": failures,
            "seconds": sum(t for t, _i, _s in seconds),
            "slowest": [{"case": i, "split": s, "seconds": t}
                        for t, i, s in sorted(seconds, reverse=True)[:5]],
            "platform": "gpu" if name else "cpu", "card": name}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deltarice_tpu_torch.tools.fuzz_native")
    p.add_argument("cases", nargs="?", type=int, default=60)
    p.add_argument("seed", nargs="?", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    args = p.parse_args(argv)
    try:
        rep = run(args.cases, args.seed, args.device, log=print)
    except NoCard as e:
        print(f"fuzz_native: {e}", file=sys.stderr)
        return 2
    print(json.dumps(rep))
    return 1 if rep["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
