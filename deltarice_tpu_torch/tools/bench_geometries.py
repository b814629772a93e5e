"""Device codec throughput and compressed ratio across the published
geometries and stress regimes: the port's counterpart of the JAX package's
``tools/bench_geometries.py``, with its seven ``CONFIGS`` and its data.

Run from the repository root::

    python -m deltarice_tpu_torch.tools.bench_geometries [--only nab,...]
        [--rows N] [--iters I] [--reps R] [--device cuda|cpu] [--out FILE]

Each config (``bench_config``) encodes and decodes one batch held on the
device, as the JAX tool does:

* short segments: :func:`..codec.encode_segments` (B1) at the host hint's
  width (``_words_hint``), rows past it re-encoded exactly;
* long segments (``_split_parts`` > 1): ``_split_layout`` ->
  ``encode_segments_bits`` with ``prev0`` (B1 on the sub-blocks) ->
  ``_merge_device`` (B3 or B5), the merge also timed alone (``merge_ms``);
* decode: :func:`..codec.decode_segments` (B2), or with
  ``DELTARICE_TPU_SPLIT_DECODE=1`` the split decode (B9 + B6) where its
  router splits, with ``decode_split_parts`` and ``decode_flagged`` (the
  segments it flagged, re-decoded exactly through B2).

Every round trip must be exact. ``ratio`` is 4 (1 + nseg + sum of word
counts) / raw bytes, the framed stream's size, rounded to 3 places as in
``GEOMETRY_BENCH.json``; ``compressed_bytes`` is that size. ``--rows N``
cuts the segments of each config (its row count) for small runs; the
length and the data's distribution stay.

Timing: CUDA events around ``iters`` calls after a warm-up, the median and
range of ``reps`` windows (``*_GBps`` the median, ``*_GBps_min`` /
``*_GBps_max`` the range).

Dropped from the JAX output (they exist only on the TPU): ``sync_cost_ms``
and ``decode_service_j`` (the port's B2 is exact at every rate).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..codec import (
    _decode_device_split,
    _merge_device,
    _merge_inputs,
    _redecode_bad_rows,
    _reencode_bad_rows,
    _split_decode_enabled,
    _split_layout,
    _split_parts,
    _words_hint,
    decode_segments,
    encode_segments,
    encode_segments_bits,
)
from ..config import RiceConfig
from ..ops.split_decode import decode_split_parts
from ..utils.profiling import NoCard, card, spread, windows

DROPPED = ("sync_cost_ms", "decode_service_j")
BUCKET = 256  # decode pads each row's words to a multiple of this

# name -> ((kind, rows, sigma) parts stacked by rows, M, L): the JAX tool's
# CONFIGS (tools/bench_geometries.py:219-248)
CONFIGS = {
    "nab": ((("walk", 1024, 10.0),), 8, 7000),
    "nedm": ((("walk", 1024, 4.0),), 16, 81920),
    "noptrex": ((("walk", 256, 8.0),), 8, 500000),
    "nab_m2": ((("walk", 1024, 10.0),), 2, 7000),
    "nab_m32": ((("walk", 1024, 10.0),), 32, 7000),
    "escape_uniform": ((("uniform", 1024, 0.0),), 8, 7000),
    "mixed_dense1pct": ((("uniform", 1014, 0.0), ("walk", 10, 10.0)), 8,
                        7000),
}


def make_data(kind: str, shape, sigma: float, seed=0) -> np.ndarray:
    """The JAX tool's generator (``tools/bench_geometries.py:210-217``)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":  # incompressible: every sample escapes
        return rng.integers(-32768, 32768, shape).astype(np.int16)
    return np.cumsum(
        np.round(rng.normal(0, sigma, shape)), axis=-1
    ).astype(np.int16)


def make_config(name: str, rows: int | None = None):
    """(samples (nseg, L) int16, RiceConfig) of a config; ``rows`` cuts its
    segments, each part keeping its share (at least one row)."""
    parts, m, length = CONFIGS[name]
    counts = [n for _k, n, _s in parts]
    if rows is not None:
        total = sum(counts)
        counts = [max(1, n * rows // total) for n in counts]
        counts[0] = max(1, rows - sum(counts[1:]))
    x = np.concatenate([make_data(kind, (n, length), sigma)
                        for (kind, _n, sigma), n in zip(parts, counts)])
    return x, RiceConfig(m, length)


def encode_config(x: np.ndarray, cfg: RiceConfig, iters: int, reps: int,
                  device) -> dict:
    """The encode half of :func:`bench_config`: {"words" (nseg, W) on the
    device, "nwords" (nseg,) host, "encode" timing, "parts", and for a
    split "merge" timing}."""
    nseg, length = x.shape
    nb = x.nbytes
    parts = _split_parts(nseg, length, cfg)
    out = {"parts": parts}
    if parts > 1:
        xs, nv, p0, ls = _split_layout(x, np.full(nseg, length, np.int32),
                                       parts)
        xd, nvd, p0d = (torch.from_numpy(a).to(device) for a in (xs, nv, p0))
        mw = cfg.max_words(ls)
        enc = lambda: encode_segments_bits(xd, nvd, cfg, mw, prev0=p0d,
                                           device=device)
        t_sub = windows(enc, iters=iters, reps=reps, device=device)
        wsub, _nw, nbits = enc()
        nb2 = nbits.cpu().numpy().astype(np.int64).reshape(nseg, parts)
        w3, nbt, out_w, nwords = _merge_inputs(wsub, nb2, parts)
        mrg = lambda: _merge_device(w3, nbt, out_w)
        t_mrg = windows(mrg, iters=iters, reps=reps, device=device)
        out["merge"] = spread(t_mrg)
        # encode = sub-block encode + merge, window by window
        out["encode"] = spread([a + b for a, b in zip(t_sub, t_mrg)], nb)
        out["words"], out["nwords"] = mrg(), nwords
        return out
    xd = torch.from_numpy(x).to(device)
    nvd = torch.full((nseg,), length, dtype=torch.int32, device=device)
    cap = _words_hint(x, cfg, length)
    enc = lambda: encode_segments(xd, nvd, cfg, cap, device)
    out["encode"] = spread(windows(enc, iters=iters, reps=reps,
                                   device=device), nb)
    words, nwords = enc()
    nw = nwords.cpu().numpy()
    over = nw > cap
    if over.any():  # rows past the hint's width: exact re-encode
        wmax = int(nw.max()) + 1
        wn = words[:, : min(wmax, cap)].cpu().numpy().view(np.uint32)
        if wmax > cap:
            wn = np.pad(wn, ((0, 0), (0, wmax - cap)))
        wn = _reencode_bad_rows(wn, x, np.full(nseg, length, np.int32),
                                over, cfg, cfg.max_words(length), device)
        words = torch.from_numpy(wn.view(np.int32)).to(device)
    out["words"], out["nwords"] = words, nw
    return out


def compressed_bytes(nwords: np.ndarray) -> int:
    """Size of the framed stream of one chunk holding every segment."""
    return 4 * (1 + nwords.size + int(np.asarray(nwords).sum()))


def bench_config(name: str, x: np.ndarray, cfg: RiceConfig, iters: int,
                 reps: int, device="cuda") -> dict:
    """Encode, decode and check one config's batch; returns its row."""
    nseg, length = x.shape
    nb = x.nbytes
    enc = encode_config(x, cfg, iters, reps, device)
    counts = np.asarray(enc["nwords"], dtype=np.int64)
    w = -(-(int(counts.max()) + 1) // BUCKET) * BUCKET
    words = enc["words"][:, :w]
    if words.shape[1] < w:  # the hint's width may be short of the bucket
        words = torch.nn.functional.pad(words, (0, w - words.shape[1]))
    wd = words.contiguous()
    nvalid = np.full(nseg, length, np.int32)
    sparts = 1
    if _split_decode_enabled():
        sparts = decode_split_parts(nseg, int(counts.max()), cfg.k)
    if sparts > 1:
        dec = lambda: _decode_device_split(wd, counts, length, cfg, sparts,
                                           nvalid)
        out_d, bad = dec()
        bad = bad.cpu().numpy()
        out = _redecode_bad_rows(out_d.cpu().numpy(), bad,
                                 wd.cpu().numpy().view(np.uint32), length,
                                 cfg, device)
    else:
        dec = lambda: decode_segments(wd, length, cfg, device)
        out = dec().cpu().numpy()
    t_dec = spread(windows(dec, iters=iters, reps=reps, device=device), nb)
    if not np.array_equal(out, x):
        raise RuntimeError(f"{name}: the round trip is not exact")
    size = compressed_bytes(counts)
    row = {
        "config": name,
        "shape": [nseg, length],
        "m": cfg.m,
        "encode_GBps": enc["encode"]["GBps"],
        "decode_GBps": t_dec["GBps"],
        "ratio": round(size / nb, 3),
        "compressed_bytes": size,
        "encode_GBps_min": enc["encode"]["GBps_min"],
        "encode_GBps_max": enc["encode"]["GBps_max"],
        "decode_GBps_min": t_dec["GBps_min"],
        "decode_GBps_max": t_dec["GBps_max"],
        "split_decode": _split_decode_enabled(),
    }
    if enc["parts"] > 1:
        row["split_parts"] = enc["parts"]
        row["merge_ms"] = enc["merge"]["ms"]
        row["merge_ms_min"] = enc["merge"]["ms_min"]
        row["merge_ms_max"] = enc["merge"]["ms_max"]
    if sparts > 1:
        row["decode_split_parts"] = sparts
        row["decode_flagged"] = int(bad.sum())
    return row


def iters_for(nbytes: int, iters: int) -> int:
    """Calls a window: at most ``iters``, fewer for larger batches (the JAX
    tool's rule, down to 3 calls)."""
    return min(iters, max(3, int(3e8 / nbytes) + 3))


def report(rows: list[dict], name: str | None, iters: int,
           reps: int) -> dict:
    return {
        "metric": "device codec throughput across published geometries",
        "platform": "gpu" if name else "cpu",
        "method": f"CUDA events around up to {iters} calls after a "
                  f"warm-up (fewer for larger batches), median and range "
                  f"of {reps} windows (host clock on the CPU)",
        "rows": rows,
        "card": name,
    }


def run(only=None, rows: int | None = None, iters: int = 20, reps: int = 5,
        device="cuda") -> dict:
    """Every config of ``only`` (default all), one at a time; the split
    switch is read from the environment, as in the JAX tool."""
    name = card(device)
    out = []
    for config in only or CONFIGS:
        x, cfg = make_config(config, rows)
        out.append(bench_config(config, x, cfg, iters_for(x.nbytes, iters),
                                reps, device))
        del x
    return report(out, name, iters, reps)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deltarice_tpu_torch.tools.bench_geometries")
    p.add_argument("--only", default=None,
                   help="comma-separated configs (default all)")
    p.add_argument("--rows", type=int, default=None,
                   help="segments of each config (default its own)")
    p.add_argument("--iters", type=int, default=20,
                   help="calls a timing window, at most")
    p.add_argument("--reps", type=int, default=5, help="timing windows")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    only = args.only.split(",") if args.only else None
    try:
        rep = run(only, args.rows, args.iters, args.reps, args.device)
    except NoCard as e:
        print(f"bench_geometries: {e}", file=sys.stderr)
        return 2
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
