"""Per-stage time of one batch's encode and decode: the port's counterpart
of the JAX package's ``tools/profile_stages.py``, over the port's own
stages (the TPU's ``_placement``, ``_compaction`` and ``transpose2d`` have
no counterpart on the port's path).

Run from the repository root::

    python -m deltarice_tpu_torch.tools.profile_stages [nseg length M]
        [--iters I] [--reps R] [--device cuda|cpu]

(defaults 1024 7000 8, the Nab batch; ``1024 81920 16`` is the nEDM shape,
whose segments split into sub-blocks merged by B3.) The batch is a random
walk of rounded N(0, 10) steps from ``rng(0)``, as in the JAX tool, and is
one chunk of ``nseg`` segments. The JSON gives:

* ``host``: host milliseconds of ``_padded_rows``, ``_words_hint``,
  ``frame_stream``, ``walk_headers`` and ``gather_segments`` on this
  batch (median and range of ``reps`` calls);
* ``copies``: the samples in (``_on``: pinned staging and the copy to the
  card), the words and the decoded samples out (``_pinned_copy``);
* ``device``: the encode (B1, or for a split the sub-block encode and the
  merge, B3 or B5) and the decode (B2), each on data resident on the card,
  CUDA events around ``iters`` calls in ``reps`` windows; a stage under
  0.1 ms also in a CUDA graph (``graph_ms``);
* ``passes``: device milliseconds a call of each kernel (``bits_kernel``,
  ``scan_kernel``, ``emit_kernel`` of B1; ``tables_kernel``,
  ``compose_kernel``, ``resolve_kernel``, ``decode_kernel``,
  ``tail_kernel`` of B2; the merge's concentration and glue) and the
  device rows of one ``torch.profiler`` repeat of ``iters`` calls a stage.

On the CPU the host stages and the plain versions' host times are
measured; ``passes``, ``graph_ms`` and the copies are null.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..codec import (
    _merge_device,
    _merge_inputs,
    _on,
    _padded_rows,
    _pinned_copy,
    _split_layout,
    _split_parts,
    _words_hint,
    decode_segments,
    encode_segments,
    encode_segments_bits,
    frame_stream,
    gather_segments,
    walk_headers,
)
from ..config import RiceConfig
from ..utils.profiling import NoCard, card, profiled, timed

KERNELS = ("bits_kernel", "scan_kernel", "emit_kernel", "tables_kernel",
           "compose_kernel", "resolve_kernel", "decode_kernel", "tail_kernel",
           "concentrate_kernel", "wide_kernel", "wide16_kernel")
TOP_ROWS = 12  # device rows kept from each profiled stage


def make_data(nseg: int, length: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.cumsum(np.round(rng.normal(0, 10, (nseg, length))),
                     axis=-1).astype(np.int16)


def _host(fn, reps: int) -> dict:
    return timed(fn, iters=1, reps=reps, device="cpu")


def _passes(fn, iters: int) -> dict | None:
    """Device ms a call of each kernel of ``KERNELS`` over one
    ``torch.profiler`` repeat of ``iters`` calls of ``fn``, and its top
    device rows; None when every try's trace lost them."""
    rows, _wall = profiled(lambda: [fn() for _ in range(iters)])
    if not rows:
        return None
    per = {}
    for ms, _n, key in rows:
        for k in KERNELS:
            if k in key:
                per[k] = per.get(k, 0.0) + ms / iters
    return {"per_call_ms": per,
            "busy_ms_per_call": sum(ms for ms, _n, _k in rows) / iters,
            "rows": [{"ms": ms, "count": n, "name": key[:120]}
                     for ms, n, key in rows[:TOP_ROWS]]}


def run(nseg: int = 1024, length: int = 7000, m: int = 8, iters: int = 20,
        reps: int = 5, device="cuda") -> dict:
    name = card(device)
    cuda = name is not None
    cfg = RiceConfig(m, length)
    x = make_data(nseg, length)
    nb = x.nbytes
    total = x.size
    arrs = [x.ravel()]
    host = {"_padded_rows": _host(lambda: _padded_rows(arrs, total, cfg),
                                  reps)}
    x2, nv, _ = _padded_rows(arrs, total, cfg)
    host["_words_hint"] = _host(lambda: _words_hint(x2, cfg, length), reps)
    copies = {}
    if cuda:
        copies["samples_in"] = timed(lambda: _on(x2, device, torch.int16),
                                     nb, iters, reps, device, graph=False)
    parts = _split_parts(nseg, length, cfg)
    dev, passes = {}, {}
    if parts > 1:
        xs, nvs, p0, ls = _split_layout(x2, nv, parts)
        xd, nvd, p0d = (torch.from_numpy(a).to(device) for a in (xs, nvs, p0))
        mw = cfg.max_words(ls)
        enc = lambda: encode_segments_bits(xd, nvd, cfg, mw, prev0=p0d,
                                           device=device)
        wsub, _nw, nbits = enc()
        nb2 = nbits.cpu().numpy().astype(np.int64).reshape(nseg, parts)
        w3, nbt, out_w, nwords = _merge_inputs(wsub, nb2, parts)
        mrg = lambda: _merge_device(w3, nbt, out_w)
        dev["encode_sub_blocks"] = timed(enc, nb, iters, reps, device)
        dev["merge"] = timed(mrg, nb, iters, reps, device)
        if cuda:
            passes["encode_sub_blocks"] = _passes(enc, iters)
            passes["merge"] = _passes(mrg, iters)
        words = mrg()
    else:
        xd = torch.from_numpy(x2).to(device)
        nvd = torch.from_numpy(nv).to(device)
        cap = _words_hint(x2, cfg, length)
        enc = lambda: encode_segments(xd, nvd, cfg, cap, device)
        dev["encode"] = timed(enc, nb, iters, reps, device)
        if cuda:
            passes["encode"] = _passes(enc, iters)
        words, nwords = enc()
        nwords = nwords.cpu().numpy()
        if int(nwords.max()) > cap:
            raise RuntimeError("a row overflowed the hint's width; profile "
                               "a batch the hint covers")
    if cuda:
        copies["words_out"] = timed(lambda: _pinned_copy(words), None,
                                    iters, reps, device, graph=False)
    wn = words.cpu().numpy().view(np.uint32)
    host["frame_stream"] = _host(lambda: frame_stream(total, wn, nwords),
                                 reps)
    buf = np.frombuffer(frame_stream(total, wn, nwords), dtype="<u4")
    host["walk_headers"] = _host(lambda: walk_headers(buf, nseg), reps)
    counts, starts = walk_headers(buf, nseg)
    host["gather_segments"] = _host(
        lambda: gather_segments(buf, counts, starts), reps)
    wd = torch.from_numpy(gather_segments(buf, counts, starts)
                          .view(np.int32)).to(device)
    dec = lambda: decode_segments(wd, length, cfg, device)
    dev["decode"] = timed(dec, nb, iters, reps, device)
    if cuda:
        passes["decode"] = _passes(dec, iters)
    out = dec()
    if cuda:
        copies["samples_out"] = timed(lambda: _pinned_copy(out), nb, iters,
                                      reps, device, graph=False)
    if not np.array_equal(out.cpu().numpy(), x):
        raise RuntimeError("profile_stages: the round trip is not exact")
    return {"metric": "per-stage time of one batch's encode and decode",
            "batch": [nseg, length], "m": m, "MB": nb / 1e6,
            "split_parts": parts, "words_in": int(wd.shape[1]),
            "ratio": 4 * (1 + nseg + int(np.sum(nwords))) / nb,
            "iters": iters, "reps": reps, "host": host,
            "copies": copies or None, "device": dev,
            "passes": passes or None,
            "platform": "gpu" if cuda else "cpu", "card": name}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deltarice_tpu_torch.tools.profile_stages")
    p.add_argument("shape", nargs="*", type=int,
                   help="nseg length M (default 1024 7000 8)")
    p.add_argument("--iters", type=int, default=20,
                   help="calls a timing window and a profiled repeat")
    p.add_argument("--reps", type=int, default=5, help="timing windows")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    args = p.parse_args(argv)
    if args.shape and len(args.shape) != 3:
        p.error("give nseg, length and M, or none of them")
    nseg, length, m = args.shape or (1024, 7000, 8)
    try:
        rep = run(nseg, length, m, args.iters, args.reps, args.device)
    except NoCard as e:
        print(f"profile_stages: {e}", file=sys.stderr)
        return 2
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
