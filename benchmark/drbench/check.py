"""The comparison that decides ``correct``: what the timed calls returned,
for a sample of them drawn from the seed, against the plain reference on
the same resident inputs. Run once the window has closed.

* encode: each row's count, and its delivered stream's words below the
  reference's count (from the words up to the cap, or where the count
  passed the cap from its full-width encode), against the reference with
  the configuration's pre-filter: ``rows_wrong``, limit 0. Words past a row's count are no part of its
  stream and are not compared.
* decode: every decoded sample against the samples that the reference
  encoder coded (the stream's exact inverse): ``samples_wrong``, limit 0.
"""

from __future__ import annotations

import torch

from . import reference

LIMITS = {"rows_wrong": 0, "samples_wrong": 0}


def encode_rows_wrong(out: tuple, ref_words: torch.Tensor,
                      ref_counts: torch.Tensor) -> int:
    """Rows of one call's output that differ from the reference.

    ``out``: (words (rows, cap), counts (rows,)) and, where rows passed
    the cap, (their indices, their full-width words, their counts)."""
    words, counts = out[0], out[1]
    ok = ((counts.to(torch.int64) == ref_counts)
          & _streams_equal(words, ref_words, ref_counts))
    if len(out) > 2:
        idx, again, again_counts = out[2:5]
        ok[idx] = ((again_counts.to(torch.int64) == ref_counts[idx])
                   & _streams_equal(again, ref_words[idx], ref_counts[idx]))
    return int((~ok).sum())


def _streams_equal(words: torch.Tensor, ref_words: torch.Tensor,
                   ref_counts: torch.Tensor) -> torch.Tensor:
    """Per row: every word below the reference's count equal, and the row
    wide enough to hold them."""
    width = min(words.shape[1], ref_words.shape[1])
    inside = (torch.arange(width, device=words.device)[None, :]
              < ref_counts[:, None])
    same = ((words[:, :width] == ref_words[:, :width]) | ~inside).all(dim=1)
    return same & (ref_counts <= width)


def decode_samples_wrong(out: torch.Tensor, x: torch.Tensor) -> int:
    return int((out != x).sum())


def run(work, kept: list) -> dict:
    """Readings of the comparison over the kept calls: the compared
    numbers, the calls compared and those with any difference, and the
    reference's word counts of every buffer (for the roofline's bytes)."""
    counts = {}
    wrong, bad_calls = 0, 0
    by_buffer: dict[int, list] = {}
    for b, out in kept:
        by_buffer.setdefault(b, []).append(out)
    for b, xb in enumerate(work.x):
        if work.op == "decode":
            counts[b] = work.ref_counts[b]
            for out in by_buffer.get(b, []):
                n = decode_samples_wrong(out[0], xb)
                wrong += n
                bad_calls += n > 0
            continue
        outs = by_buffer.get(b, [])
        if not outs:
            counts[b] = reference.counts_blocks(xb, work.nvalid, work.m,
                                                work.filt)
            continue
        ref_words, counts[b] = reference.encode_blocks(
            xb, work.nvalid, work.m, work.full, work.filt)
        for out in outs:
            n = encode_rows_wrong(out, ref_words, counts[b])
            wrong += n
            bad_calls += n > 0
        del ref_words
    name = "rows_wrong" if work.op == "encode" else "samples_wrong"
    return {"compared": {name: wrong}, "calls_checked": len(kept),
            "calls_wrong": bad_calls, "stream_words": counts}
