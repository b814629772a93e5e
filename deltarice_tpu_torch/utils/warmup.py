"""Cold-start control: build the kernels and run the codec once.

The reference C filter has no warm-up. Here the first call of a process
builds the CUDA kernels with ``nvcc`` (seconds; cached in
``deltarice_tpu_torch/build/`` for later processes) and the native C
library, and pays CUDA's context and pinned-memory set-up. Run
``deltarice_tpu_torch.warmup(...)`` (or ``deltarice-tpu-torch warmup``)
once at deploy time, e.g. from the install pipeline, so production traffic
finds them ready.

Like the JAX package's warm-up it encodes representative data
(caller-provided, or the Nab profile's generator) and decodes what it
produced, then decodes the same streams at the neighbouring 256-word
buckets, the widths that production data whose ratio wobbles around the
sample's would take.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import RiceConfig


def warmup(data=None, cfg: RiceConfig | None = None, nseg: int = 1024,
           extra_buckets: int = 1, verbose: bool = False,
           device="cuda") -> float:
    """Build the kernels and round-trip one production geometry on
    ``device``; returns elapsed seconds.

    Args:
      data: representative (num_segments, L) int16 array. Default: the
        Nab profile's synthetic generator at (nseg, cfg length).
      cfg: codec parameters; default Nab (M=8, L=7000).
      nseg: segments per batch when synthesizing data.
      extra_buckets: also decode at this many 256-word buckets above the
        sample's.
      device: ``"cuda"`` builds the CUDA kernels first; without a card it
        raises.
    """
    from .. import codec, native
    from ..ops import _kernels

    if cfg is None:
        cfg = RiceConfig(8, 7000)
    if data is None:
        from ..models.profiles import get_profile

        nseg_, length, _ = cfg.segments(
            nseg * (cfg.waveform_length if cfg.waveform_length > 0 else 7000)
        )
        data = get_profile("nab").synthetic(nseg_, length=length)
    data = np.ascontiguousarray(data, dtype=np.int16)
    t0 = time.perf_counter()
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("warmup on a CUDA device needs a CUDA card")
        _kernels.library()
    native.codec_lib()
    blob = codec.compress(data, cfg, device)
    out = codec.decompress(blob, cfg, device)
    if not np.array_equal(out.reshape(data.shape), data):
        raise RuntimeError("warmup round trip returned other samples")
    buf = np.frombuffer(blob, dtype="<u4")
    nseg_, length, _ = cfg.segments(data.size)
    counts, starts = codec.walk_headers(buf, nseg_)
    base = -(-(int(counts.max(initial=0)) + 1) // codec._WORD_BUCKET)
    for b in range(1, max(extra_buckets, 0) + 1):
        bucket = (base + b) * codec._WORD_BUCKET
        words = codec.gather_segments(buf, counts, starts, bucket)
        codec.decode_segments(words, length, cfg, device, counts=counts,
                              nvalid=np.full(nseg_, length, np.int32))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if verbose:
        print(f"deltarice_tpu_torch warmup: {data.shape} M={cfg.m} on "
              f"{device} in {dt:.1f}s")
    return dt
