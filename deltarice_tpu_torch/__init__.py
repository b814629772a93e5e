"""deltarice_tpu_torch: the Delta-Rice codec (HDF5 filter 32025) on PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``deltarice_tpu`` (JAX / Pallas on a TPU), which stays the
reference: the same streams byte for byte, the same config schema. It
imports torch, numpy and ctypes only. Every entry point takes ``device``
(default ``"cuda"``); ``device="cpu"`` runs the kernels' plain torch
versions. The CUDA kernels build with ``nvcc`` at their first launch.
HDF5 files are written and read through :mod:`.h5` (direct-chunk I/O, no
h5py import at package import), and ``python -m deltarice_tpu_torch`` is
the command line (:mod:`.cli`).
"""

from .config import H5FILTER, RiceConfig, rice_k
from .utils.warmup import warmup
from .codec import (
    compress,
    compress_batch,
    decode_segments,
    decompress,
    decompress_batch,
    encode_segments,
)

__version__ = "0.1.0"

__all__ = [
    "H5FILTER",
    "RiceConfig",
    "rice_k",
    "compress",
    "compress_batch",
    "decompress",
    "decompress_batch",
    "encode_segments",
    "decode_segments",
    "warmup",
]
