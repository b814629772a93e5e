"""Multi-device / multi-process parallelism for the Delta-Rice codec.

The counterpart of ``deltarice_tpu.parallel``: chunks shard over a 1-D
``"chunks"`` mesh of ``torch.distributed`` ranks, one rank per device (NCCL
between cards, gloo on the host), and each rank runs the single-device
codec on its own chunks. Within a rank, the segments of a chunk are the
parallel axis of the CUDA kernels. :mod:`.multihost` gathers framed streams
and decoded samples to rank 0.
"""

from .sharded import (
    chunk_mesh,
    encode_chunks_sharded,
    decode_chunks_sharded,
    roundtrip_check_step,
)

__all__ = [
    "chunk_mesh",
    "encode_chunks_sharded",
    "decode_chunks_sharded",
    "roundtrip_check_step",
]
