"""The port's measurement tools, each run as ``python -m
deltarice_tpu_torch.tools.<name>`` (``--device cpu`` for a run of the
kernels' plain versions; the default ``cuda`` needs a card):

* :mod:`.bench_geometries`: device codec throughput and compressed ratio of
  the seven configs of the JAX package's ``tools/bench_geometries.py``;
* :mod:`.bench_file`: HDF5 write and read throughput of the three published
  geometries, the port's direct-chunk path beside the native filter plugin;
* :mod:`.fuzz_native`: random configurations held byte for byte against the
  native C codec;
* :mod:`.profile_stages`: per-stage host and device time of one batch;
* :mod:`.singlechip_scaling`: the one-rank overhead of the chunk data
  parallelism, the device's busy share of an HDF5 write and read, and the
  card's copy rates;
* :mod:`.scaling_bench`: weak scaling of ``parallel.multihost`` over 1, 2
  and 4 ranks;
* :mod:`.iir_blocks`: the generic inverse's blocked scan timed over block
  lengths (no JAX counterpart);
* :mod:`.memstore`: the in-memory direct-chunk store the tools use where
  h5py is missing.

``python -m deltarice_tpu_torch.bench`` is the one-line benchmark. Each tool
prints JSON with the keys and config names of its JAX counterpart (less the
keys that only a TPU run has, listed in its ``DROPPED``) and the card it ran
on (``card``: null on the CPU).
"""
