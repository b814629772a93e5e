"""Runnable examples of the port: ``python -m
deltarice_tpu_torch.examples.<name> --help`` (``basic_roundtrip``,
``native_plugin``, ``sharded_encode``)."""
