"""Device ops of the port: plain torch versions (``rice``, ``prefilter``,
``pack_ref``) and the CUDA kernels' wrappers (``*_cuda``), each of which
launches its kernel on a CUDA tensor and takes its plain version on a CPU
tensor."""
