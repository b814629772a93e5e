"""Test machinery of the port that runs on the card: :mod:`.guard`, the
guard-page allocator that holds every kernel's global-memory accesses to
the buffers its wrapper hands it (``guard_alloc.cu``). Nothing here is on
a codec path."""
