"""An in-memory direct-chunk store with the surface of an h5py group that
:mod:`deltarice_tpu_torch.h5` uses: ``create_dataset`` keeps the filter id
and its cd_values, and each dataset's ``id`` writes and reads raw chunk
streams by offset. It stands in for an HDF5 file where h5py is missing (the
card's machine) or where file I/O should stay out of a measurement."""

from __future__ import annotations

import numpy as np


class MemPlist:
    """The dataset creation property list's filter pipeline."""

    def __init__(self, filters):
        self._filters = filters

    def get_nfilters(self) -> int:
        return len(self._filters)

    def get_filter(self, i):
        return self._filters[i]


class MemDatasetID:
    """Direct-chunk I/O of one dataset: stored blobs by chunk offset."""

    def __init__(self, filters):
        self.chunks: dict[tuple, tuple[int, bytes]] = {}
        self._plist = MemPlist(filters)

    def write_direct_chunk(self, offset, data, filter_mask=0) -> None:
        self.chunks[tuple(offset)] = (filter_mask, bytes(data))

    def read_direct_chunk(self, offset):
        return self.chunks[tuple(offset)]

    def get_create_plist(self) -> MemPlist:
        return self._plist

    def get_storage_size(self) -> int:
        """Bytes of every stored chunk, as h5py's dataset id gives them."""
        return sum(len(blob) for _mask, blob in self.chunks.values())


class MemDataset:
    def __init__(self, name, shape, dtype, chunks, filters):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.chunks = tuple(chunks)
        self.id = MemDatasetID(filters)


class MemGroup:
    """An in-memory stand-in for an h5py group, with the direct-chunk
    surface the port's ``h5`` module uses: ``create_dataset`` keeps the
    filter id and the cd_values it is given."""

    def __init__(self):
        self.datasets: dict[str, MemDataset] = {}

    def create_dataset(self, name, shape, dtype, chunks, compression,
                       compression_opts, allow_unknown_filter=False):
        filters = [(compression, 0, tuple(compression_opts), b"deltarice")]
        dset = MemDataset(name, shape, dtype, chunks, filters)
        self.datasets[name] = dset
        return dset

    def __getitem__(self, name) -> MemDataset:
        return self.datasets[name]
