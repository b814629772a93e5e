"""Import-time filter registration: ``import deltarice_tpu_torch.register``.

Registers filter 32025 into h5py's HDF5 as a side effect of the import,
the one-line experience of the reference's ``import deltaRice.h5``. After
it, plain h5py reads and writes of deltarice datasets go through the
standard HDF5 filter pipeline (served by the native C filter); ``H5FILTER``
is re-exported for ``compression=`` arguments.

A failed registration raises instead of passing silently: a script must
not fall through to writing uncompressed data. Use
:func:`deltarice_tpu_torch.h5.register_h5_filter` for a bool-returning
variant.
"""

from __future__ import annotations

from .config import H5FILTER
from .h5 import register_h5_filter

__all__ = ["H5FILTER"]

if not register_h5_filter():
    raise RuntimeError(
        "deltarice_tpu_torch: could not register HDF5 filter 32025 with "
        "h5py (h5py missing, native filter library not buildable, or no "
        "loadable libhdf5 found)"
    )
