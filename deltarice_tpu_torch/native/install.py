"""Install the filter plugin into an HDF5 plugin directory.

After installation any HDF5 >= 1.8.11 application (C, Fortran, h5py
without this package) loads filter 32025 through HDF5's dynamic-plugin
mechanism, with no registration code: HDF5 scans the directory and calls the
library's ``H5PLget_plugin_type`` / ``H5PLget_plugin_info`` entry points
(``deltarice_tpu_torch/native/src/h5z_deltarice.c``).

Usage::

    deltarice-tpu-torch install-plugin [--plugin-dir DIR]

The directory defaults to the first entry of ``$HDF5_PLUGIN_PATH`` when
set, else HDF5's built-in default search path (``/usr/local/hdf5/lib/
plugin`` on Unix, ``%ALLUSERSPROFILE%\\hdf5\\lib\\plugin`` on Windows).
"""

from __future__ import annotations

import os
import shutil
import sys
from pathlib import Path


def default_plugin_dir() -> Path:
    env = os.environ.get("HDF5_PLUGIN_PATH")
    if env:
        first = env.split(os.pathsep)[0]
        if first:
            return Path(first)
    if sys.platform == "win32":
        base = os.environ.get("ALLUSERSPROFILE", "C:\\ProgramData")
        return Path(base) / "hdf5" / "lib" / "plugin"
    return Path("/usr/local/hdf5/lib/plugin")


def install_plugin(plugin_dir: "str | Path | None" = None,
                   verbose: bool = False) -> Path:
    """Build the plugin if needed (:func:`..ensure_built`) and copy it into
    ``plugin_dir``.

    Returns the installed library's path. Raises on a failed build or copy
    (e.g. an unwritable system directory: pass a writable ``plugin_dir`` and
    point ``HDF5_PLUGIN_PATH`` at it).
    """
    from . import ensure_built

    src = ensure_built(verbose)
    dest_dir = Path(plugin_dir) if plugin_dir else default_plugin_dir()
    dest_dir.mkdir(parents=True, exist_ok=True)
    dest = dest_dir / src.name
    shutil.copy2(src, dest)
    if verbose:
        sys.stderr.write(f"installed {dest}\n")
    return dest
