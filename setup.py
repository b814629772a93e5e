"""Build hook: compile the native HDF5 filter into the wheel.

All project metadata lives in pyproject.toml; this file exists only so
binary wheels ship a PREBUILT ``deltarice_tpu/native/lib/libh5deltarice_
tpu.so`` — reference parity with its compiled-extension wheels
(``/root/reference/setup.py``): a machine without a C compiler can still
auto-load the filter from HDF5_PLUGIN_PATH after
``deltarice-tpu install-plugin``. Source installs without a toolchain
still work (the library also builds lazily on first use); the hook just
warns and continues if no compiler is available.

The hook builds the PyTorch port's filter the same way, from the port's own
copy of the sources, into ``deltarice_tpu_torch/build/native/
libh5deltarice_tpu_torch.so``.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

from setuptools import setup
from setuptools.command.build_py import build_py


class build_py_with_native(build_py):
    def run(self):
        here = Path(__file__).resolve().parent
        sys.path.insert(0, str(here))
        try:
            from deltarice_tpu.native._build import build_library

            build_library()
        except Exception as exc:  # no toolchain: pure-Python wheel
            sys.stderr.write(
                f"warning: native filter not prebuilt ({exc}); it will "
                "build lazily on first use\n"
            )
        finally:
            sys.path.pop(0)
        try:  # the PyTorch port's own copy: imports only ctypes and numpy
            spec = importlib.util.spec_from_file_location(
                "deltarice_tpu_torch_native",
                here / "deltarice_tpu_torch" / "native" / "__init__.py")
            native = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(native)
            native.build()
        except Exception as exc:  # no toolchain: pure-Python wheel
            sys.stderr.write(
                f"warning: the port's native filter not prebuilt ({exc}); "
                "it will build lazily on first use\n"
            )
        super().run()


setup(cmdclass={"build_py": build_py_with_native})
