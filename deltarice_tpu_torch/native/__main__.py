"""``python -m deltarice_tpu_torch.native`` — build / install the C filter.

Subcommands:
  build                      compile the shared library in place
  install [--plugin-dir DIR] build if needed and copy it into an HDF5
                             plugin directory (see :mod:`.install` for the
                             default)
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m deltarice_tpu_torch.native")
    sub = p.add_subparsers(dest="cmd", required=True)
    pb = sub.add_parser("build", help="compile the native filter library")
    pb.add_argument("-v", "--verbose", action="store_true")
    pi = sub.add_parser(
        "install", help="build and copy the plugin into HDF5_PLUGIN_PATH")
    pi.add_argument("--plugin-dir", default=None)
    pi.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    if args.cmd == "build":
        from . import build

        print(f"built {build(verbose=args.verbose)}")
    else:
        from .install import install_plugin

        print(f"installed {install_plugin(args.plugin_dir, args.verbose)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
