"""B4's device times, and a baseline transpose kernel's beside them, on one
CUDA card.

Run from the repository root::

    python -m deltarice_tpu_torch.profile_transpose [--baseline FILE.cu]

At each of :data:`SHAPES` (the Nab samples' shape and the JAX package's
shapes of its transpose), on seeded random data, ``transpose2d`` must equal
its plain version; it is then timed in CUDA graphs
(``utils.profiling.graph_ms``: no host time between launches): warm, on
one buffer pair, and cold, rotated over enough buffer pairs that at least
:data:`COLD_BYTES` move between two uses of one.

``--baseline`` names an earlier transpose source with the 2-D interface
``dr_transpose2d(x, out, a, b, elem_size, stream)`` (the 32 x 32 tile
kernel before the batched one; ``git archive`` an earlier commit to get
it). It is compiled alone with ``nvcc`` under ``deltarice_tpu_torch/build/``,
checked the same way, and timed in the same graphs, a 3-D input taking one
launch per matrix. At each shape the order is baseline, current, current,
baseline, so that both meet the card in the same state; each line prints
both readings. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

import torch

L2_BYTES = 50 * 10**6  # H100 L2 (NVIDIA data sheet)
COLD_BYTES = 2 * L2_BYTES  # bytes moved between two uses of a buffer
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# B4 at the Nab samples and at the JAX package's shapes of its transpose
# (jax.vmap over blocks of 1024 segments; Nab's lp is 14 x 512)
SHAPES = (
    ("Nab samples", (2048, 7000), torch.int16),
    ("JAX encode (blocks, 1024, lp)", (2, 1024, 7168), torch.int16),
    ("JAX untile (blocks, lp, 1024)", (2, 7168, 1024), torch.int16),
    ("JAX decode word plane (blocks, 1024, cols)", (2, 1024, 1280),
     torch.uint32),
)


def cold_inputs(a: torch.Tensor) -> list[torch.Tensor]:
    """``a`` and copies of it, enough that rotating calls over them moves
    at least :data:`COLD_BYTES` (each call reads ``a``'s bytes and writes
    as many) between two uses of one."""
    moved = 2 * a.numel() * a.element_size()
    pairs = -(-COLD_BYTES // moved) + 1
    return [a] + [a.clone() for _ in range(pairs - 1)]


def baseline_library(source: Path) -> ctypes.CDLL:
    """``source`` compiled alone into a shared library (cached by digest)."""
    from .ops import _kernels

    h = hashlib.sha256(" ".join(_kernels.NVCC_FLAGS).encode())
    h.update(source.read_bytes())
    lib = _kernels.BUILD / f"libtranspose_baseline_{h.hexdigest()[:16]}.so"
    if not lib.is_file():
        lib.parent.mkdir(parents=True, exist_ok=True)
        res = subprocess.run(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared",
             "-I", str(source.parent), "-o", str(lib), str(source)],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n"
                               f"{res.stdout}{res.stderr}")
    dll = ctypes.CDLL(str(lib))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    dll.dr_transpose2d.argtypes = [p, p, i64, i64, ctypes.c_int, p]
    dll.dr_transpose2d.restype = ctypes.c_int
    return dll


def baseline_transpose(dll: ctypes.CDLL):
    """The baseline kernel as a transpose of the last two axes: one launch
    per matrix."""
    from .ops import _kernels

    def run(x: torch.Tensor) -> torch.Tensor:
        a, b = x.shape[-2:]
        out = torch.empty(x.shape[:-2] + (b, a), dtype=x.dtype,
                          device=x.device)
        xs, os_ = x.reshape(-1, a, b), out.view(-1, b, a)
        for m in range(xs.shape[0]):
            _kernels.check(dll.dr_transpose2d(
                xs[m].data_ptr(), os_[m].data_ptr(), a, b, x.element_size(),
                _kernels.stream()), "baseline transpose2d")
        return out

    return run


def bits(t: torch.Tensor) -> torch.Tensor:
    """uint32 tensors as int32 bit patterns, for comparisons."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def random(shape, dtype, gen) -> torch.Tensor:
    """Seeded random int16, int32 or uint32 elements on the card."""
    raw = torch.randint(-2**31, 2**31, shape, generator=gen, device="cuda",
                        dtype=torch.int64)
    return (raw.to(torch.int16) if dtype == torch.int16
            else raw.to(torch.int32).view(dtype))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_transpose: needs a CUDA card", file=sys.stderr)
        return 2
    from .ops.transpose_cuda import transpose2d, transpose2d_plain
    from .utils.profiling import graph_ms, rotated

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    kernels = {"current": transpose2d}
    if args.baseline is not None:
        kernels["baseline"] = baseline_transpose(
            baseline_library(args.baseline))
    order = (["baseline", "current", "current", "baseline"]
             if "baseline" in kernels else ["current", "current"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, shape, dtype in SHAPES:
        a = random(shape, dtype, gen)
        want = transpose2d_plain(a)
        for name, fn in kernels.items():
            got = fn(a)
            torch.cuda.synchronize()
            if not torch.equal(bits(got), bits(want)):
                print(f"profile_transpose: {name} disagrees with the plain "
                      f"version at {shape}", file=sys.stderr)
                return 1
        del got, want
        inputs = cold_inputs(a)
        moved, pairs = 2 * a.numel() * a.element_size(), len(inputs)
        times = {name: {"warm": [], "cold": []} for name in kernels}
        for name in order:
            fn = kernels[name]
            times[name]["warm"].append(graph_ms([lambda: fn(a)]))
            times[name]["cold"].append(graph_ms(rotated(fn, inputs)))
        del inputs
        print(f"{label} {tuple(shape)} {str(dtype).split('.')[-1]}: bound "
              f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms; cold over {pairs} "
              f"buffer pairs, {(pairs - 1) * moved / 1e6:.1f} MB between "
              f"reuses; "
              + "; ".join(
                  f"{name} warm {' '.join(f'{t:.4f}' for t in v['warm'])} "
                  f"cold {' '.join(f'{t:.4f}' for t in v['cold'])} ms"
                  for name, v in times.items()) + f"; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
