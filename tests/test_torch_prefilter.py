"""The generic pre-filter inverse on the CPU: the port's plain version
(``ops/prefilter.py::iir_decode_plain``) against the JAX package's
``_iir_decode``, the routing of ``prefilter_decode``, and the codec with
generic filters against the JAX codec and the native C codec.

Inputs come from numpy seeds (``tests/prefilter_cases.py``); every
comparison is exact (tolerance 0: the inverse is integer arithmetic, and
the JAX package's output is the reference even where it is lossy). The
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deltarice_tpu as drt
import deltarice_tpu.codec as jcodec
import deltarice_tpu_torch as dt
from deltarice_tpu.config import RiceConfig as JaxConfig
from deltarice_tpu.ops import prefilter as jpre
from deltarice_tpu_torch import codec
from deltarice_tpu_torch.models import get_profile
from deltarice_tpu_torch.native import native_compress, native_decompress
from deltarice_tpu_torch.ops import _kernels, prefilter, prefilter_cuda
from prefilter_cases import EDGES, GRID, grid_filter, samples

CPU = "cpu"


def _jax(d: np.ndarray, filt) -> np.ndarray:
    return np.asarray(jpre._iir_decode(jnp.asarray(d), tuple(filt)))


def _plain(d: np.ndarray, filt) -> np.ndarray:
    return prefilter.iir_decode_plain(torch.from_numpy(d), filt).numpy()


@pytest.mark.parametrize("ntaps,f0", GRID)
def test_plain_inverse_matches_jax(ntaps, f0):
    filt = grid_filter(ntaps, f0)
    d = samples((3, 40), ntaps)
    np.testing.assert_array_equal(_plain(d, filt), _jax(d, filt))


@pytest.mark.parametrize("filt", EDGES, ids=str)
def test_plain_inverse_matches_jax_on_the_division_edges(filt):
    d = samples((4, 64), 7)
    d[0, :8] = -32768  # -32768 / -1 must wrap back to -32768
    np.testing.assert_array_equal(_plain(d, filt), _jax(d, filt))


@pytest.mark.parametrize("shape,ntaps", [
    ((5, 3), 12),     # rows shorter than the filter
    ((1, 1), 4),
    ((4, 0), 3),      # zero-length rows
    ((0, 9), 3),      # no rows
    ((2, 3, 50), 5),  # leading axes, flattened as JAX flattens them
    ((2, 3, 50), 1),
])
def test_plain_inverse_matches_jax_on_odd_shapes(shape, ntaps):
    filt = grid_filter(ntaps, -1)
    d = samples(shape, 3)
    got = _plain(d, filt)
    assert got.shape == d.shape and got.dtype == np.int16
    if d.shape[-1] == 0:  # JAX's reshape((-1, 0)) cannot size its rows
        return
    np.testing.assert_array_equal(got, _jax(d, filt))


@pytest.mark.parametrize("ntaps", [1025, 1026, 2500])
def test_plain_inverse_matches_jax_on_long_filters(ntaps):
    """Filters of any length (the card's serial walk keeps their history in
    shared or global memory; nothing refuses them)."""
    filt = grid_filter(ntaps, 1)
    d = samples((2, 1100), ntaps)
    np.testing.assert_array_equal(_plain(d, filt), _jax(d, filt))


def test_prefilter_decode_on_the_cpu_never_touches_the_kernels(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path reached the kernel")

    monkeypatch.setattr(_kernels, "library", refuse)
    monkeypatch.setattr(prefilter, "iir_decode", refuse)
    before = dict(_kernels.launches)
    d = samples((3, 30), 5)
    for filt in ((1, 0, -1), (8, -1), (65536,)):
        got = prefilter.prefilter_decode(torch.from_numpy(d), filt)
        np.testing.assert_array_equal(got.numpy(), _jax(d, filt))
    assert dict(_kernels.launches) == before


def test_unsupported_devices_raise():
    meta = torch.empty((2, 8), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        prefilter.prefilter_decode(meta, (1, 0, -1))
    for entry in (prefilter_cuda.iir_decode, prefilter_cuda.iir_decode_serial):
        with pytest.raises(ValueError, match="CUDA tensor"):
            entry(torch.zeros((2, 8), dtype=torch.int16), (1, 0, -1))


def test_taps_wrap_into_int16():
    taps = prefilter_cuda._taps((1, 70000, -32769, 65535, -1), torch.device(CPU))
    assert taps.dtype == torch.int16
    assert taps.tolist() == [prefilter.c16(c) for c in (70000, -32769, 65535,
                                                        -1)]


def _cfgs(m, length, filt):
    """The port's config, the JAX package's from the same cd_values, and
    the cd_values."""
    cfg = dt.RiceConfig(m, length, filt)
    cd = cfg.to_cd_values()
    return cfg, JaxConfig.from_cd_values(cd), cd


@pytest.mark.parametrize("filt", [(1, 0, -1), (1, -1, 0, 1), (8, -1)],
                         ids=str)
def test_batch_with_generic_filters_matches_jax_and_native(filt):
    cfg, jcfg, cd = _cfgs(8, 700, filt)
    x = get_profile("nab").synthetic(6, seed=2, length=700)
    chunks = list(x.reshape(3, 1400))
    streams = dt.compress_batch(chunks, cfg, device=CPU)
    assert streams == [bytes(s) for s in jcodec.compress_batch(chunks, jcfg)]
    back = dt.decompress_batch(streams, cfg, device=CPU)
    want = jcodec.decompress_batch(streams, jcfg)
    for c, s, b, w in zip(chunks, streams, back, want):
        assert s == native_compress(c, cd)
        np.testing.assert_array_equal(b, np.asarray(w))
        np.testing.assert_array_equal(b, native_decompress(s, cd))
        if cfg.lossless:
            np.testing.assert_array_equal(b, c)


def _long_filters():
    rng = np.random.default_rng(3)
    dense = (1,) + tuple(int(c) for c in rng.integers(-3, 4, 1025))
    return [dense, (1,) + (0,) * 1100 + (-1,)]


@pytest.mark.parametrize("filt", _long_filters(), ids=lambda f: f"{len(f)}taps")
def test_long_filter_round_trip_matches_native(filt):
    """A filter of more than 1024 taps (1026 dense, 1102 sparse) through
    ``compress_batch`` / ``decompress_batch`` on the CPU equals native
    ``dr_compress`` / ``dr_decompress`` and gives back the samples (the
    JAX package's encode of such a filter takes minutes, so native C is
    the oracle here)."""
    cfg = dt.RiceConfig(8, 1100, filt)
    cd = cfg.to_cd_values()
    assert len(cd) > 1024
    chunks = list(get_profile("nab").synthetic(4, seed=4, length=1100)
                  .reshape(2, 2, 1100))
    streams = dt.compress_batch(chunks, cfg, device=CPU)
    for c, s, b in zip(chunks, streams,
                       dt.decompress_batch(streams, cfg, device=CPU)):
        assert s == native_compress(c, cd)
        np.testing.assert_array_equal(b, native_decompress(s, cd))
        np.testing.assert_array_equal(b, c.ravel())


def test_leftover_segment_with_a_generic_filter_matches_jax():
    cfg, jcfg, _cd = _cfgs(16, 300, (1, -1, 0, 1))
    chunks = list(get_profile("nab").synthetic(3, seed=6, length=1000))
    streams = dt.compress_batch(chunks, cfg, device=CPU)
    assert streams == [bytes(s) for s in jcodec.compress_batch(chunks, jcfg)]
    for c, b in zip(chunks, dt.decompress_batch(streams, cfg, device=CPU)):
        np.testing.assert_array_equal(b, c)


@pytest.mark.parametrize("split", [False, True], ids=["split-off",
                                                      "split-on"])
def test_long_segment_generic_filter_takes_the_halo_split(split,
                                                          monkeypatch):
    """One 16384-sample segment a chunk: the encode splits it in two
    sub-blocks whose FIR halo carries the filter's history across the cut;
    the decode inverts after B2, or after the split decode's merge."""
    filt = (1, -1, 0, 1)
    cfg, jcfg, cd = _cfgs(8, 16384, filt)
    x = get_profile("noptrex").synthetic(2, seed=3)[:, :16384].copy()
    assert codec._split_parts(1, 16384, cfg) == 2
    chunks = [x[0], x[1]]
    streams = dt.compress_batch(chunks, cfg, device=CPU)
    for c, s in zip(chunks, streams):
        assert s == bytes(drt.compress(c, jcfg, method="segsum"))
        assert s == native_compress(c, cd)
    if split:
        monkeypatch.setenv("DELTARICE_TPU_SPLIT_DECODE", "1")
        monkeypatch.setattr(codec, "decode_split_parts", lambda *a: 4)
    for c, b in zip(chunks, dt.decompress_batch(streams, cfg, device=CPU)):
        np.testing.assert_array_equal(b, c)
