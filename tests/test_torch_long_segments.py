"""Long segments through the port's batch codec, on the CPU: one encode path
for every segment length.

The JAX package splits a long segment into sub-blocks, encodes them apart
and merges the sub-streams at bit offsets. The port encodes every segment
whole through B1 (here its plain version), in one ``encode_segments`` call
over every row of the batch. Each case holds ``compress_batch``'s streams
to the JAX package's ``compress_batch`` and ``compress`` and to native
``dr_compress`` byte for byte (tolerance 0: the codec is integer and
lossless), and native ``dr_decompress`` of each stream to its chunk. The
port's plain decode steps through every sample, so these cases decode with
native C only; ``tests/test_torch_split.py`` decodes long rows through the
port.
"""

import numpy as np
import pytest

import deltarice_tpu as drt
import deltarice_tpu.codec as jcodec
import deltarice_tpu_torch as dt
from deltarice_tpu.config import RiceConfig as JaxConfig
from deltarice_tpu_torch import codec, tracing
from deltarice_tpu_torch.native import native_compress, native_decompress

CPU = "cpu"
DELTA, FIR = (1, -1), (1, -2, 1)
# (segments of a batch, length, cd_values, the JAX package's sub-blocks a
# segment): the shapes its split policy was held to, from a short segment
# to one NOPTREX chunk (32, 500000)
SHAPES = [
    (1024, 7000, (8,), 1),
    (256, 500000, (8,), 16),
    (1024, 81920, (8,), 4),
    (256, 500000, (8, -1, 3, 1, -2, 1), 16),
    (32, 81920, (16, 81920), 8),
    (32, 500000, (8, 500000), 32),
    (3, 30000, (8, 30000), 2),
]


def _cfg(m, length, filt):
    """The port's config and the JAX package's, from the same cd_values."""
    cfg = dt.RiceConfig(m, length, filt)
    return cfg, JaxConfig.from_cd_values(cfg.to_cd_values())


def _walk(shape, sigma, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0, sigma, shape).round(), -1).astype(np.int16)


def _encodes(monkeypatch):
    """The shape of each ``encode_segments`` call the codec makes."""
    calls = []
    real = codec.encode_segments

    def spy(rows, *a, **k):
        calls.append(np.shape(rows))
        return real(rows, *a, **k)

    monkeypatch.setattr(codec, "encode_segments", spy)
    return calls


def _assert_jax_and_native(chunks, streams, cfg, jcfg):
    assert streams == [bytes(s) for s in jcodec.compress_batch(chunks, jcfg)]
    cd = cfg.to_cd_values()
    for c, s in zip(chunks, streams):
        assert s == bytes(drt.compress(c, jcfg))
        assert s == native_compress(c, cd)
        np.testing.assert_array_equal(native_decompress(s, cd), c.ravel())


@pytest.mark.parametrize("filt", [DELTA, FIR], ids=["delta", "fir"])
@pytest.mark.parametrize("nseg,length,cd,parts", SHAPES, ids=[
    "short", "noptrex_batch", "nedm_batch", "noptrex_batch_fir",
    "nedm_chunk", "noptrex_chunk", "three_segments"])
def test_long_segments_encode_whole_rows_to_the_jax_bytes(
        nseg, length, cd, parts, filt, monkeypatch):
    """Two chunks of one row each: one ``encode_segments`` call over both
    whole rows gives the bytes of the JAX package's split."""
    jfull = JaxConfig.from_cd_values(tuple(c & 0xFFFFFFFF for c in cd))
    assert jcodec._split_parts(nseg, length, jfull) == parts
    cfg, jcfg = _cfg(cd[0], cd[1] if len(cd) > 1 else -1, filt)
    x = _walk((2, length), 4.0 if cd[0] == 16 else 8.0,
              SHAPES.index((nseg, length, cd, parts)))
    chunks = [x[0], x[1]]
    calls = _encodes(monkeypatch)
    streams = dt.compress_batch(chunks, cfg, device=CPU)
    assert calls == [(2, length)]
    _assert_jax_and_native(chunks, streams, cfg, jcfg)


@pytest.mark.parametrize("filt", [DELTA, FIR], ids=["delta", "fir"])
def test_a_ragged_last_segment_encodes_whole_to_the_jax_bytes(filt,
                                                              monkeypatch):
    """40,000 samples a chunk in segments of 30,000: a whole segment and a
    ragged one of 10,000 a chunk, each encoded whole."""
    cfg, jcfg = _cfg(8, 30000, filt)
    x = _walk((2, 40000), 6.0, 21)
    chunks = [x[0], x[1]]
    calls = _encodes(monkeypatch)
    streams = dt.compress_batch(chunks, cfg, device=CPU)
    assert calls == [(4, 30000)]
    _assert_jax_and_native(chunks, streams, cfg, jcfg)


def test_a_nine_tap_filter_encodes_whole_to_the_jax_bytes(monkeypatch):
    """A filter whose history (8 samples) the JAX split carries across each
    sub-block's cut in a halo: the port filters the whole row."""
    cfg, jcfg = _cfg(8, 40000, (1, -2, 1, 0, 3, -1, 0, -2, 1))
    x = _walk((2, 40000), 6.0, 22)
    chunks = [x[0], x[1]]
    calls = _encodes(monkeypatch)
    streams = dt.compress_batch(chunks, cfg, device=CPU)
    assert calls == [(2, 40000)]
    _assert_jax_and_native(chunks, streams, cfg, jcfg)


@pytest.mark.parametrize("m", [1, 8, 32768], ids=["k0", "k3", "k15"])
def test_each_rice_parameter_encodes_whole_to_the_jax_bytes(m, monkeypatch):
    cfg, jcfg = _cfg(m, 40000, DELTA)
    x = _walk((2, 40000), 60.0 if m > 8 else 3.0, 23)
    chunks = [x[0], x[1]]
    calls = _encodes(monkeypatch)
    streams = dt.compress_batch(chunks, cfg, device=CPU)
    assert calls == [(2, 40000)]
    _assert_jax_and_native(chunks, streams, cfg, jcfg)


def test_long_rows_over_the_cap_reencode_alone_to_the_jax_bytes(monkeypatch):
    """Four chunks of one 40,000-sample segment; two carry uniform noise
    past sample 4096, outside the host hint's subsample, so they overflow
    its cap. Collect pads and re-encodes those two rows alone, at the full
    bound."""
    cfg, jcfg = _cfg(8, 40000, DELTA)
    x = _walk((4, 40000), 6.0, 24)
    rng = np.random.default_rng(25)
    x[1::2, 4096:] = rng.integers(-32768, 32768, (2, 40000 - 4096))
    chunks = list(x)
    cap = codec._words_hint(x, cfg, 40000)
    assert cap < cfg.max_words(40000)
    calls = _encodes(monkeypatch)
    tracing.clear()
    handle = codec.compress_batch_dispatch(chunks, cfg, CPU)
    np.testing.assert_array_equal(handle[3].numpy() > cap,
                                  [False, True, False, True])
    streams = codec.compress_batch_collect(handle, cfg)
    assert tracing.snapshot()["counters"]["rows_reencoded"] == 2
    tracing.clear()
    assert calls == [(4, 40000), (2, 40000)]
    _assert_jax_and_native(chunks, streams, cfg, jcfg)
