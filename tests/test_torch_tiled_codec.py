"""The plain model of B2's and B1's tiled passes
(``deltarice_tpu_torch.ops.tiled_model``) against the JAX package's
serial codec, on the CPU.

B2 and B1 are parallel inside each segment: B2 decodes tiles of words from
entry phases resolved by composing per-tile tables, B1 encodes tiles of
samples at bit offsets from a prefix sum of tile totals. The model computes
each of those passes in plain torch; here every result must equal
``_decode_segments_scan`` / ``unpack_bits`` and ``_encode_segments_xla``
exactly (tolerance 0: the codec is integer and lossless), at every k, on
escape-heavy rows, with codewords and escapes across tile boundaries,
every entry phase 0..24, W = 1, empty segments and samples decoded past a
stream's end (the clamped cursor). The kernels themselves are held against
the same model and the serial oracles on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltarice_tpu.codec import _decode_segments_scan, _encode_segments_xla
from deltarice_tpu.config import RiceConfig as JaxConfig
from deltarice_tpu.ops import pack_xla as jpack
from deltarice_tpu.ops import rice as jrice
from deltarice_tpu_torch.ops import tiled_model as tm
from deltarice_tpu_torch.ops.pack_cuda import pack_encode
from deltarice_tpu_torch.ops.unpack_cuda import unpack_decode, unpack_tables

LENGTH = 700


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The model steps small tensors in long loops: one intra-op thread
    per test process keeps parallel test workers from contending."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rows(seed, rows=10, length=LENGTH):
    """Random walks at several scales, uniform (escape-heavy) rows, a
    constant row and a short and an empty segment's valid counts."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(np.round(rng.normal(0, 8.0, (rows, length))),
                  axis=-1).astype(np.int16)
    x[1] = np.cumsum(np.round(rng.normal(0, 0.4, length))).astype(np.int16)
    x[2] = np.cumsum(np.round(rng.normal(0, 300.0, length))).astype(np.int16)
    x[3] = rng.integers(-32768, 32768, length)
    x[4] = rng.integers(-32768, 32768, length)
    x[5] = 1234
    nv = np.full(rows, length, np.int32)
    nv[6], nv[7] = 0, length // 3
    return x, nv


def _jax_words(x, nv, k):
    cfg = JaxConfig(1 << k, x.shape[1])
    jw, jn, _ = _encode_segments_xla(jnp.asarray(x), jnp.asarray(nv), cfg,
                                     cfg.max_words(x.shape[1]) + 1)
    return np.array(jw), np.asarray(jn)


def _t(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


@pytest.mark.parametrize("k", range(16))
def test_tiled_decode_matches_decode_segments_scan(k):
    x, nv = _rows(k)
    words, nwords = _jax_words(x, nv, k)
    words = words[:, : int(nwords.max()) + 1]  # one pad word past the longest
    n = LENGTH + 60  # past every stream's end: the clamped cursor
    want = np.asarray(_decode_segments_scan(jnp.asarray(words), n,
                                            JaxConfig(1 << k, LENGTH)))
    for tile_words, group in [(tm.TILE_WORDS, tm.GROUP), (2, 3)]:
        got = tm.decode_tiled(_t(words), n, k, True, tile_words, group)
        np.testing.assert_array_equal(got.numpy(), want)
    for r in range(len(x)):
        np.testing.assert_array_equal(want[r, : nv[r]], x[r, : nv[r]])


@pytest.mark.parametrize("tile_words,group", [(1, 2), (1, 32), (3, 2),
                                              (5, 4), (32, 2)])
def test_tiled_decode_any_tiling_matches_unpack_bits(tile_words, group):
    """Tiles of one word put most codewords and escapes across a tile
    boundary and make several levels of composition; the un-zigzagged
    values (no delta) must still equal the serial walk's."""
    k = 2
    x, nv = _rows(100 + tile_words)
    words, nwords = _jax_words(x, nv, k)
    words = words[:, : int(nwords.max()) + 3]
    n = LENGTH + 200
    want = np.asarray(jrice.unzigzag(jpack.unpack_bits(jnp.asarray(words), n,
                                                       k)))
    got = tm.decode_tiled(_t(words), n, k, False, tile_words, group)
    np.testing.assert_array_equal(got.numpy(), want)
    tab = tm.decode_tables(_t(words), k, tile_words)
    ent = tm.entry_states(tab, group)
    assert torch.equal(ent, tm.entry_states_serial(tab))
    if tile_words == 1:  # every entry phase occurs on this data
        assert set(ent[..., 0].unique().tolist()) == set(range(tm.PHASES))


def _value(bits) -> int:
    return int("".join(map(str, bits)) or "0", 2)


def _bit_walk(row, bit, lim, k):
    """(exit bit - lim, codewords, wrapping sum) of a plain bit-by-bit walk
    of the MSB-first stream ``row`` (uint32 words) from ``bit`` over the
    codewords that start before ``lim``: q zeros (8 or more: the 25-bit
    escape), a one, then k remainder bits or the 16-bit value."""
    bits = np.unpackbits(row.astype(">u4").view(np.uint8))
    bits = np.concatenate([bits, np.zeros(64, np.uint8)])
    count, total = 0, 0
    while bit < lim:
        q = 0
        while q < 8 and bits[bit + q] == 0:
            q += 1
        if q == 8:
            u, n = _value(bits[bit + 9: bit + 25]), 25
        else:
            u, n = (q << k) | _value(bits[bit + q + 1: bit + q + 1 + k]), q + 1 + k
        total += (u >> 1) ^ -(u & 1)
        count += 1
        bit += n
    return bit - lim, count, ((total + 0x8000) & 0xFFFF) - 0x8000


@pytest.mark.parametrize("k", [0, 3, 8, 15])
def test_decode_tables_match_a_bit_walk_from_every_entry_phase(k):
    """Each tile's table entry for entry phase e equals a plain bit-by-bit
    walk from the tile's first bit + e: the codewords that start before the
    tile's end, their wrapping sum and the exit phase — including walks
    from wrong phases, which read garbage codewords and phantom escapes."""
    x, nv = _rows(200 + k)
    x, nv = x[1:5], nv[1:5]  # slow and fast walks, escape-heavy rows
    words, nwords = _jax_words(x, nv, k)
    words = words[:, : int(nwords.max()) + 1]
    tile_words = 4
    tab = tm.decode_tables(_t(words), k, tile_words).numpy()
    maxbit = 32 * (words.shape[1] - 1)
    for s in range(words.shape[0]):
        for t in range(0, tab.shape[1], 7):
            lim = min(32 * tile_words * (t + 1), maxbit)
            for e in range(tm.PHASES):
                got = tuple(tab[s, t, e])
                assert got == _bit_walk(words[s], 32 * tile_words * t + e,
                                        lim, k), (s, t, e)


def test_tiled_decode_of_pad_only_and_cut_streams():
    """W = 1 (the pad word alone, zero or not), and streams cut short of
    their end, decode as the serial walk does: every sample past the clamp
    re-decodes the codeword there."""
    rng = np.random.default_rng(7)
    pad = rng.integers(0, 1 << 32, (5, 1), dtype=np.uint64).astype(np.uint32)
    pad[0] = 0
    x, nv = _rows(8)
    words, _ = _jax_words(x, nv, 3)
    for w in (pad, words[:, :1], words[:, :2], words[:, :33], words[:, :70]):
        for delta in (True, False):
            got = tm.decode_tiled(_t(w), 300, 3, delta, 2, 2)
            want = jrice.unzigzag(jpack.unpack_bits(jnp.asarray(w), 300, 3))
            want = np.asarray(want)
            if delta:
                want = np.cumsum(want.astype(np.int64), axis=1)
                want = (((want + 0x8000) & 0xFFFF) - 0x8000).astype(np.int16)
            np.testing.assert_array_equal(got.numpy(), want)


def test_compose_levels_equal_the_serial_composition():
    """Random tables (any exit phase, counts and sums): the levels of
    groups compose to the same entry states as tile after tile."""
    rng = np.random.default_rng(3)
    n = 1100
    tab = np.stack([rng.integers(0, tm.PHASES, (3, n, tm.PHASES)),
                    rng.integers(1, 1025, (3, n, tm.PHASES)),
                    rng.integers(-32768, 32768, (3, n, tm.PHASES))], axis=-1)
    tab = torch.from_numpy(tab.astype(np.int32))
    want = tm.entry_states_serial(tab)
    for group in (2, 7, 32):
        assert torch.equal(tm.entry_states(tab, group), want)


@pytest.mark.parametrize("k", range(16))
def test_tiled_encode_matches_encode_segments_xla(k):
    x, nv = _rows(300 + k)
    p0 = np.random.default_rng(k).integers(-32768, 32768, len(x)).astype(
        np.int32)
    cfg = JaxConfig(1 << k, LENGTH)
    full = cfg.max_words(LENGTH)
    for diff, prev0 in [(True, None), (True, p0), (False, None)]:
        for cap in (7, 40, full):
            jw, jn, jb = _encode_segments_xla(
                jnp.asarray(x), jnp.asarray(nv), cfg, cap, "segsum",
                None if prev0 is None else jnp.asarray(prev0), not diff)
            for tile in (7, 64, tm.TILE_SAMPLES):
                words, nwords, nbits = tm.encode_tiled(
                    torch.from_numpy(x), torch.from_numpy(nv),
                    None if prev0 is None else torch.from_numpy(prev0), k,
                    diff, cap, tile)
                np.testing.assert_array_equal(
                    words.numpy().view(np.uint32), np.asarray(jw))
                np.testing.assert_array_equal(nwords.numpy(), np.asarray(jn))
                np.testing.assert_array_equal(nbits.numpy(), np.asarray(jb))


def test_wrappers_take_the_segment_major_layout_on_the_cpu():
    """On CPU tensors the B1 / B2 wrappers run their serial oracles and
    ``unpack_tables`` the model's first pass: all agree with the model."""
    x, nv = _rows(9)
    xt, nvt = torch.from_numpy(x), torch.from_numpy(nv)
    words, nwords, nbits = pack_encode(xt, nvt, None, 4, True, 900)
    model = tm.encode_tiled(xt, nvt, None, 4, True, 900)
    for a, b in zip((words, nwords, nbits), model):
        assert torch.equal(a, b)
    w = words[:, : int(nwords.max()) + 1].contiguous()
    assert torch.equal(unpack_decode(w, LENGTH + 40, 4),
                       tm.decode_tiled(w, LENGTH + 40, 4))
    assert torch.equal(unpack_tables(w, 4), tm.decode_tables(w, 4))
