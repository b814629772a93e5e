"""The plain model of B2's and B1's tiled passes
(``deltarice_tpu_torch.ops.tiled_model``) against the JAX package's
serial codec, on the CPU.

B2 and B1 are parallel inside each segment: B2 walks each tile of words
from phase 0 and from its assumed entry phase, walks a tile again from its
true entry phase where the assumption is wrong, sums the tiles' entries to
every tile's start and decodes the tiles from there; B1 encodes tiles of
samples at bit offsets from a prefix sum of tile totals. The model computes
each of those passes in plain torch; here every result must equal
``_decode_segments_scan`` / ``unpack_bits`` and ``_encode_segments_xla``
exactly (tolerance 0: the codec is integer and lossless), at every k, on
escape-heavy rows, with codewords and escapes across tile boundaries, on
streams whose walk never meets phase 0's, W = 1, empty segments and samples
decoded past a stream's end (the clamped cursor); each tile's entry must
equal the walk from every entry phase 0..24 (``decode_tables``, itself held
to a bit-by-bit walk) at its true entry phase. The kernels themselves are held against
the same model and the serial oracles on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import re
from pathlib import Path

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

from tiled_cases import never_joining

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
    want_states = tm.entry_states_serial(tab)
    ent = tm.decode_entries(_t(words), k, 1 << 30, tile_words)[0]
    assert torch.equal(tm.entry_states(ent[..., 1:], group), want_states)
    if tile_words == 1:  # every entry phase occurs on this data
        assert set(want_states[..., 0].unique().tolist()) == set(
            range(tm.PHASES))


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
    """Random entries (any exit phase, counts and sums), one a tile: the
    levels of groups compose to the same entry states as tile after tile,
    which is the serial composition of tables that give the same entry
    from every phase."""
    rng = np.random.default_rng(3)
    n = 1100
    ent = np.stack([rng.integers(0, tm.PHASES, (3, n)),
                    rng.integers(1, 1025, (3, n)),
                    rng.integers(-32768, 32768, (3, n))], axis=-1)
    ent = torch.from_numpy(ent.astype(np.int32))
    want = tm.entry_states_serial(ent[:, :, None].expand(-1, -1, tm.PHASES,
                                                         -1))
    for group in (2, 7, 32):
        assert torch.equal(tm.entry_states(ent, group), want)


def _true_walk(tab, n_samples):
    """From the tables of every entry phase (the oracle): each tile's true
    entry phase, the phase-0 exit of the tile before it (the assumed
    entry), and whether its first codeword lies below ``n_samples``."""
    states = tm.entry_states_serial(tab)
    assumed = torch.zeros_like(states[..., 0])
    assumed[:, 1:] = tab[:, :-1, 0, 0]
    return states[..., 0], assumed, states[..., 1] < n_samples


def _check_entries(words, k, n_samples, tile_words):
    """The model's entries against the oracle: a tile below ``n_samples``
    holds the walk from its true entry phase, any other the walk from its
    assumed one; the tiles walked again are those below ``n_samples``
    whose assumed entry is wrong. Returns that count."""
    tab = tm.decode_tables(words, k, tile_words)
    true, assumed, below = _true_walk(tab, n_samples)
    ent, rejoined = tm.decode_entries(words, k, n_samples, tile_words)
    used = torch.where(below, true, assumed)
    assert torch.equal(ent[..., 0], used)
    assert torch.equal(ent[..., 1:], tm._step(tab, used).to(torch.int32))
    assert rejoined == int(((true != assumed) & below).sum())
    return rejoined


@pytest.mark.parametrize("k", range(16))
def test_decode_entries_are_the_tables_at_the_true_entry(k):
    """B2's one join a tile, checked and repaired: every tile's entry is
    the table's entry at the tile's true entry phase (tiles of 32 words
    and of 3, which put escapes across tile boundaries), below the samples
    asked for and past every stream's end; the decode equals the serial
    walk."""
    x, nv = _rows(400 + k)
    words, nwords = _jax_words(x, nv, k)
    w = _t(words[:, : int(nwords.max()) + 1])
    for tile_words in (tm.TILE_WORDS, 3):
        for n in (LENGTH, 1 << 30):
            _check_entries(w, k, n, tile_words)
    n = LENGTH + 60
    want = np.asarray(_decode_segments_scan(jnp.asarray(words[:, : int(
        nwords.max()) + 1]), n, JaxConfig(1 << k, LENGTH)))
    np.testing.assert_array_equal(tm.decode_tiled(w, n, k, True, 3, 2).numpy(),
                                  want)


@pytest.mark.parametrize("tile_words,group", [(32, 32), (32, 2), (3, 2),
                                              (1, 3)])
def test_streams_that_never_join_are_repaired(tile_words, group):
    """Where the true walk never meets phase 0's, every tile from the
    third on is walked again (the first is walked from its true entry 0,
    the second from the first's exit, which is true); the entries and the
    decode stay exact, past the stream's end and its clamp included. Rows
    dense with escapes and cut streams ride along."""
    k, nw = 3, 200
    rows = [never_joining(nw), never_joining(nw, 0x3FFFFFFF)]
    x, nv = _rows(500)
    esc, _ = _jax_words(x[3:5], nv[3:5], k)
    words = np.zeros((4, nw + 1), np.uint32)
    words[:2] = rows
    words[2:, : min(nw + 1, esc.shape[1])] = esc[:, : nw + 1]
    words[2:, -1] = 0
    w = _t(words)
    n_codewords = 1 + 8 * (nw - 1) + 7  # the first word's 5 + 27 bits
    ntiles = -(-nw // tile_words)
    for n in (n_codewords + 40, 1 << 30):
        rejoined = _check_entries(w, k, n, tile_words)
        assert rejoined >= 2 * (ntiles - 2)
    assert _check_entries(w, k, 50, tile_words) < 2 * (ntiles - 2)
    for cut in (w[:, :1], w[:, :2], w[:, :33], w):
        for n in (n_codewords, n_codewords + 40):
            got = tm.decode_tiled(cut.contiguous(), n, k, True, tile_words,
                                  group)
            want = np.asarray(jrice.unzigzag(jpack.unpack_bits(
                jnp.asarray(cut.numpy().view(np.uint32)), n, k)))
            want = np.cumsum(want.astype(np.int64), axis=1)
            want = (((want + 0x8000) & 0xFFFF) - 0x8000).astype(np.int16)
            np.testing.assert_array_equal(got.numpy(), want)


# B2's decode pass by warps: (k, tiles a row, samples asked for, out's
# phase in 8-byte words, delta): warps across rows of 1, 31, 33 and 40
# tiles, samples cut inside a round and inside a tile and decoded past the
# streams' end, every phase of out, tiles at 1024 / (k + 1) samples (the
# constant row) and tiles of escapes alone
WARP_CASES = [(0, 1, 600, 0, True), (0, 33, 250, 3, False),
              (3, 31, 600, 1, True), (3, 33, 450, 2, True),
              (3, 40, 900, 2, False), (3, 1, 600, 3, True),
              (7, 33, 601, 1, True), (8, 40, 599, 1, False),
              (15, 31, 333, 3, True), (15, 1, 600, 0, False)]


@pytest.mark.parametrize("k,tiles,n,ph,delta", WARP_CASES, ids=str)
def test_decode_warps_store_each_sample_once_as_the_serial_decode(
        k, tiles, n, ph, delta):
    """The decode pass as the kernel's warps store it (``write_plan``)
    stores every sample below the samples that the stream's codewords
    before the clamp give exactly once and no other; with the tail the
    result is the serial decode's, and JAX's."""
    x, nv = _rows(900 + k, rows=8, length=600)
    words, _, _ = pack_encode(torch.from_numpy(x), torch.from_numpy(nv),
                              None, k, True, 32 * tiles + 1)
    got, stored = tm.decode_warps(words, n, k, delta, ph)
    assert torch.equal(got, unpack_decode(words, n, k, delta))
    want = np.asarray(jrice.unzigzag(jpack.unpack_bits(
        jnp.asarray(words.numpy().view(np.uint32)), n, k)))
    if delta:
        want = np.cumsum(want.astype(np.int64), axis=1)
    want = (((want.astype(np.int64) + 0x8000) & 0xFFFF) - 0x8000)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int16))
    # the codewords before the clamp, from the walk of every entry phase
    tab = tm.decode_tables(words, k)
    states = tm.entry_states_serial(tab).to(torch.int64)
    last = tm._step(tab[:, -1], states[:, -1, 0])
    ends = torch.clamp(states[:, -1, 1] + last[:, 1], max=n)
    want_stored = (torch.arange(n)[None, :] < ends[:, None]).to(torch.int64)
    assert torch.equal(stored, want_stored)


def test_the_models_warp_and_round_are_the_kernels():
    """``tiled_model``'s round and tiles a warp are ``csrc/unpack.cu``'s."""
    src = (Path(__file__).resolve().parents[1] / "deltarice_tpu_torch" /
           "csrc" / "unpack.cu").read_text()
    assert int(re.search(r"constexpr int kRound = (\d+);", src)[1]) == \
        tm.ROUND
    assert "one warp per 32 consecutive tiles" in src and tm.WARP == 32


@pytest.mark.parametrize("seed", range(6))
def test_write_plan_stores_consecutive_aligned_words(seed):
    """On random plans (counts up to 1024 a tile, rows cut inside a tile,
    any phase of out) each warp store is one lane's round: at most 32
    consecutive 8-byte words, lane u storing word u, over at most 9
    sectors (256 bytes from an 8-byte boundary); only a round's first and
    last word go sample by sample; every sample of a tile's count is
    stored once, at its place."""
    rng = np.random.default_rng(seed)
    nseg, ntiles = int(rng.integers(1, 5)), int(rng.integers(1, 70))
    count = torch.from_numpy(rng.integers(0, 1025, (nseg, ntiles)))
    count[:, rng.random(ntiles) < 0.2] = 0
    first = count.cumsum(dim=1) - count
    n = int(rng.integers(1, int(first[:, -1].max()) + 1200))
    count = torch.where(first < n, torch.clamp(count, max=n - first), 0)
    ph, base = int(rng.integers(0, 4)), 8 * int(rng.integers(0, 4))
    plan = tm.write_plan(first, count, n, ph)
    store = plan["store"]
    assert bool((store[1:] >= store[:-1]).all())
    _, at = torch.unique_consecutive(store, return_inverse=True)
    begin = torch.zeros(int(at.max()) + 1, dtype=torch.int64).scatter_reduce(
        0, at, plan["word"], "amin", include_self=False)
    assert torch.equal(plan["word"] - begin[at], plan["lane"])
    assert int(tm.store_sectors(plan, base).max()) <= 9
    lo, nn = plan["lo"], plan["n"]
    edge = (lo < 0) | (lo + 4 > nn)
    assert torch.equal(~plan["full"], edge)
    assert bool(((plan["lane"] == 0) | (lo + 4 >= nn) | ~edge).all())
    flat = torch.zeros(nseg * n + ph + 4, dtype=torch.int64)
    for m in range(4):
        ok = (lo + m >= 0) & (lo + m < nn)
        flat.index_add_(0, 4 * plan["word"][ok] + m, torch.ones_like(
            plan["word"][ok]))
    i = torch.arange(n)[None, :]
    mine = torch.zeros((nseg, n), dtype=torch.int64)
    for t in range(ntiles):
        mine += ((i >= first[:, t:t + 1]) &
                 (i < first[:, t:t + 1] + count[:, t:t + 1])).to(torch.int64)
    assert torch.equal(flat[ph: ph + nseg * n].reshape(nseg, n), mine)
    assert int(flat.sum()) == int(count.sum())


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
    ``unpack_tables`` the walk from every entry phase: all agree with the
    model, B2's decode also with the model's decode from the 25-phase
    tables."""
    x, nv = _rows(9)
    xt, nvt = torch.from_numpy(x), torch.from_numpy(nv)
    words, nwords, nbits = pack_encode(xt, nvt, None, 4, True, 900)
    model = tm.encode_tiled(xt, nvt, None, 4, True, 900)
    for a, b in zip((words, nwords, nbits), model):
        assert torch.equal(a, b)
    w = words[:, : int(nwords.max()) + 1].contiguous()
    assert torch.equal(unpack_decode(w, LENGTH + 40, 4),
                       tm.decode_tiled(w, LENGTH + 40, 4))
    assert torch.equal(unpack_decode(w, LENGTH + 40, 4),
                       tm.decode_tiled(w, LENGTH + 40, 4, oracle=True))
    assert torch.equal(unpack_tables(w, 4), tm.decode_tables(w, 4))
