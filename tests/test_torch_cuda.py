"""The port's CUDA kernels against their plain torch versions, on the card.

Every kernel output must equal its plain version's exactly (tolerance 0:
the codec is integer and lossless). The plain versions run on a CPU copy of
the same inputs. Each test skips without a CUDA card; run them on the card
with ``pytest tests/test_torch_cuda.py``. Imports no JAX.
"""

import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import deltarice_tpu_torch as dt
from deltarice_tpu_torch import codec
from deltarice_tpu_torch.models import get_profile
from deltarice_tpu_torch.native import native_compress, native_decompress
from deltarice_tpu_torch.ops import _kernels, prefilter
from deltarice_tpu_torch.ops import prefilter_model
from deltarice_tpu_torch.ops.prefilter_cuda import (
    iir_decode, iir_decode_serial)
from deltarice_tpu_torch.ops.concentrate_cuda import (
    DEAD,
    biased_plane,
    concentrate_packed,
    concentrate_wide,
    concentrate_wide16,
    staged_planes,
)
from deltarice_tpu_torch.ops.concentrate_tiled_cuda import (
    concentrate_tiled,
    concentrate_tiled_vd,
    decode_staging,
    tile,
    untile,
)
from deltarice_tpu_torch.ops.pack_cuda import pack_encode
from deltarice_tpu_torch.ops.rice import codeword_lengths_values, zigzag
from deltarice_tpu_torch.ops.prefilter import prefilter_encode
from deltarice_tpu_torch.ops import transpose_model
from deltarice_tpu_torch.ops.transpose_cuda import transpose2d
from deltarice_tpu_torch.ops.split_decode import _local_width
from deltarice_tpu_torch.ops.split_decode_cuda import (
    split_decode,
    split_decode_passes,
)
from deltarice_tpu_torch.ops.tiled_model import decode_entries, decode_tiled
from deltarice_tpu_torch.ops.unpack_cuda import (
    unpack_decode, unpack_decode_plain, unpack_tables)
import hostile_cases as hc
import plain_codec
from prefilter_cases import EDGES, GRID, blocked_grid, grid_filter, samples
from tiled_cases import CASES as TILED_CASES, KINDS as TILED_KINDS, planes
from tiled_cases import never_joining

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).parent / "data" / "golden"
SPIN_CYCLES = 400_000_000  # torch.cuda._sleep: about 0.2 s at H100 clocks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _nab(rows, length=7000, seed=0):
    return get_profile("nab").synthetic(rows, seed=seed, length=length)


def _escape_heavy(rows, length, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, (rows, length)).astype(np.int16)


def _both(fn, *args):
    """fn on CUDA copies and on CPU copies of the tensor args."""
    on = [a.cuda() if isinstance(a, torch.Tensor) else a for a in args]
    off = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    got = fn(*on)
    torch.cuda.synchronize()
    return got, fn(*off)


def _assert_same(got, want):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    assert got.device.type == "cuda"
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


# (dtype, shape, storage offset in elements): the Nab samples, the JAX
# package's batched shapes (blocks of 1024 segments), every row-pitch class
# (B % 8 and A % 8 for int16, B % 4 and A % 4 for 32-bit), pointers off
# their 16-byte boundary, and shapes at the grid's and the tiles' edges
_TRANSPOSE_CASES = (
    [(torch.int16, (2048, 7000), 0), (torch.int32, (2048, 1280), 0),
     (torch.uint32, (33, 65), 0), (torch.int16, (1, 1), 0),
     (torch.int32, (70000, 3), 0), (torch.uint32, (1, 1), 0),
     (torch.int16, (70000, 3), 0), (torch.int16, (3, 70000), 0),
     (torch.uint32, (70000, 3), 0), (torch.uint32, (3, 70000), 0),
     (torch.int16, (2, 1024, 7168), 0), (torch.int16, (2, 7168, 1024), 0),
     (torch.uint32, (2, 1024, 1280), 0), (torch.int32, (3, 130, 1024), 0),
     (torch.int16, (5, 33, 65), 0)]
    + [(torch.int16, (300, 1000 + r), 0) for r in range(8)]
    + [(torch.int16, (296 + r, 1000), 0) for r in range(1, 8)]
    + [(torch.uint32, (96, 500 + r), 0) for r in range(4)]
    + [(torch.uint32, (96 + r, 500), 0) for r in range(1, 4)]
    + [(torch.int16, (2048, 6999), 1), (torch.int16, (2048, 7000), 1),
       (torch.int16, (2, 64, 512), 3), (torch.int16, (2, 64, 512), 8),
       (torch.uint32, (96, 500), 1), (torch.uint32, (2, 64, 128), 2)])


def _transpose_input(dtype, shape, offset):
    """Seeded data on the card: a contiguous view ``offset`` elements into
    its storage."""
    rng = np.random.default_rng(0)
    n = int(np.prod(shape)) + offset
    if dtype == torch.int16:
        flat = torch.from_numpy(rng.integers(-2**15, 2**15, n).astype(np.int16))
    else:
        flat = torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32))
    xc = flat.cuda()[offset:].view(shape)
    if dtype == torch.uint32:
        xc = xc.view(torch.uint32)
    assert xc.data_ptr() % 16 == offset * xc.element_size() % 16
    return xc


@pytest.mark.parametrize("dtype,shape,offset", _TRANSPOSE_CASES, ids=str)
def test_transpose_matches_plain(cuda, dtype, shape, offset):
    """Equal to the plain version on a contiguous view ``offset`` elements
    into its storage, in one launch."""
    xc = _transpose_input(dtype, shape, offset)
    _kernels.reset_launches()
    got = transpose2d(xc)
    torch.cuda.synchronize()
    assert _kernels.launches["transpose2d"] == 1
    _assert_same(got, transpose2d(xc.cpu()))


@pytest.mark.parametrize("esize", [2, 4])
def test_transpose_geometry_is_the_models(cuda, esize):
    """The kernel's tile constants, as it reports them, are the plain
    model's."""
    import ctypes

    got = (ctypes.c_int64 * 9)()
    assert _kernels.library().dr_transpose_geometry(esize, got) == 0
    assert tuple(got) == transpose_model.geometry(esize)


@pytest.mark.parametrize(
    "dtype,shape,offset",
    [c for c in _TRANSPOSE_CASES if np.prod(c[1]) <= 400_000], ids=str)
def test_transpose_model_is_the_kernel(cuda, dtype, shape, offset):
    """The plain model takes the kernel's path (``dr_transpose2d``'s own
    choice) and gives its output."""
    xc = _transpose_input(dtype, shape, offset)
    got = transpose2d(xc)
    a, b = shape[-2:]
    vector = _kernels.library().dr_transpose_vector_path(
        xc.data_ptr(), got.data_ptr(), a, b, xc.element_size())
    want, path = transpose_model.transpose_model(xc.cpu(),
                                                 xc.data_ptr() % 16)
    assert path == ("vector" if vector else "edge")
    _assert_same(got, want)


@pytest.mark.parametrize("k", range(16))
def test_pack_encode_matches_plain_all_k(cuda, k):
    x = np.concatenate([_nab(40, 3000), _escape_heavy(8, 3000)])
    nv = np.full(48, 3000, np.int32)
    nv[::5] = np.arange(10) * 299  # short and empty segments
    cap = dt.RiceConfig(1 << k).max_words(3000)
    _assert_same(*_both(pack_encode, torch.from_numpy(x),
                        torch.from_numpy(nv), None, k, True, cap))


@pytest.mark.parametrize("diff,cap", [(True, 700), (True, 0), (False, 5469)])
def test_pack_encode_cap_prev0_and_prefiltered(cuda, diff, cap):
    x = np.concatenate([_nab(200), _escape_heavy(56, 7000)])
    rng = np.random.default_rng(2)
    p0 = torch.from_numpy(rng.integers(-32768, 32768, 256).astype(np.int32))
    nv = torch.full((256,), 7000, dtype=torch.int32)
    _assert_same(*_both(pack_encode, torch.from_numpy(x), nv, p0, 3, diff,
                        cap))


def _streams(x, k, width):
    """Plain-encoded segment-major streams of x with >= 1 zero pad word."""
    nv = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32)
    words, nwords, _ = pack_encode(torch.from_numpy(x), nv, None, k, True,
                                   width)
    assert int(nwords.max()) < width
    return words


@pytest.mark.parametrize("k", [0, 3, 7, 15])
def test_unpack_decode_matches_plain(cuda, k):
    x = np.concatenate([_nab(24, 2000), _escape_heavy(8, 2000)])
    words = _streams(x, k, 1600)
    for delta in (True, False):
        got, want = _both(unpack_decode, words, 2000, k, delta)
        _assert_same(got, want)
        if delta:
            assert np.array_equal(got.cpu().numpy(), x)


def test_unpack_decode_past_stream_end_matches_plain(cuda):
    # decoding more samples than a stream holds walks into the clamped
    # cursor; the garbage must still agree with the plain version
    words = _streams(_nab(64, 500), 3, 256)
    _assert_same(*_both(unpack_decode, words, 900, 3, True))


def _cut(words, nwords):
    """Streams cut to one zero pad word past the longest, as the decoder
    gathers them."""
    return words[:, : int(nwords.max()) + 1].contiguous()


@pytest.mark.parametrize("k", range(16))
def test_unpack_decode_matches_plain_all_k(cuda, k):
    x = np.concatenate([_nab(20, 3000), _escape_heavy(4, 3000)])
    nv = np.full(24, 3000, np.int32)
    nv[3], nv[7] = 0, 1111  # an empty and a short segment
    cap = dt.RiceConfig(1 << k).max_words(3000) + 1
    words, nwords, _ = pack_encode(torch.from_numpy(x), torch.from_numpy(nv),
                                   None, k, True, cap)
    words = _cut(words, nwords)
    for delta in (True, False):  # 3100 samples: past every stream's end
        _assert_same(*_both(unpack_decode, words, 3100, k, delta))


@pytest.mark.parametrize("k", [0, 3, 8, 15])
def test_unpack_tables_match_the_plain_model(cuda, k):
    """B2's first pass (every tile, every entry phase 0..24) against
    ``tiled_model.decode_tables``."""
    x = np.concatenate([_nab(6, 2000), _escape_heavy(2, 2000)])
    words = _streams(x, k, dt.RiceConfig(1 << k).max_words(2000) + 1)
    _assert_same(*_both(unpack_tables, words, k))


def test_unpack_decode_pad_only_and_cut_streams_match_plain(cuda):
    # W = 1 (the pad word alone, zero or not) and streams cut short of their
    # end: every sample past the clamp re-decodes the codeword there
    rng = np.random.default_rng(5)
    pad = torch.from_numpy(rng.integers(-2**31, 2**31, (40, 1)).astype(
        np.int32))
    pad[::3] = 0
    words = _streams(_nab(40, 2000), 3, 1200)
    for w in (pad, words[:, :2], words[:, :33], words[:, :70]):
        for delta in (True, False):
            _assert_same(*_both(unpack_decode, w.contiguous(), 700, 3, delta))


def _b2_entries(words, n_samples, k):
    """B2's first pass, checked and repaired, as a decode leaves it: ((nseg,
    ntiles, 4) int32 of (entry phase walked from, exit phase, codewords,
    wrapping int16 sum) of every tile, the tiles walked again), read from
    the start of the decode's scratch, where level 0's entries lie. A CPU
    tensor takes the plain model."""
    if not words.is_cuda:
        return decode_entries(words, k, n_samples)
    nseg, w = words.shape
    ntiles = max(-(-(w - 1) // 32), 0)
    lib = _kernels.library()
    nbytes = lib.dr_unpack_scratch_bytes(w, nseg)
    scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                          device=words.device)
    out = torch.empty((nseg, n_samples), dtype=torch.int16,
                      device=words.device)
    counter = torch.zeros((), dtype=torch.int64, device=words.device)
    rc = lib.dr_unpack_decode(
        words.data_ptr(), out.data_ptr(), scratch.data_ptr(), nbytes, w, nseg,
        n_samples, k, 1, counter.data_ptr(), _kernels.stream())
    assert rc == 0
    raw = scratch[: nseg * ntiles * 8].view(torch.int32).view(nseg, ntiles, 2)
    ent = torch.stack([(raw[..., 1] >> 8) & 0xFF, raw[..., 1] & 0xFF,
                       raw[..., 0], raw[..., 1] >> 16], dim=-1)
    return ent, int(counter.item())


def _entries_cases(k):
    """B2's first pass at k: Nab and escape-heavy rows with an empty and a
    short segment, past the streams' end and cut short of it, W = 1 and 2,
    and at k = 3 two streams that never meet phase 0's walk beside them:
    (words, n_samples) pairs."""
    x = np.concatenate([_nab(10, 2000), _escape_heavy(4, 2000)])
    nv = np.full(14, 2000, np.int32)
    nv[3], nv[7] = 0, 777
    cap = dt.RiceConfig(1 << k).max_words(2000) + 1
    words, nwords, _ = pack_encode(torch.from_numpy(x), torch.from_numpy(nv),
                                   None, k, True, cap)
    words = _cut(words, nwords)
    # 32 samples a word: every tile's first codeword below (a tile holds at
    # most 1024)
    cases = [(words, 2000), (words, 32 * words.shape[1]),
             (words[:, :1].contiguous(), 50),
             (words[:, :2].contiguous(), 50), (words[:, :70].contiguous(), 900)]
    if k == 3:
        nw = words.shape[1] - 1
        joined = np.concatenate([np.stack([never_joining(nw),
                                           never_joining(nw, 0x3FFFFFFF)]),
                                 words.numpy().view(np.uint32)])
        joined = torch.from_numpy(joined.view(np.int32))
        cases += [(joined, 2000), (joined, 8 * nw), (joined, 32 * (nw + 1))]
    return cases


@pytest.mark.parametrize("k", range(16))
def test_b2_entries_and_tiles_rejoined_match_the_plain_model(cuda, k):
    """B2's first pass with its check and repair: each tile's entry (the
    phase it was walked from, exit, codewords, sum) and the tiles walked
    again equal ``tiled_model.decode_entries``; where the streams never
    join, every tile from the third on is walked again."""
    for words, n in _entries_cases(k):
        got, want = _both(_b2_entries, words, n, k)
        _assert_same(got[0], want[0])
        assert got[1] == want[1], (n, got[1], want[1])
        if n == 32 * words.shape[1] and k == 3:  # the never-joining rows
            assert got[1] >= 2 * (got[0].shape[1] - 2)


def test_unpack_decode_never_joining_noptrex_row_and_misaligned_out(cuda):
    """Two 500,000-sample rows at k = 3 whose walk never meets phase 0's:
    every tile from the third is walked again, and the decode is exact
    (a 5- or 6-bit first codeword, then -4 each), also into outputs that
    start 2, 4 and 6 bytes off an 8-byte boundary (C2)."""
    nw, n = 62500, 499999  # the last codeword would run into the pad word
    words = torch.from_numpy(np.stack([
        never_joining(nw), never_joining(nw, 0x3FFFFFFF)]).view(np.int32))
    wc = words.cuda()
    first = np.array([-8, -12], np.int64)[:, None]
    want = first - 4 * np.arange(n, dtype=np.int64)[None, :]
    want = torch.from_numpy((((want + 0x8000) & 0xFFFF) - 0x8000).astype(
        np.int16))
    ntiles = -(-nw // 32)
    counter = torch.zeros((), dtype=torch.int64, device=cuda)
    lib = _kernels.library()
    nbytes = lib.dr_unpack_scratch_bytes(nw + 1, 2)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=cuda)
    for off in range(4):  # int16s past an 8-byte boundary
        buf = torch.zeros(2 * n + 8, dtype=torch.int16, device=cuda)
        out = buf[off: off + 2 * n]
        assert out.data_ptr() % 8 == 2 * off
        rc = lib.dr_unpack_decode(
            wc.data_ptr(), out.data_ptr(), scratch.data_ptr(), nbytes,
            nw + 1, 2, n, 3, 1, counter.data_ptr(), _kernels.stream())
        assert rc == 0
        torch.cuda.synchronize()
        assert torch.equal(out.view(2, n).cpu(), want), off
        assert int((buf[:off] != 0).sum() + (buf[off + 2 * n:] != 0).sum()) \
            == 0
    assert int(counter.item()) == 4 * 2 * (ntiles - 2)
    ent, rejoined = _b2_entries(wc, n, 3)
    assert rejoined == 2 * (ntiles - 2)
    assert torch.equal(ent[:, 2:, 0].cpu(), torch.tensor([[1], [2]]).expand(
        2, ntiles - 2).to(torch.int32))


def _b2_first_samples(words, n_samples, k):
    """Level 0 of a decode's scratch on the card: each tile's codewords (as
    walked from the phase it was walked from) and its first sample, both
    (nseg, ntiles) int64 (layout in ``csrc/unpack.cu``'s ``plan``)."""
    nseg, w = words.shape
    ntiles = max(-(-(w - 1) // 32), 0)
    lib = _kernels.library()
    nbytes = lib.dr_unpack_scratch_bytes(w, nseg)
    scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                          device=words.device)
    out = torch.empty((nseg, n_samples), dtype=torch.int16,
                      device=words.device)
    counter = torch.zeros((), dtype=torch.int64, device=words.device)
    rc = lib.dr_unpack_decode(
        words.data_ptr(), out.data_ptr(), scratch.data_ptr(), nbytes, w, nseg,
        n_samples, k, 1, counter.data_ptr(), _kernels.stream())
    assert rc == 0
    level = nseg * ntiles * 8
    tab = scratch[:level].view(torch.int32).view(nseg, ntiles, 2)
    ent = scratch[level: 2 * level].view(torch.int32).view(nseg, ntiles, 2)
    as_u32 = lambda t: t.cpu().to(torch.int64) & 0xFFFFFFFF  # noqa: E731
    return as_u32(tab[..., 0]), as_u32(ent[..., 0])


@pytest.mark.parametrize("k", [0, 3, 15])
def test_b2_first_samples_are_the_sums_of_the_counts(cuda, k):
    """What B2's decode pass reads of passes 1-3: below n_samples each
    tile's first sample plus its codewords is the next tile's first sample
    (the pass takes a tile's sample count from its entry), also where the
    check walked tiles again and where the streams never join; the decode
    equals the plain one."""
    for words, n in _entries_cases(k):
        wc = words.cuda()
        count, first = _b2_first_samples(wc, n, k)
        below = first[:, :-1] < n
        assert torch.equal((first[:, :-1] + count[:, :-1])[below],
                           first[:, 1:][below]), n
        _assert_same(*_both(unpack_decode, words, n, k, True))


def _warp_rows(k, tiles, seed=11):
    """Streams of 32 * tiles + 1 words (cut where longer) for B2's decode
    pass by warps: Nab rows, escape-heavy rows (escapes alone at small k),
    a constant row (every tile at 1024 / (k + 1) samples), a short and an
    empty segment."""
    x = np.concatenate([_nab(20, 3000, seed), _escape_heavy(6, 3000, seed)])
    x[5] = 321
    nv = np.full(26, 3000, np.int32)
    nv[3], nv[7] = 0, 1234
    words, _, _ = pack_encode(torch.from_numpy(x), torch.from_numpy(nv),
                              None, k, True, 32 * tiles + 1)
    return words


@pytest.mark.parametrize("tiles", [1, 31, 33, 40])
@pytest.mark.parametrize("k", [0, 3, 15])
def test_unpack_decode_across_warps_and_misaligned_out_match_plain(
        cuda, k, tiles):
    """B2's decode pass stores a warp's 32 tiles through shared memory:
    warps across rows of 1, 31, 33 and 40 tiles, tiles at the most samples
    and of escapes alone, samples cut inside a round (61) and inside a tile
    (200, 1061) and decoded past the streams' end, delta on and off, into
    outputs 0, 2, 4 and 6 bytes past an 8-byte boundary: equal to the plain
    decode, and nothing written outside the output."""
    words = _warp_rows(k, tiles)
    wc = words.cuda()
    nseg, w = words.shape
    lib = _kernels.library()
    nbytes = lib.dr_unpack_scratch_bytes(w, nseg)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=cuda)
    counter = torch.zeros((), dtype=torch.int64, device=cuda)
    for n in (61, 200, 1061, 3500):
        for delta in (True, False):
            want = unpack_decode_plain(words, n, k, delta)
            for off in range(4):
                buf = torch.full((nseg * n + 8,), 0x5A5A, dtype=torch.int16,
                                 device=cuda)
                out = buf[off: off + nseg * n]
                assert out.data_ptr() % 8 == 2 * off
                rc = lib.dr_unpack_decode(
                    wc.data_ptr(), out.data_ptr(), scratch.data_ptr(), nbytes,
                    w, nseg, n, k, int(delta), counter.data_ptr(),
                    _kernels.stream())
                assert rc == 0
                torch.cuda.synchronize()
                assert torch.equal(out.view(nseg, n).cpu(), want), (n, delta,
                                                                    off)
                outside = torch.cat([buf[:off], buf[off + nseg * n:]])
                assert bool((outside == 0x5A5A).all()), (n, delta, off)


@pytest.mark.parametrize("name,rows,width", [("nab", 2048, 1280),
                                             ("noptrex", 8, 65792)])
def test_tiles_rejoined_on_profile_batches_is_the_oracles(cuda, name, rows,
                                                          width):
    """On Nab- and NOPTREX-profile streams in the benchmark's planes (zero
    padding to a multiple of 256 words) the counter that
    ``tracing.snapshot()`` reads equals the tiles whose assumed entry is
    wrong below the samples, by the walk from every entry phase
    (``unpack_tables``) chained tile after tile; the decode gives the
    samples back. The zero padding never joins, so decoding past the
    streams' end walks its tiles again."""
    from deltarice_tpu_torch import tracing
    from deltarice_tpu_torch.ops.tiled_model import entry_states_serial

    prof = get_profile(name)
    x = torch.from_numpy(prof.synthetic(rows, seed=5))
    length, k = x.shape[1], prof.config.k
    nv = torch.full((rows,), length, dtype=torch.int32)
    words, nwords = dt.encode_segments(x, nv, prof.config, width,
                                       device="cuda")
    assert int(nwords.max()) < width
    tab = unpack_tables(words, k)
    states = entry_states_serial(tab)
    assumed = torch.zeros_like(states[..., 0])
    assumed[:, 1:] = tab[:, :-1, 0, 0]
    wrong = states[..., 0] != assumed
    for n in (length, length + 2000):
        tracing.clear()
        out = dt.decode_segments(words, n, prof.config, device="cuda")
        assert torch.equal(out[:, :length].cpu(), x)
        got = tracing.snapshot()["counters"].get("tiles_rejoined", 0)
        want = int((wrong & (states[..., 1] < n)).sum())
        print(f"{name} ({rows}, {width}) n={n}: tiles_rejoined {got} of "
              f"{wrong.numel()} tiles ({got / wrong.numel():.2e})")
        assert got == want
        if n > length:
            assert got > 0
    tracing.clear()


def test_tiles_rejoined_adds_no_synchronisation_with_tracing_off(cuda):
    """A decode queues its launches with tracing off and the device counter
    read by no one: under ``torch.cuda.set_sync_debug_mode("error")`` no
    call synchronises; the counter is read once, by ``snapshot()``."""
    from deltarice_tpu_torch import tracing

    nw = 300
    words = torch.from_numpy(np.stack([never_joining(nw)]).view(
        np.int32)).cuda()
    tracing.clear()
    assert not tracing.on()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            unpack_decode(words, 8 * nw - 2, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ntiles = -(-nw // 32)
    assert tracing.snapshot()["counters"]["tiles_rejoined"] == 3 * (ntiles - 2)
    tracing.clear()
    assert "tiles_rejoined" not in tracing.snapshot()["counters"]


def test_tiled_codec_at_a_noptrex_segment(cuda):
    """B1 and B2 on two 500,000-sample NOPTREX segments: B1 against its
    plain version, B2 against the samples and, past the streams' end,
    against the plain model of its tiled passes."""
    prof = get_profile("noptrex")
    x = torch.from_numpy(prof.synthetic(2, seed=4))
    k, length = prof.config.k, x.shape[1]
    nv = torch.full((2,), length, dtype=torch.int32)
    got, want = _both(pack_encode, x, nv, None, k, True,
                      prof.config.max_words(length) + 1)
    _assert_same(got, want)
    words = _cut(want[0], want[1])
    out = unpack_decode(words.cuda(), length + 2000, k).cpu()
    assert torch.equal(out[:, :length], x)
    assert torch.equal(out, decode_tiled(words, length + 2000, k))


def test_concentrate_matches_plain(cuda):
    x = torch.from_numpy(np.concatenate([_nab(250), _escape_heavy(6, 7000)]))
    lens, _ = codeword_lengths_values(zigzag(prefilter_encode(x)), 3)
    nv = torch.full((256,), 7000, dtype=torch.int32)
    words, nwords, _ = pack_encode(x, nv, None, 3, True, 5469)
    lead, follow = staged_planes(lens, words, 7168)
    got, want = _both(lambda a, b: concentrate_packed((a, b), 5469, True),
                      lead, follow)
    _assert_same(got, want)
    assert torch.equal(want, words)
    narrow = _both(lambda a: concentrate_packed((a,), 5469, False), lead)
    _assert_same(*narrow)


def _packed_planes(rows, r, density, seed, gaps=0.0):
    """Random (lead, follow) planes: live slots with strictly increasing
    destinations, dead slots INT32_MIN, and, with ``gaps``, that share of
    the dead slots leaving a column that nothing reaches."""
    rng = np.random.default_rng(seed)
    u = rng.random((rows, r))
    valid = u < density
    gap = ~valid & (u < density + gaps * (1 - density))
    dest = np.cumsum(valid, axis=1) - 1 + np.cumsum(gap, axis=1)
    disp = np.arange(r)[None, :] - dest
    vals = rng.integers(-2**31, 2**31, (rows, r), dtype=np.int64)
    lead = np.where(valid, (disp << 16) | ((vals >> 16) & 0xFFFF),
                    DEAD).astype(np.int32)
    follow = (((vals & 0xFFFF) ^ 0x8000) - 0x8000).astype(np.int16)
    return (torch.from_numpy(lead), torch.from_numpy(follow),
            int(np.where(valid, dest, -1).max()) + 1)


@pytest.mark.parametrize("rows,r,density,gaps,extra,offset", [
    (256, 16384, 0.97, 0.0, 0, 0),    # the nEDM merge: fewer rows than SMs x 2
    (100, 7168, 0.2, 0.5, 40, 0),     # unreached columns inside and after
    (64, 7000, 0.5, 0.1, -300, 0),    # destinations past n_out dropped
    (130, 4099, 0.3, 0.2, 7, 0),      # ragged tile, scalar loads
    (40, 2048, 0.6, 0.3, 3, 1),       # a base off 16-byte alignment
])
def test_concentrate_packed_cases_match_plain(cuda, rows, r, density, gaps,
                                              extra, offset):
    lead, follow, n_live = _packed_planes(rows, r, density, r, gaps)
    n_out = n_live + extra

    def shifted(t):  # the same plane at a base off 16-byte alignment
        return torch.cat([t.new_zeros(offset), t.flatten()])[offset:].view(
            t.shape)

    for wide in (True, False):
        planes = (lead, follow) if wide else (lead,)
        got, want = _both(lambda *p: concentrate_packed(
            tuple(map(shifted, p)), n_out, wide), *planes)
        _assert_same(got, want)
    assert int((want == 0).sum()) > 0  # some columns nothing reaches


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    xt = torch.zeros((4, 16), dtype=torch.int16, device=cuda)
    nv = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        pack_encode(xt.to(torch.int32), nv, None, 3, True, 8)
    with pytest.raises(ValueError):
        pack_encode(xt, nv.cpu(), None, 3, True, 8)
    with pytest.raises(ValueError):
        pack_encode(xt.t(), nv, None, 3, True, 8)
    with pytest.raises(ValueError):
        unpack_decode(torch.zeros((4, 0), dtype=torch.int32, device=cuda), 4, 3)
    with pytest.raises(TypeError):
        transpose2d(torch.zeros((2, 2), dtype=torch.float32, device=cuda))


@pytest.mark.parametrize("case", json.loads((GOLDEN / "manifest.json").read_text()),
                         ids=lambda c: c["name"])
def test_golden_on_card(cuda, case):
    cfg = dt.RiceConfig.from_cd_values(case["cd_values"])
    data = np.load(GOLDEN / f"{case['name']}.npy")
    golden = (GOLDEN / f"{case['name']}.bin").read_bytes()
    assert dt.compress(data, cfg, device="cuda") == golden
    assert np.array_equal(dt.decompress(golden, cfg, device="cuda"), data)


def test_batch_matches_native_and_counts_launches(cuda):
    chunks = _nab(128).reshape(4, 32, 7000)
    cfg = dt.RiceConfig(8, 7000)
    _kernels.reset_launches()
    streams = dt.compress_batch(list(chunks), cfg, device="cuda")
    back = dt.decompress_batch(streams, cfg, device="cuda")
    counts = dict(_kernels.launches)
    for c, s, b in zip(chunks, streams, back):
        assert s == native_compress(c, cfg.to_cd_values())
        assert np.array_equal(b, c.ravel())
    assert counts["pack_encode"] >= 1 and counts["unpack_decode"] >= 1
    # B1 and B2 take the codec's segment-major layout: no transpose
    assert counts.get("transpose2d", 0) == 0


def _planes(rows, r, density, seed, dtype=np.int16):
    """Random monotone conflict-free (values, disp) planes and n_out."""
    rng = np.random.default_rng(seed)
    valid = rng.random((rows, r)) < density
    dest = np.cumsum(valid, axis=1) - 1
    disp = np.where(valid, np.arange(r)[None, :] - dest, -1).astype(np.int32)
    vals = rng.integers(-2**31, 2**31, (rows, r)).astype(dtype)
    return (torch.from_numpy(vals), torch.from_numpy(disp),
            max(int(valid.sum(axis=1).max()), 1))


@pytest.mark.parametrize("rows,r,dtype", [
    (256, 65536, np.int32),    # the NOPTREX merge's slot axis
    (24, 70000, np.int16),
    (8, 300000, np.int32),
])
def test_concentrate_wide_matches_plain(cuda, rows, r, dtype):
    vals, disp, n_out = _planes(rows, r, 0.45, r, dtype)
    _assert_same(*_both(concentrate_wide, vals, disp, n_out + 5))


def test_concentrate_wide_huge_displacement(cuda):
    r = 300000
    vals = torch.zeros((8, r), dtype=torch.int32)
    disp = torch.full((8, r), -1, dtype=torch.int32)
    vals[:, r - 1] = torch.arange(8) + 7
    disp[:, r - 1] = r - 1
    got, want = _both(concentrate_wide, vals, disp, 4)
    _assert_same(got, want)
    assert torch.equal(want[:, 0], torch.arange(8, dtype=torch.int32) + 7)


@pytest.mark.parametrize("rows,r,density", [(64, 4 * 23040, 0.9),
                                            (16, 565248, 0.95),
                                            (24, 49152, 0.5)])
def test_concentrate_wide16_matches_plain(cuda, rows, r, density):
    vals, disp, n_out = _planes(rows, r, density, r)
    assert int(disp.max()) < (1 << 16)
    plane = torch.where(disp >= 0, biased_plane(disp.clamp(min=0),
                                                vals.to(torch.int32) & 0xFFFF),
                        DEAD)
    _assert_same(*_both(concentrate_wide16, plane, n_out))


def test_concentrate_wide16_dead_collision(cuda):
    plane = torch.full((8, 40000), DEAD, dtype=torch.int32)
    plane[:, 0] = DEAD  # a live 0 at displacement 0
    plane[:, 5] = biased_plane(torch.tensor(4), torch.tensor(1234))
    got, want = _both(concentrate_wide16, plane, 4)
    _assert_same(got, want)
    assert want[:, 0].eq(0).all() and want[:, 1].eq(1234).all()


@pytest.mark.parametrize("k,delta,parts", [(3, True, 8), (4, True, 4),
                                           (3, False, 8), (1, True, 8)])
def test_split_decode_matches_plain(cuda, k, delta, parts):
    length = 16000
    x = np.concatenate([get_profile("noptrex").synthetic(7, seed=k,
                                                         length=length),
                        _escape_heavy(1, length)])
    nv = torch.full((8,), length, dtype=torch.int32)
    cap = dt.RiceConfig(1 << k).max_words(length) + 1
    words, nwords, _ = pack_encode(torch.from_numpy(x), nv, None, k, True, cap)
    args = _split_args(words, nwords, parts, 24, _local_width(length, parts),
                       k, delta)
    _assert_same(*_both(split_decode, *args))


def _split_args(words, nwords, parts, halo, lw, k, delta=True):
    """B9's arguments for segment-major streams: words cut to one zero pad
    word past the longest, each sub-block's owned words."""
    words = _cut(words, nwords)
    counts = nwords.to(torch.int64)
    wsub = -(-int(counts.max()) // parts)
    wv = (counts[:, None] - torch.arange(parts) * wsub).clamp(0, wsub)
    return (words, wv.reshape(-1).to(torch.int32), parts, wsub, halo, lw, k,
            delta)


def _never_sync(rows, length):
    """1, 0, -1, -2, ...: at k=1 no speculation ever meets the stream."""
    x = (1 - np.arange(length, dtype=np.int64)).astype(np.int16)
    return np.broadcast_to(x, (rows, length)).copy()


@pytest.mark.parametrize("case", ["never-sync", "wide-window", "short",
                                  "overrun", "k0", "k15", "noptrex-p32",
                                  "odd-rows"])
def test_split_decode_cases_match_plain(cuda, case):
    """B9 on segment-major words against the serial walk: a stream that
    never resynchronises (every stretch walked again), windows of several
    shared-memory stages, sub-blocks owning no words, counts past lw, the
    extreme k, the NOPTREX shape's 32 parts, and a row count that leaves
    warps of the last block without a row."""
    k, parts, halo, lw = 3, 4, 24, None
    length = 40000 if case == "wide-window" else 16000
    if case == "never-sync":
        x, k = _never_sync(4, length), 1
    elif case == "k15":
        x, k, parts = _escape_heavy(4, 3000), 15, 2
    else:
        rows = {"wide-window": 2, "noptrex-p32": 4, "odd-rows": 3}.get(
            case, 8)
        x = get_profile("noptrex").synthetic(rows, seed=1, length=length)
        if case == "wide-window":
            parts = 2
        elif case == "k0":
            k, x = 0, x // 64
        elif case == "noptrex-p32":
            parts, halo = 32, 8
        elif case == "odd-rows":
            parts = 3  # 9 rows: the third block of 4 warps holds one
        elif case == "overrun":
            lw = 256
    length = x.shape[1]
    nv = torch.full((x.shape[0],), length, dtype=torch.int32)
    if case == "short":
        nv[::3] = torch.tensor([0, 4000, 9000])[: len(nv[::3])]
    cap = dt.RiceConfig(1 << k).max_words(length) + 1
    words, nwords, _ = pack_encode(torch.from_numpy(x), nv, None, k, True,
                                   cap)
    lw = _local_width(length, parts) if lw is None else lw
    args = _split_args(words, nwords, parts, halo, lw, k)
    got, want = _both(split_decode, *args)
    _assert_same(got, want)
    if case == "wide-window":
        assert args[3] > 4 * 512
    if case == "short":
        assert int((args[1] == 0).sum()) > 0
    if case == "overrun":
        assert int(want[1][2].max()) > lw


def test_split_decode_passes_launch(cuda):
    """The pass-timing launches run (staging, + A, + B) and the whole one
    equals split_decode."""
    x = get_profile("noptrex").synthetic(4, seed=2, length=16000)
    nv = torch.full((4,), 16000, dtype=torch.int32)
    words, nwords, _ = pack_encode(torch.from_numpy(x), nv, None, 3, True,
                                   dt.RiceConfig(8).max_words(16000) + 1)
    args = [a.cuda() if isinstance(a, torch.Tensor) else a
            for a in _split_args(words, nwords, 8, 8,
                                 _local_width(16000, 8), 3)]
    for passes in (1, 2, 3):
        split_decode_passes(*args, passes)
    torch.cuda.synchronize()
    with pytest.raises(ValueError):
        split_decode_passes(*[a.cpu() if isinstance(a, torch.Tensor) else a
                              for a in args], 4)
    _assert_same(split_decode(*args), split_decode(*[
        a.cpu() if isinstance(a, torch.Tensor) else a for a in args]))


def _long_chunk(name):
    prof = get_profile(name)
    return prof.synthetic(32, seed=0), prof.config


@pytest.mark.parametrize("name,merge", [("nedm", "concentrate_packed"),
                                        ("noptrex", "concentrate_wide")])
def test_long_chunk_round_trip_matches_native(cuda, name, merge, monkeypatch):
    chunk, cfg = _long_chunk(name)
    cd = cfg.to_cd_values()
    _kernels.reset_launches()
    stream = dt.compress_batch([chunk], cfg, device="cuda")[0]
    assert stream == native_compress(chunk, cd)
    # B1 encodes the rows whole: no sub-stream merge runs
    assert _kernels.launches[merge] == 0
    assert _kernels.launches["pack_encode"] == 1
    monkeypatch.delenv("DELTARICE_TPU_SPLIT_DECODE", raising=False)
    assert np.array_equal(dt.decompress(stream, cfg, device="cuda"),
                          chunk.ravel())
    monkeypatch.setenv("DELTARICE_TPU_SPLIT_DECODE", "1")
    _kernels.reset_launches()
    # one chunk is below the router's lane target: decode 8 copies
    back = dt.decompress_batch([stream] * 8, cfg, device="cuda")
    assert all(np.array_equal(b, chunk.ravel()) for b in back)
    assert _kernels.launches["split_decode"] == 1
    assert _kernels.launches["concentrate_wide16"] == 1
    # B9 reads the codec's segment-major words: no transpose on any path
    assert _kernels.launches["transpose2d"] == 0


def _tiled_planes(nseg, r, density, sb, seed, bias=False):
    """Tiled (lead, follow, values, disp) planes of random monotone
    conflict-free rows, and n_out."""
    vals, disp, n_out = _planes(nseg, r, density, seed, np.int32)
    hi = (vals.to(torch.int64) >> 16) & 0xFFFF
    if bias:
        lead = torch.where(disp >= 0, biased_plane(disp.clamp(min=0), hi),
                           DEAD)
    else:
        lead = torch.where(disp >= 0, (disp << 16) | hi.to(torch.int32), DEAD)
    follow = (((vals.to(torch.int64) & 0xFFFF) ^ 0x8000) - 0x8000).to(
        torch.int16)
    return (tile(lead, sb, DEAD), tile(follow, sb, 0),
            tile(follow, sb, 0), tile(disp, sb, -1), n_out)


@pytest.mark.parametrize("nseg,r,density,sb,emit,bias", [
    (1024, 5000, 0.7, 8, "int16", False),
    (300, 20000, 0.9, 2, "u32", False),
    (128, 90000, 0.8, 1, "int16", True),    # nEDM-like biased staging
    (256, 60000, 0.5, 2, "u32", True),
])
def test_concentrate_tiled_matches_plain(cuda, nseg, r, density, sb, emit,
                                         bias):
    lead, follow, _v, _d, n_out = _tiled_planes(nseg, r, density, sb, r,
                                                bias)
    planes = (lead,) if bias or emit == "int16" else (lead, follow)
    got, want = _both(lambda *p: concentrate_tiled(p, n_out + 3, sb, emit,
                                                   bias), *planes)
    _assert_same(got, want)


def test_concentrate_tiled_bias_dead_collision(cuda):
    plane = torch.full((128, 3000), DEAD, dtype=torch.int32)
    plane[:, 5] = biased_plane(torch.tensor(4), torch.tensor(1234))
    got, want = _both(lambda p: concentrate_tiled((p,), 4, 1, bias=True),
                      tile(plane, 1, DEAD))
    _assert_same(got, want)
    back = untile(want, 128, 1)
    assert back[:, 0].eq(0).all() and back[:, 1].eq(1234).all()


@pytest.mark.parametrize("nseg,r,density,sb", [
    (128, 520192, 0.95, 1),   # the NOPTREX decode staging's slot axis
    (2048, 1200, 0.4, 8),
    (256, 6000, 0.4, 2),
])
def test_concentrate_tiled_vd_matches_plain(cuda, nseg, r, density, sb):
    _l, _f, values, disp, n_out = _tiled_planes(nseg, r, density, sb, r)
    _assert_same(*_both(concentrate_tiled_vd, values, disp, n_out, sb))


def _tiled_fn(kind, n_out, sb):
    if kind == "vd":
        return lambda *p: concentrate_tiled_vd(*p, n_out, sb)
    emit = "u32" if kind == "u32" else "int16"
    return lambda *p: concentrate_tiled(p, n_out, sb, emit, kind == "bias")


@pytest.mark.parametrize("kind", TILED_KINDS)
@pytest.mark.parametrize("case", sorted(TILED_CASES))
def test_concentrate_tiled_edge_cases_match_plain(cuda, case, kind):
    """B7 and B8 on ``tests/tiled_cases.py``'s edge cases at four times
    their CPU length: many spans, 16-byte and one-element loads."""
    ps, _rows, sb, n_out, _lanes = planes(case, kind, scale=4)
    name = "concentrate_tiled_vd" if kind == "vd" else "concentrate_tiled"
    _kernels.reset_launches()
    _assert_same(*_both(_tiled_fn(kind, n_out, sb), *ps))
    assert _kernels.launches[name] == 1


def _misaligned(t):
    """A contiguous copy of ``t`` one element past an aligned start."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.flatten()
    return flat[1:].view(t.shape)


@pytest.mark.parametrize("kind", TILED_KINDS)
def test_concentrate_tiled_misaligned_planes_match_plain(cuda, kind):
    """Planes that start off a 16-byte boundary take one-element loads."""
    ps, _rows, sb, n_out, _lanes = planes("ragged", kind, scale=2)
    ps = tuple(_misaligned(p.cuda()) for p in ps)
    _assert_same(*_both(_tiled_fn(kind, n_out, sb), *ps))


@pytest.mark.parametrize("mode", ["packed", "bias", "vd"])
def test_decode_staging_concentrates_to_the_samples(cuda, mode):
    k, length, nseg, sb = 4, 20000, 64, 1
    x = torch.from_numpy(get_profile("nedm").synthetic(nseg, seed=1,
                                                       length=length))
    j = 7  # codeword starts per word at k = 4
    wc = 512 if mode == "vd" else 1024
    w = int(_streams(x.numpy(), k, dt.RiceConfig(1 << k).max_words(length)
                     + 1).shape[1])
    planes = decode_staging(x.cuda(), k, w, j, wc, sb, mode)
    if mode == "vd":
        got, want = _both(lambda *p: concentrate_tiled_vd(*p, length, sb),
                          *planes)
    else:
        got, want = _both(lambda p: concentrate_tiled(
            (p,), length, sb, bias=mode == "bias"), *planes)
    _assert_same(got, want)
    assert torch.equal(untile(want, nseg, sb)[:, :length], x)


class _Plist:
    def __init__(self, filters):
        self._filters = filters

    def get_nfilters(self):
        return len(self._filters)

    def get_filter(self, i):
        return self._filters[i]


class _DatasetID:
    def __init__(self, filters):
        self.chunks = {}
        self._plist = _Plist(filters)

    def write_direct_chunk(self, offset, data, filter_mask=0):
        self.chunks[tuple(offset)] = (filter_mask, bytes(data))

    def read_direct_chunk(self, offset):
        return self.chunks[tuple(offset)]

    def get_create_plist(self):
        return self._plist


class _Dataset:
    def __init__(self, name, shape, dtype, chunks, filters):
        self.name, self.shape, self.chunks = name, tuple(shape), tuple(chunks)
        self.dtype = np.dtype(dtype)
        self.id = _DatasetID(filters)


class _Group:
    """In-memory direct-chunk store with the surface ``h5`` uses (the
    card's machine has no h5py); the same as ``chip_smoke.py``'s."""

    def __init__(self):
        self.datasets = {}

    def create_dataset(self, name, shape, dtype, chunks, compression,
                       compression_opts, allow_unknown_filter=False):
        self.datasets[name] = _Dataset(
            name, shape, dtype, chunks,
            [(compression, 0, tuple(compression_opts), b"deltarice")])
        return self.datasets[name]

    def __getitem__(self, name):
        return self.datasets[name]


@pytest.mark.parametrize("name,rows,batch", [("nab", 150, 2),
                                             ("noptrex", 96, 1)])
def test_h5_window_pipeline_matches_native(cuda, name, rows, batch,
                                           monkeypatch):
    from deltarice_tpu_torch import h5

    prof = get_profile(name)
    x = prof.synthetic(rows, seed=3)
    cfg = prof.config
    store = _Group()
    dset = h5.write_dataset(store, "d", x, cfg, (32, x.shape[1]),
                            batch_chunks=batch, verify=name == "nab",
                            device="cuda")
    assert len(dset.id.chunks) == -(-rows // 32)
    for off, (mask, blob) in dset.id.chunks.items():
        full = np.zeros((32, x.shape[1]), np.int16)
        part = x[off[0]: off[0] + 32]
        full[: len(part)] = part
        assert mask == 0 and blob == native_compress(full, cfg.to_cd_values())
    for split in ("0", "1"):
        monkeypatch.setenv("DELTARICE_TPU_SPLIT_DECODE", split)
        assert np.array_equal(h5.read_dataset(store["d"], batch_chunks=batch,
                                              device="cuda"), x)


def test_collect_does_not_wait_for_the_next_window(cuda, monkeypatch):
    """Collect of a Nab encode window returns while a later NOPTREX decode
    bucket still runs: the bucket is queued behind a spin kernel of about
    0.2 s, so the check does not depend on how fast B2 is."""
    monkeypatch.delenv("DELTARICE_TPU_SPLIT_DECODE", raising=False)
    nab_cfg = get_profile("nab").config
    opt_cfg = get_profile("noptrex").config
    opt_chunk = get_profile("noptrex").synthetic(32, seed=0)
    blobs = dt.compress_batch([opt_chunk, opt_chunk], opt_cfg, device="cuda")
    chunks = list(_nab(16 * 32).reshape(16, 32, 7000))
    dt.decompress_batch(blobs, opt_cfg, device="cuda")  # warm the caches
    torch.cuda.synchronize()
    enc = codec.compress_batch_dispatch(chunks, nab_cfg, "cuda")
    torch.cuda._sleep(SPIN_CYCLES)
    dec = codec.decompress_batch_dispatch(blobs, opt_cfg, "cuda")
    streams = codec.compress_batch_collect(enc, nab_cfg)
    assert not dec[2][3].query()
    back = codec.decompress_batch_collect(dec)
    for c, s in zip(chunks, streams):
        assert s == native_compress(c, nab_cfg.to_cd_values())
    assert all(np.array_equal(b, opt_chunk.ravel()) for b in back)


@pytest.mark.parametrize("n_taps", [2, 3])
def test_optimize_on_the_card_equals_the_cpu(cuda, n_taps):
    from deltarice_tpu_torch import optimize as opt

    x = _nab(64)
    got = opt.optimize(x, n_taps=n_taps, device="cuda")
    assert got == opt.optimize(x, n_taps=n_taps, device="cpu")
    b_gpu = opt.expected_bits(x, got.m, got.filt, device="cuda")
    b_cpu = opt.expected_bits(x, got.m, got.filt, device="cpu")
    assert abs(b_gpu - b_cpu) <= 1e-6 * b_cpu


def test_over_cap_rows_reencode_on_the_collect_stream(cuda, monkeypatch):
    # a cap below every row's word count: collect re-encodes every row at
    # the full bound, on its own stream, while a later window is queued
    chunks = list(_nab(96).reshape(3, 32, 7000))
    cfg = dt.RiceConfig(8, 7000)
    monkeypatch.setattr(codec, "_words_hint", lambda x, c, n: 256)
    first = codec.compress_batch_dispatch(chunks[:2], cfg, "cuda")
    later = codec.compress_batch_dispatch(chunks[2:], cfg, "cuda")
    streams = (codec.compress_batch_collect(first, cfg)
               + codec.compress_batch_collect(later, cfg))
    for c, s in zip(chunks, streams):
        assert s == native_compress(c, cfg.to_cd_values())


def test_one_rank_nccl_round_trip_matches_native(cuda, tmp_path,
                                                 monkeypatch):
    """A world of one over NCCL: the gathers run through the NCCL
    communicator, B1 and B2 launch, every stream equals native
    dr_compress and the decode gives the input back."""
    import torch.distributed as dist

    from deltarice_tpu_torch.parallel import chunk_mesh, roundtrip_check_step
    from deltarice_tpu_torch.parallel.multihost import (
        decode_chunks_multihost, encode_chunks_multihost,
        initialize_distributed)
    from deltarice_tpu_torch.parallel.sharded import put_sharded

    for var in ("WORLD_SIZE", "MASTER_ADDR", "SLURM_JOB_ID", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    x = _nab(5 * 32).reshape(5, 32, 7000)
    cfg = dt.RiceConfig(8, 7000)
    initialize_distributed(device="cuda:0", backend="nccl",
                           init_method=f"file://{tmp_path / 'store'}",
                           rank=0, world_size=1)
    try:
        mesh = chunk_mesh()
        assert mesh.group is not None and mesh.comm.type == "cuda"
        _kernels.reset_launches()
        streams = encode_chunks_multihost(x, cfg, mesh)
        back = decode_chunks_multihost(streams, cfg, mesh)
        nvalid = np.full((5, 32), 7000, np.int32)
        *_, bad = roundtrip_check_step(put_sharded(x, mesh),
                                       put_sharded(nvalid, mesh), cfg, mesh,
                                       cfg.max_words(7000))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    for c, s in zip(x, streams):
        assert s == native_compress(c, cfg.to_cd_values())
    np.testing.assert_array_equal(back, x.reshape(5, -1))
    assert bad == 0
    for name in ("pack_encode", "unpack_decode"):
        assert _kernels.launches[name] > 0
    assert _kernels.launches["transpose2d"] == 0


def test_sharded_step_on_the_card_counts_like_the_cpu(cuda):
    """roundtrip_check_step on the card and on the CPU: the same words up
    to nwords and the same lossy mismatch count (filter (8, -1) wraps
    int16 on Nab's largest samples)."""
    from deltarice_tpu_torch.parallel import chunk_mesh, roundtrip_check_step

    x = _nab(4 * 32).reshape(4, 32, 7000)
    nvalid = np.full((4, 32), 7000, np.int32)
    nvalid[-1, -1] = 3000
    cfg = dt.RiceConfig(8, 7000, (8, -1))
    width = cfg.max_words(7000)
    got = roundtrip_check_step(x, nvalid, cfg, chunk_mesh(), width)
    want = roundtrip_check_step(x, nvalid, cfg, chunk_mesh(device="cpu"),
                                width)
    assert got[2] == want[2] > 0
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())
    valid = (np.arange(width)[None, None, :]
             < want[1].numpy()[..., None])
    np.testing.assert_array_equal(np.where(valid, got[0].cpu().numpy(), 0),
                                  np.where(valid, want[0].numpy(), 0))


def _inverse_matches_plain(d: torch.Tensor, filt, block=None) -> str:
    """The generic inverse on the card (one call of one path, none for an
    empty input) equal to the plain version on a CPU copy; returns the
    path the call took."""
    before = dict(_kernels.launches)
    if block is None:
        got = prefilter.prefilter_decode(d.cuda(), filt)
    else:
        got = iir_decode(d.cuda(), filt, block)
    torch.cuda.synchronize()
    grew = {k: v - before.get(k, 0) for k, v in _kernels.launches.items()
            if v != before.get(k, 0)}
    paths = [k.split(".")[1] for k in grew if k.startswith("iir_decode.")]
    if d.numel() == 0:
        assert not grew
    else:
        n = d.shape[-1]
        want_path = prefilter_model.plan(tuple(filt), d.numel() // n, n,
                                         block)[0]
        assert grew == {"iir_decode": 1, f"iir_decode.{want_path}": 1}
    want = prefilter.iir_decode_plain(d.cpu(), filt)
    assert got.dtype == torch.int16 and got.shape == d.shape
    assert torch.equal(got.cpu(), want)
    return paths[0] if paths else ""


@pytest.mark.parametrize("ntaps,f0", GRID)
def test_iir_decode_matches_plain(cuda, ntaps, f0):
    # 70 rows: two whole warps and a partial one; 600 samples: two whole
    # tiles of 256 and a partial one, staged 16 bytes at a time
    _inverse_matches_plain(torch.from_numpy(samples((70, 600), ntaps)),
                           grid_filter(ntaps, f0))


@pytest.mark.parametrize("filt", EDGES, ids=str)
def test_iir_decode_division_edges_match_plain(cuda, filt):
    d = samples((40, 520), 7)
    d[0, :8] = -32768  # -32768 / -1 must wrap back to -32768
    _inverse_matches_plain(torch.from_numpy(d), filt)


@pytest.mark.parametrize("shape", [(33, 601), (5, 3), (1, 1), (4, 0),
                                   (0, 9), (2, 3, 50), (3, 2049)], ids=str)
@pytest.mark.parametrize("ntaps", [3, 12])
def test_iir_decode_shapes_match_plain(cuda, shape, ntaps):
    """Element-wise staging (601 samples), rows shorter than the filter,
    empty inputs, leading axes, a tile boundary plus one sample."""
    _inverse_matches_plain(torch.from_numpy(samples(shape, ntaps)),
                           grid_filter(ntaps, -1))


def test_iir_decode_misaligned_view_matches_plain(cuda):
    flat = torch.from_numpy(samples((40 * 512 + 1,), 9)).cuda()
    d = flat[1:].view(40, 512)  # contiguous, 2 bytes off 16-byte alignment
    assert d.data_ptr() % 16 == 2
    _inverse_matches_plain(d, (1, -1, 0, 1))


@pytest.mark.parametrize("ntaps", [9, 10, 200, 1024, 1025, 2500, 60000])
def test_iir_decode_long_filters_match_plain(cuda, ntaps):
    """9 taps: the blocked scan's longest filter. Past it the serial walk:
    taps and history in shared memory, beyond 48 KB of it from about 110
    taps; past the device's opt-in (about 1500 taps on an H100) the
    history ring in global memory and the taps read through L1. No length
    is refused."""
    filt = grid_filter(ntaps, 1)
    shape = (35, 300) if ntaps < 60000 else (3, 300)
    d = torch.from_numpy(samples(shape, ntaps))
    path = _inverse_matches_plain(d, filt)
    assert path == ("blocked" if ntaps <= 9 else "serial")
    ring = _kernels.library().dr_iir_ring_bytes(ntaps - 1, shape[0])
    assert (ring > 0) == (ntaps >= 2500)


@pytest.mark.parametrize("filt", [(1, -1, 0, 1), (8, -1)], ids=str)
def test_iir_decode_serial_matches_plain(cuda, filt):
    """The serial walk on demand, whatever path the filter routes to: the
    design the blocked scan replaced, which phase 13 times beside it."""
    d = torch.from_numpy(samples((70, 1600), 3))
    before = dict(_kernels.launches)
    got = iir_decode_serial(d.cuda(), filt)
    torch.cuda.synchronize()
    grew = {k: v - before.get(k, 0) for k, v in _kernels.launches.items()
            if v != before.get(k, 0)}
    assert grew == {"iir_decode_serial": 1}
    assert torch.equal(got.cpu(), prefilter.iir_decode_plain(d, filt))


@pytest.mark.parametrize("filt,block,n,rows", blocked_grid(), ids=str)
def test_iir_decode_blocked_grid_matches_plain(cuda, filt, block, n, rows):
    """The blocked scan (passes A, B, C; one walk where a row is one block
    or the filter has no history) at forced block lengths, on the grid the
    CPU tests hold its plain model to."""
    d = torch.from_numpy(samples((33, n), n)[:rows])
    path = _inverse_matches_plain(d, filt, block)
    nb = -(-n // block)
    assert path == ("blocked" if nb > 1 and len(filt) > 1 else "one_walk")


@pytest.mark.parametrize("filt", [(1, -1, 0, 1), (-1, 1)], ids=str)
def test_iir_decode_blocked_edges_match_plain(cuda, filt):
    """Element-wise staging (n % 8 != 0; a view off 16 bytes), and one row
    of 500,000 samples: 1954 blocks carried in chunks of 64 (the plain
    version on a prefix: the inverse is causal; the whole row must give
    back the samples it was filtered from)."""
    assert _inverse_matches_plain(
        torch.from_numpy(samples((40, 1203), 4)), filt) == "blocked"
    flat = torch.from_numpy(samples((40 * 1024 + 1,), 9)).cuda()
    view = flat[1:].view(40, 1024)
    assert view.data_ptr() % 16 == 2
    assert _inverse_matches_plain(view, filt, 256) == "blocked"
    x = torch.from_numpy(get_profile("noptrex").synthetic(1, seed=2))
    d = prefilter.prefilter_encode(x.cuda(), filt)
    got = prefilter.prefilter_decode(d, filt)
    torch.cuda.synchronize()
    assert prefilter_model.plan(filt, 1, x.shape[1])[:2] == ("blocked", 256)
    assert torch.equal(got.cpu(), x)
    want = prefilter.iir_decode_plain(d[:, :20000].cpu(), filt)
    assert torch.equal(got[:, :20000].cpu(), want)


def _forward_matches_plain(x, filt):
    """The forward filter on the card (``prefilter_encode``, one
    ``fir_encode`` launch, none for an empty input) against its plain
    version on a CPU copy."""
    before = dict(_kernels.launches)
    got = prefilter.prefilter_encode(x if x.is_cuda else x.cuda(), filt)
    torch.cuda.synchronize()
    grew = {k: v - before.get(k, 0) for k, v in _kernels.launches.items()
            if v != before.get(k, 0)}
    assert grew == ({"fir_encode": 1} if x.numel() else {})
    assert got.dtype == torch.int16 and got.shape == x.shape and got.is_cuda
    assert torch.equal(got.cpu(), prefilter.prefilter_encode_plain(x.cpu(),
                                                                   filt))


@pytest.mark.parametrize("ntaps,f0", GRID)
def test_fir_encode_matches_plain(cuda, ntaps, f0):
    # 601 samples a row: rows start inside vectors, the last vector short;
    # 70 rows: 42070 samples, six blocks
    _forward_matches_plain(torch.from_numpy(samples((70, 601), ntaps)),
                           grid_filter(ntaps, f0))


@pytest.mark.parametrize("filt", EDGES, ids=str)
def test_fir_encode_division_edges_match_plain(cuda, filt):
    _forward_matches_plain(torch.from_numpy(samples((40, 520), 7)), filt)


@pytest.mark.parametrize("shape", [(33, 601), (5, 3), (1, 1), (4, 0),
                                   (0, 9), (1001,), (2, 3, 50), (3, 8192),
                                   (1, 8193), (9, 7)], ids=str)
@pytest.mark.parametrize("ntaps", [3, 8, 12, 17])
def test_fir_encode_shapes_match_plain(cuda, shape, ntaps):
    """Rows shorter than the filter's halo, empty inputs, 1-D and 3-D
    inputs, a block of 8192 samples and one sample past it."""
    _forward_matches_plain(torch.from_numpy(samples(shape, ntaps)),
                           grid_filter(ntaps, -1))


@pytest.mark.parametrize("filt", [(1, 0, -1), (1, -1, 0, 1) * 3], ids=len)
def test_fir_encode_misaligned_view_matches_plain(cuda, filt):
    flat = torch.from_numpy(samples((40 * 512 + 1,), 9)).cuda()
    x = flat[1:].view(40, 512)  # contiguous, 2 bytes off 16-byte alignment
    assert x.data_ptr() % 16 == 2
    _forward_matches_plain(x, filt)


@pytest.mark.parametrize("ntaps", [8, 9, 16, 17, 200, 1100, 30000, 40000])
def test_fir_encode_long_filters_match_plain(cuda, ntaps):
    """8 taps: the last in registers. Past them every read, of the history
    and of the taps, from global memory. No length is refused."""
    filt = grid_filter(ntaps, 1)
    shape = (35, 300) if ntaps < 30000 else (3, 300)
    _forward_matches_plain(torch.from_numpy(samples(shape, ntaps)), filt)


def test_fir_encode_at_the_nab_opt_batch_matches_plain(cuda):
    """The 20000 x 7000 batch of ``nab_opt.vram_encode``, filter (1, 0,
    -1): one launch over 140 million samples."""
    x = torch.from_numpy(samples((20000, 7000), 23))
    _forward_matches_plain(x, (1, 0, -1))


def test_batch_with_a_long_filter_matches_native(cuda):
    """A filter of 1100 taps, longer than the 1024 the card once refused,
    through compress_batch / decompress_batch on the card."""
    rng = np.random.default_rng(5)
    filt = (1,) + tuple(int(c) for c in rng.integers(-3, 4, 1099))
    cfg = dt.RiceConfig(8, 2000, filt)
    cd = cfg.to_cd_values()
    chunks = _nab(16, length=2000).reshape(4, 4, 2000)
    _kernels.reset_launches()
    streams = dt.compress_batch(list(chunks), cfg, device="cuda")
    back = dt.decompress_batch(streams, cfg, device="cuda")
    assert _kernels.launches["iir_decode.serial"] >= 1
    for c, s, b in zip(chunks, streams, back):
        assert s == native_compress(c, cd)
        np.testing.assert_array_equal(b, native_decompress(s, cd))
        np.testing.assert_array_equal(b, c.ravel())


@pytest.mark.parametrize("filt", [(1, 0, -1), (8, -1)], ids=str)
def test_batch_with_a_generic_filter_matches_native(cuda, filt):
    cfg = dt.RiceConfig(8, 7000, filt)
    cd = cfg.to_cd_values()
    chunks = _nab(128).reshape(4, 32, 7000)
    _kernels.reset_launches()
    streams = dt.compress_batch(list(chunks), cfg, device="cuda")
    back = dt.decompress_batch(streams, cfg, device="cuda")
    assert _kernels.launches["iir_decode"] >= 1
    for c, s, b in zip(chunks, streams, back):
        assert s == native_compress(c, cd)
        np.testing.assert_array_equal(b, native_decompress(s, cd))
        if cfg.lossless:
            np.testing.assert_array_equal(b, c.ravel())


# --- hostile streams: corrupt words through the kernels and the codec -------
#
# tests/hostile_cases.py's corpus, which tests/test_torch_robustness.py holds
# against the JAX package on the CPU: every decode on the card must equal the
# port's CPU decode exactly, or both must raise ValueError; no other
# exception may escape, and the card must stay usable after every case.


def _hostile_nab(rows=32, seed=0):
    x = _nab(rows, seed=seed)
    return x, native_compress(x, (8, 7000))


def _plane(blob, nseg):
    """The decode plane of a stream that passes the header walk: (nseg, W)
    int32 words as the codec gathers them, and the word counts."""
    buf = np.frombuffer(blob, dtype="<u4")
    counts, starts = codec.walk_headers(buf, nseg)
    words = codec.gather_segments(buf, counts, starts)
    return torch.from_numpy(words.view(np.int32)), counts


@functools.lru_cache(maxsize=None)
def _hostile_check():
    return _hostile_nab(4, seed=9)


def _card_still_exact():
    """A later valid decode on the card is exact: the context survived."""
    torch.cuda.synchronize()
    x, blob = _hostile_check()
    got = dt.decompress(blob, dt.RiceConfig(8, 7000), device="cuda")
    assert np.array_equal(got, x.ravel())


@pytest.mark.parametrize("case", ["one segment", "payload random",
                                  "payload zeros", "payload ones"])
def test_unpack_decode_hostile_planes_match_plain(cuda, case):
    """B2 on the (e) and (f) planes of a Nab chunk: an escape-wide row
    holding the whole stream, and payloads no encoder wrote."""
    x, blob = _hostile_nab()
    cases = dict(hc.one_segment(blob, 32) + hc.bad_payloads(blob, 32))
    words, _counts = _plane(cases[case], 32)
    for delta in (True, False):
        _assert_same(*_both(unpack_decode, words, 7000, 3, delta))
    _card_still_exact()


@pytest.mark.parametrize("k", [0, 3, 8, 15])
def test_unpack_decode_hostile_narrow_and_full_rows_match_plain(cuda, k):
    """B2 on random rows of width 2 (one word and the pad, zero or not)
    and on random streams that fill their row up to the pad word."""
    rng = np.random.default_rng(k)
    two = rng.integers(-2**31, 2**31, (64, 2)).astype(np.int32)
    two[::2, 1] = 0
    full = rng.integers(-2**31, 2**31, (16, 256)).astype(np.int32)
    full[:, -1] = 0
    for w, n in ((two, 100), (full, 3000), (full, 9000)):
        for delta in (True, False):
            _assert_same(*_both(unpack_decode, torch.from_numpy(w), n, k,
                                delta))
    _card_still_exact()


def _hostile_long():
    """The long-segment case (h) of tests/test_torch_robustness.py: a
    NOPTREX-like chunk of 8 segments of 12000 samples, M=8, its flips
    and bad payloads."""
    x = get_profile("noptrex").synthetic(8, seed=0, length=12000)
    blob = native_compress(x, (8, 12000))
    return x, blob, hc.flips(blob, 40) + hc.bad_payloads(blob, 8)


def test_split_decode_hostile_matches_plain(cuda):
    """B9 + B6 (``unpack_decode_split``) on the flipped and bad-payload
    long-segment streams, in one plane, flags included."""
    from deltarice_tpu_torch.ops.split_decode import unpack_decode_split

    _x, _blob, cases = _hostile_long()
    planes = [_plane(s, 8) for s in hc.batchable([s for _n, s in cases], 8,
                                                 8 * 12000)]
    width = max(p[0].shape[1] for p in planes)
    words = torch.cat([torch.nn.functional.pad(w, (0, width - w.shape[1]))
                       for w, _c in planes])
    counts = np.concatenate([c for _w, c in planes])
    got, want = _both(lambda w: unpack_decode_split(w, counts, 12000, 3,
                                                    True, 4), words)
    _assert_same(got, want)
    assert bool(want[1].any())  # bad payloads break junctions
    _card_still_exact()


@pytest.mark.parametrize("filt", hc.GENERIC_FILTERS, ids=str)
def test_iir_decode_on_garbage_decodes_matches_plain(cuda, filt):
    """The generic inverse (blocked for the lossless filter, serial for the
    lossy one) on what B2 gives for the flipped streams of (g)."""
    cd = (8, 7000, len(filt), *[f & 0xFFFFFFFF for f in filt])
    cfg = dt.RiceConfig.from_cd_values(cd)
    x = _nab(32, seed=4)
    blob = native_compress(x, cd)
    cases = hc.flips(blob, 24) + hc.bad_payloads(blob, 32)
    planes = [_plane(s, 32)[0]
              for s in hc.batchable([s for _n, s in cases], 32, x.size)]
    width = max(p.shape[1] for p in planes)
    words = torch.cat([torch.nn.functional.pad(w, (0, width - w.shape[1]))
                       for w in planes])
    values = unpack_decode(words.cuda(), 7000, cfg.k, False)
    _kernels.reset_launches()
    got = prefilter.prefilter_decode(values, cfg.filt)
    torch.cuda.synchronize()
    assert _kernels.launches["iir_decode"] == 1
    _assert_same(got, prefilter.prefilter_decode(values.cpu(), cfg.filt))
    _card_still_exact()


def _hostile_corpora():
    """(label, cd, corpus): the CPU test's stream and its families (a)-(f),
    the generic filters' flips (g) and the long-segment cases (h)."""
    rng = np.random.default_rng(0)
    x = np.round(np.cumsum(rng.normal(0, 10, 1000))).astype(np.int16)
    out = [("nab-like", (8, 100), hc.corpus(native_compress(x, (8, 100)),
                                            10))]
    for filt in hc.GENERIC_FILTERS:
        cd = (8, 100, len(filt), *[f & 0xFFFFFFFF for f in filt])
        out.append((f"filter {filt}", cd,
                    hc.flips(native_compress(x, cd), 60)))
    _x, _blob, cases = _hostile_long()
    out.append(("long", (8, 12000), cases))
    return out


@pytest.mark.parametrize("split", [False, True], ids=["split-off",
                                                      "split-on"])
def test_decompress_hostile_on_the_card_equals_the_cpu(cuda, split,
                                                       monkeypatch):
    """Every case, one stream a call, on the card and on the CPU; then
    each corpus's walkable streams as one batch. With the split switch on
    the router is held at 4 parts, as on the CPU."""
    monkeypatch.setenv("DELTARICE_TPU_SPLIT_DECODE", "1" if split else "0")
    if split:
        monkeypatch.setattr(codec, "decode_split_parts", lambda *a: 4)
    _kernels.reset_launches()
    for label, cd, cases in _hostile_corpora():
        cfg = dt.RiceConfig.from_cd_values(cd)
        total = int(np.frombuffer(cases[-1][1][:4], "<u4")[0])
        batch = hc.batchable([s for _n, s in cases],
                             cfg.segments(total)[0], total)
        for name, s in cases:
            if label == "long" and s in batch:
                continue  # 12000 samples a segment: the batch covers it
            got = hc.outcome(lambda b: dt.decompress(b, cfg, device="cuda"),
                             s)
            want = hc.outcome(lambda b: dt.decompress(b, cfg, device="cpu"),
                              s)
            assert hc.same(got, want), f"{label} {name}: {got[0]} {want[0]}"
            torch.cuda.synchronize()
        got = dt.decompress_batch(batch, cfg, device="cuda")
        want = dt.decompress_batch(batch, cfg, device="cpu")
        assert len(got) == len(want) == len(batch)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        _card_still_exact()
    assert _kernels.launches["unpack_decode"] > 0
    assert (_kernels.launches["split_decode"] > 0) == split


def _verify_chunks(name):
    """Chunks of one geometry at its full chunk shape: 8 of them for the
    long profiles (the split router takes 8 x 32 segments), 4 for Nab."""
    if name == "nab":
        return list(_nab(128).reshape(4, 32, 7000)), dt.RiceConfig(8, 7000)
    chunk, cfg = _long_chunk(name)
    return [np.roll(chunk, 997 * i, axis=1) for i in range(8)], cfg


@pytest.mark.parametrize("split", [False, True], ids=["split-off",
                                                      "split-on"])
@pytest.mark.parametrize("name", ["nab", "nedm", "noptrex"])
def test_verify_retry_on_the_card(cuda, name, split, monkeypatch):
    """A transient payload fault and a truncated header, each in one chunk
    of a batch, recover to native ``dr_compress``'s bytes; a persistent
    fault raises ``RuntimeError``. B1 encodes whole rows (no merge at
    nEDM and NOPTREX), and the check decodes on the card."""
    monkeypatch.setenv("DELTARICE_TPU_SPLIT_DECODE", "1" if split else "0")
    chunks, cfg = _verify_chunks(name)
    cd = cfg.to_cd_values()
    want = [native_compress(c, cd) for c in chunks]
    real = codec.frame_stream
    for fault in ("payload", "header"):
        spy = hc.faulty_frames({2}, real, fault)
        monkeypatch.setattr(codec, "frame_stream", spy)
        _kernels.reset_launches()
        got = dt.compress_batch(chunks, cfg, verify=True, device="cuda")
        assert got == want, fault
        assert spy.count[0] == len(chunks) + 1
        assert _kernels.launches["pack_encode"] == 2
        assert _kernels.launches["concentrate_packed"] == 0
        assert _kernels.launches["concentrate_wide"] == 0
        if split and name != "nab":
            assert _kernels.launches["split_decode"] >= 1
        _card_still_exact()
    monkeypatch.setattr(codec, "frame_stream",
                        hc.faulty_frames(set(range(100)), real))
    with pytest.raises(RuntimeError, match="round-trip verification"):
        dt.compress_batch(chunks[:2], cfg, verify=True, retries=1,
                          device="cuda")
    _card_still_exact()


def test_h5_hostile_write_and_read_on_the_card(cuda, monkeypatch):
    """``write_dataset(verify=True)`` repairs a fault in the second of three
    windows (every blob native ``dr_compress``'s); a read with a truncated
    chunk raises ValueError as on the CPU, and an intact read after it is
    exact."""
    from deltarice_tpu_torch import h5 as th5
    from deltarice_tpu_torch.tools.memstore import MemGroup

    x = _nab(192)
    cfg = dt.RiceConfig(8, 7000)
    spy = hc.faulty_frames({2}, codec.frame_stream)
    monkeypatch.setattr(codec, "frame_stream", spy)
    g = MemGroup()
    th5.write_dataset(g, "d", x, cfg, (32, 7000), batch_chunks=2,
                      verify=True, device="cuda")
    monkeypatch.undo()
    assert spy.count[0] == 7
    dset = g["d"]
    for i in range(6):
        assert dset.id.read_direct_chunk((32 * i, 0))[1] == native_compress(
            x[32 * i : 32 * i + 32], (8, 7000))
    mask, blob = dset.id.read_direct_chunk((96, 0))
    dset.id.write_direct_chunk((96, 0), blob[:-4], mask)
    for device in ("cuda", "cpu"):
        with pytest.raises(ValueError):
            th5.read_dataset(dset, cfg, 2, device=device)
    dset.id.write_direct_chunk((96, 0), blob, mask)
    np.testing.assert_array_equal(th5.read_dataset(dset, cfg, 2,
                                                   device="cuda"), x)
    _card_still_exact()


def test_c_written_file_reads_on_the_card(cuda, tmp_path):
    """``examples/c/dr_roundtrip.c``, built against the port's native
    library, writes a file through a system libhdf5; the card's read of it
    equals the example's recurrence and the CPU read. Skips where
    ``tests/test_torch_c_example.py`` skips, and without h5py."""
    import c_example
    from deltarice_tpu_torch import h5 as th5

    h5py = pytest.importorskip("h5py")
    tools = c_example.toolchain()
    if tools is None:
        pytest.skip("needs a C compiler and a system libhdf5 runtime")
    binary = c_example.build_example(*tools, tmp_path / "dr_roundtrip")
    h5file = tmp_path / "c_written.h5"
    assert "round-trip OK" in c_example.write_file(binary, h5file)
    with h5py.File(h5file, "r") as f:
        _kernels.reset_launches()
        got = th5.read_dataset(f["waveforms"], device="cuda")
        counts = dict(_kernels.launches)
        cpu = th5.read_dataset(f["waveforms"], device="cpu")
    np.testing.assert_array_equal(got, c_example.example_data())
    np.testing.assert_array_equal(got, cpu)
    assert counts["unpack_decode"] >= 1


def _guard_child(args, timeout=300):
    """A child process under the guard allocator (``deltarice_tpu_torch/
    testing/guard.py``): its exit code, output, and the case it started and
    did not finish with its error."""
    from deltarice_tpu_torch.testing import guard

    res = subprocess.run([sys.executable, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    out = res.stdout + res.stderr
    return res.returncode, out, guard.read_child(out)


@pytest.mark.parametrize("fault", [None, "past_end", "before_start"])
def test_guard_positive_control(cuda, fault):
    """The guard pages see a one-byte read outside a buffer: in a child,
    the last byte of an ``end`` buffer and the first of a ``front`` buffer
    read back what was written; one byte past the end, or one before the
    start, kills the child with cudaErrorIllegalAddress in that case."""
    from deltarice_tpu_torch.testing import guard

    rc, out, (unfinished, error) = _guard_child(
        ["-m", "deltarice_tpu_torch.testing.guard", "control"]
        + (["--fault", fault] if fault else []))
    assert "[guard] ok control.end_last" in out, out[-3000:]
    assert "[guard] ok control.front_first" in out, out[-3000:]
    if fault is None:
        assert rc == 0 and unfinished is None, out[-3000:]
    else:
        assert rc != 0 and unfinished == f"control.{fault}", out[-3000:]
        assert guard.illegal_address(error), error


def test_guard_child_over_the_hostile_nab_planes(cuda):
    """``chip_smoke.py``'s guard child on case b at Nab (B2 on the hostile
    planes and on planes of width 1 and 2 and full rows, the generic
    inverse on garbage decodes), end placement: no access outside a
    buffer, every output equal to its reference."""
    rc, out, (unfinished, error) = _guard_child(
        [str(ROOT / "chip_smoke.py"), "--guard", "end", "--fill", "165",
         "--cases", "b.nab"])
    assert rc == 0, f"died in {unfinished} with {error}:\n{out[-3000:]}"
    assert unfinished is None
    assert any(ln.startswith("[guard] end: ") and " 0 faults" in ln
               for ln in out.splitlines()), out[-3000:]


def test_guard_exact_child_over_ragged_b2(cuda):
    """B2 under the ``exact`` placement (ROADMAP C2): each buffer's size is
    rounded up to 4 bytes only, so the output of 33 x 9 int16 samples (594
    bytes) starts 4 bytes off an 8-byte boundary. The decode must store
    such an output sample by sample (it once stored 8 bytes there and died
    with a misaligned address) and equal its plain version."""
    rc, out, (unfinished, error) = _guard_child(
        [str(ROOT / "chip_smoke.py"), "--guard", "exact", "--fill", "195",
         "--cases", "c.unpack_decode", "--cases", "c.unpack_tables"])
    assert rc == 0, f"died in {unfinished} with {error}:\n{out[-3000:]}"
    assert any(ln.startswith("[guard] exact: ") and " 0 faults" in ln
               for ln in out.splitlines()), out[-3000:]


@pytest.mark.parametrize("mode,fill", [("end", 165), ("front", 90),
                                       ("exact", 195)])
def test_guard_children_over_the_forward_filter(cuda, mode, fill):
    """The forward filter's kernel on case c's shapes under each guard
    placement (``exact``: inputs off a 16-byte boundary, which take the
    element-wise loads): no access outside a buffer, every output equal
    to its plain version."""
    rc, out, (unfinished, error) = _guard_child(
        [str(ROOT / "chip_smoke.py"), "--guard", mode, "--fill", str(fill),
         "--cases", "c.fir_encode"])
    assert rc == 0, f"died in {unfinished} with {error}:\n{out[-3000:]}"
    assert any(ln.startswith(f"[guard] {mode}: ") and " 0 faults" in ln
               for ln in out.splitlines()), out[-3000:]


def _smem_child(args, timeout=600):
    """A child process of the shared-memory check (``deltarice_tpu_torch/
    testing/smem.py``): its exit code, output, and the case it did not
    finish, its error and the site of its bounds failure."""
    from deltarice_tpu_torch.testing import smem

    res = subprocess.run([sys.executable, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    out = res.stdout + res.stderr
    return res.returncode, out, smem.read_child(out)


def test_smem_checked_build_equals_the_default_build(cuda):
    """The checked build (``csrc/smem_check.h`` with ``-DDR_SMEM_CHECK=1``)
    under a perturbed schedule, in a child, over case c (every kernel at
    ragged shapes): every wrapper and each path of the generic inverse
    launches, every output equals its plain version, and every output
    hashes as the default build's in this process."""
    import importlib.util
    import re

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rc, out, (unfinished, error, site) = _smem_child(
        [str(ROOT / "chip_smoke.py"), "--smem-check", "1", "--fill", "165",
         "--cases", "c."])
    assert rc == 0, (f"died in {unfinished} with {error} at {site}:\n"
                     f"{out[-3000:]}")
    checked = dict(ln.split()[2:4] for ln in out.splitlines()
                   if ln.startswith("[guard] ok "))
    said = re.findall(r"launches (\{.*?\}); ", out)
    assert said, out[-3000:]
    launched = json.loads(said[-1])
    assert set(cs.GUARD_KERNELS + cs.IIR_PATHS) <= set(launched)
    default = {c.name: cs._digest(c.run("cuda"))
               for c in cs.ragged_cases(cs.tests_module("tiled_cases"))}
    torch.cuda.synchronize()
    assert checked == default


def test_smem_control_dies_naming_its_site(cuda):
    """The checked build's positive control: shared slots no thread wrote
    read back the fill byte, and a write one past a 32-slot shared array
    stops the kernel with a record of its site."""
    from deltarice_tpu_torch.testing import smem

    rc, out, (unfinished, error, site) = _smem_child(
        ["-m", "deltarice_tpu_torch.testing.smem", "control", "--fill", "90",
         "--fault"])
    assert rc != 0 and unfinished == "control.past_end", out[-3000:]
    assert "[guard] ok control.clean" in out, out[-3000:]
    assert "[smem] unwritten 0x5a5a5a5a x32" in out, out[-3000:]
    assert smem.parse_site(site) == smem.past_end_site(), site


@pytest.mark.parametrize("op", ["encode", "decode"])
def test_trace_events_agree_with_the_profiler(cuda, op):
    """The tracer's device events (``fill`` and ``kernels`` of an encode,
    ``kernels`` of a decode) resolve, and over calls queued behind a spin
    their sum is the profiler's kernel time of the same calls within 5 %."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deltarice_tpu_torch import tracing

    rows, length, calls = 8192, 7000, 10
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randint(-20, 21, (rows, length), device="cuda", generator=g,
                      dtype=torch.int32).cumsum(1).to(torch.int16)
    nv = torch.full((rows,), length, dtype=torch.int32, device="cuda")
    cfg = dt.RiceConfig(8, length)
    full, counts = dt.encode_segments(x, nv, cfg, cfg.max_words(length),
                                      device="cuda")
    width = -(-(int(counts.max()) + 1) // 256) * 256
    plane = full[:, :width].contiguous()
    del full

    def call():
        if op == "encode":
            dt.encode_segments(x, nv, cfg, width, device="cuda")
        else:
            dt.decode_segments(plane, length, cfg, device="cuda")

    call()
    torch.cuda.synchronize()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES // 4)  # the launches queue behind it
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    top = "dr.encode_segments" if op == "encode" else "dr.decode_segments"
    snap = tracing.snapshot()
    traced = tracing.calls(snap, top, rows)
    assert len(traced) == calls
    events = [sum(s["device_ms"].values()) for c in traced for s in c]
    names = {n for c in traced for s in c for n in s["device_ms"]}
    assert names == ({"fill", "kernels"} if op == "encode" else {"kernels"})
    kernel_ms = sum((ev.end_ns() - ev.start_ns()) * 1e-6
                    for ev in prof.profiler.kineto_results.events()
                    if ev.device_type() == DeviceType.CUDA
                    and not ev.is_user_annotation()
                    and "spin" not in ev.name()
                    and not ev.name().startswith("Memcpy"))
    assert kernel_ms > 0
    assert sum(events) == pytest.approx(kernel_ms, rel=0.05)


#: the nab_opt deployment: Nab with the optimizer's 3-tap pre-filter
NAB_OPT = dt.RiceConfig(8, 7000, filt=(1, 0, -1))


def _nab_opt_batch(rows=2000, seed=23):
    """Nab-profile rows on the card, a few cut short, one of noise."""
    x = _nab(rows, seed=seed)
    x[7] = np.random.default_rng(seed).integers(-32768, 32768, 7000)
    nv = np.full(rows, 7000, np.int32)
    nv[[3, 11, 1999]] = (4321, 1, 0)
    return (torch.from_numpy(x).cuda(), torch.from_numpy(nv).cuda())


def test_prefilter_events_and_counters_on_the_card(cuda):
    """Each generic-filter call records its ``prefilter`` /
    ``prefilter_inverse`` event pair inside its span, read as positive
    ms, and counts its rows once."""
    from deltarice_tpu_torch import tracing

    x, nv = _nab_opt_batch()
    rows, full = x.shape[0], NAB_OPT.max_words(7000)
    words, _ = dt.encode_segments(x, nv, NAB_OPT, full, device="cuda")
    dt.decode_segments(words, 7000, NAB_OPT, device="cuda")
    torch.cuda.synchronize()
    tracing.clear()
    with tracing.recording():
        words, _ = dt.encode_segments(x, nv, NAB_OPT, full, device="cuda")
        out = dt.decode_segments(words, 7000, NAB_OPT, device="cuda")
    snap = tracing.snapshot()
    for op, span, event in (("encode", "dr.prefilter", "prefilter"),
                            ("decode", "dr.prefilter_inverse",
                             "prefilter_inverse")):
        assert tracing.event_ms(snap, tracing.ENTRY[op], rows, event) > 0
        assert [s["name"] for s in snap["spans"]
                if event in s["device_ms"]] == [span]
    assert snap["counters"]["rows_prefiltered"] == rows
    assert snap["counters"]["rows_prefilter_inverted"] == rows
    full_rows = (nv == 7000).cpu()
    assert torch.equal(out.cpu()[full_rows], x.cpu()[full_rows])
    tracing.clear()


def test_nab_opt_on_the_card_is_the_plain_codec(cuda):
    """A 2000 x 7000 batch of the nab_opt deployment: the card's encode at
    the deployment's word cap and at full width, and its decode of a plane
    that the plain codec made, equal the plain codec of
    ``tests/plain_codec.py``."""
    x, nv = _nab_opt_batch()
    full = NAB_OPT.max_words(7000)
    ref_words, ref_counts = plain_codec.encode(x, nv, 8, full, (1, 0, -1))
    cap = 1536
    words, counts = dt.encode_segments(x, nv, NAB_OPT, cap, device="cuda")
    assert torch.equal(counts.to(torch.int64), ref_counts)
    fit = counts <= cap
    assert int((~fit).sum()) >= 1  # the noise row
    assert torch.equal(words[fit], ref_words[fit, :cap])
    words, counts = dt.encode_segments(x, nv, NAB_OPT, full, device="cuda")
    assert torch.equal(words, ref_words)

    width = -(-(int(ref_counts.max()) + 1) // 256) * 256
    plane, _ = plain_codec.encode(x, nv, 8, width, (1, 0, -1))
    out = dt.decode_segments(plane, 7000, NAB_OPT, device="cuda").cpu().numpy()
    plain = plain_codec.decode(plane.cpu().numpy().view(np.uint32), 7000, 8,
                               (1, 0, -1))
    xs, nvs = x.cpu().numpy(), nv.cpu().numpy()
    full_rows = nvs == 7000
    np.testing.assert_array_equal(out[full_rows], xs[full_rows])
    np.testing.assert_array_equal(plain[full_rows], xs[full_rows])
    for i in np.nonzero(~full_rows)[0]:
        np.testing.assert_array_equal(out[i, :nvs[i]], xs[i, :nvs[i]])
        np.testing.assert_array_equal(plain[i, :nvs[i]], xs[i, :nvs[i]])
