"""The plain model of B9's passes (``ops/split_model.py``) against the JAX
split kernel and the port's serial walk, on the CPU.

B9 (``csrc/split_decode.cu``) walks each (segment, part) sub-block with one
warp: chunks of window words cut into 32 lane stretches, a phase-0 walk of
every stretch (pass A), joins from the assumed entries and the walks again
of stretches whose true entry differs (pass B), prefix sums and the decode
from true entries (pass C). Its model must give exactly what JAX's
``_split_kernel_program`` gives (entry and exit phases, local counts,
final delta states, and the local samples its staging concentrates to)
and what ``split_decode_plain``, the kernel's oracle on the card, gives:
tolerance 0, the codec is integer and lossless. The JAX kernel runs in
interpret mode with its unroll constant ``_GROUP`` set to 1, which only
cuts its compile time (``tests/test_torch_split.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deltarice_tpu_torch as dt
from deltarice_tpu.ops import split_decode as jsplit
from deltarice_tpu.ops.concentrate_pallas import concentrate_tiled as jax_tiled
from deltarice_tpu_torch import codec
from deltarice_tpu_torch.models import get_profile
from deltarice_tpu_torch.ops import split_decode as tsplit
from deltarice_tpu_torch.ops import split_model
from deltarice_tpu_torch.ops.concentrate_tiled_cuda import untile
from deltarice_tpu_torch.ops.split_decode_cuda import split_decode_plain


def _gathered(x, cfg):
    """Port-encoded streams of x as the decoder gathers them: (words
    (nseg, W) uint32, word counts, sample counts)."""
    blob = dt.compress(x, cfg, device="cpu")
    buf = np.frombuffer(blob, dtype="<u4")
    nseg, _length, nvalid = codec._segment_layout(x.size, cfg)
    counts, starts = codec.walk_headers(buf, nseg)
    return codec.gather_segments(buf, counts, starts), counts, nvalid


def _never_sync(rows, length):
    """1, 0, -1, -2, ... at k=1: true codeword boundaries on odd bits, every
    phase-0 walk on even ones, so no speculation ever meets the stream
    (``tests/test_torch_split.py``)."""
    x = (1 - np.arange(length, dtype=np.int64)).astype(np.int16)
    return np.broadcast_to(x, (rows, length)).copy()


def _data(kind, k, rows, total, seed):
    if kind == "noptrex":
        return get_profile("noptrex").synthetic(rows, seed=seed,
                                                length=total)
    if kind == "never":
        return _never_sync(rows, total)
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(-32768, 32768, (rows, total)).astype(np.int16)
    sigma = 0.7 * (1 << k)  # a random walk whose steps suit M = 2^k
    return np.cumsum(rng.normal(0, sigma, (rows, total)).round(),
                     -1).astype(np.int16)


class Case:
    def __init__(self, kind, k, parts, rows, total, length, seed=0,
                 halo=None, lw=None, delta=True):
        x = _data(kind, k, rows, total, seed)
        cfg = dt.RiceConfig(1 << k, length)
        words, counts, nvalid = _gathered(x, cfg)
        self.x, self.nvalid, self.counts = x, nvalid, counts
        self.words = words
        self.k, self.parts, self.length, self.delta = k, parts, length, delta
        self.wsub = -(-int(counts.max()) // parts)
        self.halo = (tsplit._halo_words(length / counts.mean())
                     if halo is None else halo)
        self.lw = tsplit._local_width(length, parts) if lw is None else lw
        self.wv2 = np.clip(counts[:, None] - np.arange(parts)[None, :]
                           * self.wsub, 0, self.wsub).astype(np.int32)

    def args(self):
        return (torch.from_numpy(self.words.view(np.int32)),
                torch.from_numpy(self.wv2.reshape(-1)), self.parts,
                self.wsub, self.halo, self.lw, self.k, self.delta)

    def jax(self):
        """JAX ``_split_kernel_program`` on the same sub-blocks: (local,
        meta (4, rows))."""
        nseg, parts, wsub, halo = (self.words.shape[0], self.parts,
                                   self.wsub, self.halo)
        width = halo + wsub + jsplit._TAIL
        wq = np.pad(self.words, ((0, 0), (halo, parts * wsub + width)))
        subs = np.stack([wq[:, p * wsub: p * wsub + width]
                         for p in range(parts)], axis=1).reshape(-1, width)
        first = np.zeros((nseg, parts), np.int32)
        first[:, 0] = 1
        j = jsplit.codewords_per_word(self.k)
        plane_t, *meta = jsplit._split_kernel_program(
            jnp.asarray(subs), jnp.asarray(self.wv2.reshape(-1)),
            jnp.asarray(first.reshape(-1)), self.k, self.delta, halo, j,
            True)
        wc = jsplit._chunk_words(j)
        bound = (-(-width // wc) * wc - 1) * (j - 1) + halo + j
        staged = np.array(jax_tiled((plane_t,), self.lw, 8, bound, "int16",
                                    True))
        local = untile(torch.from_numpy(staged), nseg * parts, 8)[:, :self.lw]
        return local, torch.from_numpy(np.stack([np.asarray(m)
                                                 for m in meta]))


CASES = {
    # NOPTREX-like streams at the JAX halo, where junctions do not resync
    "noptrex-flagged-a": lambda: Case("noptrex", 3, 4, 8, 12000, 12000),
    "noptrex-flagged-b": lambda: Case("noptrex", 3, 4, 8, 6000, 6000, seed=4),
    "never-sync": lambda: Case("never", 1, 4, 2, 20000, 20000),
    "k0-p2": lambda: Case("walk", 0, 2, 3, 4000, 4000, seed=1),
    "k1-p4": lambda: Case("walk", 1, 4, 4, 6000, 6000, seed=2),
    "k7-p32": lambda: Case("walk", 7, 32, 2, 20000, 20000, seed=3),
    "k15-p2": lambda: Case("uniform", 15, 2, 2, 3000, 3000, seed=4),
    # three segments, the last of 7531 samples: its last parts own no words
    "short-last-segment": lambda: Case("walk", 3, 4, 1, 47531, 20000, seed=5),
    "lw-overrun": lambda: Case("walk", 3, 4, 4, 8000, 8000, seed=6, lw=128),
    # 2750 words per sub-block: six shared-memory stages of 512
    "wide-window": lambda: Case("walk", 3, 2, 2, 40000, 40000, seed=7),
    "no-delta": lambda: Case("noptrex", 3, 4, 4, 8000, 8000, seed=8,
                             delta=False),
}


@pytest.fixture(scope="module")
def cases():
    return {}


def _case(cases, name):
    if name not in cases:
        cases[name] = CASES[name]()
    return cases[name]


@pytest.mark.parametrize("name", list(CASES))
def test_model_matches_the_serial_walk(cases, name):
    c = _case(cases, name)
    local, meta = split_model.split_decode_model(*c.args())
    want_local, want_meta = split_decode_plain(*c.args())
    assert torch.equal(meta, want_meta)
    assert torch.equal(local, want_local)


@pytest.mark.parametrize("name", list(CASES))
def test_model_matches_jax(cases, name, monkeypatch):
    monkeypatch.setattr(jsplit, "_GROUP", 1)
    c = _case(cases, name)
    local, meta = split_model.split_decode_model(*c.args())
    jlocal, jmeta = c.jax()
    assert torch.equal(meta, jmeta)
    assert torch.equal(local, jlocal)


def test_case_coverage(cases):
    """The cases hold what they are named for."""
    c = _case(cases, "short-last-segment")
    assert (c.wv2 == 0).any() and c.nvalid[-1] < c.length
    c = _case(cases, "lw-overrun")
    _local, meta = split_model.split_decode_model(*c.args())
    assert int(meta[2].max()) > c.lw
    c = _case(cases, "wide-window")
    assert c.wsub > 4 * split_model.CHUNK
    for name, flagged in (("noptrex-flagged-a", 2), ("noptrex-flagged-b", 1),
                          ("never-sync", 2)):
        c = _case(cases, name)
        local, meta = split_model.split_decode_model(*c.args())
        _out, bad = tsplit._compose_merge(
            local, *meta, torch.from_numpy(c.wv2),
            torch.from_numpy(c.nvalid.astype(np.int32)), c.length, c.parts,
            c.lw, True)
        assert int(bad.sum()) == flagged


def _serial_entries(words, row, parts, wsub, halo, k):
    """The cursor phase entering every window word of one row, by a walk
    of plain Python integers (independent of the port's decoder): {window
    word: phase}."""
    s, p = divmod(row, parts)
    w = words[s]

    def word(t):
        g = p * wsub - halo + t
        return int(w[g]) if 0 <= g < len(w) else 0

    def length(pos):
        w0, w1, off = word(pos >> 5), word((pos >> 5) + 1), pos & 31
        win = ((w0 << off) | (w1 >> (32 - off) if off else 0)) & 0xFFFFFFFF
        q = 32 - win.bit_length()
        return 25 if q >= 8 else q + 1 + k

    phases, pos, t = {}, 0, 0
    end = halo + wsub
    while t < end:
        if t == halo and p == 0:
            pos = 32 * t
        phases[t] = pos - 32 * t
        while pos < 32 * (t + 1):
            pos += length(pos)
        t += 1
    return phases


@pytest.mark.parametrize("name", ["noptrex-flagged-a", "never-sync",
                                  "wide-window"])
def test_resolved_entries_match_a_serial_walk(cases, name):
    """Pass B's true entry phase of every stretch is the serial cursor's
    phase entering the stretch's first word."""
    c = _case(cases, name)
    stats = {}
    split_model.split_decode_model(*c.args(), stats=stats)
    rows = c.words.shape[0] * c.parts
    serial = [_serial_entries(c.words, r, c.parts, c.wsub, c.halo, c.k)
              for r in range(rows)]
    checked = 0
    for c0, b0, _b1, live, entry in stats["entries"]:
        for r, lane in live.nonzero().tolist():
            t = c0 + int(b0[r, lane])
            assert serial[r][t] == int(entry[r, lane]), (r, t)
            checked += 1
    assert checked == stats["lanes"]


def test_walks_again_only_where_the_speculation_missed(cases):
    """On NOPTREX-like streams few stretches are walked a second time in
    pass B; on the never-sync stream the first sub-block of each segment
    (whose entry is known, off the phase-0 lattice) walks nearly all again,
    and the result stays exact."""
    dense = {}
    c = _case(cases, "noptrex-flagged-a")
    split_model.split_decode_model(*c.args(), stats=dense)
    assert dense["again"] < dense["lanes"] // 10
    never = {}
    c = _case(cases, "never-sync")
    local, meta = split_model.split_decode_model(*c.args(), stats=never)
    assert never["again"] > never["lanes"] // 5
    want = split_decode_plain(*c.args())
    assert torch.equal(local, want[0]) and torch.equal(meta, want[1])
