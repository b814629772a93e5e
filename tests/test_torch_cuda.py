"""The port's CUDA kernels against their plain torch versions, on the card.

Every kernel output must equal its plain version's exactly (tolerance 0:
the codec is integer and lossless). The plain versions run on a CPU copy of
the same inputs. Each test skips without a CUDA card; run them on the card
with ``pytest tests/test_torch_cuda.py``. Imports no JAX.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import deltarice_tpu_torch as dt
from deltarice_tpu_torch.models import get_profile
from deltarice_tpu_torch.native import native_compress
from deltarice_tpu_torch.ops import _kernels
from deltarice_tpu_torch.ops.concentrate_cuda import (
    concentrate_packed,
    staged_planes,
)
from deltarice_tpu_torch.ops.pack_cuda import pack_encode
from deltarice_tpu_torch.ops.rice import codeword_lengths_values, zigzag
from deltarice_tpu_torch.ops.prefilter import prefilter_encode
from deltarice_tpu_torch.ops.transpose_cuda import transpose2d
from deltarice_tpu_torch.ops.unpack_cuda import unpack_decode

pytestmark = pytest.mark.cuda

GOLDEN = Path(__file__).parent / "data" / "golden"


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


@pytest.mark.parametrize("dtype,shape", [
    (torch.int16, (2048, 7000)), (torch.int32, (2048, 1280)),
    (torch.uint32, (33, 65)), (torch.int16, (1, 1)), (torch.int32, (70000, 3)),
])
def test_transpose_matches_plain(cuda, dtype, shape):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-2**15, 2**15, shape).astype(np.int32))
    x = x.to(torch.int16) if dtype == torch.int16 else x.view(dtype)
    _assert_same(*_both(transpose2d, x))


@pytest.mark.parametrize("k", range(16))
def test_pack_encode_matches_plain_all_k(cuda, k):
    x = np.concatenate([_nab(40, 3000), _escape_heavy(8, 3000)])
    nv = np.full(48, 3000, np.int32)
    nv[::5] = np.arange(10) * 299  # short and empty segments
    xt = torch.from_numpy(np.ascontiguousarray(x.T))
    cap = dt.RiceConfig(1 << k).max_words(3000)
    _assert_same(*_both(pack_encode, xt, torch.from_numpy(nv), None, k,
                        True, cap))


@pytest.mark.parametrize("diff,cap", [(True, 700), (True, 0), (False, 5469)])
def test_pack_encode_cap_prev0_and_prefiltered(cuda, diff, cap):
    x = np.concatenate([_nab(200), _escape_heavy(56, 7000)])
    rng = np.random.default_rng(2)
    p0 = torch.from_numpy(rng.integers(-32768, 32768, 256).astype(np.int32))
    xt = torch.from_numpy(np.ascontiguousarray(x.T))
    nv = torch.full((256,), 7000, dtype=torch.int32)
    _assert_same(*_both(pack_encode, xt, nv, p0, 3, diff, cap))


def _streams(x, k, width):
    """Plain-encoded word-major streams of x with >= 1 zero pad word."""
    xt = torch.from_numpy(np.ascontiguousarray(x.T))
    nv = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32)
    words_t, nwords, _ = pack_encode(xt, nv, None, k, True, width)
    assert int(nwords.max()) < width
    return words_t


@pytest.mark.parametrize("k", [0, 3, 7, 15])
def test_unpack_decode_matches_plain(cuda, k):
    x = np.concatenate([_nab(24, 2000), _escape_heavy(8, 2000)])
    words_t = _streams(x, k, 1600)
    for delta in (True, False):
        got, want = _both(unpack_decode, words_t, 2000, k, delta)
        _assert_same(got, want)
        if delta:
            assert np.array_equal(got.cpu().numpy().T, x)


def test_unpack_decode_past_stream_end_matches_plain(cuda):
    # decoding more samples than a stream holds walks into the clamped
    # cursor; the garbage must still agree with the plain version
    words_t = _streams(_nab(64, 500), 3, 256)
    _assert_same(*_both(unpack_decode, words_t, 900, 3, True))


def test_concentrate_matches_plain(cuda):
    x = torch.from_numpy(np.concatenate([_nab(250), _escape_heavy(6, 7000)]))
    lens, _ = codeword_lengths_values(zigzag(prefilter_encode(x)), 3)
    xt = x.t().contiguous()
    nv = torch.full((256,), 7000, dtype=torch.int32)
    words_t, nwords, _ = pack_encode(xt, nv, None, 3, True, 5469)
    words = words_t.t().contiguous()
    lead, follow = staged_planes(lens, words, 7168)
    got, want = _both(lambda a, b: concentrate_packed((a, b), 5469, True),
                      lead, follow)
    _assert_same(got, want)
    assert torch.equal(want, words)
    narrow = _both(lambda a: concentrate_packed((a,), 5469, False), lead)
    _assert_same(*narrow)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    xt = torch.zeros((16, 4), dtype=torch.int16, device=cuda)
    nv = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        pack_encode(xt.to(torch.int32), nv, None, 3, True, 8)
    with pytest.raises(ValueError):
        pack_encode(xt, nv.cpu(), None, 3, True, 8)
    with pytest.raises(ValueError):
        pack_encode(xt.t(), nv, None, 3, True, 8)
    with pytest.raises(ValueError):
        unpack_decode(torch.zeros((0, 4), dtype=torch.int32, device=cuda), 4, 3)
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
    assert counts["transpose2d"] >= 4
