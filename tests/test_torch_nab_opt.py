"""The ``nab_opt`` deployment on the CPU: Nab's waveforms (L=7000, M=8)
with the pre-filter (1, 0, -1) that the reference's documented filter/M
optimizer returns for 3 taps, set through ``cd_values``
``(8, 7000, 3, 1, 0, -1)``. The plain codec of ``plain_codec.py`` (which
imports neither package) against the C reference's golden streams; the
port's ``encode_segments`` / ``decode_segments`` against the plain codec
at the deployment's full 7000-sample width, cut to a few rows; the
optimizer's choice on the Nab profile; the generic pre-filter's
counters and device events; and, on a card, one ``fir_encode`` launch a
generic-filter encode and none a delta encode. The same comparison at 2000 x 7000 on the card
is in ``tests/test_torch_cuda.py``. Imports no JAX.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import deltarice_tpu_torch as dt
from deltarice_tpu_torch import tracing
from deltarice_tpu_torch.models import get_profile
from deltarice_tpu_torch.ops import _kernels
from deltarice_tpu_torch.optimize import optimize
import plain_codec as pc

GOLDEN = Path(__file__).parent / "data" / "golden"
CASES = json.loads((GOLDEN / "manifest.json").read_text())
CD_VALUES = (8, 7000, 3, 1, 0, -1)
M, L, FILT = 8, 7000, (1, 0, -1)
CAP = 1536  # the deployment's plane: every Nab row's stream fits, noise does not


def _int32(v: int) -> int:
    return (int(v) + (1 << 31)) % (1 << 32) - (1 << 31)


def _settings(cd):
    """(M, L, filter) of ``cd_values``, each part optional, as the C
    reference parses them."""
    m = cd[0] if cd else 8
    length = cd[1] if len(cd) > 1 else -1
    filt = (tuple(_int32(c) for c in cd[3:3 + cd[2]]) if len(cd) > 2
            else pc.DELTA)
    return m, length, filt


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
@pytest.mark.parametrize("way", ["frame", "unframe"])
def test_plain_codec_is_the_c_reference(case, way):
    m, length, filt = _settings(case["cd_values"])
    chunk = np.load(GOLDEN / f"{case['name']}.npy")
    blob = (GOLDEN / f"{case['name']}.bin").read_bytes()
    if way == "frame":
        assert pc.frame(chunk, m, length, filt) == blob
    else:
        np.testing.assert_array_equal(pc.unframe(blob, m, length, filt), chunk)


def _batch(seed: int):
    """Six Nab-profile rows of the deployment's width: two full, one cut
    short, one of a single sample, one empty, and one of uniform noise,
    whose stream (all escapes) passes the word cap."""
    x = get_profile("nab").synthetic(6, seed=seed)
    x[5] = np.random.default_rng(seed).integers(-32768, 32768, L)
    nv = np.full(6, L, np.int32)
    nv[2], nv[3], nv[4] = 3333, 1, 0
    return x, nv


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 3100000007])
def test_port_is_the_plain_codec_at_nab_opt(seed):
    cfg = dt.RiceConfig.from_cd_values(CD_VALUES)
    assert cfg == dt.RiceConfig(M, L, filt=FILT)
    full = cfg.max_words(L)
    assert full == pc.max_words(L, M)
    x, nv = _batch(seed)
    ref_words, ref_counts = pc.encode(torch.from_numpy(x), torch.from_numpy(nv),
                                      M, full, FILT)

    words, counts = dt.encode_segments(x, nv, cfg, CAP, device="cpu")
    assert torch.equal(counts.to(torch.int64), ref_counts)
    over = np.nonzero(counts.numpy() > CAP)[0]
    assert over.tolist() == [5]
    fit = counts.numpy() <= CAP
    assert torch.equal(words[fit], ref_words[fit, :CAP])
    again, again_counts = dt.encode_segments(x[over], nv[over], cfg, full,
                                             device="cpu")
    assert torch.equal(again, ref_words[over])
    assert torch.equal(again_counts.to(torch.int64), ref_counts[over])

    width = -(-(int(ref_counts.max()) + 1) // 256) * 256
    plane, _ = pc.encode(torch.from_numpy(x), torch.from_numpy(nv), M, width,
                         FILT)
    out = dt.decode_segments(plane, L, cfg, device="cpu").numpy()
    plain = pc.decode(plane.numpy().view(np.uint32), L, M, FILT)
    for i, n in enumerate(nv):
        np.testing.assert_array_equal(out[i, :n], x[i, :n])
        np.testing.assert_array_equal(plain[i, :n], x[i, :n])


@pytest.mark.parametrize("seed", [0, 3100000007])
def test_the_optimizer_chooses_nab_opt_on_the_nab_profile(seed):
    x = get_profile("nab").synthetic(300, seed=seed)
    cfg = optimize(x, n_taps=3, span=1, device="cpu")
    assert (cfg.m, cfg.filt) == (M, FILT)


@pytest.mark.parametrize("filt", [FILT, pc.DELTA], ids=["nab_opt", "delta"])
def test_prefilter_counters_count_generic_rows_only(filt):
    tracing.clear()
    length = 700
    cfg = dt.RiceConfig(M, length, filt=filt)
    x = get_profile("nab").synthetic(5, seed=11, length=length)
    nv = np.full(5, length, np.int32)
    generic = filt != pc.DELTA
    words, _ = dt.encode_segments(x, nv, cfg, cfg.max_words(length),
                                  device="cpu")
    dt.decode_segments(words, length, cfg, device="cpu")
    counters = tracing.snapshot()["counters"]  # always on
    assert counters.get("rows_prefiltered", 0) == 5 * generic
    assert counters.get("rows_prefilter_inverted", 0) == 5 * generic
    with tracing.recording():
        words, _ = dt.encode_segments(x, nv, cfg, cfg.max_words(length),
                                      device="cpu")
        dt.decode_segments(words, length, cfg, device="cpu")
    snap = tracing.snapshot()
    assert snap["counters"].get("rows_prefiltered", 0) == 10 * generic
    assert snap["counters"].get("rows_prefilter_inverted", 0) == 10 * generic
    names = {s["name"] for s in snap["spans"]}
    assert ({"dr.prefilter", "dr.prefilter_inverse"} <= names) == generic
    for op, event in (("encode", "prefilter"), ("decode", "prefilter_inverse")):
        # no CUDA event on the CPU
        assert tracing.event_ms(snap, tracing.ENTRY[op], 5, event) is None
    assert all(s["device_ms"] == {} for s in snap["spans"])
    tracing.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("filt", [FILT, pc.DELTA], ids=["nab_opt", "delta"])
def test_a_generic_filter_encode_launches_fir_encode_once(filt):
    """On the card one encode of a generic filter launches the forward
    filter's kernel once; a delta encode (B1 fuses the delta) none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = dt.RiceConfig(M, L, filt=filt)
    x, nv = _batch(5)
    dt.encode_segments(x, nv, cfg, CAP, device="cuda")  # builds, warms
    before = _kernels.launches["fir_encode"]
    words, counts = dt.encode_segments(x, nv, cfg, CAP, device="cuda")
    torch.cuda.synchronize()
    assert _kernels.launches["fir_encode"] - before == (filt != pc.DELTA)
    ref_words, ref_counts = pc.encode(torch.from_numpy(x),
                                      torch.from_numpy(nv), M, CAP, filt)
    assert torch.equal(counts.cpu().to(torch.int64), ref_counts)
    fit = (counts.cpu() <= CAP).numpy()
    assert torch.equal(words.cpu()[fit], ref_words[fit])


def test_a_split_segment_counts_each_sub_block_once():
    """A long segment (the JAX package splits 16384 samples in two
    sub-blocks) encodes whole: one count a row."""
    tracing.clear()
    n = 16384
    cfg = dt.RiceConfig(M, n, filt=FILT)
    rng = np.random.default_rng(7)
    x = np.round(np.cumsum(rng.normal(0, 10, (2, n)), axis=1)).astype(np.int16)
    dt.compress_batch([x], cfg, device="cpu")
    counters = tracing.snapshot()["counters"]
    assert counters["rows_prefiltered"] == counters["rows_encoded"] == 2
    tracing.clear()
