"""The port's optimizer, warm-up and profiling helpers against the JAX
package's, on the CPU.

Bit costs are means of exact integer codeword lengths; the JAX package
takes them in float32 and the port in float64, so costs compare within
1e-5 relative, and chosen configs (argmins) must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltarice_tpu import optimize as jopt
from deltarice_tpu.ops import prefilter as jpre
from deltarice_tpu.ops import rice as jrice
from deltarice_tpu_torch import optimize as topt
from deltarice_tpu_torch.config import RiceConfig
from deltarice_tpu_torch.ops import prefilter as tpre

REL = 1e-5


def _walk(rows, length, sigma, seed):
    rng = np.random.default_rng(seed)
    return np.round(np.cumsum(rng.normal(0, sigma, (rows, length)),
                              axis=-1)).astype(np.int16)


def test_optimal_m_matches_jax():
    for sigma, seed in ((2, 3), (10, 4), (120, 5), (2000, 6)):
        x = _walk(8, 2000, sigma, seed)
        for filt in ((1, -1), (1, -2, 1)):
            assert (topt.optimal_m(x, filt, device="cpu")
                    == jopt.optimal_m(x, filt))


def test_codeword_bits_and_bits_all_k_match_jax():
    x = _walk(6, 3000, 40, 7)
    x[5] = np.random.default_rng(8).integers(-32768, 32768, 3000)
    d = jpre.prefilter_encode(jnp.asarray(x))
    u = np.asarray(jrice.zigzag(d))
    for k in range(16):
        np.testing.assert_array_equal(
            topt.codeword_bits(torch.from_numpy(u.astype(np.int64)),
                               k).numpy(),
            np.asarray(jopt.codeword_bits(jnp.asarray(u), k)))
    got = topt._bits_all_k(tpre.prefilter_encode(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jopt._bits_all_k(d)),
                               rtol=REL)
    for m, filt in ((8, (1, -1)), (64, (1, -1)), (8, (1, -2, 1)), (1, (1,))):
        assert topt.expected_bits(x, m, filt, device="cpu") == pytest.approx(
            jopt.expected_bits(x, m, filt), rel=REL)


@pytest.mark.parametrize("n_taps", [2, 3])
def test_batch_filter_bits_matches_jax(n_taps):
    # 9 and 27 candidates; taps far outside int16 wrap mod 2**16, and large
    # taps on wide data wrap the accumulator
    x = _walk(4, 1500, 300, 9)
    span = range(-1, 2)
    cands = [tuple(c) for c in np.array(np.meshgrid(*[span] * n_taps))
             .reshape(n_taps, -1).T.tolist()]
    cands[0] = (1, 70000, -3)[:n_taps]
    cands[1] = (-1, 30000, -65537)[:n_taps]
    filts = [[int(jpre._c16(c)) for c in f] for f in cands]
    want = np.asarray(jopt._batch_filter_bits(
        jnp.asarray(x), jnp.asarray(filts, dtype=jnp.int32), n_taps))
    got = topt._batch_filter_bits(torch.from_numpy(x),
                                  torch.tensor(filts, dtype=torch.int64),
                                  n_taps)
    assert got.shape == (3 ** n_taps, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=REL)
    kb = topt._filter_costs(torch.from_numpy(x), cands)
    jkb = jopt._filter_costs(jnp.asarray(x), cands, pad_to=len(cands))
    assert [k for k, _b in kb] == [k for k, _b in jkb]
    np.testing.assert_allclose([b for _k, b in kb], [b for _k, b in jkb],
                               rtol=REL)


@pytest.mark.parametrize("n_taps", [2, 3])
def test_optimize_matches_jax_on_random_walks(n_taps):
    rng = np.random.default_rng(4)
    x = np.round(np.cumsum(rng.normal(0, 10, (4, 3000)), axis=-1)).astype(
        np.int16)
    got = topt.optimize(x, n_taps=n_taps, span=1, device="cpu")
    want = jopt.optimize(x, n_taps=n_taps, span=1)
    assert (got.m, got.filt) == (want.m, want.filt)
    if n_taps == 2:
        assert got.filt == (1, -1) and got.m in (8, 16)


def test_warmup_round_trips_on_the_cpu():
    import deltarice_tpu_torch as dt

    assert dt.warmup(nseg=4, cfg=RiceConfig(8, 256), device="cpu") > 0
    x = _walk(4, 256, 9, 0)
    cfg = RiceConfig(8, 256)
    np.testing.assert_array_equal(
        dt.decompress(dt.compress(x, cfg, "cpu"), cfg, "cpu").reshape(4, 256),
        x)


def test_throughput_on_the_cpu():
    from deltarice_tpu_torch.utils.profiling import throughput

    x = torch.arange(1 << 16, dtype=torch.int32)
    res = throughput(torch.cumsum, x, 0, nbytes=x.numel() * 4, iters=3,
                     device="cpu")
    assert res["seconds_per_call"] > 0 and res["gbps"] > 0


def test_device_trace_writes_a_trace(tmp_path):
    from deltarice_tpu_torch.utils.profiling import device_trace

    with device_trace(str(tmp_path)) as prof:
        torch.arange(1000).sum()
    assert (tmp_path / "trace.json").is_file()
    assert prof.key_averages()
