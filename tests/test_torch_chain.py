"""The port's CrossfeedChain: tests/test_chain.py's cases, with the port's
upsampler and crossfeed on the CPU, and parity with the JAX chain on the
same seeded input."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from totton_tpu.engine.chain import CrossfeedChain as JaxChain
from totton_tpu.engine.crossfeed import CrossfeedFilter as JaxCfFilter
from totton_tpu.engine.crossfeed import CrossfeedProcessor as JaxCf
from totton_tpu.engine.upsampler import StreamingUpsampler as JaxUp
from totton_tpu.filters.hrtf import generate_all
from totton_tpu.filters.sidecar import load_filter
from totton_tpu_torch.engine.chain import CrossfeedChain
from totton_tpu_torch.engine.crossfeed import (
    CrossfeedFilter,
    CrossfeedProcessor,
    crossfeed_signal,
)
from totton_tpu_torch.engine.upsampler import StreamingUpsampler, upsample_signal
from totton_tpu_torch.io.pcm import PcmFormat

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cf_path(tmp_path_factory):
    out = tmp_path_factory.mktemp("cf")
    return generate_all(out, sizes=["M"], families=["44k"])[0]


def _chain(coefficients_dir, cf_path):
    lf = load_filter(next(coefficients_dir.glob("filter_44k_2x_*.json")))
    return lf, CrossfeedChain(
        StreamingUpsampler(lf, channels=2, device="cpu"),
        CrossfeedProcessor(CrossfeedFilter.load(cf_path), device="cpu"))


def test_chain_equals_sequential(coefficients_dir, cf_path, rng):
    """Chunked chain output = offline upsample then offline crossfeed,
    shifted by the chain's latency (rtol 1e-4, atol 1e-5, as the JAX
    test); the priming samples are zeros."""
    lf, chain = _chain(coefficients_dir, cf_path)
    bi = chain.block_input_frames
    x = (rng.normal(size=(2, 40 * bi)) * 0.3).astype(np.float32)
    y = np.concatenate([
        chain.process_block(x[:, i * 10 * bi: (i + 1) * 10 * bi])
        for i in range(4)], axis=1)
    assert y.shape == (2, x.shape[1] * lf.ratio)
    up = upsample_signal(x, lf, device="cpu")
    ref = crossfeed_signal(up, CrossfeedFilter.load(cf_path), device="cpu")
    d = chain.latency
    np.testing.assert_allclose(y[:, d:], ref[:, : ref.shape[1] - d],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y[:, :d], 0, atol=1e-7)


def test_chain_matches_jax_chain(coefficients_dir, cf_path, rng):
    """Port chain vs JAX chain on the same chunks: rel < 1e-5."""
    lf, chain = _chain(coefficients_dir, cf_path)
    jchain = JaxChain(JaxUp(lf, channels=2),
                      JaxCf(JaxCfFilter.load(cf_path)))
    assert chain.latency == jchain.latency
    bi = chain.block_input_frames
    nb = chain.latency // (bi * chain.ratio) + 12  # past the priming zeros
    x = (rng.normal(size=(2, nb * bi)) * 0.3).astype(np.float32)
    got, ref = [], []
    for lo, hi in [(0, 1), (1, 5), (5, nb)]:
        got.append(chain.process_block(x[:, lo * bi: hi * bi]))
        ref.append(np.asarray(jchain.process_block(x[:, lo * bi: hi * bi])))
    got, ref = np.concatenate(got, 1), np.concatenate(ref, 1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


def test_chain_reset_flushes_stale_audio(coefficients_dir, cf_path, rng):
    """reset() on the chain flushes the crossfeed FIFO and pending audio:
    after it, silence in gives silence out (the SOFT_RESET contract)."""
    _, chain = _chain(coefficients_dir, cf_path)
    bi = chain.block_input_frames
    nb = chain.latency // (bi * chain.ratio) + 8
    loud = (rng.normal(size=(2, nb * bi)) * 0.5).astype(np.float32)
    chain.process_block(loud)
    stale = chain.process_block(np.zeros((2, bi), np.float32))
    assert np.max(np.abs(stale)) > 1e-4  # the test bites
    chain.process_block(loud)
    chain.reset()
    y = chain.process_block(np.zeros((2, bi), np.float32))
    np.testing.assert_allclose(y, 0.0, atol=1e-9)


def test_chain_reset_only_inner_upsampler_is_insufficient(
        coefficients_dir, cf_path, rng):
    """Resetting only the inner upsampler leaves the chain's FIFO stale:
    why SOFT_RESET targets the outermost engine."""
    _, chain = _chain(coefficients_dir, cf_path)
    bi = chain.block_input_frames
    nb = chain.latency // (bi * chain.ratio) + 8
    chain.process_block((rng.normal(size=(2, nb * bi)) * 0.5)
                        .astype(np.float32))
    chain.upsampler.reset()
    y = chain.process_block(np.zeros((2, bi), np.float32))
    assert np.max(np.abs(y)) > 1e-6


def test_chain_rejects_device_pcm_upsampler(coefficients_dir):
    lf = load_filter(next(coefficients_dir.glob("filter_44k_2x_*.json")))
    eng = StreamingUpsampler(lf, channels=2, device_pcm=PcmFormat.S16_LE,
                             device="cpu")
    with pytest.raises(ValueError, match="float-output upsampler"):
        CrossfeedChain(eng, object())


def test_chain_two_phase_equals_process_block(coefficients_dir, cf_path,
                                              rng):
    """dispatch_block/fetch (the session's pipelined path) equals
    process_block bit for bit."""
    _, a = _chain(coefficients_dir, cf_path)
    _, b = _chain(coefficients_dir, cf_path)
    bi = a.block_input_frames
    nb = a.latency // (bi * a.ratio) + 6  # past the priming zeros
    x = (rng.normal(size=(2, nb * bi)) * 0.3).astype(np.float32)
    handles = [a.dispatch_block(x[:, :3 * bi]), a.dispatch_block(x[:, 3 * bi:])]
    got = np.concatenate([a.fetch(h) for h in handles], 1)
    ref = np.concatenate([b.process_block(x[:, :3 * bi]),
                          b.process_block(x[:, 3 * bi:])], 1)
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_array_equal(got, ref)
