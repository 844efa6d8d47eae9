"""Port parity: totton_tpu_torch.engine.crossfeed against the JAX package's
crossfeed and a scipy float64 oracle, on the CPU (tests/test_crossfeed.py's
cases). Inputs come from numpy with a seed; tolerances are stated per
test."""

import numpy as np
import pytest
from scipy import signal as ssig

torch = pytest.importorskip("torch")

from totton_tpu.engine import crossfeed as jcf
from totton_tpu.filters.hrtf import generate_all
from totton_tpu_torch.engine import crossfeed as tcf

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cf_path(tmp_path_factory):
    out = tmp_path_factory.mktemp("cf")
    return generate_all(out, sizes=["M"], families=["44k"])[0]


@pytest.fixture(scope="module")
def cf_filter(cf_path):
    return tcf.CrossfeedFilter.load(cf_path)


def oracle(x, channels):
    ll, lr, rl, rr = (c.astype(np.float64) for c in channels)
    n = x.shape[1]
    out_l = ssig.fftconvolve(x[0], ll)[:n] + ssig.fftconvolve(x[1], rl)[:n]
    out_r = ssig.fftconvolve(x[0], lr)[:n] + ssig.fftconvolve(x[1], rr)[:n]
    return np.stack([out_l, out_r])


def _rel(y, ref):
    return np.abs(y - ref).max() / np.abs(ref).max()


def test_matches_jax_and_convolution_oracle(cf_path, cf_filter, rng):
    """rel < 1e-5 against both (float32 rfft/irfft in another sum order)."""
    x = (rng.normal(size=(2, 5000)) * 0.3).astype(np.float32)
    y = tcf.crossfeed_signal(x, cf_filter, device="cpu")
    ref_jax = np.asarray(jcf.crossfeed_signal(
        x, jcf.CrossfeedFilter.load(cf_path)))
    assert y.shape == ref_jax.shape == x.shape
    assert _rel(y, ref_jax) < 1e-5
    assert _rel(y, oracle(x.astype(np.float64), cf_filter.channels)) < 1e-5


def test_loaded_set_and_geometry_equal_jax(cf_path, cf_filter):
    jf = jcf.CrossfeedFilter.load(cf_path)
    np.testing.assert_array_equal(cf_filter.channels, jf.channels)
    assert cf_filter.taps == jf.taps
    for taps in (cf_filter.taps, 100, 2049):
        t, j = tcf._cf_geometry(taps), jcf._cf_geometry(taps)
        assert (t.taps, t.fft_size, t.block_size, t.ratio) == (
            j.taps, j.fft_size, j.block_size, j.ratio)


def test_streaming_continuity(cf_filter, rng):
    """Block-by-block streaming equals one shot (rtol 1e-5, atol 1e-6)."""
    proc = tcf.CrossfeedProcessor(cf_filter, device="cpu")
    bi = proc.block_input_frames
    x = (rng.normal(size=(2, 4 * bi)) * 0.3).astype(np.float32)
    chunks = [proc.process_block(x[:, i * bi: (i + 1) * bi]).copy()
              for i in range(4)]
    streamed = np.concatenate(chunks, axis=1)
    proc.reset()
    one_shot = proc.process_block(x)
    np.testing.assert_allclose(streamed, one_shot, rtol=1e-5, atol=1e-6)


def test_direct_path_is_dry_plus_cross(cf_filter):
    # Left-only impulse: out_L = LL (unit impulse), out_R = LR (atol 1e-5).
    x = np.zeros((2, 2000), np.float32)
    x[0, 0] = 1.0
    y = tcf.crossfeed_signal(x, cf_filter, device="cpu")
    assert y[0, 0] == pytest.approx(1.0, abs=1e-5)
    n = min(2000, cf_filter.taps)
    np.testing.assert_allclose(y[1, :n], cf_filter.channels[1][:n],
                               atol=1e-5)


def test_stereo_only_and_block_multiple(cf_filter):
    proc = tcf.CrossfeedProcessor(cf_filter, device="cpu")
    with pytest.raises(ValueError, match="stereo"):
        proc.process_block(np.zeros((4, proc.block_input_frames)))
    with pytest.raises(ValueError, match="multiple"):
        proc.process_block(np.zeros((2, proc.block_input_frames + 1)))


def test_processor_state_on_its_device(cf_filter, monkeypatch):
    proc = tcf.CrossfeedProcessor(cf_filter, device="cpu")
    assert proc._h[0].device.type == "cpu" and proc._tail.device.type == "cpu"
    assert proc._tail.shape == (2, proc.config.halo_in)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcf.CrossfeedProcessor(cf_filter, device="cuda")
