"""Port parity: totton_tpu_torch.ops.device_pcm against the host conversion
(io/pcm.float_to_pcm, itself bit-exact with the reference's C casts) and
the JAX quantizer, on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from totton_tpu.io.pcm import PcmFormat, float_to_pcm, quantize_s16_host
from totton_tpu.ops import device_pcm as jax_pcm
from totton_tpu_torch.ops import device_pcm as dp

torch.set_num_threads(2)


def _edge_vector():
    """tests/test_device_pcm.py's edge values plus seeded noise."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=4096) * 0.5).astype(np.float32)
    edges = np.array(
        [0.0, 1.0, -1.0, 1.5, -1.5, 0.9999695, -0.9999695, 0.99997,
         0.5, -0.5, 1e-9, -1e-9, 3.0517578e-05, -3.0517578e-05],
        dtype=np.float32)
    return np.concatenate([edges, x])


def test_quantize_matches_host_cast_bit_exact():
    x = _edge_vector()
    got = dp.quantize_s16(torch.from_numpy(x)).numpy()
    host = np.frombuffer(float_to_pcm(x, PcmFormat.S16_LE), "<i2")
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, host)


def test_quantize_matches_jax_and_host_helper():
    x = _edge_vector().reshape(2, -1)
    got = dp.quantize_s16(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_pcm.quantize_s16(x)))
    np.testing.assert_array_equal(got, quantize_s16_host(x))


def _dithered(x, seed=0, counter=1):
    return dp.quantize_s16_dithered(torch.from_numpy(x), seed, counter).numpy()


def test_dithered_within_one_lsb_of_round_to_nearest():
    x = (np.random.default_rng(3).normal(size=8192) * 0.4).astype(np.float32)
    q = _dithered(x)
    scaled = np.clip(x, -1.0, 0.9999695).astype(np.float32) * np.float32(32768)
    nearest = np.floor(scaled.astype(np.float64) + 0.5)
    assert q.dtype == np.int16
    assert np.all(np.abs(q - nearest) <= 1)
    # TPDF is zero-mean: no bias in the quantized values.
    assert abs(float(np.mean(q - scaled))) < 0.05


def test_dithered_reproducible_and_fresh_per_counter():
    x = (np.random.default_rng(4).normal(size=4096) * 0.4).astype(np.float32)
    a = _dithered(x, seed=5, counter=1)
    np.testing.assert_array_equal(a, _dithered(x, seed=5, counter=1))
    assert np.any(a != _dithered(x, seed=5, counter=2))
    assert np.any(a != _dithered(x, seed=6, counter=1))


@pytest.mark.parametrize("value", [1.0, 0.9999695, 5.0, -1.0, -5.0])
def test_dithered_clamps_at_the_integer_edge(value):
    x = np.full(8192, value, dtype=np.float32)
    q = _dithered(x).astype(np.int64)
    assert q.max() <= 32767 and q.min() >= -32768



def test_set_dither_live_in_device_pcm_mode(coefficients_dir):
    """set_dither (the counterpart of the JAX engine's, which the CLI's
    RELOAD calls for the web dither toggle): a float-output engine returns
    False; a device-PCM engine swaps under its lock, creates the host TPDF
    twin when turned on, and each dispatch after it is the seeded
    quantize_s16_dithered of the float output (bit-exact), or the plain
    quantize_s16 once turned off again."""
    from totton_tpu.filters.sidecar import load_filter
    from totton_tpu_torch.engine.upsampler import StreamingUpsampler
    from totton_tpu_torch.io.pcm import PcmFormat as PortPcmFormat

    lf = load_filter(next(coefficients_dir.glob("filter_44k_2x_*.json")))
    assert StreamingUpsampler(lf, 2, device="cpu").set_dither(True) is False
    eng = StreamingUpsampler(lf, 2, device_pcm=PortPcmFormat.S16_LE,
                             pcm_seed=11, device="cpu")
    ref = StreamingUpsampler(lf, 2, device="cpu")
    n = eng.block_input_frames
    x = (np.random.default_rng(9).normal(size=(3, 2, n)) * 0.3).astype(
        np.float32)

    def plain(y):
        return dp.quantize_s16(torch.from_numpy(y)).numpy()

    np.testing.assert_array_equal(eng.process_block(x[0]),
                                  plain(ref.process_block(x[0])))
    assert eng._host_ditherer is None
    assert eng.set_dither(True) is True
    assert eng._pcm_dither and eng._host_ditherer is not None
    expect = dp.quantize_s16_dithered(
        torch.from_numpy(ref.process_block(x[1])), 11, 1).numpy()
    np.testing.assert_array_equal(eng.process_block(x[1]), expect)
    assert eng.set_dither(False) is True
    np.testing.assert_array_equal(eng.process_block(x[2]),
                                  plain(ref.process_block(x[2])))


def test_dither_noise_is_tpdf():
    """The dithered path's noise on ~1M samples of a constant input (fixed
    seed): the noise the quantizer adds (redrawn from the stream's
    generator and checked to be the noise applied) has mean 0 within 0.01
    LSB, variance 1/6 LSB^2 within 2% and the triangular density 1 - |n|
    on [-1, 1) LSB (40 bins, each within 0.03 of it); the total error of
    the output has mean 0 within 0.01 LSB and the variance of
    non-subtractive TPDF dither, 1/12 + 1/6 = 1/4 LSB^2, within 2%."""
    n = 1 << 20
    seed, counter = 1234, 7
    y = torch.full((2, n // 2), 0.1234, dtype=torch.float32)
    q = dp.quantize_s16_dithered(y, seed, counter)
    scaled = torch.clamp(y, -1.0, 0.9999695) * 32768.0
    gen = dp._generator(seed, counter, y.device)
    noise = (torch.rand(y.shape, generator=gen)
             + torch.rand(y.shape, generator=gen) - 1.0)
    assert torch.equal(q, torch.floor(scaled + noise + 0.5).to(torch.int16))

    z = noise.double().flatten().numpy()
    assert abs(z.mean()) < 0.01
    assert abs(z.var() / (1 / 6) - 1) < 0.02
    assert z.min() >= -1.0 and z.max() < 1.0
    density, edges = np.histogram(z, bins=40, range=(-1.0, 1.0),
                                  density=True)
    mid = (edges[:-1] + edges[1:]) / 2
    np.testing.assert_allclose(density, 1.0 - np.abs(mid), atol=0.03)

    err = (q.double() - scaled.double()).flatten().numpy()
    assert abs(err.mean()) < 0.01
    assert abs(err.var() / 0.25 - 1) < 0.02
