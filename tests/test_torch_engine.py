"""Port parity: totton_tpu_torch.engine.upsampler against the JAX engine on
the CPU, with the session's small real filters (tests/conftest.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from totton_tpu.engine.upsampler import StreamingUpsampler as JaxUpsampler
from totton_tpu.engine.upsampler import upsample_signal as jax_upsample_signal
from totton_tpu.filters.sidecar import load_filter
from totton_tpu.io.pcm import PcmFormat as JaxPcmFormat
from totton_tpu.io.pcm import quantize_s16_host
from totton_tpu_torch.io.pcm import PcmFormat
from totton_tpu_torch.engine.upsampler import StreamingUpsampler, upsample_signal

torch.set_num_threads(2)

FADE = 3000  # output samples: spans two 2192-sample blocks at 16x


def _filter(coefficients_dir, key="44k_16x"):
    return load_filter(next(coefficients_dir.glob(f"filter_{key}_*.json")))


def _rel(y, ref):
    return np.abs(y - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("chunk_blocks", [1, 2, 4])
def test_chunks_and_crossfade_match_jax(coefficients_dir, rng, chunk_blocks):
    lf = _filter(coefficients_dir)
    jeng = JaxUpsampler(lf, 2, swap_fade_frames=FADE)
    teng = StreamingUpsampler(lf, 2, swap_fade_frames=FADE, device="cpu")
    block_in = teng.block_input_frames
    assert block_in == jeng.block_input_frames
    eq = rng.uniform(0.5, 1.0, size=teng.config.n_bins)
    x = (rng.normal(size=(2, 6 * chunk_blocks * block_in)) * 0.3).astype(
        np.float32)
    for i in range(6):
        if i == 2:  # swap mid-stream: both engines crossfade
            jeng.set_eq(eq)
            teng.set_eq(eq)
        chunk = x[:, i * chunk_blocks * block_in:(i + 1) * chunk_blocks
                  * block_in]
        yj = np.asarray(jeng.process_block(chunk))
        yt = teng.process_block(chunk)
        assert yt.shape == yj.shape == (2, chunk.shape[1] * 16)
        assert _rel(yt, yj) < 1e-5, f"chunk {i}"


def test_pipelined_equals_synchronous(coefficients_dir, rng):
    lf = _filter(coefficients_dir)
    a = StreamingUpsampler(lf, 2, swap_fade_frames=FADE, device="cpu")
    b = StreamingUpsampler(lf, 2, swap_fade_frames=FADE, device="cpu")
    block_in = a.block_input_frames
    chunks = [(rng.normal(size=(2, k * block_in)) * 0.3).astype(np.float32)
              for k in (1, 3, 2, 1)]
    handles = []
    for i, c in enumerate(chunks):
        if i == 1:
            a.set_eq(np.full(a.config.n_bins, 0.5))
        handles.append(a.dispatch_block(c))
    piped = [a.fetch(h) for h in handles]
    sync = []
    for i, c in enumerate(chunks):
        if i == 1:
            b.set_eq(np.full(b.config.n_bins, 0.5))
        sync.append(b.process_block(c))
    for p, s in zip(piped, sync):
        np.testing.assert_array_equal(p, s)


def test_device_pcm_bit_exact_vs_float_and_near_jax(coefficients_dir, rng):
    lf = _filter(coefficients_dir)
    fl = StreamingUpsampler(lf, 2, swap_fade_frames=FADE, device="cpu")
    pcm = StreamingUpsampler(lf, 2, swap_fade_frames=FADE,
                             device_pcm=PcmFormat.S16_LE, device="cpu")
    jpcm = JaxUpsampler(lf, 2, swap_fade_frames=FADE,
                        device_pcm=JaxPcmFormat.S16_LE)
    block_in = fl.block_input_frames
    for i in range(4):
        if i == 1:
            for eng in (fl, pcm, jpcm):
                eng.set_eq(np.full(fl.config.n_bins, 0.7))
        x = (rng.normal(size=(2, 2 * block_in)) * 0.4).astype(np.float32)
        yf = fl.process_block(x)
        yp = pcm.process_block(x)
        yj = np.asarray(jpcm.process_block(x))
        assert yp.dtype == np.int16
        np.testing.assert_array_equal(yp, quantize_s16_host(yf))
        assert np.abs(yp.astype(np.int32) - yj.astype(np.int32)).max() <= 1


def test_dithered_device_pcm_reproducible_from_seed(coefficients_dir, rng):
    lf = _filter(coefficients_dir)
    x = (rng.normal(size=(2, 2 * 2192 // 16)) * 0.4).astype(np.float32)
    outs = []
    for _ in range(2):
        eng = StreamingUpsampler(lf, 2, device_pcm=PcmFormat.S16_LE,
                                 pcm_dither=True, pcm_seed=11, device="cpu")
        outs.append([eng.process_block(x), eng.process_block(x)])
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    yf = StreamingUpsampler(lf, 2, device="cpu").process_block(x)
    nearest = np.floor(np.clip(yf, -1.0, 0.9999695).astype(np.float64)
                       * 32768.0 + 0.5)
    assert np.abs(outs[0][0] - nearest).max() <= 1


def test_reset_and_geometry_change(coefficients_dir, rng):
    lf16 = _filter(coefficients_dir)
    lf2 = _filter(coefficients_dir, "44k_2x")
    eng = StreamingUpsampler(lf2, 2, swap_fade_frames=FADE, device="cpu")
    x2 = (rng.normal(size=(2, 4 * eng.block_input_frames)) * 0.3).astype(
        np.float32)
    first = eng.process_block(x2)
    eng.process_block(x2)
    eng.reset()
    np.testing.assert_array_equal(eng.process_block(x2), first)
    eng.load_filter(lf16)  # new geometry: no fade, history restarts
    assert eng.ratio == 16 and eng._fade_from is None
    x16 = (rng.normal(size=(2, eng.block_input_frames)) * 0.3).astype(
        np.float32)
    ref = np.asarray(JaxUpsampler(lf16, 2).process_block(x16))
    assert _rel(eng.process_block(x16), ref) < 1e-5


def test_shape_validation(coefficients_dir):
    eng = StreamingUpsampler(_filter(coefficients_dir), 2, device="cpu")
    with pytest.raises(ValueError, match="channels"):
        eng.process_block(np.zeros((3, eng.block_input_frames), np.float32))
    with pytest.raises(ValueError, match="multiple"):
        eng.process_block(np.zeros((2, 5), np.float32))


def test_upsample_signal_matches_jax(coefficients_dir, rng):
    lf = _filter(coefficients_dir, "44k_2x")
    x = (rng.normal(size=(2, 777)) * 0.3).astype(np.float32)
    ref = np.asarray(jax_upsample_signal(x, lf))
    got = upsample_signal(x, lf, device="cpu")
    assert got.shape == ref.shape == (2, 777 * 2)
    assert _rel(got, ref) < 1e-5


def test_cuda_device_refused_without_cuda(coefficients_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingUpsampler(_filter(coefficients_dir), 2, device="cuda")


@pytest.mark.parametrize("taps", [1025, 1024])  # even and odd overlap
def test_ratio1_engine_matches_jax(rng, taps):
    """Ratio 1 (the CLI's EQ-only geometry, fft 4096) through the engine:
    the folded program for an even overlap, the classic program for an
    odd one, both against the JAX engine on the same chunks, rel < 1e-5,
    with an EQ swap crossfaded mid-stream."""
    from totton_tpu.filters.sidecar import FilterSidecar, LoadedFilter

    h = (rng.normal(size=taps) * np.exp(-np.arange(taps) / 50.0)).astype(
        np.float32)
    lf = LoadedFilter(taps=h, sidecar=FilterSidecar(
        coefficients_bin="<test>", taps=taps, fft_size=4096,
        block_size=4096 - taps + 1, upsample_factor=1))
    jeng = JaxUpsampler(lf, 2, swap_fade_frames=FADE)
    teng = StreamingUpsampler(lf, 2, swap_fade_frames=FADE, device="cpu")
    n = teng.block_input_frames
    eq = rng.uniform(0.5, 1.0, size=teng.config.n_bins)
    for i, k in enumerate((1, 3, 2)):
        if i == 1:
            jeng.set_eq(eq)
            teng.set_eq(eq)
        x = (rng.normal(size=(2, k * n)) * 0.3).astype(np.float32)
        yj = np.asarray(jeng.process_block(x))
        yt = teng.process_block(x)
        assert yt.shape == yj.shape == x.shape
        assert _rel(yt, yj) < 1e-5, f"chunk {i}"


@pytest.mark.parametrize("key", ["44k_2x", "44k_16x"])
def test_from_file_matches_the_reference(coefficients_dir, rng, key):
    """StreamingUpsampler.from_file (the reference's classmethod, with the
    port's explicit device) loads the sidecar and streams as the JAX
    engine's from_file does."""
    path = str(next(coefficients_dir.glob(f"filter_{key}_*.json")))
    eq = rng.uniform(0.5, 1.0, size=StreamingUpsampler.from_file(
        path, device="cpu").config.n_bins)
    teng = StreamingUpsampler.from_file(path, 2, eq, device="cpu")
    jeng = JaxUpsampler.from_file(path, 2, eq)
    assert teng.device == torch.device("cpu")
    assert teng.ratio == jeng.ratio and teng.config.taps == jeng.config.taps
    x = (rng.normal(size=(2, 3 * teng.block_input_frames)) * 0.3).astype(
        np.float32)
    assert _rel(teng.process_block(x), jeng.process_block(x)) < 1e-5
