"""The port's ThreadedStreamSession (a copy of the JAX package's) driving
the port's engine on the CPU: tests/test_threaded_stream.py's cases, plus
threaded output equal to the synchronous session's."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from totton_tpu.filters.sidecar import load_filter
from totton_tpu.io.devices import NullSink, NullSource, WavFileSink, WavFileSource
from totton_tpu.io.wav import read_wav, write_wav
from totton_tpu_torch.engine.upsampler import (
    StreamingUpsampler,
    fade_warm_widths,
    upsample_signal,
)
from totton_tpu_torch.io.stream import (
    StreamSession,
    ThreadedStreamSession,
    _quantize_nblocks,
    _warm_up,
)

torch.set_num_threads(2)


def _lf2(coefficients_dir):
    return load_filter(next(coefficients_dir.glob("filter_44k_2x_*.json")))


def _engine(coefficients_dir, **kw):
    return StreamingUpsampler(_lf2(coefficients_dir), channels=2,
                              device="cpu", **kw)


def test_threaded_matches_offline(coefficients_dir, rng, tmp_path):
    """Tolerance as the JAX test: s24 WAV quantization (1 LSB = 1.2e-7)
    plus float32 batch-order noise, atol 5e-7."""
    lf = _lf2(coefficients_dir)
    n = 4321  # exercises the partial-final-block path
    x = (rng.normal(size=(2, n)) * 0.3).astype(np.float32)
    wav_in = str(tmp_path / "in.wav")
    write_wav(wav_in, x, 352800)
    sink = WavFileSink(str(tmp_path / "out.wav"), 705600)
    stats = ThreadedStreamSession(
        WavFileSource(wav_in), sink, _engine(coefficients_dir),
        period_frames=512).run()
    sink.close()
    assert stats.frames_in == n
    assert stats.frames_out == n * 2
    y, _ = read_wav(str(tmp_path / "out.wav"))
    assert y.shape == (2, n * 2)
    ref = upsample_signal(read_wav(wav_in)[0], lf, device="cpu")
    np.testing.assert_allclose(y, np.clip(ref, -1, 0.9999999), atol=5e-7)


def test_threaded_equals_synchronous_session(coefficients_dir, rng,
                                             tmp_path):
    """The threaded and the synchronous session give the same samples
    (atol 1e-7: the same dispatches, summed in the same order)."""
    n = 9000
    x = (rng.normal(size=(2, n)) * 0.3).astype(np.float32)
    wav_in = str(tmp_path / "in.wav")
    write_wav(wav_in, x, 352800)
    outs = []
    for cls in (ThreadedStreamSession, StreamSession):
        path = str(tmp_path / f"{cls.__name__}.wav")
        sink = WavFileSink(path, 705600)
        cls(WavFileSource(wav_in), sink, _engine(coefficients_dir),
            period_frames=700, max_batch_blocks=4).run()
        sink.close()
        outs.append(read_wav(path)[0])
    assert outs[0].shape == outs[1].shape == (2, 2 * n)
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-7)


def test_threaded_stop_terminates(coefficients_dir):
    session = ThreadedStreamSession(
        NullSource(channels=2, sample_rate=352800), NullSink(),
        _engine(coefficients_dir))
    t = threading.Thread(target=session.run)
    t.start()
    time.sleep(0.3)
    session.stop()
    t.join(timeout=15)
    assert not t.is_alive()
    assert session.stats.blocks_processed > 0


def test_realtime_overflow_drops_not_blocks(coefficients_dir):
    """A realtime feeder drops and counts a chunk against a full ring."""
    src = NullSource(channels=2, sample_rate=352800, total_frames=4096)
    src.realtime = True
    session = ThreadedStreamSession(src, NullSink(),
                                    _engine(coefficients_dir),
                                    period_frames=4096, buffer_blocks=3)
    filler = np.zeros(1024, np.float32)
    while session._in_ring.write(filler):
        pass
    session._feeder(max_frames=4096)
    assert session.stats.input_overflows >= 1
    assert session.stats.frames_in == 4096
    assert session._feed_done.is_set()


def _stalled_write(coefficients_dir, realtime):
    src = NullSource(channels=2, sample_rate=352800)
    if realtime:
        src.realtime = True
    session = ThreadedStreamSession(src, NullSink(),
                                    _engine(coefficients_dir),
                                    buffer_blocks=3)
    ring = session._out_ring
    while ring.write(np.zeros(1024, np.float32)):
        pass
    leftover = ring.available_to_write()
    if leftover:
        ring.write(np.zeros(leftover, np.float32))
    flat = np.zeros(ring.capacity - (ring.capacity % 2), np.float32)
    writer = threading.Thread(target=session._write_out, args=(flat,))
    writer.start()
    time.sleep(0.1)
    mid = session.stats.output_overflows
    while writer.is_alive():
        ring.read(min(4096, ring.available_to_read()))
        time.sleep(0.001)
    writer.join(timeout=5)
    assert not writer.is_alive()
    return mid, session.stats.output_overflows


def test_write_out_counts_one_overflow_per_episode(coefficients_dir):
    assert _stalled_write(coefficients_dir, realtime=True) == (1, 1)


def test_write_out_offline_backpressure_counts_nothing(coefficients_dir):
    assert _stalled_write(coefficients_dir, realtime=False) == (0, 0)


def test_low_latency_dispatch_quantized_to_warmed_shapes():
    for ready in range(1, 8):
        assert _quantize_nblocks(ready, 8, low_latency=True) == 1
    for ready in (8, 9, 100):
        assert _quantize_nblocks(ready, 8, low_latency=True) == 8
    assert _quantize_nblocks(3, 8, low_latency=False) == 2
    assert _quantize_nblocks(353, 512, low_latency=False) == 256


def test_output_ring_size_independent_of_dispatch_depth(coefficients_dir):
    eng = _engine(coefficients_dir)
    session = ThreadedStreamSession(
        NullSource(channels=2, sample_rate=352800), NullSink(), eng,
        buffer_blocks=8, max_batch_blocks=512)
    assert session._out_ring.capacity == eng.config.block_size * 8 * 2


def test_threaded_session_frame_conservation(coefficients_dir, rng,
                                             tmp_path):
    """Many small period reads: frames_out == frames_in * ratio exactly,
    the padded EOF flush included."""
    n = 4999
    x = (rng.normal(size=(2, n)) * 0.1).astype(np.float32)
    wav_in = str(tmp_path / "in.wav")
    write_wav(wav_in, x, 352800)
    stats = ThreadedStreamSession(
        WavFileSource(wav_in), NullSink(), _engine(coefficients_dir),
        period_frames=7).run()
    assert stats.frames_in == n
    assert stats.frames_out == n * 2


def test_warm_up_probes_the_chains_inner_upsampler(coefficients_dir,
                                                   tmp_path):
    """A CrossfeedChain delegates dispatch to its inner upsampler, so the
    warm-up runs that one's fade widths (as the reference's does)."""
    from totton_tpu.filters.hrtf import generate_all
    from totton_tpu_torch.engine.chain import CrossfeedChain
    from totton_tpu_torch.engine.crossfeed import (
        CrossfeedFilter,
        CrossfeedProcessor,
    )

    cf = generate_all(tmp_path, sizes=["M"], families=["44k"])[0]
    inner = _engine(coefficients_dir, swap_fade_frames=4096)
    chain = CrossfeedChain(inner, CrossfeedProcessor(
        CrossfeedFilter.load(cf), device="cpu"))
    widths = []
    original = chain.process_block

    def record(x):
        widths.append(x.shape[1] // chain.block_input_frames)
        return original(x)

    chain.process_block = record
    _warm_up(chain, 2, chain.block_input_frames, 16)
    fade = fade_warm_widths(4096, inner.config.block_size)
    assert max(fade) > 1  # the probe bites: more than the {1, 16} set
    assert sorted(widths) == sorted({1, 16, *fade})
