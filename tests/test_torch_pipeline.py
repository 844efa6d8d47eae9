"""The port's two-phase engine (dispatch_block/fetch) and pipelined
sessions on the CPU: tests/test_pipeline.py's cases with the port's
classes and device="cpu" (the sharded engine on a 2x2 mesh of CPU cells),
at the same tolerances, and the seeded inputs held to the JAX package's
offline upsample_signal (f32 rel < 1e-5; device-PCM s16 within one LSB)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from totton_tpu.engine.upsampler import StreamingUpsampler as JaxUpsampler
from totton_tpu.engine.upsampler import upsample_signal as jax_upsample_signal
from totton_tpu.filters.sidecar import FilterSidecar as JaxSidecar
from totton_tpu.filters.sidecar import LoadedFilter as JaxLoadedFilter
from totton_tpu.io.pcm import PcmFormat as JaxPcmFormat
from totton_tpu_torch.engine.upsampler import StreamingUpsampler, upsample_signal
from totton_tpu_torch.filters.sidecar import FilterSidecar, LoadedFilter
from totton_tpu_torch.io.stream import (
    StreamSession,
    StreamStats,
    ThreadedStreamSession,
    _EnginePipeline,
)

from test_pipeline import _ArraySource, _CaptureSink

torch.set_num_threads(2)

REL = 1e-5
CPU = "cpu"


def _filter(taps=17, fft=64, ratio=4, seed=3, ref=False):
    """The JAX test's seeded filter, as the port's LoadedFilter (or the JAX
    package's with ``ref``)."""
    rng = np.random.default_rng(seed)
    loaded, sidecar = ((JaxLoadedFilter, JaxSidecar) if ref
                       else (LoadedFilter, FilterSidecar))
    return loaded(
        taps=rng.normal(size=taps).astype(np.float32),
        sidecar=sidecar(
            coefficients_bin="<test>", taps=taps, fft_size=fft,
            block_size=fft - (taps - 1), upsample_factor=ratio,
        ),
    )


def _rel(a, b) -> float:
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / np.abs(b).max())


class TestEngineTwoPhase:
    def test_chained_dispatches_equal_sequential(self, rng):
        lf = _filter()
        x = rng.normal(size=(2, 6 * (64 - 16) // 4)).astype(np.float32)
        block_in = (64 - 16) // 4

        ref_eng = StreamingUpsampler(lf, channels=2, device=CPU)
        ref = [np.array(ref_eng.process_block(
            x[:, i * block_in:(i + 1) * block_in])) for i in range(6)]

        eng = StreamingUpsampler(lf, channels=2, device=CPU)
        # Dispatch three steps BEFORE fetching any: the carried tail must
        # chain on-device without a host sync.
        handles = [eng.dispatch_block(x[:, i * block_in:(i + 1) * block_in])
                   for i in range(3)]
        got = [eng.fetch(h) for h in handles]
        handles = [eng.dispatch_block(x[:, i * block_in:(i + 1) * block_in])
                   for i in range(3, 6)]
        got += [eng.fetch(h) for h in handles]
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(r, g)

    def test_fade_bookkeeping_across_inflight_swap(self, rng):
        """A hot-swap between two in-flight dispatches applies to the
        steps dispatched AFTER it, with the fade ramp carried in dispatch
        order — exactly like the synchronous path."""
        lf = _filter()
        lf2 = _filter(seed=9)
        block_in = (64 - 16) // 4
        x = rng.normal(size=(2, 4 * block_in)).astype(np.float32)
        fade = 40

        ref_eng = StreamingUpsampler(lf, channels=2, swap_fade_frames=fade,
                                     device=CPU)
        ref = [np.array(ref_eng.process_block(x[:, :block_in]))]
        ref_eng.load_filter(lf2)
        ref += [np.array(ref_eng.process_block(
            x[:, i * block_in:(i + 1) * block_in])) for i in range(1, 4)]

        eng = StreamingUpsampler(lf, channels=2, swap_fade_frames=fade,
                                 device=CPU)
        h0 = eng.dispatch_block(x[:, :block_in])
        eng.load_filter(lf2)
        hs = [eng.dispatch_block(x[:, i * block_in:(i + 1) * block_in])
              for i in range(1, 4)]
        got = [eng.fetch(h) for h in [h0] + hs]
        for r, g in zip(ref, got):
            np.testing.assert_allclose(r, g, rtol=1e-6, atol=1e-7)

    def test_device_pcm_two_phase(self, rng):
        from totton_tpu_torch.io.pcm import PcmFormat

        lf = _filter()
        block_in = (64 - 16) // 4
        x = (rng.normal(size=(2, 3 * block_in)) * 0.4).astype(np.float32)
        ref_eng = StreamingUpsampler(lf, channels=2,
                                     device_pcm=PcmFormat.S16_LE, device=CPU)
        ref = np.array(ref_eng.process_block(x))
        eng = StreamingUpsampler(lf, channels=2,
                                 device_pcm=PcmFormat.S16_LE, device=CPU)
        h = eng.dispatch_block(x)
        got = eng.fetch(h)
        np.testing.assert_array_equal(ref, got)
        assert got.dtype == np.int16


class TestShardedTwoPhase:
    def test_dispatch_fetch_equals_process_block(self, rng):
        from totton_tpu_torch.parallel import ShardedUpsampler, make_mesh

        lf = _filter(taps=33, fft=256, ratio=4)
        # Four CPU cells (as cli/serve.py's --shard-serve builds them on
        # the CPU) where the JAX test takes jax.devices()[:4].
        mesh = make_mesh(n_channel=2, n_time=2,
                         devices=[torch.device(CPU)] * 4)
        eng_a = ShardedUpsampler(lf, mesh, channels=2)
        eng_b = ShardedUpsampler(lf, mesh, channels=2)
        step_in = eng_a.block_input_frames
        x = rng.normal(size=(2, 3 * step_in)).astype(np.float32)
        ref = [np.array(eng_a.process_block(
            x[:, i * step_in:(i + 1) * step_in])) for i in range(3)]
        handles = [eng_b.dispatch_block(x[:, i * step_in:(i + 1) * step_in])
                   for i in range(3)]
        got = [eng_b.fetch(h) for h in handles]
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(r, g)


class TestSessionPipelining:
    @pytest.mark.parametrize("session_cls",
                             [StreamSession, ThreadedStreamSession])
    @pytest.mark.parametrize("depth", [1, 2, 3])
    def test_pipelined_equals_synchronous(self, rng, session_cls, depth):
        lf = _filter()
        block_in = (64 - 16) // 4
        x = rng.normal(size=(2, 11 * block_in + 5)).astype(np.float32)

        outs = []
        for d in (0, depth):
            sink = _CaptureSink()
            session = session_cls(
                _ArraySource(x), sink,
                StreamingUpsampler(lf, channels=2, device=CPU),
                period_frames=block_in, max_batch_blocks=2,
                pipeline_depth=d)
            stats = session.run()
            assert stats.frames_in == x.shape[1]
            assert stats.frames_out == x.shape[1] * 4
            outs.append(sink.out)
        np.testing.assert_array_equal(outs[0], outs[1])

    def test_auto_depth_engines_without_async_api(self):
        """Engines lacking dispatch_block silently run synchronously."""

        class _Plain:
            channels = 2
            ratio = 1
            block_input_frames = 8

            class config:
                block_size = 8

            def process_block(self, x):
                return np.asarray(x, np.float32)

        pipe = _EnginePipeline(_Plain(), StreamStats(), 8,
                               lambda y, v: None, depth=4)
        assert pipe.depth == 0

    @pytest.mark.parametrize("depth", [0, 3])
    def test_threaded_end_of_input_between_the_loops_reads(self, rng, depth):
        """The feeder's last writes and its end-of-input flag land between
        the threaded session's read of the input ring's fill and its read
        of the flag (forced here: the first fill read lets the feeder run
        and waits until it is done). The session still dispatches whole
        blocks and pads only the tail, and equals the synchronous session;
        read the other way round, the flag sent 3 blocks + 5 frames to the
        tail pad, which raised (ROADMAP C19)."""
        import threading

        lf = _filter()
        block_in = (64 - 16) // 4
        x = rng.normal(size=(2, 3 * block_in + 5)).astype(np.float32)
        release = threading.Event()

        class _GatedSource(_ArraySource):
            def read_frames(self, n):
                release.wait(timeout=10)
                return super().read_frames(n)

        sink = _CaptureSink()
        session = ThreadedStreamSession(
            _GatedSource(x), sink,
            StreamingUpsampler(lf, channels=2, device=CPU),
            period_frames=block_in, max_batch_blocks=2, pipeline_depth=depth)
        fill = session._in_ring.available_to_read
        main = threading.current_thread()

        def late_fill():
            n = fill()
            if threading.current_thread() is main and not release.is_set():
                release.set()
                assert session._feed_done.wait(timeout=10)
            return n

        session._in_ring.available_to_read = late_fill
        stats = session.run()
        assert release.is_set()
        assert stats.frames_out == x.shape[1] * 4
        ref = _CaptureSink()
        StreamSession(_ArraySource(x), ref,
                      StreamingUpsampler(lf, channels=2, device=CPU),
                      period_frames=block_in, max_batch_blocks=2).run()
        np.testing.assert_array_equal(sink.out, ref.out)

    def test_stats_count_all_steps(self, rng):
        lf = _filter()
        block_in = (64 - 16) // 4
        x = rng.normal(size=(2, 8 * block_in)).astype(np.float32)
        sink = _CaptureSink()
        session = StreamSession(
            _ArraySource(x), sink,
            StreamingUpsampler(lf, channels=2, device=CPU),
            period_frames=block_in, max_batch_blocks=1, pipeline_depth=2)
        stats = session.run()
        assert stats.blocks_processed == 8
        assert stats.frames_out == 8 * block_in * 4


class TestChainTwoPhase:
    def test_crossfeed_chain_pipelined_equals_sync(self, rng, tmp_path):
        from totton_tpu_torch.engine.chain import CrossfeedChain
        from totton_tpu_torch.engine.crossfeed import (
            CrossfeedFilter,
            CrossfeedProcessor,
        )
        from totton_tpu_torch.filters.hrtf import generate_all

        cf_path = generate_all(tmp_path, sizes=["M"], families=["44k"])[0]
        lf = _filter()
        block_in = (64 - 16) // 4
        x = rng.normal(size=(2, 9 * block_in)).astype(np.float32) * 0.3

        def build():
            return CrossfeedChain(
                StreamingUpsampler(lf, channels=2, device=CPU),
                CrossfeedProcessor(CrossfeedFilter.load(str(cf_path)),
                                   device=CPU))

        ref_eng = build()
        ref = [np.array(ref_eng.process_block(
            x[:, i * block_in:(i + 1) * block_in])) for i in range(9)]

        eng = build()
        handles = [eng.dispatch_block(x[:, i * block_in:(i + 1) * block_in])
                   for i in range(3)]
        got = [eng.fetch(h) for h in handles]
        handles = [eng.dispatch_block(x[:, i * block_in:(i + 1) * block_in])
                   for i in range(3, 9)]
        got += [eng.fetch(h) for h in handles]
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(r, g)


# The filters the cases above run, as (taps, fft, ratio, seed).
FILTERS = [(17, 64, 4, 3), (17, 64, 4, 9), (33, 256, 4, 3)]


@pytest.mark.parametrize("geometry", FILTERS)
def test_offline_output_matches_jax(rng, geometry):
    """The same seeded input through the JAX package's upsample_signal and
    the port's: f32 rel < 1e-5."""
    taps, fft, ratio, seed = geometry
    block_in = (fft - taps + 1) // ratio
    x = (rng.normal(size=(2, 11 * block_in + 5)) * 0.3).astype(np.float32)
    y = upsample_signal(x, _filter(taps, fft, ratio, seed), device=CPU)
    ref = jax_upsample_signal(x, _filter(taps, fft, ratio, seed, ref=True))
    assert _rel(y, np.asarray(ref)) < REL


def test_device_pcm_matches_jax_within_one_lsb(rng):
    """The device-PCM case's input through both packages' engines with
    device_pcm S16_LE: the int16 outputs within one LSB."""
    from totton_tpu_torch.io.pcm import PcmFormat

    block_in = (64 - 16) // 4
    x = (rng.normal(size=(2, 3 * block_in)) * 0.4).astype(np.float32)
    got = StreamingUpsampler(_filter(), channels=2,
                             device_pcm=PcmFormat.S16_LE,
                             device=CPU).process_block(x)
    ref = np.asarray(JaxUpsampler(_filter(ref=True), channels=2,
                                  device_pcm=JaxPcmFormat.S16_LE)
                     .process_block(x))
    assert got.dtype == ref.dtype == np.int16
    assert got.shape == ref.shape
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1
