"""Streaming session on the port: source -> ring -> engine -> ring -> sink.

A copy of ``totton_tpu.io.stream`` (``StreamStats``, ``_EnginePipeline``,
``StreamSession`` and the live-mode ``ThreadedStreamSession``), carried
because that module imports the JAX engine at its top and so loads jax.
The sessions duck-type their engine, so they drive the port's
``StreamingUpsampler`` and ``CrossfeedChain`` unchanged. The copy stays:
the JAX package is the frozen reference, so its imports will not become
lazy. ``tests/test_torch_copies.py`` holds the copy to the reference
outside its listed seams.

Period-sized reads are decoupled from filter-block-sized dispatches by
ring buffers; offline sources accumulate deep dispatches
(OFFLINE_BATCH_BLOCKS); the final partial block is zero-padded and trimmed
to frames_read * ratio output samples; up to PIPELINE_DEPTH dispatches are
in flight through the engine's dispatch_block/fetch.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time

import numpy as np

from totton_tpu_torch.io.devices import AudioSink, AudioSource, SinkClosedError
from totton_tpu_torch.io.ring_buffer import make_ring_buffer
from totton_tpu_torch.utils.profiling import BlockTimer
from totton_tpu_torch.engine.upsampler import StreamingUpsampler


@dataclasses.dataclass
class StreamStats:
    """Counters for one streaming session.

    A threaded session mutates this from several threads (feeder:
    frames_in/input_overflows; drainer: frames_out; main: dispatch
    counters + the stats-file snapshot), so every mutation goes
    through the add_*/count_* methods, which serialize on one lock, and
    to_json snapshots under the same lock — counts are exact and a
    snapshot can never tear (frames_in observed without its matching
    overflow count, etc.).
    """

    frames_in: int = 0
    frames_out: int = 0
    blocks_processed: int = 0
    input_overflows: int = 0
    output_overflows: int = 0
    start_time: float = dataclasses.field(default_factory=time.monotonic)
    process_time_s: float = 0.0
    input_rate: int = 0
    output_rate: int = 0
    timer: BlockTimer = dataclasses.field(default_factory=BlockTimer)
    # Output level metering (beyond reference: its stats surface has no
    # signal levels at all). peak/sum-of-squares over everything emitted;
    # clipped = samples at/over full scale BEFORE the sink's PCM clamp —
    # the runtime complement of the toolkit's offline safe-gain calc.
    peak_out: float = 0.0
    sum_sq_out: float = 0.0
    metered_samples: int = 0
    clipped_samples: int = 0
    # Transport fault accounting (socket endpoints; the network analog of
    # the reference's ALSA xrun counters). Folded from the endpoints by
    # fold_endpoint_faults; last_transport_error lets the CLI exit
    # nonzero on abnormal termination instead of reporting a clean stop.
    transport_errors: int = 0
    reconnects: int = 0
    last_transport_error: str | None = None
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    # -- cross-thread mutators ---------------------------------------------

    def add_frames_in(self, n: int) -> None:
        with self._lock:
            self.frames_in += n

    def add_frames_out(self, n: int) -> None:
        with self._lock:
            self.frames_out += n

    def count_input_overflow(self) -> None:
        with self._lock:
            self.input_overflows += 1

    def count_output_overflow(self) -> None:
        with self._lock:
            self.output_overflows += 1

    def add_dispatch(self, blocks: int, seconds: float) -> None:
        with self._lock:
            self.blocks_processed += blocks
            self.process_time_s += seconds

    @property
    def realtime_factor(self) -> float:
        """Output samples produced per second of compute, over the output
        rate (how many x faster than realtime the DSP runs)."""
        if self.process_time_s <= 0 or self.output_rate <= 0:
            return 0.0
        return (self.frames_out / self.process_time_s) / self.output_rate

    def fold_endpoint_faults(self, *endpoints) -> None:
        """Adopt transport-fault counters exposed by the endpoints (duck
        typed: sources/sinks without the counters contribute nothing).
        Called when a session finishes, before the final stats snapshot."""
        with self._lock:
            total = sum(getattr(e, "transport_errors", 0) for e in endpoints)
            self.transport_errors = total
            self.reconnects = sum(
                getattr(e, "reconnects", 0) for e in endpoints)
            for e in endpoints:
                err = getattr(e, "last_error", None)
                if err:
                    self.last_transport_error = err

    def meter_output(self, y: np.ndarray,
                     scale: float | None = None) -> None:
        """Fold one emitted batch into the level meters (~5 ns/sample).

        `scale` marks a quantized (device-PCM) batch of integer sample
        values: levels are normalized to full scale, and samples at the
        rails stand in for the float path's pre-clamp >= 1.0 clip count
        (the over-range excursion itself was clamped on the device)."""
        if y.size == 0:
            return
        if scale is not None:
            clipped = int(np.count_nonzero(y >= scale - 1)
                          + np.count_nonzero(y <= -scale))
            y = y.astype(np.float32) * np.float32(1.0 / scale)
            peak = float(np.abs(y).max())
        else:
            a = np.abs(y)
            peak = float(a.max())
            clipped = int(np.count_nonzero(a >= 1.0))
        sum_sq = float(np.einsum("...ij,...ij->", y, y, dtype=np.float64))
        with self._lock:
            if peak > self.peak_out:
                self.peak_out = peak
            self.sum_sq_out += sum_sq
            self.metered_samples += y.size
            self.clipped_samples += clipped

    def _level_json(self) -> dict:
        def dbfs(power_ratio: float) -> float | None:
            if power_ratio <= 0:
                return None
            return round(10.0 * np.log10(power_ratio), 2)

        rms = (self.sum_sq_out / self.metered_samples
               if self.metered_samples else 0.0)
        return {
            "peak_dbfs": dbfs(self.peak_out ** 2),
            "rms_dbfs": dbfs(rms),
            "clipped_samples": self.clipped_samples,
        }

    def to_json(self) -> dict:
        with self._lock:
            return self._to_json_locked()

    def _to_json_locked(self) -> dict:
        return {
            "uptime_ms": int((time.monotonic() - self.start_time) * 1000),
            "input_rate": self.input_rate,
            "output_rate": self.output_rate,
            "frames_in": self.frames_in,
            "frames_out": self.frames_out,
            "blocks_processed": self.blocks_processed,
            "xruns": {
                "input_overflows": self.input_overflows,
                "output_overflows": self.output_overflows,
            },
            "transport": {
                "errors": self.transport_errors,
                "reconnects": self.reconnects,
                "last_error": self.last_transport_error,
            },
            "realtime_factor": self.realtime_factor,
            "process_time_s": self.process_time_s,
            "dispatch_timing": self.timer.summary(),
            "output_level": self._level_json(),
        }


#: Dispatch granules (blocks per device dispatch) when the caller doesn't
#: pick one. Offline (file) sources accumulate deep dispatches, so the
#: frame kernel's products get many frames along their rows; the JAX
#: package's 512 is kept until a depth sweep on the card picks another.
#: Realtime/pipe sources dispatch as soon as one block is ready to bound
#: latency.
OFFLINE_BATCH_BLOCKS = 512
REALTIME_BATCH_BLOCKS = 16


def _is_low_latency(source: AudioSource) -> bool:
    """True for sources that must not sit behind a deep dispatch batch:
    realtime capture (which additionally drops on overflow) and live
    pipes like stdin (backpressure-safe, but seconds of accumulation
    latency would be unacceptable for `arecord | totton-stream -`)."""
    return bool(getattr(source, "realtime", False)
                or getattr(source, "low_latency", False))


def _auto_batch_blocks(source: AudioSource, realtime_default: int) -> int:
    if _is_low_latency(source):
        return realtime_default
    return OFFLINE_BATCH_BLOCKS


def _warm_up(engine: StreamingUpsampler, channels: int, block_in: int,
             max_batch_blocks: int) -> None:
    """Run the dispatch shapes a low-latency stream will hit before the
    first sample arrives (the kernel library builds at first use, and the
    first dispatch of each shape allocates), then reset the engine. The
    crossfade's partial shapes are part of the set: a CrossfeedChain
    delegates dispatch to its inner upsampler, so that one is probed for
    the fade, as the reference does."""
    shapes = {1, max_batch_blocks}
    inner = getattr(engine, "upsampler", engine)
    fade = getattr(inner, "_swap_fade_frames", 0)
    if fade:
        from totton_tpu_torch.engine.upsampler import fade_warm_widths

        shapes.update(fade_warm_widths(fade, inner.config.block_size))
    for nblocks in sorted(shapes):
        engine.process_block(
            np.zeros((channels, nblocks * block_in), np.float32))
    engine.reset()


def _quantize_nblocks(ready: int, max_batch_blocks: int,
                      low_latency: bool) -> int:
    """Blocks to dispatch given `ready` whole blocks in the ring.

    Low-latency sessions only hit the shapes _warm_up ran
    ({1, max_batch_blocks}). Offline sources accumulate to exactly
    max_batch_blocks in steady state; a smaller `ready` occurs only at EOF
    flush, and is quantized down to a power of two (the loop re-dispatches
    until drained), so the set of dispatch shapes is
    {1, 2, 4, ..., max_batch_blocks} for every input length — the JAX
    package's shape discipline, kept so the two sessions dispatch alike.
    """
    if low_latency:
        return max_batch_blocks if ready >= max_batch_blocks else 1
    if ready >= max_batch_blocks:
        return max_batch_blocks
    from totton_tpu_torch.utils.intmath import pow2_floor

    return pow2_floor(ready)


#: In-flight device steps per session when the engine supports two-phase
#: dispatch (dispatch_block/fetch). 2 = classic double buffering plus one
#: queued step: the device computes step i+1 (and has i+2 queued) while
#: the host drains/writes step i. Each in-flight step holds one dispatch's
#: output in pinned host memory (209 MB at 16x stereo float32 for the
#: 512-block offline granule).
PIPELINE_DEPTH = 2


class _EnginePipeline:
    """Overlaps device compute with host IO around an engine's two-phase
    dispatch API.

    submit() dispatches a step and drains the OLDEST in-flight step only
    once more than `depth` are outstanding; flush() drains the rest at
    EOF. The engine queues each step on the CUDA stream and its carried
    tail is a device tensor, so steps chain on the device — the host never
    sits between step i's compute and step i+1's dispatch. Engines without
    dispatch_block fall back to synchronous process_block — identical
    semantics, no overlap.

    Stats: per-step process_time = its dispatch submit time + its fetch
    (device-wait + transfer) time — disjoint host intervals, so the sum
    UNDERSTATES device time exactly when overlap is working and the
    realtime factor reflects the pipelined rate. The BlockTimer
    percentiles measure the fetch wait.
    """

    def __init__(self, engine, stats: StreamStats, block_input_frames: int,
                 emit, depth: int | None = None) -> None:
        self.engine = engine
        self.stats = stats
        self.block_in = block_input_frames
        self.emit = emit  # callback(y, valid_in_frames)
        if depth is None:
            depth = PIPELINE_DEPTH if hasattr(engine, "dispatch_block") else 0
        self.depth = max(0, depth) if hasattr(engine, "dispatch_block") else 0
        self._inflight: collections.deque = collections.deque()

    def submit(self, frames: np.ndarray, valid_in: int) -> None:
        nblocks = frames.shape[1] // self.block_in
        if self.depth == 0:
            t0 = time.monotonic()
            with self.stats.timer.measure():
                y = self.engine.process_block(frames)
            self.stats.add_dispatch(nblocks, time.monotonic() - t0)
            self.emit(y, valid_in)
            return
        t0 = time.monotonic()
        handle = self.engine.dispatch_block(frames)
        self._inflight.append(
            (handle, valid_in, nblocks, time.monotonic() - t0))
        while len(self._inflight) > self.depth:
            self._drain_one()

    def _drain_one(self) -> None:
        handle, valid_in, nblocks, submit_s = self._inflight.popleft()
        t0 = time.monotonic()
        with self.stats.timer.measure():
            y = self.engine.fetch(handle)
        self.stats.add_dispatch(nblocks,
                                submit_s + time.monotonic() - t0)
        self.emit(y, valid_in)

    def flush(self) -> None:
        while self._inflight:
            self._drain_one()


class StreamSession:
    """Drives source -> engine -> sink until EOF or stop().

    ``period_frames`` is clamped to the filter's input block size (reference:
    alsa_streamer_main.cpp:404-418). ``max_batch_blocks`` bounds how many
    blocks go to the device in one dispatch (latency/throughput knob);
    ``None`` selects automatically: deep batches for offline sources
    (OFFLINE_BATCH_BLOCKS), block-at-a-time for realtime ones. Offline
    sources also *accumulate* a full batch before dispatching (EOF flushes
    the remainder); realtime sources dispatch whatever is ready.
    """

    def __init__(
        self,
        source: AudioSource,
        sink: AudioSink,
        engine: StreamingUpsampler,
        period_frames: int = 4096,
        buffer_blocks: int = 8,
        max_batch_blocks: int | None = None,
        stats_path: str | None = None,
        pipeline_depth: int | None = None,
    ) -> None:
        self.source = source
        self.sink = sink
        self.engine = engine
        # Multi-process sharded engines expose per-process granules: this
        # process feeds only its local channel rows / time span.
        block_in = (getattr(engine, "local_block_input_frames", None)
                    or engine.block_input_frames)
        self.block_input_frames = block_in
        self.period_frames = max(1, min(period_frames, block_in))
        self.channels = (getattr(engine, "local_channels", None)
                         or engine.channels)
        low_latency = _is_low_latency(source)
        if max_batch_blocks is None:
            max_batch_blocks = _auto_batch_blocks(source,
                                                  REALTIME_BATCH_BLOCKS)
        self.max_batch_blocks = max(1, max_batch_blocks)
        self._low_latency = low_latency
        self._dispatch_threshold = 1 if low_latency else self.max_batch_blocks
        capacity = max(block_in, self.period_frames) * max(
            3, buffer_blocks, self.max_batch_blocks + 2)
        self._in_ring = make_ring_buffer(capacity * self.channels)
        self.stats = StreamStats(
            input_rate=source.sample_rate or 0,
            output_rate=(source.sample_rate or 0) * engine.ratio,
        )
        self._stats_path = stats_path
        # Device-PCM engines emit quantized int16 sample values; route
        # them through the sinks' packed path and meter at full scale.
        self._pcm_scale = (32768.0 if getattr(engine, "device_pcm", None)
                           is not None else None)
        self._stop = threading.Event()
        self._pipeline = _EnginePipeline(
            engine, self.stats, block_in, self._emit_output, pipeline_depth)
        if low_latency:
            _warm_up(engine, self.channels, block_in, self.max_batch_blocks)

    def stop(self) -> None:
        self._stop.set()

    def _write_stats(self) -> None:
        if not self._stats_path:
            return
        tmp = self._stats_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.stats.to_json(), f)
        os.replace(tmp, self._stats_path)

    def _dispatch(self, frames: np.ndarray, valid_in_frames: int) -> None:
        """Submit whole blocks to the (pipelined) engine; the pipeline
        calls _emit_output when each step's result is drained."""
        self._pipeline.submit(frames, valid_in_frames)

    def _emit_output(self, y: np.ndarray, valid_in_frames: int) -> None:
        valid_out = valid_in_frames * self.engine.ratio
        out = y[:, :valid_out]
        self.stats.meter_output(out, scale=self._pcm_scale)
        if self._pcm_scale is not None:
            self.sink.write_quantized(out)
        else:
            self.sink.write_frames(out)
        self.stats.add_frames_out(valid_out)

    def run(self, max_frames: int | None = None) -> StreamStats:
        """Synchronous pump loop. Returns final stats."""
        try:
            return self._run(max_frames)
        except SinkClosedError:
            # A departed consumer is the sink-side analog of source EOF:
            # stop cleanly (io/sockets.py docstring contract). Abnormal
            # departures (RST) still land in the transport counters below.
            return self.stats
        finally:
            self.stats.fold_endpoint_faults(self.source, self.sink)
            self._write_stats()

    def _run(self, max_frames: int | None) -> StreamStats:
        block_in = self.block_input_frames
        frames_remaining = max_frames
        eof = False
        while not self._stop.is_set() and not eof:
            want = self.period_frames
            if frames_remaining is not None:
                want = min(want, frames_remaining)
            if want == 0:
                # max_frames reached: flush like EOF (don't drop the
                # partial block accumulated in the ring).
                eof = True
                got = 0
                chunk = None
            else:
                chunk = self.source.read_frames(want)
                got = chunk.shape[1]
            if got == 0:
                eof = True
            else:
                self.stats.add_frames_in(got)
                if frames_remaining is not None:
                    frames_remaining -= got
                if not self._in_ring.write(chunk.T.ravel()):
                    # Overflow: drop accumulated audio (reference:
                    # alsa_streamer_main.cpp:516-521).
                    self.stats.count_input_overflow()
                    self._in_ring.clear()
                    self._in_ring.write(chunk.T.ravel())

            # Dispatch whole blocks once a full batch has accumulated
            # (offline) or as soon as any block is ready (realtime); EOF
            # flushes whatever whole blocks remain.
            while True:
                avail = self._in_ring.available_to_read() // self.channels
                ready = avail // block_in
                if ready == 0 or (not eof and ready < self._dispatch_threshold):
                    break
                nblocks = _quantize_nblocks(
                    ready, self.max_batch_blocks, self._low_latency)
                flat = self._in_ring.read(nblocks * block_in * self.channels)
                frames = flat.reshape(-1, self.channels).T
                self._dispatch(frames, nblocks * block_in)
            if self._low_latency:
                # About to block in read_frames: completed audio must not
                # sit retained in the pipeline — for realtime sessions the
                # device is paced by the source anyway, so draining here
                # costs no throughput and keeps output latency at one
                # dispatch, not PIPELINE_DEPTH of them.
                self._pipeline.flush()

            if eof:
                # Final partial block: zero-pad, emit only real frames
                # (reference file mode: alsa_streamer_main.cpp:301-303).
                left = self._in_ring.available_to_read() // self.channels
                if left:
                    flat = self._in_ring.read(left * self.channels)
                    frames = flat.reshape(-1, self.channels).T
                    padded = np.pad(frames, [(0, 0), (0, block_in - left)])
                    self._dispatch(padded, left)
            self._write_stats()

        self._pipeline.flush()
        self._write_stats()
        return self.stats


class ThreadedStreamSession:
    """Live-mode pump: feeder and drainer threads decouple endpoint IO from
    device dispatch (the reference's SPSC producer/consumer design,
    include/io/audio_ring_buffer.h — here actually on separate threads; the
    reference runs both sides on one thread, alsa_streamer_main.cpp:473-493).

    Thread layout:
      feeder:  source.read_frames -> input ring  (overflow: drop + count;
               clear() is unsafe cross-thread on an SPSC ring)
      main:    input ring -> engine.process_block -> output ring
      drainer: output ring -> sink.write_frames
    """

    def __init__(
        self,
        source: AudioSource,
        sink: AudioSink,
        engine: StreamingUpsampler,
        period_frames: int = 4096,
        buffer_blocks: int = 8,
        max_batch_blocks: int | None = None,
        stats_path: str | None = None,
        pipeline_depth: int | None = None,
    ) -> None:
        self.source = source
        self.sink = sink
        self.engine = engine
        block_in = (getattr(engine, "local_block_input_frames", None)
                    or engine.block_input_frames)
        self.block_input_frames = block_in
        self.period_frames = max(1, min(period_frames, block_in))
        self.channels = (getattr(engine, "local_channels", None)
                         or engine.channels)
        low_latency = _is_low_latency(source)
        if max_batch_blocks is None:
            max_batch_blocks = _auto_batch_blocks(source, 8)
        self.max_batch_blocks = max(1, max_batch_blocks)
        self._low_latency = low_latency
        self._dispatch_threshold = 1 if low_latency else self.max_batch_blocks
        depth = max(3, buffer_blocks, self.max_batch_blocks + 2)
        cap_in = max(block_in, self.period_frames) * depth
        # The output ring does NOT scale with dispatch depth: _emit writes
        # in ring-sized chunks with backpressure (the drainer frees space
        # concurrently), so a deep offline dispatch doesn't force a
        # proportionally deep (hundreds of MB) output allocation.
        cap_out = engine.config.block_size * max(3, buffer_blocks)
        self._in_ring = make_ring_buffer(cap_in * self.channels)
        self._out_ring = make_ring_buffer(cap_out * self.channels)
        self.stats = StreamStats(
            input_rate=source.sample_rate or 0,
            output_rate=(source.sample_rate or 0) * engine.ratio,
        )
        self._stats_path = stats_path
        # Device-PCM mode: the engine emits int16 sample values. They ride
        # the float32 output ring as their EXACT float32 representations
        # (|int16| <= 2^15 << 2^24, the f32 integer-exact range); the
        # drainer converts back and hands the sink packed samples.
        self._pcm_scale = (32768.0 if getattr(engine, "device_pcm", None)
                           is not None else None)
        self._stop = threading.Event()
        self._feed_done = threading.Event()
        self._compute_done = threading.Event()
        self._pipeline = _EnginePipeline(
            engine, self.stats, block_in, self._emit_output, pipeline_depth)
        if low_latency:
            _warm_up(engine, self.channels, block_in, self.max_batch_blocks)

    def stop(self) -> None:
        self._stop.set()

    def _feeder(self, max_frames: int | None) -> None:
        remaining = max_frames
        try:
            while not self._stop.is_set():
                want = self.period_frames
                if remaining is not None:
                    want = min(want, remaining)
                    if want == 0:
                        break
                chunk = self.source.read_frames(want)
                got = chunk.shape[1]
                if got == 0:
                    break
                self.stats.add_frames_in(got)
                if remaining is not None:
                    remaining -= got
                flat = chunk.T.ravel()
                while not self._in_ring.write(flat):
                    if self._stop.is_set():
                        return
                    if getattr(self.source, "realtime", False):
                        # Real-time capture can't wait: drop the chunk.
                        self.stats.count_input_overflow()
                        break
                    # File/pipe sources just wait for the compute side.
                    time.sleep(0.001)
        finally:
            self._feed_done.set()

    def _drainer(self) -> None:
        while True:
            avail = self._out_ring.available_to_read()
            avail -= avail % self.channels
            if avail:
                flat = self._out_ring.read(avail)
                frames = flat.reshape(-1, self.channels).T
                try:
                    if self._pcm_scale is not None:
                        self.sink.write_quantized(frames.astype(np.int16))
                    else:
                        self.sink.write_frames(frames)
                except SinkClosedError:
                    # Departed consumer: stop the whole session cleanly
                    # (feeder and main loop watch the same event; _write_out
                    # bails on it too, so nothing deadlocks on a full ring).
                    self._stop.set()
                    return
                self.stats.add_frames_out(frames.shape[1])
            elif self._compute_done.is_set():
                return
            elif self._stop.is_set() and not avail:
                return
            else:
                time.sleep(0.001)

    def _emit(self, frames: np.ndarray, valid_in: int) -> None:
        self._pipeline.submit(frames, valid_in)

    def _emit_output(self, y: np.ndarray, valid_in: int) -> None:
        out = y[:, : valid_in * self.engine.ratio]
        self.stats.meter_output(out, scale=self._pcm_scale)
        self._write_out(out.T.ravel())

    def _write_out(self, flat: np.ndarray) -> None:
        """Backpressured output-ring write in whatever-fits chunks.

        Chunking keeps the ring small — it doesn't have to admit a whole
        max_batch_blocks dispatch at once — which means a deep OFFLINE
        dispatch fills the ring by design; that is healthy backpressure,
        not an xrun, and counts nothing. Only LOW-LATENCY sessions count
        output overflows (a stalled realtime sink means audio is falling
        behind the clock — reference ring-overflow semantics,
        alsa_streamer_main.cpp:557-562, minus the drop: the drainer owns
        the sink, so waiting is safe), and at most ONE per dispatch's
        stalled episode, never one per 2 ms polling iteration.
        """
        n = len(flat)
        pos = 0
        counted = False
        while pos < n:
            room = self._out_ring.available_to_write()
            room -= room % self.channels  # keep frames whole for the drainer
            take = min(n - pos, room)
            if take and self._out_ring.write(flat[pos:pos + take]):
                pos += take
                continue
            if self._stop.is_set():
                return
            if self._low_latency and not counted:
                counted = True
                self.stats.count_output_overflow()
            time.sleep(0.002)

    def run(self, max_frames: int | None = None) -> StreamStats:
        block_in = self.block_input_frames
        feeder = threading.Thread(
            target=self._feeder, args=(max_frames,), name="totton-feeder"
        )
        drainer = threading.Thread(target=self._drainer, name="totton-drainer")
        feeder.start()
        drainer.start()
        try:
            while True:
                # The end-of-input flag before the ring's fill: once the
                # flag is set the feeder has written everything, so the
                # fill read after it is final. Read the other way round,
                # the feeder's last writes could land between the two and
                # leave more than a block for the padded tail.
                feed_done = self._feed_done.is_set()
                avail = self._in_ring.available_to_read() // self.channels
                ready = avail // block_in
                if ready and (ready >= self._dispatch_threshold or feed_done):
                    nblocks = _quantize_nblocks(
                        ready, self.max_batch_blocks, self._low_latency)
                    flat = self._in_ring.read(
                        nblocks * block_in * self.channels
                    )
                    self._emit(
                        flat.reshape(-1, self.channels).T, nblocks * block_in
                    )
                    self._write_stats()
                elif feed_done:
                    left = self._in_ring.available_to_read() // self.channels
                    if left:
                        flat = self._in_ring.read(left * self.channels)
                        frames = flat.reshape(-1, self.channels).T
                        self._emit(
                            np.pad(frames, [(0, 0), (0, block_in - left)]),
                            left,
                        )
                    break
                elif self._stop.is_set():
                    break
                else:
                    if self._low_latency:
                        # Input-starved live session: drain in-flight
                        # steps instead of retaining completed audio (the
                        # device is source-paced anyway; output latency
                        # stays at one dispatch, not PIPELINE_DEPTH).
                        # Offline sessions keep the pipeline primed — a
                        # momentary feeder lag must not serialize the
                        # next deep batch behind a full drain.
                        self._pipeline.flush()
                    time.sleep(0.001)
        finally:
            # Drain in-flight pipelined steps BEFORE signaling the drainer
            # (it exits once compute is done and its ring is empty).
            self._pipeline.flush()
            self._compute_done.set()
            feeder.join(timeout=10)
            drainer.join(timeout=10)
            self.stats.fold_endpoint_faults(self.source, self.sink)
            self._write_stats()
        return self.stats

    _write_stats = StreamSession._write_stats
