"""Engine chaining: upsampler followed by post-processors at the output rate.

A copy of ``totton_tpu.engine.chain`` (which imports the JAX engines), around
the port's ``StreamingUpsampler`` and ``CrossfeedProcessor``. It is numpy
around the engines' two-phase API and carries no device code of its own.
``tests/test_torch_copies.py`` holds it to the reference.
"""

from __future__ import annotations

import numpy as np

from totton_tpu_torch.engine.crossfeed import CrossfeedProcessor
from totton_tpu_torch.engine.upsampler import StreamingUpsampler


class CrossfeedChain:
    """StreamingUpsampler-compatible facade applying crossfeed after
    upsampling. The upsampler's output block length must be a multiple of
    the crossfeed block; the remainder is carried in a small FIFO."""

    def __init__(self, upsampler: StreamingUpsampler,
                 crossfeed: CrossfeedProcessor) -> None:
        if getattr(upsampler, "device_pcm", None) is not None:
            # The chain convolves/mixes the upsampler's output in float;
            # quantization must stay with the sink here (the CLI's
            # --device-pcm eligibility enforces the same).
            raise ValueError(
                "CrossfeedChain requires a float-output upsampler "
                "(device_pcm=None)")
        self.upsampler = upsampler
        self.crossfeed = crossfeed
        self._pending = np.zeros((2, 0), dtype=np.float32)
        # Constant latency of one crossfeed block: guarantees the output
        # FIFO never underruns mid-stream (no zero insertions after start).
        self.latency = crossfeed.block_input_frames
        self._out_fifo = np.zeros((2, self.latency), dtype=np.float32)

    @property
    def channels(self) -> int:
        return self.upsampler.channels

    @property
    def ratio(self) -> int:
        return self.upsampler.ratio

    @property
    def block_input_frames(self) -> int:
        return self.upsampler.block_input_frames

    @property
    def config(self):
        return self.upsampler.config

    def reset(self) -> None:
        self.upsampler.reset()
        self.crossfeed.reset()
        self._pending = np.zeros((2, 0), dtype=np.float32)
        self._out_fifo = np.zeros((2, self.latency), dtype=np.float32)

    # Two-phase API (same contract as StreamingUpsampler): dispatch
    # delegates to the upsampler (never host-blocks); the stateful
    # crossfeed post-stage runs at fetch, in fetch order — which the
    # session pipeline guarantees equals dispatch order — so pipelined
    # sessions overlap the upsampler's device compute with the chain's
    # host-side FIFO work too.

    def dispatch_block(self, x: np.ndarray):
        return self.upsampler.dispatch_block(x)

    def fetch(self, handle) -> np.ndarray:
        return self._post(self.upsampler.fetch(handle))

    def _post(self, up: np.ndarray) -> np.ndarray:
        buf = np.concatenate([self._pending, up], axis=1)
        cf_block = self.crossfeed.block_input_frames
        usable = buf.shape[1] - buf.shape[1] % cf_block
        if usable:
            crossfed = self.crossfeed.process_block(buf[:, :usable])
            self._out_fifo = np.concatenate([self._out_fifo, crossfed],
                                            axis=1)
        self._pending = buf[:, usable:]
        want = up.shape[1]
        out = self._out_fifo[:, :want]
        self._out_fifo = self._out_fifo[:, want:]
        return out

    def process_block(self, x: np.ndarray) -> np.ndarray:
        """Upsample then crossfeed. Output length always equals
        x.shape[1] * ratio, delayed by self.latency output samples."""
        return self.fetch(self.dispatch_block(x))
