"""StreamingUpsampler on torch: the engine facade of the port.

Counterpart of ``totton_tpu.engine.upsampler`` with the same public layouts
(numpy ``[channels, n]`` float32 in; numpy ``[channels, n*ratio]`` float32,
or int16 in device-PCM mode, out) and an explicit ``device``. The carried
input tail and the folded filter bundle live on the device; a filter or
EQ swap folds a new bundle and rebuilds nothing.

Two-phase API: ``dispatch_block`` uploads the input through pinned host
memory (non-blocking), queues the step on the current CUDA stream, queues
the download into pinned memory and records an event; ``fetch`` waits on
that event only — never on the whole device — so a session overlaps step
i+1's dispatch with step i's drain. On the CPU both phases run in line.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from totton_tpu_torch.filters.sidecar import LoadedFilter
from totton_tpu_torch.io.pcm import PcmFormat
from totton_tpu_torch import resolve_device
from totton_tpu_torch.ops import device_pcm as _dp
from totton_tpu_torch.ops.overlap_save import (
    OverlapSaveConfig,
    filter_spectrum,
    fold_bundle,
    make_block_step,
)


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host -> device: through pinned memory and non-blocking on CUDA;
    on the CPU the tensor shares the array's memory."""
    t = torch.from_numpy(x)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def download(y: torch.Tensor):
    """Queue y's device->host copy into pinned memory and record an event
    after it; returns the (host tensor, event) handle for ``fetch``. A
    CPU tensor is its own host copy (event None)."""
    if y.device.type != "cuda":
        return y, None
    host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
    host.copy_(y, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def fetch(handle) -> np.ndarray:
    """Wait for a ``download`` (its event only, never the whole device)
    and return the host array (a view of the pinned buffer)."""
    host, event = handle
    if event is not None:
        event.synchronize()
    return host.numpy()


def _fade_width_blocks(n: int, block_size: int) -> int:
    """Dispatch width (in blocks) for a fade window of n output samples:
    ceil(n / block_size) rounded up to a power of two, so fade dispatches
    take a logarithmic set of shapes. Overlap-save block j depends only on
    input up to (j+1)*block_in, so zero-padding the input prefix to the
    rounded width cannot change the first n samples."""
    from totton_tpu_torch.utils.intmath import pow2_ceil

    return pow2_ceil(-(-n // block_size))


def fade_warm_widths(fade_frames: int, block_size: int) -> list[int]:
    """Every dispatch width (in blocks) a fade of this length can use."""
    widths = []
    nb = _fade_width_blocks(fade_frames, block_size)
    while nb >= 1:
        widths.append(nb)
        nb //= 2
    return widths


def _fade_prefix(xj: torch.Tensor, n: int, block_size: int,
                 block_in: int) -> torch.Tensor:
    """Power-of-two prefix of a dispatch's input covering a fade window of
    n output samples, zero-padded past the real input when the rounded
    width exceeds it."""
    need = _fade_width_blocks(n, block_size) * block_in
    pref = xj[:, :need]
    if pref.shape[1] < need:
        pref = torch.nn.functional.pad(pref, (0, need - pref.shape[1]))
    return pref


class StreamingUpsampler:
    """Stateful block-streaming upsampler for a fixed channel count.

    State is the last halo_in input-rate samples per channel, on the
    device, plus the folded filter bundle.
    """

    def __init__(
        self,
        filt: LoadedFilter,
        channels: int = 2,
        eq_response: np.ndarray | None = None,
        swap_fade_frames: int = 0,
        device_pcm: PcmFormat | None = None,
        pcm_dither: bool = False,
        pcm_seed: int | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        if channels < 1:
            raise ValueError(f"channels must be >= 1: {channels}")
        if swap_fade_frames < 0:
            raise ValueError(f"swap_fade_frames must be >= 0: {swap_fade_frames}")
        if device_pcm is not None and device_pcm is not PcmFormat.S16_LE:
            raise ValueError(
                f"device_pcm supports S16_LE only, got {device_pcm}")
        self.device = resolve_device(device)
        self._filter = filt
        self._channels = channels
        self.config = self._checked_config(filt)
        self._bundle = self._fold(filt, self.config, eq_response)
        self._step = make_block_step(self.config)
        self._tail = torch.zeros((channels, self.config.halo_in),
                                 dtype=torch.float32, device=self.device)
        # Click-free hot swap: fade the first swap_fade_frames output
        # samples after a same-geometry swap from the old bundle's output
        # to the new one's (0 = abrupt). The tail is input-domain, so the
        # old output is reproducible with one extra partial dispatch.
        self._swap_fade_frames = swap_fade_frames
        self._fade_from = None
        self._fade_pos = 0
        # Serializes hot swaps from a control thread against dispatch.
        self._lock = threading.Lock()
        self.device_pcm = device_pcm
        self._pcm_dither = bool(pcm_dither)
        self._pcm_seed = 0 if pcm_seed is None else pcm_seed
        self._pcm_counter = 0
        # Host twin for the crossfade dispatches, which mix old/new output
        # in host float before quantizing.
        self._host_ditherer = None
        if device_pcm is not None and self._pcm_dither:
            from totton_tpu_torch.io.pcm import TpdfDitherer

            self._host_ditherer = TpdfDitherer(self._pcm_seed)

    def _checked_config(self, filt: LoadedFilter) -> OverlapSaveConfig:
        """The filter's geometry; on CUDA, refuses up front a geometry
        outside the frame kernel's range (an odd overlap runs the classic
        program instead)."""
        cfg = OverlapSaveConfig.from_sidecar(filt.sidecar)
        if self.device.type == "cuda" and cfg.overlap % 2 == 0:
            from totton_tpu_torch.ops.fused_frames import kernel_plan

            kernel_plan(cfg)
        return cfg

    def _fold(self, filt: LoadedFilter, cfg: OverlapSaveConfig,
              eq_response: np.ndarray | None):
        spectrum = filter_spectrum(filt.taps, cfg.fft_size, eq_response,
                                   device=self.device)
        return fold_bundle(spectrum, cfg)

    # -- properties -------------------------------------------------------

    @property
    def channels(self) -> int:
        return self._channels

    @property
    def ratio(self) -> int:
        return self.config.ratio

    @property
    def block_input_frames(self) -> int:
        return self.config.block_in

    @property
    def filter(self) -> LoadedFilter:
        return self._filter

    # -- control ----------------------------------------------------------

    def reset(self) -> None:
        """Zero the carried history."""
        with self._lock:
            self._tail = torch.zeros_like(self._tail)
            self._fade_from = None
            self._fade_pos = 0

    def _note_swap(self, old_bundle) -> None:
        """Arm the crossfade (keep the original pre-swap bundle if several
        swaps land during one fade — fade from what was last heard)."""
        if self._swap_fade_frames and self._fade_from is None:
            self._fade_from = old_bundle
            self._fade_pos = 0

    def set_dither(self, enabled: bool) -> bool:
        """Swap output dithering live (device-PCM mode only; in float mode
        quantization, and so dither, belongs to the sink). Mirrors
        AudioSink.set_dither so the CLI's RELOAD path can target whichever
        side owns the quantizer. Returns False when the engine does not
        quantize."""
        if self.device_pcm is None:
            return False
        with self._lock:
            self._pcm_dither = bool(enabled)
            if enabled and self._host_ditherer is None:
                from totton_tpu_torch.io.pcm import TpdfDitherer

                self._host_ditherer = TpdfDitherer(self._pcm_seed)
        return True

    def set_eq(self, eq_response: np.ndarray | None) -> None:
        """Hot-swap the EQ baked into the filter spectrum (folds a new
        bundle; rebuilds nothing)."""
        bundle = self._fold(self._filter, self.config, eq_response)
        with self._lock:
            self._note_swap(self._bundle)
            self._bundle = bundle

    def load_filter(self, filt: LoadedFilter,
                    eq_response: np.ndarray | None = None) -> None:
        """Swap filters. A new geometry restarts the history (no fade)."""
        cfg = self._checked_config(filt)
        bundle = self._fold(filt, cfg, eq_response)
        with self._lock:
            self._filter = filt
            if cfg != self.config:
                self.config = cfg
                self._step = make_block_step(cfg)
                self._tail = torch.zeros((self._channels, cfg.halo_in),
                                         dtype=torch.float32,
                                         device=self.device)
                self._fade_from = None
                self._fade_pos = 0
            else:
                self._note_swap(self._bundle)
            self._bundle = bundle

    # -- processing -------------------------------------------------------

    def _quantize_device(self, y: torch.Tensor) -> torch.Tensor:
        if self._pcm_dither:
            self._pcm_counter += 1
            return _dp.quantize_s16_dithered(y, self._pcm_seed,
                                             self._pcm_counter)
        return _dp.quantize_s16(y)

    def dispatch_block(self, x: np.ndarray):
        """Submit [channels, k*block_in] input frames; returns an opaque
        handle for fetch(). Never waits on the device. Swaps apply to
        every step dispatched after them; fades are bookkept here
        (dispatch order = output order)."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[0] != self._channels:
            raise ValueError(
                f"expected [channels={self._channels}, n] input, got {x.shape}"
            )
        with self._lock:
            if x.shape[1] == 0 or x.shape[1] % self.config.block_in != 0:
                raise ValueError(
                    f"input length {x.shape[1]} must be a positive multiple "
                    f"of block_input_frames {self.config.block_in}"
                )
            tail_before = self._tail
            xt = upload(x, self.device)
            y, self._tail = self._step(tail_before, xt, self._bundle)
            fade = None
            if self._fade_from is not None:
                # One partial dispatch with the pre-swap bundle covering
                # only the fade window, then a linear ramp old -> new
                # carried across dispatches until the window is done.
                total = self._swap_fade_frames
                k_blocks = x.shape[1] // self.config.block_in
                n = min(total - self._fade_pos,
                        k_blocks * self.config.block_size)
                y_old, _ = self._step(
                    tail_before,
                    _fade_prefix(xt, n, self.config.block_size,
                                 self.config.block_in),
                    self._fade_from)
                ramp = (self._fade_pos
                        + np.arange(n, dtype=np.float32)) / total
                fade = (download(y_old), ramp, n)
                self._fade_pos += n
                if self._fade_pos >= total:
                    self._fade_from = None
                    self._fade_pos = 0
            if self.device_pcm is not None and fade is None:
                y = self._quantize_device(y)
            return download(y), fade

    def fetch(self, handle) -> np.ndarray:
        """Wait for a dispatched step's output and return it on the host.
        Fetch in dispatch order: the host dither twin and the fade ramps
        are stateful in that order."""
        y_handle, fade = handle
        y = fetch(y_handle)
        if fade is None:
            return y
        old_handle, ramp, n = fade
        y = y.copy()
        y[:, :n] = fetch(old_handle)[:, :n] * (1.0 - ramp) + y[:, :n] * ramp
        if self.device_pcm is not None:
            from totton_tpu_torch.io.pcm import quantize_s16_host

            return quantize_s16_host(
                y, self._host_ditherer if self._pcm_dither else None)
        return y

    def process_block(self, x: np.ndarray) -> np.ndarray:
        """[channels, k*block_in] -> [channels, k*block_size], synchronous."""
        return self.fetch(self.dispatch_block(x))


def upsample_signal(x: np.ndarray, filt: LoadedFilter,
                    eq_response: np.ndarray | None = None,
                    device: str | torch.device = "cuda") -> np.ndarray:
    """Offline convenience: upsample [channels, n] (any n) in one call,
    zero-padding the last block and trimming the output to n * ratio."""
    x = np.atleast_2d(np.asarray(x, dtype=np.float32))
    channels, n = x.shape
    eng = StreamingUpsampler(filt, channels, eq_response, device=device)
    n_pad = (-n) % eng.config.block_in
    if n_pad:
        x = np.pad(x, [(0, 0), (0, n_pad)])
    return eng.process_block(x)[:, : n * eng.ratio]
