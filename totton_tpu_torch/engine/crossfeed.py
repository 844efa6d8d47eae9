"""Crossfeed engine on torch: 2x2 matrix FIR convolution for headphone
speaker simulation, the counterpart of ``totton_tpu.engine.crossfeed``.

Consumes the 4-channel sets written by totton_tpu.filters.hrtf
(LL, LR, RL, RR — speaker -> ear impulse responses) and applies

    out_L = LL * in_L + RL * in_R
    out_R = LR * in_L + RR * in_R

as frequency-domain overlap-save at ratio 1, sharing one forward transform
per input channel. ``CrossfeedFilter`` and ``_cf_geometry`` are the JAX
package's, copied; the step and the processor's state live on an explicit
torch device. The JAX step is an XLA-composed program, not a Pallas
kernel, so the port's step is plain torch on every device.
``tests/test_torch_copies.py`` holds the copy to the reference outside its
device seams.
"""

from __future__ import annotations

import functools
import json
import math
import os

import numpy as np
import torch

from totton_tpu_torch import resolve_device
from totton_tpu_torch.engine.upsampler import download, fetch, upload
from totton_tpu_torch.ops import fft as _fft
from totton_tpu_torch.ops.overlap_save import OverlapSaveConfig, frame_input


class CrossfeedFilter:
    """4-channel crossfeed set loaded from the .bin + .json sidecar."""

    def __init__(self, channels: np.ndarray, meta: dict) -> None:
        if channels.ndim != 2 or channels.shape[0] != 4:
            raise ValueError(f"expected [4, taps] channels, got {channels.shape}")
        self.channels = channels.astype(np.float64)
        self.meta = meta
        self.taps = channels.shape[1]

    @classmethod
    def load(cls, json_path: str | os.PathLike) -> "CrossfeedFilter":
        json_path = os.fspath(json_path)
        meta = json.loads(open(json_path).read())
        bin_path = meta["coefficients_bin"]
        if not os.path.isabs(bin_path):
            bin_path = os.path.join(os.path.dirname(json_path), bin_path)
        n = int(meta["taps_per_channel"])
        data = np.fromfile(bin_path, dtype="<f4")
        if data.size != 4 * n:
            raise ValueError(
                f"bin size {data.size} != 4 * taps_per_channel {n}"
            )
        return cls(data.reshape(4, n), meta)


def _cf_geometry(taps: int) -> OverlapSaveConfig:
    # Pad taps to odd (even overlap not required at ratio 1, but keep the
    # sidecar invariant fft - block == taps - 1 with a healthy block).
    fft_size = 1 << max(10, math.ceil(math.log2(4 * taps)))
    return OverlapSaveConfig(
        taps=taps, fft_size=fft_size, block_size=fft_size - (taps - 1),
        ratio=1,
    )


@functools.lru_cache(maxsize=16)
def _make_cf_step(cfg: OverlapSaveConfig):
    def step(tail: torch.Tensor, x: torch.Tensor, h):
        """x: [2, T] on the device; h: ([4, bins], [4, bins]) pair."""
        hr, hi = h
        xin = torch.cat([tail, x], dim=-1)
        frames = frame_input(xin, cfg.block_in, cfg.halo_in)  # [2, B, F]
        xr, xi = _fft.rfft2(frames, cfg.frame_in)  # [2, B, bins]
        # out_L = LL*L + RL*R ; out_R = LR*L + RR*R  (indices 0..3 =
        # LL, LR, RL, RR).
        yl_r, yl_i = _fft.complex_mul(xr[0], xi[0], hr[0], hi[0])
        t_r, t_i = _fft.complex_mul(xr[1], xi[1], hr[2], hi[2])
        yl_r, yl_i = yl_r + t_r, yl_i + t_i
        yr_r, yr_i = _fft.complex_mul(xr[0], xi[0], hr[1], hi[1])
        t_r, t_i = _fft.complex_mul(xr[1], xi[1], hr[3], hi[3])
        yr_r, yr_i = yr_r + t_r, yr_i + t_i
        yr_stack = torch.stack([yl_r, yr_r])  # [2, B, bins]
        yi_stack = torch.stack([yl_i, yr_i])
        y = _fft.irfft2(yr_stack, yi_stack, cfg.fft_size)[..., cfg.overlap:]
        out = y.reshape(2, -1)
        new_tail = xin[:, xin.shape[-1] - cfg.halo_in:].clone()
        return out, new_tail

    return step


class CrossfeedProcessor:
    """Stateful stereo crossfeed convolver (block streaming). The filter
    spectra (a device (re, im) pair) and the carried input tail live on
    ``device``."""

    def __init__(self, filt: CrossfeedFilter,
                 device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        self.filter = filt
        self.config = _cf_geometry(filt.taps)
        spectra = np.fft.rfft(filt.channels, self.config.fft_size)
        self._h = (
            torch.as_tensor(spectra.real.astype(np.float32),
                            device=self.device),
            torch.as_tensor(spectra.imag.astype(np.float32),
                            device=self.device),
        )
        self._step = _make_cf_step(self.config)
        self._tail = torch.zeros((2, self.config.halo_in),
                                 dtype=torch.float32, device=self.device)

    @property
    def block_input_frames(self) -> int:
        return self.config.block_in

    def reset(self) -> None:
        self._tail = torch.zeros_like(self._tail)

    def process_block(self, x: np.ndarray) -> np.ndarray:
        """[2, k*block_in] stereo in -> [2, k*block_in] crossfed out."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[0] != 2:
            raise ValueError(f"crossfeed is stereo-only, got {x.shape}")
        if x.shape[1] == 0 or x.shape[1] % self.config.block_in != 0:
            raise ValueError(
                f"input length {x.shape[1]} must be a positive multiple of "
                f"{self.config.block_in}"
            )
        y, self._tail = self._step(self._tail, upload(x, self.device),
                                   self._h)
        return fetch(download(y))


def crossfeed_signal(x: np.ndarray, filt: CrossfeedFilter,
                     device: str | torch.device = "cuda") -> np.ndarray:
    """Offline convenience: crossfeed [2, n] (any n)."""
    x = np.asarray(x, dtype=np.float32)
    proc = CrossfeedProcessor(filt, device=device)
    n = x.shape[1]
    pad = (-n) % proc.config.block_in
    if pad:
        x = np.pad(x, [(0, 0), (0, pad)])
    return proc.process_block(x)[:, :n]
