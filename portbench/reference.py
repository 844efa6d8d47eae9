"""The plain reference: what a stream's reply must be, in float64.

A served stream is the linear convolution of the zero-stuffed input with
the filter's taps, from a zero history, cut at ratio x the input frames
(the EOF flush zero-pads the final partial block and trims it). Written
polyphase: output sample ``ratio * j + p`` is ``sum_i h[ratio * i + p] *
x[j - i]``, one FFT convolution a phase, over just the input that a
checked segment needs. It reads the taps from the bank's ``.bin`` with its
own reader and works out everything else again: no tail, fold or weight of
the program is used. Plain torch, so that it runs on the card when many
segments are checked; it imports nothing of ``totton_tpu_torch``.

``precision="tf32"`` is the control: the same arithmetic with its operands
rounded to TF32 (10 mantissa bits) and computed in float32, the nearest
precision below the float32 that the configurations state.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from portbench import audio, wire


def read_taps(json_path: str) -> tuple[np.ndarray, dict]:
    """(taps float64, sidecar dict) of a bank's ``.json`` + ``.bin``."""
    with open(json_path) as f:
        meta = json.load(f)
    path = os.path.join(os.path.dirname(json_path), meta["coefficients_bin"])
    taps = np.fromfile(path, dtype="<f4").astype(np.float64)
    if taps.size != meta["taps"]:
        raise ValueError(f"{path}: {taps.size} taps, sidecar says "
                         f"{meta['taps']}")
    return taps, meta


def round_tf32(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to nearest (ties to even) at TF32's 10-bit
    mantissa."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~np.uint64(0x1FFF)
    return b.astype(np.uint32).view(np.float32)


def stream_input(seed: int, start: int, stop: int, channels: int,
                 fmt: str, cache: dict | None = None) -> np.ndarray:
    """Input frames [start, stop) as the server decoded them from the wire
    (zeros before the stream), [channels, n] float64."""
    x = audio.frames(seed, start, stop, channels, cache)
    if fmt == "s16":
        return wire.quantize_s16(x).astype(np.float64) / wire.S16_SCALE
    return x.astype(np.float64)


class Reference:
    """Reply segments of served streams, for one bank and wire format."""

    def __init__(self, taps: np.ndarray, ratio: int, channels: int,
                 fmt: str, device: str = "cpu",
                 precision: str = "float64") -> None:
        if precision not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.ratio, self.channels, self.fmt = ratio, channels, fmt
        self.device = torch.device(device)
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        lh = -(-taps.size // ratio)
        poly = np.zeros((ratio, lh))
        for p in range(ratio):
            poly[p, :taps[p::ratio].size] = taps[p::ratio]
        if precision == "tf32":
            poly = round_tf32(poly.astype(np.float32)).astype(np.float64)
        self.lh = lh
        self.poly = torch.as_tensor(poly, dtype=self.dtype, device=self.device)
        self._spectra: dict[int, torch.Tensor] = {}

    def _filter_spectrum(self, nfft: int) -> torch.Tensor:
        if nfft not in self._spectra:
            self._spectra[nfft] = torch.fft.rfft(self.poly, nfft)
        return self._spectra[nfft]

    def segments(self, items: list[tuple[int, int, int]],
                 batch: int = 32) -> list[np.ndarray]:
        """For each (stream seed, first output frame a, frames n): the
        reply frames [a, a + n) as [n, channels] float64."""
        out: list[np.ndarray] = []
        r = self.ratio
        chunks: dict = {}
        for b0 in range(0, len(items), batch):
            part = items[b0:b0 + batch]
            spans = [((a // r), (a + n - 1) // r) for _s, a, n in part]
            width = max(j1 - j0 for j0, j1 in spans) + self.lh
            nfft = 1 << (width + self.lh - 1).bit_length()
            x = np.zeros((len(part), self.channels, width))
            for i, ((seed, _a, _n), (j0, j1)) in enumerate(zip(part, spans)):
                x[i, :, :j1 - j0 + self.lh] = stream_input(
                    seed, j0 - self.lh + 1, j1 + 1, self.channels, self.fmt,
                    chunks)
            if self.precision == "tf32":
                x = round_tf32(x.astype(np.float32)).astype(np.float64)
            xt = torch.as_tensor(x, dtype=self.dtype, device=self.device)
            spec = torch.fft.rfft(xt, nfft)[:, :, None, :] \
                * self._filter_spectrum(nfft)[None, None]
            y = torch.fft.irfft(spec, nfft)  # [B, C, r, nfft]
            for i, ((_seed, a, n), (j0, j1)) in enumerate(zip(part, spans)):
                # Phase p of input frame j sits at conv index lh - 1 + j - j0.
                v = y[i, :, :, self.lh - 1:self.lh + j1 - j0]  # [C, r, J]
                flat = v.permute(0, 2, 1).reshape(self.channels, -1)
                seg = flat[:, a - r * j0:a - r * j0 + n].T
                out.append(seg.to(torch.float64).cpu().numpy())
            del xt, spec, y
        return out


def quantize_s16(y: np.ndarray) -> np.ndarray:
    """The s16 wire value of float64 samples: clamp to [-1, 0.9999695],
    scale by 32768, truncate toward zero."""
    return np.trunc(np.clip(y, -1.0, wire.S16_CLAMP_HI)
                    * wire.S16_SCALE).astype(np.int64)
