"""The yardstick of the frame kernel's forward transform alone: the least
time a served frame's forward can take, and the device records that do
that work, kept here so that no change to the program's plan moves it.

Every plan of the 80k bank hands the forward's spectrum to a separate
inverse through device memory (h = fft_size / 2 > 8192), so the forward is
a unit of its own: an m-point real FFT of the frame, m = fft_size / ratio.
Its nominal work, whatever implements it (one m/2-point FFT of the packed
frame, or the four-step m = P x Q of two launches): 2.5 m log2 m
operations. Its least bytes: the frame read once (m float32, 4m bytes) and
its half spectrum written once (m/2 complex float32, 4m bytes), 8m bytes.
The least time is the larger of the two at the card's peaks
(``geometry.py``): at m = 32768 (4x) the bytes bound it, 78.3 ns a frame;
at m = 8192 (16x) 19.6 ns.

Which launches are the forward, by the store or load each is built with
(``csrc/fused_frames.cu``): ``FwdStage1*`` and ``FwdStage2*`` (F1 and F2,
the four-launch plan at 4x and 2x), or ``FrameLoad``/``SpecStore`` (F, the
three-launch plan at 16x and 8x). The resident plan (8k bank) has no
separate forward, and none of its records match.
"""

from __future__ import annotations

import math

from portbench.geometry import PEAK_BYTES_S, PEAK_FP32_FLOPS

#: substrings of a forward launch's kernel name
FORWARD_KERNELS = ("FwdStage1", "FwdStage2", "FrameLoad", "SpecStore")


def forward_flops(m: int) -> float:
    """Nominal operations of one m-point real forward FFT."""
    return 2.5 * m * math.log2(m)


def forward_bytes(m: int) -> float:
    """Least bytes of one frame's forward: the frame read once, its half
    spectrum written once."""
    return 4 * m + 8 * (m // 2)


def forward_least_seconds(m: int, frames: float) -> tuple[float, str]:
    """(the least time of ``frames`` forwards, the side that sets it)."""
    ops = forward_flops(m) * frames / PEAK_FP32_FLOPS
    mem = forward_bytes(m) * frames / PEAK_BYTES_S
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def forward_kernel_s(kernels) -> float:
    """Summed seconds of the forward launches among a window's device
    records: (name, start ns, end ns, launch) as ``spans.device_window``
    gives them."""
    return sum(b - a for name, a, b, _launch in kernels
               if any(k in name for k in FORWARD_KERNELS)) * 1e-9
