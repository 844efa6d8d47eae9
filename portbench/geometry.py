"""The work of a frame and the card's peaks: the yardstick of the roofline
shares, kept here so that no change to the program's plan moves it.

A served block is one frame of ``fft_size / ratio`` input samples turned
into ``block_size`` output samples. Its nominal work, whatever implements
it: a real forward FFT of m = fft_size / ratio points (2.5 m log2 m), the
spectrum product over h = fft_size / 2 bins (6 h), and a half-size complex
inverse of h points (5 h log2 h). Its least bytes: the frame read once
(float32), the block written once in the type it leaves the device in, and
the folded filter (h complex float32) read once a dispatch.
"""

from __future__ import annotations

import math

#: NVIDIA H100 SXM data sheet, dense, at the full 700 W: float32 outside
#: the tensor cores, and HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12


def flops_per_frame(fft_size: int, ratio: int) -> float:
    m, h = fft_size // ratio, fft_size // 2
    return 2.5 * m * math.log2(m) + 6 * h + 5 * h * math.log2(h)


def least_bytes(fft_size: int, ratio: int, block_size: int, frames: int,
                dispatches: int, out_bytes: int) -> float:
    m, h = fft_size // ratio, fft_size // 2
    return frames * (4 * m + out_bytes * block_size) + dispatches * 8 * h


def least_seconds(fft_size: int, ratio: int, block_size: int, frames: int,
                  dispatches: int, out_bytes: int) -> tuple[float, str]:
    """(the least time for the work, the side that sets it)."""
    ops = flops_per_frame(fft_size, ratio) * frames / PEAK_FP32_FLOPS
    mem = least_bytes(fft_size, ratio, block_size, frames, dispatches,
                      out_bytes) / PEAK_BYTES_S
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def served_frames(before: dict, after: dict, block_size: int,
                  channels: int) -> tuple[float, int]:
    """(frames, dispatches) the serve plane served between two counter
    snapshots (``run.snapshot``). Only served work counts: the frames are
    the blocks delivered to the streams (``frames_out``, output frames a
    slot, over the block, each channel a frame), never the zero-padded rows
    and blocks a step's shape also carries; the dispatches are the steps."""
    out = after["frames_out"] - before["frames_out"]
    return out * channels / block_size, after["steps"] - before["steps"]
