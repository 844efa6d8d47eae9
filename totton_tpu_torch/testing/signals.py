"""Deterministic test-signal generators (float32, [channels, n])."""

from __future__ import annotations

import numpy as np


def sine(
    frequency_hz: float,
    duration_s: float,
    sample_rate: int,
    amplitude: float = 0.5,
    channels: int = 2,
) -> np.ndarray:
    n = int(round(duration_s * sample_rate))
    t = np.arange(n, dtype=np.float64) / sample_rate
    x = amplitude * np.sin(2 * np.pi * frequency_hz * t)
    return np.tile(x.astype(np.float32), (channels, 1))


def log_sweep(
    f_start: float,
    f_end: float,
    duration_s: float,
    sample_rate: int,
    amplitude: float = 0.5,
    channels: int = 2,
) -> np.ndarray:
    """Exponential (log-frequency) sweep."""
    n = int(round(duration_s * sample_rate))
    t = np.arange(n, dtype=np.float64) / sample_rate
    k = np.log(f_end / f_start) / duration_s
    phase = 2 * np.pi * f_start * (np.expm1(k * t)) / k
    x = amplitude * np.sin(phase)
    return np.tile(x.astype(np.float32), (channels, 1))


def white_noise(
    duration_s: float,
    sample_rate: int,
    amplitude: float = 0.3,
    channels: int = 2,
    seed: int = 0,
) -> np.ndarray:
    n = int(round(duration_s * sample_rate))
    rng = np.random.default_rng(seed)
    x = rng.uniform(-amplitude, amplitude, size=(channels, n))
    return x.astype(np.float32)
