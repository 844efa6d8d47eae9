"""WAV file IO on the stdlib wave module (no soundfile dependency).

Supports 16/24/32-bit integer PCM read/write via the same conversion rules
as the raw PCM path (totton_tpu.io.pcm). Replaces the reference test
tooling's soundfile/wave usage (scripts/test/convert_audio.py).
"""

from __future__ import annotations

import wave

import numpy as np

from totton_tpu_torch.io.pcm import (
    PcmFormat,
    TpdfDitherer,
    deinterleave,
    float_to_pcm,
    interleave,
    pcm_to_float,
)

_WIDTH_TO_FORMAT = {2: PcmFormat.S16_LE, 3: PcmFormat.S24_3LE, 4: PcmFormat.S32_LE}


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 [channels, n], sample_rate)."""
    with wave.open(path, "rb") as w:
        width = w.getsampwidth()
        if width not in _WIDTH_TO_FORMAT:
            raise ValueError(f"Unsupported WAV sample width: {width} bytes")
        channels = w.getnchannels()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    samples = pcm_to_float(raw, _WIDTH_TO_FORMAT[width])
    return deinterleave(samples, channels), rate


def write_wav(
    path: str,
    x: np.ndarray,
    sample_rate: int,
    fmt: PcmFormat = PcmFormat.S24_3LE,
    ditherer: TpdfDitherer | None = None,
) -> None:
    """Write float32 [channels, n] to a PCM WAV file."""
    x = np.atleast_2d(np.asarray(x, dtype=np.float32))
    with wave.open(path, "wb") as w:
        w.setnchannels(x.shape[0])
        w.setsampwidth(fmt.bytes)
        w.setframerate(sample_rate)
        w.writeframes(float_to_pcm(interleave(x), fmt, ditherer))
