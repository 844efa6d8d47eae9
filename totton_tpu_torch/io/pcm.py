"""PCM sample format conversion, vectorized.

Bit-exact with the reference's conversions (src/alsa/alsa_common.cpp:12-127):
same scale factors and the same asymmetric clamp constants on the
float->int path (0.9999695 for s16, 0.9999999 for s24/s32 — chosen so
value * scale never reaches +full-scale).
"""

from __future__ import annotations

import enum

import numpy as np

from totton_tpu_torch import native as _native


class PcmFormat(enum.Enum):
    S16_LE = "S16_LE"
    S24_3LE = "S24_3LE"
    S32_LE = "S32_LE"

    @property
    def bytes(self) -> int:
        return {"S16_LE": 2, "S24_3LE": 3, "S32_LE": 4}[self.value]

    @property
    def scale(self) -> float:
        return {"S16_LE": 32768.0, "S24_3LE": 8388608.0, "S32_LE": 2147483648.0}[
            self.value
        ]

    @property
    def clamp_hi(self) -> float:
        return 0.9999695 if self is PcmFormat.S16_LE else 0.9999999


def parse_format(name: str) -> PcmFormat:
    """Accepts s16/s16_le, s24/s24_3le, s32/s32_le (case-insensitive)."""
    lower = name.lower()
    table = {
        "s16": PcmFormat.S16_LE,
        "s16_le": PcmFormat.S16_LE,
        "s24": PcmFormat.S24_3LE,
        "s24_3le": PcmFormat.S24_3LE,
        "s32": PcmFormat.S32_LE,
        "s32_le": PcmFormat.S32_LE,
    }
    if lower not in table:
        raise ValueError(f"Unknown PCM format: {name}")
    return table[lower]


def bytes_per_sample(fmt: PcmFormat) -> int:
    return fmt.bytes


def pcm_to_float(data: bytes | np.ndarray, fmt: PcmFormat) -> np.ndarray:
    """Raw interleaved PCM bytes -> float32 samples in [-1, 1)."""
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray
    ) else data.view(np.uint8).ravel()
    if len(buf) % fmt.bytes != 0:
        raise ValueError(
            f"buffer length {len(buf)} not a multiple of sample size {fmt.bytes}"
        )
    native = _native.pcm_to_float(buf, fmt)
    if native is not None:
        return native
    if fmt is PcmFormat.S16_LE:
        ints = buf.view("<i2").astype(np.float32)
    elif fmt is PcmFormat.S32_LE:
        ints = buf.view("<i4").astype(np.float32)
    else:  # S24_3LE: sign-extend 3-byte little-endian
        tri = buf.reshape(-1, 3).astype(np.int32)
        vals = tri[:, 0] | (tri[:, 1] << 8) | (tri[:, 2] << 16)
        vals = np.where(vals & 0x00800000, vals - (1 << 24), vals)
        ints = vals.astype(np.float32)
    return ints * np.float32(1.0 / fmt.scale)


def _pack_ints(vals: np.ndarray, fmt: PcmFormat) -> bytes:
    """Clip int64 sample values to the format's range and pack little-endian."""
    if fmt is PcmFormat.S16_LE:
        vals = np.clip(vals, -(1 << 15), (1 << 15) - 1)
        return vals.astype("<i2").tobytes()
    if fmt is PcmFormat.S32_LE:
        vals = np.clip(vals, -(1 << 31), (1 << 31) - 1)
        return vals.astype("<i4").tobytes()
    vals = np.clip(vals, -(1 << 23), (1 << 23) - 1).astype(np.int32)
    out = np.empty((len(vals), 3), dtype=np.uint8)
    out[:, 0] = vals & 0xFF
    out[:, 1] = (vals >> 8) & 0xFF
    out[:, 2] = (vals >> 16) & 0xFF
    return out.tobytes()


def float_to_pcm(
    x: np.ndarray, fmt: PcmFormat, ditherer: "TpdfDitherer | None" = None
) -> bytes:
    """float32 samples -> raw interleaved PCM bytes, with clamping.

    Without a ditherer this is bit-exact with the reference's C cast
    (truncation toward zero, alsa_common.cpp:87-127). With one, samples are
    TPDF-dithered and rounded to nearest — see TpdfDitherer.
    """
    x = np.asarray(x, dtype=np.float32).ravel()
    if ditherer is not None:
        return ditherer.quantize(x, fmt)
    native = _native.float_to_pcm(x, fmt)
    if native is not None:
        return native
    clamped = np.clip(x, np.float32(-1.0), np.float32(fmt.clamp_hi))
    scaled = clamped * np.float32(fmt.scale)
    if fmt is PcmFormat.S16_LE:
        return scaled.astype("<i2").tobytes()
    # float32 * 2^31 can round up to 2^31 (unrepresentable); match the
    # C cast-to-int behavior by clipping at the integer edge in int64.
    return _pack_ints(scaled.astype(np.int64), fmt)


class TpdfDitherer:
    """Stateful TPDF dither for float -> PCM quantization.

    The engine's signal path is float32 (>130 dB SNR); truncating that to
    s16/s24 without dither leaves quantization distortion correlated with the
    signal. Adding triangular noise of +-1 LSB before round-to-nearest
    converts it to a benign, signal-independent noise floor — standard
    mastering practice the reference omits (its float->int conversion only
    clamps and truncates, src/alsa/alsa_common.cpp:87-127).

    Stateful so successive stream blocks draw fresh noise; a fixed seed gives
    reproducible output for tests.
    """

    def __init__(self, seed: int | None = None) -> None:
        self._rng = np.random.default_rng(seed)

    def quantize(self, x: np.ndarray, fmt: PcmFormat) -> bytes:
        x = np.asarray(x, dtype=np.float32).ravel()
        clamped = np.clip(x, np.float32(-1.0), np.float32(fmt.clamp_hi))
        # float64 scaling: float32 can't represent odd integers near 2^31,
        # which would double-quantize the s32 path.
        scaled = clamped.astype(np.float64) * fmt.scale
        noise = (self._rng.random(len(scaled))
                 + self._rng.random(len(scaled)) - 1.0)
        # round-to-nearest with TPDF noise: floor(v + n + 0.5)
        vals = np.floor(scaled + noise + 0.5).astype(np.int64)
        return _pack_ints(vals, fmt)


def quantize_s16_host(x: np.ndarray,
                      ditherer: "TpdfDitherer | None" = None) -> np.ndarray:
    """float32 [..., n] -> int16 sample VALUES (same shape, not packed).

    The host twin of ops.device_pcm.quantize_s16 — used for the dispatches
    that must stay on the host float path (hot-swap crossfade mixing) when
    the engine runs in device-PCM mode. Bit-compatible with float_to_pcm
    by construction: it IS float_to_pcm's byte output viewed as int16.
    """
    x = np.asarray(x, dtype=np.float32)
    raw = float_to_pcm(x, PcmFormat.S16_LE, ditherer)
    return np.frombuffer(raw, dtype="<i2").reshape(x.shape)


def deinterleave(x: np.ndarray, channels: int) -> np.ndarray:
    """Interleaved [n*channels] -> [channels, n]."""
    x = np.asarray(x)
    if x.size % channels != 0:
        raise ValueError(
            f"sample count {x.size} not divisible by channels {channels}"
        )
    return x.reshape(-1, channels).T.copy()


def interleave(x: np.ndarray) -> np.ndarray:
    """[channels, n] -> interleaved [n*channels]."""
    return np.asarray(x).T.reshape(-1).copy()
