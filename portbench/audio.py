"""Seeded input audio: two tones and a little noise, made in 1 s chunks.

After ``chip_smoke.seeded_signal`` (tones at 0.4 and 0.3 of full scale plus
seeded noise at 0.02, peak under 0.8), with the tone frequency drawn from
the stream's seed rather than computed from it. A track repeats its first
``LOOP`` seconds, so that the load generator encodes each stream's audio
once and spends its CPU on the sockets, not on sines; the serve plane's
work is the same for any samples. Chunk ``k`` of a stream depends only on
(stream seed, k mod LOOP): the load generator and the reference make the
same samples independently.
"""

from __future__ import annotations

import numpy as np

RATE = 44100
CHUNK = RATE  # frames a chunk
LOOP = 4  # chunks before a track repeats


def stream_seed(run_seed: int, stream: int) -> int:
    """A stream's own seed from the run's seed and its index."""
    return int(np.random.SeedSequence([run_seed % 2**63, stream])
               .generate_state(1, np.uint64)[0] >> 1)


def tone_hz(seed: int) -> float:
    return float(np.random.default_rng([seed, 0]).uniform(150.0, 2500.0))


def chunk(seed: int, k: int, channels: int = 2) -> np.ndarray:
    """Frames [k * CHUNK, (k + 1) * CHUNK) of the stream: [channels, CHUNK]
    float32."""
    k %= LOOP
    f0 = tone_hz(seed)
    t = (np.arange(CHUNK, dtype=np.float64) + k * CHUNK) / RATE
    base = [0.4 * np.sin(2 * np.pi * f0 * t),
            0.3 * np.sin(2 * np.pi * 1.5 * f0 * t)]
    tones = np.stack([base[c % 2] for c in range(channels)])
    noise = np.random.default_rng([seed, 1, k]).normal(size=tones.shape)
    return (tones + noise * 0.02).astype(np.float32)


def frames(seed: int, start: int, stop: int, channels: int = 2,
           cache: dict | None = None) -> np.ndarray:
    """Frames [start, stop) of the stream, [channels, stop - start]
    float32; negative indices are the zero history before the stream.
    ``cache`` (a dict the caller owns) keeps the chunks made."""
    out = np.zeros((channels, max(0, stop - start)), np.float32)
    lo = max(start, 0)
    if stop <= lo:
        return out
    for k in range(lo // CHUNK, (stop - 1) // CHUNK + 1):
        c0 = k * CHUNK
        a, b = max(lo, c0), min(stop, c0 + CHUNK)
        key = (seed, k % LOOP, channels)
        if cache is None:
            c = chunk(seed, k, channels)
        elif key in cache:
            c = cache[key]
        else:
            c = cache[key] = chunk(seed, k, channels)
        out[:, a - start:b - start] = c[:, a - c0:b - c0]
    return out
