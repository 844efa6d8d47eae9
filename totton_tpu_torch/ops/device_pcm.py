"""On-device float32 -> s16 PCM quantization (torch ops).

Counterpart of ``totton_tpu.ops.device_pcm``: quantizing on the device
halves the device->host transfer (int16 instead of float32). Plain torch
elementwise ops here; a fused kernel waits until a profile on the card
shows the pass matters (ROADMAP queue B).

Bit-compatibility contract (tested against io/pcm.float_to_pcm and the JAX
quantizer):
- undithered: clamp to [-1.0, 0.9999695], scale by 32768 in float32,
  truncate toward zero (the cast to int16);
- dithered: TPDF noise in [-1, 1) LSB and round to nearest
  (floor(v + n + 0.5)), clamped at the integer edge before the cast. The
  noise comes from a torch.Generator seeded from (seed, counter), so a
  stream is reproducible from its seed; it is not JAX's threefry stream.
"""

from __future__ import annotations

import numpy as np
import torch

_CLAMP_LO = -1.0
_CLAMP_HI = 0.9999695  # PcmFormat.S16_LE.clamp_hi (alsa_common.cpp parity)
_SCALE = 32768.0


def quantize_s16(y: torch.Tensor) -> torch.Tensor:
    """float32 [..., n] -> int16 [..., n]; truncation toward zero."""
    clamped = torch.clamp(y, _CLAMP_LO, _CLAMP_HI)
    return (clamped * _SCALE).to(torch.int16)


def _generator(seed: int, counter: int, device: torch.device) -> torch.Generator:
    """One independent, reproducible stream per (seed, counter) pair. The
    pair is hashed (numpy's SeedSequence) so every bit of the torch seed
    depends on both: the CPU generator reads only the low 32 bits."""
    state = np.random.SeedSequence([seed, counter]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) & 0x7FFFFFFFFFFFFFFF)
    return gen


def quantize_s16_dithered(y: torch.Tensor, seed: int,
                          counter: int) -> torch.Tensor:
    """TPDF-dithered round-to-nearest s16 quantization on y's device.

    ``seed`` is the stream's seed and ``counter`` a per-dispatch counter,
    so successive dispatches draw fresh, reproducible noise.
    """
    scaled = torch.clamp(y, _CLAMP_LO, _CLAMP_HI) * _SCALE
    gen = _generator(seed, counter, y.device)
    noise = (torch.rand(y.shape, generator=gen, device=y.device)
             + torch.rand(y.shape, generator=gen, device=y.device) - 1.0)
    vals = torch.floor(scaled + noise + 0.5)
    # floor(0.9999695*32768 + <1 + 0.5) can reach 32768: clamp at the
    # integer edge before the narrowing cast.
    return torch.clamp(vals, -32768.0, 32767.0).to(torch.int16)
